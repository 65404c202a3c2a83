"""K4: the DFT y = scale · x · W, W[j, k] = exp(sign · 2πi · jk / n).

Counterpart of ``c_ofdm_tpu/ops/pallas_fft.py`` (the Pallas TPU kernel
``_dft_kernel``, public ``dft_pallas``), reached through
``ops.fft.fft_fwd`` / ``ifft_unnorm`` under ``fft_backend="pallas"`` for
complex64 inputs.  On a CUDA complex64 tensor ``dft`` launches one of five
hand-written Hopper kernels in ``csrc/dft.cu``, chosen by n alone
(``_route``):

* ``radix``: a Stockham FFT with each row in shared memory, for every power
  of two from 16 to 8192;
* ``mixed``: the same scheme with a runtime plan of radices 8, 4, 2, 3, 5
  and 7, for every other 7-smooth n (2^a·3^b·5^c·7^d) from 16 to 8192;
* ``cluster``: a four-step FFT, one row per thread-block cluster of c
  blocks held in the cluster's distributed shared memory, for every
  7-smooth n from 8193 to 131072 that splits as n = c·L, c a 7-smooth
  block count from 3 to 16 (odd and composite c included; above 8 the
  card's non-portable cluster sizes), L <= 8192 (DVB-T2's 16K and 32K,
  LTE 5G broadcast's 82944);
* ``bluestein``: the chirp-z transform, one row per block, two power-of-two
  FFTs of m >= 2n - 1 points in shared memory, for every other n from 16
  to 4096;
* ``dense``: the complex GEMM against the n x n twiddle planes, for what is
  left (n < 16, non-7-smooth n above 4096, 7-smooth n above 8192 with no
  such split: 7^6 = 117649, every n above 131072).

Each launch adds one to ``dft.launches`` and to ``dft.<route>_launches``.
On a CPU tensor ``dft`` runs a plain version: ``dft_cluster_ref`` at the
sizes the cluster route takes (the twiddle planes of n = 32768 alone are
8.6 GB, of n = 82944 55 GB), ``dft_ref`` (4 real float32 GEMMs on the
twiddle planes, as the Pallas kernel computes) at every other n.  Anything else raises; a failed
launch raises too, with no fallback.

``dft_radix_ref``, ``dft_mixed_ref``, ``dft_cluster_ref`` and
``dft_bluestein_ref`` are the kernels' arithmetic in plain PyTorch (the
same passes, index maps and float32 tables); the CPU tests hold them
against the float64 DFT and ``dft_pallas`` (or, past 8192, the JAX
package's ``ct_dft``) and the card's tests hold each kernel against its
own.  Only ``dft_cluster_ref`` is on a path of the modem, the CPU one.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import numpy as np
import torch

from ..utils import graphs
from . import _kernels, fft

RADIX_MIN_N = 16      # n / 8 threads per row, 8 points each
RADIX_MAX_N = 8192    # n / 8 = 1024 threads, the most a block can have
BLUESTEIN_MAX_N = 4096  # m = 8192 points, 64 KB of shared memory
CLUSTER_MAX_N = 131072  # 16 blocks (the card's largest cluster) of 8192 points
# blocks a cluster, in the order tried: the 7-smooth counts from 3 to 16
# (above 8 the non-portable cluster sizes the H100 allows); 2 is never the
# least count for an n from 8193 to 131072, so it is not built
CLUSTER_SPLITS = (3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 15, 16)
CLUSTER_BEST_L = 4096       # points a block where a split allows it
ROUTES = ("radix", "mixed", "cluster", "bluestein", "dense")


def _smooth(n: int) -> bool:
    """n = 2^a·3^b·5^c·7^d."""
    for p in (2, 3, 5, 7):
        while n % p == 0:
            n //= p
    return n == 1


def _cluster_split(n: int) -> tuple[int, int] | None:
    """(c, L) with n = c·L for the cluster route, for a 7-smooth n from
    8193 to 131072: the first c of ``CLUSTER_SPLITS`` that divides n with
    L <= 4096, else the first with L <= 8192; None where no c divides n so.
    16384 = 4 x 4096, 32768 = 8 x 4096, 65536 = 16 x 4096, 19683 = 9 x
    2187, 82944 = 12 x 6912: blocks of 4096 points were the fastest split
    on the H100 at the 16K and 32K steps, and 12 x 6912 beat 16 x 5184 at
    82944 (``csrc/dft.cu``)."""
    if not (RADIX_MAX_N < n <= CLUSTER_MAX_N and _smooth(n)):
        return None
    fits = [(c, n // c) for c in CLUSTER_SPLITS if n % c == 0]
    return next((s for s in fits if s[1] <= CLUSTER_BEST_L),
                next((s for s in fits if s[1] <= RADIX_MAX_N), None))


def _fits(route: str, n: int) -> bool:
    """Whether the kernel of ``route`` takes length n: each route the sizes
    ``_route`` gives it, the mixed kernel also the powers of two (phase 18
    of ``chip_smoke.py`` times it against the radix kernel there) and the
    dense kernel every n."""
    if route == "radix":
        return RADIX_MIN_N <= n <= RADIX_MAX_N and n & (n - 1) == 0
    if route == "mixed":
        return RADIX_MIN_N <= n <= RADIX_MAX_N and _smooth(n)
    if route == "cluster":
        return _cluster_split(n) is not None
    if route == "bluestein":
        return RADIX_MIN_N <= n <= BLUESTEIN_MAX_N and not _smooth(n)
    return route == "dense"


def _route(n: int) -> str:
    """The first of ``ROUTES`` whose kernel takes n: "radix" for a power of
    two from 16 to 8192, "mixed" for any other 7-smooth n up to 8192,
    "cluster" for a 7-smooth n from 8193 to 131072 with a split n = c·L (c
    from 3 to 16; L <= 8192), "bluestein" for any other n up to 4096, else
    "dense"."""
    return next(r for r in ROUTES if _fits(r, n))


_forced = None      # the route _forced_route names, else None


@contextlib.contextmanager
def _forced_route(route: str):
    """Inside the block ``dft`` launches the kernel of ``route`` on CUDA
    tensors, where ``_route`` would pick another (and raises ValueError
    where that kernel does not take n): ``chip_smoke.py`` and the card tests
    time and check the dense route, and the mixed one at powers of two, on
    the inputs the path gives the new routes."""
    global _forced
    if route not in ROUTES:
        raise ValueError(f"dft: no route {route!r}")
    before, _forced = _forced, route
    try:
        yield
    finally:
        _forced = before


@graphs.device_cache(maxsize=16)
def dft_planes(n: int, sign: int, scale: float,
               device: torch.device) -> torch.Tensor:
    """(Re W, Im W) as one float32 tensor [2, n, n] on ``device``: the
    twiddles in complex128 times ``scale``, rounded once to float32 (the
    Pallas kernel's ``_dft_planes``); cached."""
    return fft.basis_pair(fft._dft_matrix_np(n, sign) * scale, device,
                          torch.float32)


def _twiddles_np(n: int, sign: int) -> np.ndarray:
    return np.exp(sign * 2j * np.pi * np.arange(n) / n).astype(np.complex64)


@graphs.device_cache(maxsize=16)
def fft_twiddles(n: int, sign: int, device: torch.device) -> torch.Tensor:
    """exp(sign · 2πi · k / n) for k < n, complex64 [n] on ``device``:
    computed in float64 and rounded once; cached."""
    return torch.from_numpy(_twiddles_np(n, sign)).to(device)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x [..., n] -> [b, n] (a view where the strides allow one)."""
    n = x.shape[-1]
    return x.reshape(math.prod(x.shape[:-1]), n)


def dft_ref(x: torch.Tensor, sign: int = -1, scale: float = 1.0) -> torch.Tensor:
    """Plain version of K4: x [..., n] complex -> complex64 [..., n] as 4
    real float32 GEMMs on the planes."""
    w = dft_planes(x.shape[-1], sign, float(scale), x.device)
    y = fft.complex_matmul(_rows(x).to(torch.complex64), w)
    return y.reshape(x.shape)


# ------------------------------------------------------------ butterflies


def _radices(n: int) -> list[int]:
    """The radix route's passes: 2^(log2 n mod 3, or 3) first, then 8s."""
    lg = n.bit_length() - 1
    return [1 << (lg % 3 or 3)] + [8] * ((lg - 1) // 3)


@functools.cache
def _root(radix: int, q: int) -> tuple[float, float]:
    """cos and sin of 2π·q/R, q/R in lowest terms, computed in float64 and
    rounded once to float32: the constants of the kernels' radix-3/5/7
    butterflies (``csrc/dft.cu::root``) and of the rotations inside a
    composite butterfly (``turn``)."""
    g = math.gcd(q, radix)
    v = np.exp(2j * np.pi * (q // g) / (radix // g))
    return float(np.float32(v.real)), float(np.float32(v.imag))


@functools.cache
def _odd_roots(radix: int) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """``_root`` of 2π·q/R for q < R, as (cos, sin) tuples: the constants of
    the kernel's radix-3/5/7 butterflies."""
    return tuple(zip(*(_root(radix, q) for q in range(radix))))


def _dft_odd(u: list[torch.Tensor], s: int) -> list[torch.Tensor]:
    """The kernel's radix-3/5/7 butterfly: with a_k = u_k + u_{R-k} and
    b_k = u_k - u_{R-k}, y_p = u_0 + Σ_k cos(2πkp/R)·a_k ± s·i·Σ_k
    sin(2πkp/R)·b_k for y_p and y_{R-p}."""
    radix = len(u)
    half = (radix - 1) // 2
    cos, sin = _odd_roots(radix)
    a = [u[k] + u[radix - k] for k in range(1, half + 1)]
    b = [u[k] - u[radix - k] for k in range(1, half + 1)]
    y = [u[0]] * radix
    for ak in a:
        y[0] = y[0] + ak
    for p in range(1, half + 1):
        re, im = u[0], None
        for k in range(1, half + 1):
            q = k * p % radix
            re = re + cos[q] * a[k - 1]
            im = sin[q] * b[k - 1] if im is None else im + sin[q] * b[k - 1]
        rot = im * (s * 1j)
        y[p], y[radix - p] = re + rot, re - rot
    return y


# c = a·b for the kernels' composite butterflies: a-point DFTs, the
# rotations, then b-point DFTs (csrc/dft.cu::Split)
_BUTTERFLY_FACTORS = {6: (2, 3), 9: (3, 3), 10: (2, 5), 12: (4, 3),
                      14: (2, 7), 15: (3, 5), 16: (4, 4)}


def _rotate(z: torch.Tensor, radix: int, q: int, s: int) -> torch.Tensor:
    """z · exp(s·2πi·q/R) as the kernels' ``rotate``: exact where q/R is
    0, 1/2, 1/4 or 3/4 (mod 1), else the float32 root."""
    q %= radix
    g = math.gcd(q, radix)
    radix, q = radix // g, q // g
    if q == 0:
        return z
    if radix == 2:
        return -z
    if radix == 4:
        return z * ((s if q == 1 else -s) * 1j)
    cos, sin = _root(radix, q)
    return z * complex(cos, s * sin)


def _dft_two(u: list[torch.Tensor], s: int) -> list[torch.Tensor]:
    """The kernels' composite butterfly of c = a·b points
    (``_BUTTERFLY_FACTORS``): with m = b·m1 + m2 and k = k1 + a·k2, the
    a-point DFTs over m1 for each m2, each output k1 rotated by
    exp(s·2πi·m2·k1/c), then the b-point DFTs over m2 for each k1."""
    c = len(u)
    a, b = _BUTTERFLY_FACTORS[c]
    z = [[_rotate(v, c, m2 * k1, s)
          for k1, v in enumerate(_dft_small(u[m2::b], s))]
         for m2 in range(b)]
    y = [None] * c
    for k1 in range(a):
        for k2, v in enumerate(_dft_small([z[m2][k1] for m2 in range(b)],
                                          s)):
            y[k1 + a * k2] = v
    return y


def _dft_small(u: list[torch.Tensor], s: int) -> list[torch.Tensor]:
    """The kernels' butterflies on lists of complex tensors: y_k = Σ_m u_m
    · exp(s·2πi·mk/R), R in {2, 3, 4, 5, 7, 8} and the composite counts of
    ``_BUTTERFLY_FACTORS``."""
    if len(u) == 2:
        return [u[0] + u[1], u[0] - u[1]]
    if len(u) == 4:
        t0, t1 = u[0] + u[2], u[0] - u[2]
        t2, t3 = u[1] + u[3], (u[1] - u[3]) * (s * 1j)
        return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]
    if len(u) in _BUTTERFLY_FACTORS:
        return _dft_two(u, s)
    if len(u) != 8:
        return _dft_odd(u, s)
    e = _dft_small(u[0::2], s)
    o = _dft_small(u[1::2], s)
    c = math.sqrt(0.5)
    o = [o[0], o[1] * complex(c, s * c), o[2] * (s * 1j),
         o[3] * complex(-c, s * c)]
    return [e[k] + o[k] for k in range(4)] + [e[k] - o[k] for k in range(4)]


# ------------------------------------------------------------ plain passes


def dft_radix_ref(x: torch.Tensor, sign: int = -1,
                  scale: float = 1.0) -> torch.Tensor:
    """The radix kernel's arithmetic in plain PyTorch: x [..., n] complex,
    n a power of two from 16 to 8192 -> complex64 [..., n].

    Registers are ``regs[:, k, t]``, thread t's point t + k·n/8.  Pass
    (R, Ns) runs butterfly j = t + b·n/8 on the points k = b + (8/R)·r,
    multiplies point r by ``tw[(j mod Ns)·r·n/(Ns·R)]`` and sends it to
    expand(j, Ns, R) + r·Ns = (j div Ns)·Ns·R + j mod Ns + r·Ns, with the
    same table (``fft_twiddles``) as the kernel; scale comes last."""
    n = x.shape[-1]
    if not _fits("radix", n):
        raise ValueError(f"dft_radix_ref: n={n} is not a power of two from "
                         f"{RADIX_MIN_N} to {RADIX_MAX_N}")
    tw = fft_twiddles(n, sign, x.device)
    data = _rows(x).to(torch.complex64)
    m, t_n = data.shape[0], n // 8
    t = torch.arange(t_n, device=x.device)
    k = torch.arange(8, device=x.device)
    ns = 1
    for radix in _radices(n):
        nb = 8 // radix
        b, r = (k % nb)[:, None], (k // nb)[:, None]
        j = t + b * t_n                                    # [8, T]
        regs = data.reshape(m, 8, t_n)
        if ns > 1:
            regs = regs * tw[(j % ns) * r * (n // (ns * radix))]
        u = regs.reshape(m, radix, nb, t_n)                # k = r·nb + b
        regs = torch.stack(_dft_small(list(u.unbind(1)), sign), 1)
        dest = (j // ns) * ns * radix + j % ns + r * ns
        data = torch.empty_like(data)
        data[:, dest.reshape(-1)] = regs.reshape(m, n)
        ns *= radix
    return (data * scale).reshape(x.shape)


@functools.cache
def _mixed_radices(n: int) -> tuple[int, ...]:
    """The mixed route's plan for a 7-smooth n: the power of two as 8s,
    then its remainder (4 or 2), then 3s, 5s and 7s.  With this order the
    swizzled exchanges of the 1536- and 6144-point plans are free of bank
    conflicts (tests/test_torch_fft.py)."""
    out = []
    for p in (2, 3, 5, 7):
        while n % p == 0:
            out.append(p)
            n //= p
    lg = out.count(2)
    twos = [8] * (lg // 3) + ([1 << (lg % 3)] if lg % 3 else [])
    return tuple(twos + [p for p in out if p != 2])


def _mixed_twiddle_index(n: int) -> np.ndarray:
    """Where ``mixed_twiddles`` takes each value from the n-point table: for
    each pass (R, Ns) after the first, (j mod Ns)·r·n/(Ns·R) for r = 1 ..
    R - 1 (major) and j mod Ns < Ns."""
    idx, ns = [], 1
    for radix in _mixed_radices(n):
        if ns > 1:
            r = np.arange(1, radix)[:, None]
            idx.append((np.arange(ns) * r * (n // (ns * radix))).reshape(-1))
        ns *= radix
    return np.concatenate(idx)


@graphs.device_cache(maxsize=16)
def mixed_twiddles(n: int, sign: int, device: torch.device) -> torch.Tensor:
    """The mixed kernel's twiddles: the values of ``fft_twiddles(n, sign)``
    (float64, rounded once) gathered by ``_mixed_twiddle_index``, complex64
    on ``device``; cached.  A warp's twiddles of one point r are then
    contiguous, where the n-point table scatters them."""
    idx = _mixed_twiddle_index(n)
    return torch.from_numpy(_twiddles_np(n, sign)[idx]).to(device)


def dft_mixed_ref(x: torch.Tensor, sign: int = -1,
                  scale: float = 1.0) -> torch.Tensor:
    """The mixed kernel's arithmetic in plain PyTorch: x [..., n] complex,
    n 7-smooth from 16 to 8192 -> complex64 [..., n].

    Pass (R, Ns) of ``_mixed_radices(n)`` runs the n/R butterflies j on the
    points j + r·n/R, multiplies point r > 0 by exp(sign·2πi·(j mod Ns)·r/
    (Ns·R)) = ``tw[(r - 1)·Ns + j mod Ns]`` of the pass's block of
    ``mixed_twiddles`` (the kernel's table), and sends output r to
    expand(j, Ns, R) + r·Ns; scale comes last.  The kernel's thread t runs
    the butterflies j = t + b·ceil(n/8)."""
    n = x.shape[-1]
    if not _fits("mixed", n):
        raise ValueError(f"dft_mixed_ref: n={n} is not 7-smooth from "
                         f"{RADIX_MIN_N} to {RADIX_MAX_N}")
    tw = mixed_twiddles(n, sign, x.device)
    data = _rows(x).to(torch.complex64)
    m = data.shape[0]
    ns, off = 1, 0
    for radix in _mixed_radices(n):
        nb = n // radix
        j = torch.arange(nb, device=x.device)
        r = torch.arange(radix, device=x.device)[:, None]
        u = data.reshape(m, radix, nb)                     # point j + r·nb
        if ns > 1:
            block = tw[off:off + (radix - 1) * ns].reshape(radix - 1, ns)
            u = torch.cat([u[:, :1], u[:, 1:] * block[:, j % ns]], 1)
            off += (radix - 1) * ns
        y = torch.stack(_dft_small(list(u.unbind(1)), sign), 1)
        dest = (j // ns) * ns * radix + j % ns + r * ns    # [R, nb]
        data = torch.empty_like(data)
        data[:, dest.reshape(-1)] = y.reshape(m, n)
        ns *= radix
    return (data * scale).reshape(x.shape)


@graphs.device_cache(maxsize=16)
def cluster_twiddles(n: int, c: int, sign: int,
                     device: torch.device) -> torch.Tensor:
    """The cluster kernel's twiddles between its two steps for the split
    n = c·L: exp(sign·2πi·r·k1/n) for r = 1 .. c - 1 (major) and k1 < L,
    the values of ``fft_twiddles(n, sign)`` (float64, rounded once) at
    r·k1 < n, complex64 [(c - 1)·L] on ``device``; cached."""
    idx = np.arange(1, c)[:, None] * np.arange(n // c)
    return torch.from_numpy(_twiddles_np(n, sign)[idx.reshape(-1)]).to(device)


def dft_cluster_ref(x: torch.Tensor, sign: int = -1,
                    scale: float = 1.0) -> torch.Tensor:
    """The cluster kernel's arithmetic in plain PyTorch: x [..., n]
    complex, n a size the cluster route takes -> complex64 [..., n].

    With (c, L) = ``_cluster_split(n)``, input index c·i + r and output
    index k1 + L·k2: block r's L-point FFT of x[c·i + r] (``dft_mixed_ref``,
    the same passes and table as the kernel's), X_r[k1] times
    ``cluster_twiddles`` (exp(sign·2πi·r·k1/n), r > 0), the c-point
    butterfly across r for each k1 (the kernels' ``_dft_small``: odd c
    as the mixed passes' radix-3/5/7 butterflies, composite c as two
    factors) and scale."""
    n = x.shape[-1]
    if not _fits("cluster", n):
        raise ValueError(f"dft_cluster_ref: n={n} is not 7-smooth from "
                         f"{RADIX_MAX_N + 1} to {CLUSTER_MAX_N} with a split "
                         f"n = c·L, c in {CLUSTER_SPLITS}, "
                         f"L <= {RADIX_MAX_N}")
    c, L = _cluster_split(n)
    data = _rows(x).to(torch.complex64)
    m = data.shape[0]
    u = data.reshape(m, L, c).transpose(1, 2).reshape(m * c, L)
    z = dft_mixed_ref(u, sign).reshape(m, c, L)
    tw = cluster_twiddles(n, c, sign, x.device).reshape(c - 1, L)
    parts = [z[:, 0]] + [z[:, r] * tw[r - 1] for r in range(1, c)]
    y = torch.stack(_dft_small(parts, sign), 1)           # [m, k2, k1]
    return (y.reshape(m, n) * scale).reshape(x.shape)


def _bluestein_m(n: int) -> int:
    """The convolution length: the least power of two >= 2n - 1, and at
    least 64 (the smallest size the kernel is built for)."""
    return max(64, 1 << (2 * n - 2).bit_length())


def _chirp_np(n: int, sign: int) -> np.ndarray:
    """c_k = exp(sign·πi·(k² mod 2n)/n) in complex128, k² mod 2n exact in
    int64 before the float64 exponential."""
    k = np.arange(n, dtype=np.int64)
    return np.exp(sign * 1j * np.pi * ((k * k) % (2 * n)) / n)


@graphs.device_cache(maxsize=16)
def bluestein_chirp(n: int, sign: int, device: torch.device) -> torch.Tensor:
    """The chirp c [n] as complex64 on ``device``, rounded once; cached."""
    return torch.from_numpy(_chirp_np(n, sign).astype(np.complex64)).to(device)


@graphs.device_cache(maxsize=16)
def bluestein_filter(n: int, sign: int, device: torch.device) -> torch.Tensor:
    """The m-point forward spectrum of the filter h (h_l = conj(c_l) for
    l < n, h_{m-l} = conj(c_l) for 0 < l < n, zero between), computed in
    float64 with numpy and rounded once to complex64; cached."""
    m = _bluestein_m(n)
    h = np.zeros(m, np.complex128)
    c = _chirp_np(n, sign).conj()
    h[:n] = c
    h[m - n + 1:] = c[1:][::-1]
    return torch.from_numpy(np.fft.fft(h).astype(np.complex64)).to(device)


def dft_bluestein_ref(x: torch.Tensor, sign: int = -1,
                      scale: float = 1.0) -> torch.Tensor:
    """The Bluestein kernel's arithmetic in plain PyTorch: x [..., n]
    complex, n from 16 to 4096 and not 7-smooth -> complex64 [..., n].

    With jk = (j² + k² - (k-j)²)/2, y_k = scale·c_k·Σ_j (x_j·c_j)·
    conj(c_{k-j}): x·c zero-padded to m points, its forward m-point FFT
    (``dft_radix_ref``, sign -1) times the filter's spectrum, the backward
    m-point FFT (sign +1), and the first n points times c and scale/m."""
    n = x.shape[-1]
    if not _fits("bluestein", n):
        raise ValueError(f"dft_bluestein_ref: n={n} is 7-smooth or is not "
                         f"from {RADIX_MIN_N} to {BLUESTEIN_MAX_N}")
    m = _bluestein_m(n)
    c = bluestein_chirp(n, sign, x.device)
    data = _rows(x).to(torch.complex64)
    a = torch.zeros((data.shape[0], m), dtype=torch.complex64,
                    device=x.device)
    a[:, :n] = data * c
    spectrum = dft_radix_ref(a, -1) * bluestein_filter(n, sign, x.device)
    z = dft_radix_ref(spectrum, +1)
    return (z[:, :n] * c * _post_scale(scale, m)).reshape(x.shape)


def _post_scale(scale: float, m: int) -> float:
    """scale/m as the kernel takes it: one float32."""
    return float(np.float32(scale / m))


# ------------------------------------------------------------ the kernels


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _kernels.library("dft")
    vp, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_float
    for name, args in (
            ("c_ofdm_dft", [vp, ll, vp, vp, vp, ll, ll, vp]),
            ("c_ofdm_fft", [vp, ll, vp, vp, ll, ll, i, f, vp]),
            ("c_ofdm_mixed_fft", [vp, ll, vp, vp, ll, ll, ctypes.c_ulonglong,
                                  i, i, f, vp]),
            ("c_ofdm_bluestein", [vp, ll, vp, vp, vp, vp, vp, ll, ll, ll, f,
                                  vp]),
            ("c_ofdm_cluster_fft", [vp, ll, vp, vp, vp, ll, i, ll,
                                    ctypes.c_ulonglong, i, i, f, vp]),
            ("c_ofdm_fft_prepare", [ll]),
            ("c_ofdm_mixed_prepare", []),
            ("c_ofdm_cluster_prepare", [i, ll, ctypes.c_ulonglong, i,
                                        ctypes.POINTER(i)]),
            ("c_ofdm_bluestein_prepare", [ll])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.c_ofdm_dft_error_string.argtypes = [ctypes.c_int]
    lib.c_ofdm_dft_error_string.restype = ctypes.c_char_p
    return lib


def _plan_word(n: int) -> tuple[int, int]:
    """The mixed plan of n as the kernels take it: (4 bits a radix, first
    pass lowest; passes)."""
    plan = _mixed_radices(n)
    return sum(r << (4 * i) for i, r in enumerate(plan)), len(plan)


@functools.cache
def _prepare(route: str, device_index: int, *size: int) -> int | None:
    """A kernel's once-per-(process, device, size) set-up, its dynamic
    shared memory limit (``c_ofdm_*_prepare``): the radix kernel of n, the
    mixed kernel (no size), the cluster kernel of (c, L), which also checks
    that one of its clusters fits on the device and returns how many fit at
    once (``cudaOccupancyMaxActiveClusters``), the Bluestein kernel of m.
    Runs at the first launch on the device, which is never inside a
    CUDA-graph capture: the captured call's warm-up launches first
    (``utils/graphs.py``)."""
    lib = _lib()
    fits = None
    with torch.cuda.device(device_index):
        if route == "cluster":
            c, L = size
            fits = ctypes.c_int(0)
            rc = lib.c_ofdm_cluster_prepare(c, L, *_plan_word(L),
                                            ctypes.byref(fits))
            fits = fits.value
        else:
            rc = {"radix": lambda: lib.c_ofdm_fft_prepare(*size),
                  "mixed": lib.c_ofdm_mixed_prepare,
                  "bluestein": lambda: lib.c_ofdm_bluestein_prepare(*size)
                  }[route]()
    if rc != 0:
        msg = lib.c_ofdm_dft_error_string(rc).decode()
        raise RuntimeError(f"dft {route} kernel set-up failed for size "
                           f"{size}: {msg}")
    return fits


def _launch(x: torch.Tensor, sign: int, scale: float,
            route: str) -> torch.Tensor:
    """One launch of the kernel of ``route`` on CUDA complex64 x [..., n],
    counted; ValueError, before anything runs, where that kernel does not
    take n."""
    n = x.shape[-1]
    if not _fits(route, n):
        raise ValueError(f"dft: the {route} route does not take n={n}")
    x2 = _rows(x.resolve_conj())
    if x2.stride(1) != 1:
        x2 = x2.contiguous()
    out = torch.empty(x2.shape, dtype=torch.complex64, device=x.device)
    if out.numel() == 0:
        return out.reshape(x.shape)
    lib = _lib()
    dev = x.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (x2.data_ptr(), x2.stride(0))
        if route == "radix":
            _prepare(route, dev.index, n)
            rc = lib.c_ofdm_fft(*args, fft_twiddles(n, sign, dev).data_ptr(),
                                out.data_ptr(), x2.shape[0], n, sign,
                                float(scale), stream)
        elif route == "mixed":
            _prepare(route, dev.index)
            rc = lib.c_ofdm_mixed_fft(
                *args, mixed_twiddles(n, sign, dev).data_ptr(), out.data_ptr(),
                x2.shape[0], n, *_plan_word(n), sign, float(scale), stream)
        elif route == "cluster":
            c, L = _cluster_split(n)
            _prepare(route, dev.index, c, L)
            rc = lib.c_ofdm_cluster_fft(
                *args, mixed_twiddles(L, sign, dev).data_ptr(),
                cluster_twiddles(n, c, sign, dev).data_ptr(), out.data_ptr(),
                x2.shape[0], c, L,
                *_plan_word(L), sign, float(scale), stream)
        elif route == "bluestein":
            m = _bluestein_m(n)
            _prepare(route, dev.index, m)
            rc = lib.c_ofdm_bluestein(
                *args, bluestein_chirp(n, sign, dev).data_ptr(),
                bluestein_filter(n, sign, dev).data_ptr(),
                fft_twiddles(m, -1, dev).data_ptr(),
                fft_twiddles(m, +1, dev).data_ptr(), out.data_ptr(),
                x2.shape[0], n, m, _post_scale(scale, m), stream)
        else:
            w = dft_planes(n, sign, float(scale), dev)
            rc = lib.c_ofdm_dft(*args, w[0].data_ptr(), w[1].data_ptr(),
                                out.data_ptr(), x2.shape[0], n, stream)
    if rc != 0:
        msg = lib.c_ofdm_dft_error_string(rc).decode()
        raise RuntimeError(f"dft {route} kernel launch failed: {msg} "
                           f"(rows={x2.shape[0]}, n={n})")
    dft.launches += 1
    setattr(dft, f"{route}_launches", getattr(dft, f"{route}_launches") + 1)
    return out.reshape(x.shape)


def dft(x: torch.Tensor, sign: int = -1, scale: float = 1.0) -> torch.Tensor:
    """K4: x [..., n] -> y [..., n] with y = scale · x · W along the last
    axis (sign -1: FFTW forward, +1: FFTW backward).

    CUDA complex64 tensors: one launch on the current stream (no
    synchronise) of the kernel ``_route(n)`` names, adding one to
    ``dft.launches`` and to ``dft.<route>_launches``.  Rows may be strided
    (a view such as ``sig.reshape(B, S, L)[..., cp:]`` is read in place);
    the last axis must have stride 1 or is copied.  CPU tensors:
    ``dft_cluster_ref`` at the sizes of the cluster route, else ``dft_ref``.
    """
    if x.device.type == "cpu":
        plain = dft_cluster_ref if _fits("cluster", x.shape[-1]) else dft_ref
        return plain(x, sign, scale)
    if x.device.type != "cuda":
        raise ValueError(f"dft: no kernel for device {x.device}")
    if x.dtype != torch.complex64:
        raise TypeError(f"dft: the kernel takes complex64, got {x.dtype}")
    return _launch(x, sign, scale, _forced or _route(x.shape[-1]))


dft.launches = 0
dft.radix_launches = 0
dft.mixed_launches = 0
dft.cluster_launches = 0
dft.bluestein_launches = 0
dft.dense_launches = 0
