"""K4: the DFT y = scale · x · W, W[j, k] = exp(sign · 2πi · jk / n).

Counterpart of ``c_ofdm_tpu/ops/pallas_fft.py`` (the Pallas TPU kernel
``_dft_kernel``, public ``dft_pallas``), reached through
``ops.fft.fft_fwd`` / ``ifft_unnorm`` under ``fft_backend="pallas"`` for
complex64 inputs.  On a CUDA complex64 tensor ``dft`` runs one of seven
hand-written Hopper routes in ``csrc/dft.cu``, chosen by n alone
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
* ``fourstep``: a four-step FFT in two launches through a workspace, for
  every other 7-smooth n that splits as N1·N2 with both factors from 16 to
  8192 (117649 = 7^6, 165888, every such n from 131073 to 8192²): launch 1
  the N1-point DFTs down the columns (in registers for N1 <= 64) and the
  twiddles, launch 2 the N2-point DFTs along the rows;
* ``bluestein``: the chirp-z transform, one row per block, two power-of-two
  FFTs of m >= 2n - 1 points in shared memory, for every other n from 16
  to 4096;
* ``chirp``: Bluestein's algorithm over the FFT routes for every other n up
  to 2^25 (non-7-smooth n above 4096): the chirp product, the m-point FFTs
  on m's route (m the least 7-smooth length >= 2n - 1 that the radix,
  mixed, cluster or four-step route takes), the filter product, the last
  chirp product, in their own launches;
* ``dense``: the complex GEMM against the n x n twiddle planes, for n < 16
  only (a DFT of at most 15 points as a matrix).

No route takes a non-7-smooth n above 2^25, or a 7-smooth n above 8192²
or with no such split: ``dft`` raises ValueError there before it builds
anything.  Each CUDA launch adds one to ``dft.launches`` and to the
counter of the route whose kernel it is, ``dft.<route>_launches``: a
four-step transform is two launches, a chirp call two or three of its own
(``chirp_launches``: the chirp products and, off the four-step route, the
filter product) beside its two m-point FFTs on m's route's counter.  On a
CPU tensor ``dft`` runs a plain version:
``dft_cluster_ref``, ``dft_fourstep_ref`` or ``dft_chirp_ref`` at those
routes' sizes (no n x n planes: at n = 82944 they would be 55 GB),
``dft_ref`` (4 real float32 GEMMs on the twiddle planes, as the Pallas
kernel computes) at every other n.  A failed set-up or launch raises, with
no fallback.

``dft_radix_ref``, ``dft_mixed_ref``, ``dft_cluster_ref``,
``dft_fourstep_ref``, ``dft_bluestein_ref`` and ``dft_chirp_ref`` are the
kernels' arithmetic in plain PyTorch (the same passes, index maps and
float32 tables); the CPU tests hold them against the float64 DFT and
``dft_pallas`` (or, past 8192, the JAX package's ``ct_dft``) and the
card's tests hold each kernel against its own.  Of these only the cluster,
four-step and chirp ones are on a path of the modem, the CPU one.
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
FOURSTEP_MAX_N = RADIX_MAX_N ** 2   # two factors of at most 8192 points
FOURSTEP_GROUP = 4   # rows k1 a launch-2 block writes together (32 bytes)
CHIRP_MAX_N = 1 << 25   # the chirp route's m >= 2n - 1 stays <= 8192²
SMEM_MAX = 232448    # the H100's shared memory a block may opt in to
ROUTES = ("radix", "mixed", "cluster", "fourstep", "bluestein", "chirp",
          "dense")


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


@functools.cache
def _smooth_upto(limit: int) -> tuple[int, ...]:
    """Every 7-smooth number from 1 to ``limit``, ascending."""
    out = [1]
    for p in (2, 3, 5, 7):
        out = [v * p ** e for v in out
               for e in range(int(math.log(limit / v, p)) + 2)
               if v * p ** e <= limit]
    return tuple(sorted(set(out)))


# N1 = A·B for the register column kernel (csrc/dft.cu::reg_kernel): A, B
# radices of the mixed passes, N1 <= 64 points held by one thread; every
# such N1 that ``_fourstep_split`` picks for some n past 131072 (16 only
# for n <= 4096, which other routes take, so it is not built)
_FOURSTEP_REG = {20: (4, 5), 21: (3, 7), 24: (3, 8), 25: (5, 5), 28: (4, 7),
                 32: (4, 8), 35: (5, 7), 40: (5, 8), 49: (7, 7), 56: (7, 8),
                 64: (8, 8)}


@functools.cache
def _fourstep_split(n: int) -> tuple[int, int] | None:
    """(N1, N2) with n = N1·N2 for the four-step route, both factors
    7-smooth from 16 to 8192: the largest N1 the register column kernel
    takes (``_FOURSTEP_REG``, N1 <= 64: launch 1 then runs from registers,
    and a short N2 keeps launch 2's blocks small enough to write 4 rows
    k1 together), else the least N1 above 64; None where n has no such
    split.  165888 = 64 x 2592, 117649 = 49 x 2401, 262144 = 64 x 4096,
    82944 = 64 x 1296 (``PERF.md`` section 6 records the others' times)."""
    if not (RADIX_MIN_N ** 2 <= n <= FOURSTEP_MAX_N and _smooth(n)):
        return None
    fits = [a for a in _smooth_upto(RADIX_MAX_N) if a >= RADIX_MIN_N
            and n % a == 0 and RADIX_MIN_N <= n // a <= RADIX_MAX_N]
    if not fits:
        return None
    n1 = max((a for a in fits if a in _FOURSTEP_REG),
             default=next((a for a in fits if a > 64), fits[-1]))
    return n1, n // n1


def _fourstep_points(n: int, rows: int) -> int:
    """Points a thread of a four-step block of ``rows`` rows of n points
    takes: 8 while the block stays within 1024 threads, else 16
    (``csrc/dft.cu::fourstep_points``)."""
    return 8 if rows * -(-n // 8) <= 1024 else 16


def _block_fits(n: int, rows: int) -> bool:
    """Whether a four-step block of ``rows`` rows of n points fits: at most
    1024 threads, and the rows' two buffers (n rounded up to 16 points,
    one float2 of padding a row) within ``SMEM_MAX``."""
    threads = rows * -(-n // _fourstep_points(n, rows))
    smem = rows * (2 * -(-n // 16) * 16 + 1) * 8
    return threads <= 1024 and smem <= SMEM_MAX


def _fourstep_shape(n1: int, n2: int) -> tuple[int, int]:
    """(cols, group): the columns a launch-1 block holds, 0 for the
    register kernel (an N1 of ``_FOURSTEP_REG``), else about 256 threads'
    worth, from 16 to 64 columns where the block fits, fewer only where it
    does not; and the rows k1 a launch-2 block writes together (at most
    ``FOURSTEP_GROUP``, a divisor of n1 that fits)."""
    group = FOURSTEP_GROUP
    if n1 in _FOURSTEP_REG:
        cols = 0
    else:
        cols = min(64, max(16, 1 << (max(1, 256 // -(-n1 // 8))
                                     .bit_length() - 1)))
    while cols > 1 and not _block_fits(n1, cols):
        cols //= 2
    while group > 1 and (n1 % group or not _block_fits(n2, group)):
        group //= 2
    return cols, group


def _fits(route: str, n: int) -> bool:
    """Whether the kernel of ``route`` takes length n: each route the sizes
    ``_route`` gives it, the mixed kernel also the powers of two (timed
    against the radix kernel there, ``PERF.md`` section 6), the four-step
    kernel also the cluster route's sizes (timed against it there), the
    chirp kernel every n from 4097 to 2^25 and the dense kernel every
    n."""
    if route == "radix":
        return RADIX_MIN_N <= n <= RADIX_MAX_N and n & (n - 1) == 0
    if route == "mixed":
        return RADIX_MIN_N <= n <= RADIX_MAX_N and _smooth(n)
    if route == "cluster":
        return _cluster_split(n) is not None
    if route == "fourstep":
        return _fourstep_split(n) is not None
    if route == "bluestein":
        return RADIX_MIN_N <= n <= BLUESTEIN_MAX_N and not _smooth(n)
    if route == "chirp":
        return BLUESTEIN_MAX_N < n <= CHIRP_MAX_N
    return route == "dense"


def _route(n: int) -> str | None:
    """The route ``dft`` takes for length n: "dense" below 16 points, else
    the first of ``ROUTES`` whose kernel takes n: "radix" for a power of
    two from 16 to 8192, "mixed" for any other 7-smooth n up to 8192,
    "cluster" for a 7-smooth n from 8193 to 131072 with a split n = c·L (c
    from 3 to 16; L <= 8192), "fourstep" for any other 7-smooth n with a
    split N1·N2 (both from 16 to 8192), "bluestein" for any other n up to
    4096, "chirp" for any other n up to 2^25; None past that (a non-7-smooth
    n above 2^25, or a 7-smooth one above 8192² or with no split)."""
    if n < RADIX_MIN_N:
        return "dense"
    return next((r for r in ROUTES[:-1] if _fits(r, n)), None)


_forced = None      # the route _forced_route names, else None


@contextlib.contextmanager
def _forced_route(route: str):
    """Inside the block ``dft`` launches the kernel of ``route`` on CUDA
    tensors, where ``_route`` would pick another (and raises ValueError
    where that kernel does not take n): the card tests check the dense
    route, and the mixed one at powers of two, on the inputs the path gives
    the new routes."""
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


@graphs.device_cache(maxsize=16)
def fourstep_twiddles(n: int, n1: int, sign: int,
                      device: torch.device) -> torch.Tensor:
    """The four-step kernel's twiddles between its two launches for the
    split n = N1·N2: exp(sign·2πi·j2·k1/n) for k1 = 1 .. N1 - 1 (major) and
    j2 < N2, the values of ``fft_twiddles(n, sign)`` (float64, rounded
    once) at j2·k1 < n, complex64 [(N1 - 1)·N2] on ``device``; cached.  A
    warp's loads of one k1 are then contiguous across its columns j2."""
    idx = np.arange(1, n1)[:, None] * np.arange(n // n1)
    tw = np.exp(sign * 2j * np.pi * idx.reshape(-1) / n)
    return torch.from_numpy(tw.astype(np.complex64)).to(device)


def _dft_regs(u: torch.Tensor, sign: int) -> torch.Tensor:
    """The register column kernel's N1-point DFT of each row of u [M, N1]
    (N1 = A·B of ``_FOURSTEP_REG``): with j = B·m1 + m2 and k = ka + A·kb,
    the A-point butterflies over m1 for each m2 (``_dft_small``), output ka
    times ``fft_twiddles(N1)[m2·ka]``, the B-point butterflies over m2 for
    each ka."""
    n1 = u.shape[-1]
    a, b = _FOURSTEP_REG[n1]
    tw = fft_twiddles(n1, sign, u.device)
    v = list(u.unbind(1))
    for m2 in range(b):
        out = _dft_small([v[b * m1 + m2] for m1 in range(a)], sign)
        for ka in range(a):
            v[b * ka + m2] = out[ka] if m2 * ka == 0 else out[ka] * tw[m2 * ka]
    y = [None] * n1
    for ka in range(a):
        for kb, w in enumerate(_dft_small(v[b * ka:b * ka + b], sign)):
            y[ka + a * kb] = w
    return torch.stack(y, 1)


def dft_fourstep_ref(x: torch.Tensor, sign: int = -1,
                     scale: float = 1.0) -> torch.Tensor:
    """The four-step kernel's arithmetic in plain PyTorch: x [..., n]
    complex, n a size the four-step route takes -> complex64 [..., n].

    With (N1, N2) = ``_fourstep_split(n)``, j = N2·j1 + j2 and k = k1 +
    N1·k2: launch 1's N1-point DFTs down the columns j2 (``_dft_regs``, the
    register kernel's two factors, for an N1 of ``_FOURSTEP_REG``, else
    ``dft_mixed_ref``, the mixed kernel's passes and table), X1[k1, j2] times
    ``fourstep_twiddles`` (exp(sign·2πi·j2·k1/n), k1 > 0) into the
    workspace Z[k1, j2], launch 2's N2-point DFTs along Z's rows
    (``dft_mixed_ref``), y[k1 + N1·k2] times scale."""
    n = x.shape[-1]
    if not _fits("fourstep", n):
        raise ValueError(f"dft_fourstep_ref: n={n} is not 7-smooth from "
                         f"{RADIX_MIN_N ** 2} to {FOURSTEP_MAX_N} with a "
                         f"split n = N1·N2, both from {RADIX_MIN_N} to "
                         f"{RADIX_MAX_N}")
    n1, n2 = _fourstep_split(n)
    data = _rows(x).to(torch.complex64)
    m = data.shape[0]
    cols = data.reshape(m, n1, n2).transpose(1, 2).reshape(m * n2, n1)
    col_fft = _dft_regs if n1 in _FOURSTEP_REG else dft_mixed_ref
    x1 = col_fft(cols, sign).reshape(m, n2, n1).transpose(1, 2)
    tw = fourstep_twiddles(n, n1, sign, x.device).reshape(n1 - 1, n2)
    z = torch.cat([x1[:, :1], x1[:, 1:] * tw], 1)          # [m, k1, j2]
    y = dft_mixed_ref(z.reshape(m * n1, n2), sign).reshape(m, n1, n2)
    return (y.transpose(1, 2).reshape(m, n) * scale).reshape(x.shape)


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


def _filter_np(n: int, m: int, sign: int) -> np.ndarray:
    """The m-point forward spectrum of the filter h (h_l = conj(c_l) for
    l < n, h_{m-l} = conj(c_l) for 0 < l < n, zero between), computed in
    float64 with numpy and rounded once to complex64."""
    h = np.zeros(m, np.complex128)
    c = _chirp_np(n, sign).conj()
    h[:n] = c
    h[m - n + 1:] = c[1:][::-1]
    return np.fft.fft(h).astype(np.complex64)


@graphs.device_cache(maxsize=16)
def bluestein_filter(n: int, sign: int, device: torch.device) -> torch.Tensor:
    """``_filter_np`` at the Bluestein route's m, on ``device``; cached."""
    return torch.from_numpy(_filter_np(n, _bluestein_m(n), sign)).to(device)


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


@functools.cache
def _chirp_m(n: int) -> int:
    """The chirp route's FFT length: the least 7-smooth m >= 2n - 1 that
    the radix, mixed, cluster or four-step route takes (4099 -> 8232 on the
    cluster route, 131071 -> 262144 on the four-step one)."""
    if not _fits("chirp", n):
        raise ValueError(f"dft: the chirp route does not take n={n}")
    cands = _smooth_upto(FOURSTEP_MAX_N)
    start = next(i for i, v in enumerate(cands) if v >= 2 * n - 1)
    return next(v for v in cands[start:]
                if _route(v) in ("radix", "mixed", "cluster", "fourstep"))


@graphs.device_cache(maxsize=16)
def chirp_filter(n: int, sign: int, device: torch.device) -> torch.Tensor:
    """``_filter_np`` at the chirp route's m (``_chirp_m``), complex64 [m]
    on ``device``; cached."""
    return torch.from_numpy(_filter_np(n, _chirp_m(n), sign)).to(device)


def dft_chirp_ref(x: torch.Tensor, sign: int = -1,
                  scale: float = 1.0) -> torch.Tensor:
    """The chirp route's arithmetic in plain PyTorch: x [..., n] complex,
    n from 4097 to 2^25 -> complex64 [..., n].

    Bluestein's algorithm as ``dft_bluestein_ref``, its m-point FFTs
    (m = ``_chirp_m(n)``) on the plain version of m's route: x·c
    zero-padded to m points, its forward FFT times the filter's spectrum
    (``chirp_filter``), the backward FFT, and the first n points times c
    and scale/m."""
    n = x.shape[-1]
    if not _fits("chirp", n):
        raise ValueError(f"dft_chirp_ref: n={n} is not from "
                         f"{BLUESTEIN_MAX_N + 1} to {CHIRP_MAX_N}")
    m = _chirp_m(n)
    fft_m = _PLAIN[_route(m)]
    c = bluestein_chirp(n, sign, x.device)
    data = _rows(x).to(torch.complex64)
    a = torch.zeros((data.shape[0], m), dtype=torch.complex64,
                    device=x.device)
    a[:, :n] = data * c
    spectrum = fft_m(a, -1) * chirp_filter(n, sign, x.device)
    z = fft_m(spectrum, +1)
    return (z[:, :n] * c * _post_scale(scale, m)).reshape(x.shape)


def _post_scale(scale: float, m: int) -> float:
    """scale/m as the kernel takes it: one float32."""
    return float(np.float32(scale / m))


# each FFT route's plain version
_PLAIN = {"radix": dft_radix_ref, "mixed": dft_mixed_ref,
          "cluster": dft_cluster_ref, "fourstep": dft_fourstep_ref,
          "bluestein": dft_bluestein_ref, "chirp": dft_chirp_ref}


# ------------------------------------------------------------ the kernels


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _kernels.library("dft")
    vp, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_float
    ull = ctypes.c_ulonglong
    for name, args in (
            ("c_ofdm_dft", [vp, ll, vp, vp, vp, ll, ll, vp]),
            ("c_ofdm_fft", [vp, ll, vp, vp, ll, ll, i, f, vp]),
            ("c_ofdm_mixed_fft", [vp, ll, vp, vp, ll, ll, ull, i, i, f, vp]),
            ("c_ofdm_bluestein", [vp, ll, vp, vp, vp, vp, vp, ll, ll, ll, f,
                                  vp]),
            ("c_ofdm_cluster_fft", [vp, ll, vp, vp, vp, ll, i, ll, ull, i, i,
                                    f, vp]),
            ("c_ofdm_fourstep_fft", [vp, ll, vp, vp, vp, vp, vp, vp, ll, ll,
                                     ll, i, i, ull, i, ull, i, i, f, vp]),
            ("c_ofdm_chirp_pre", [vp, ll, vp, vp, ll, ll, ll, vp]),
            ("c_ofdm_chirp_product", [vp, vp, ll, ll, vp]),
            ("c_ofdm_chirp_post", [vp, vp, vp, ll, ll, ll, f, vp]),
            ("c_ofdm_fft_prepare", [ll]),
            ("c_ofdm_mixed_prepare", []),
            ("c_ofdm_cluster_prepare", [i, ll, ull, i, ctypes.POINTER(i)]),
            ("c_ofdm_fourstep_prepare", [ll, ll, i, i, ull, i, ull, i]),
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


def _fail(what: str, rc: int) -> RuntimeError:
    msg = _lib().c_ofdm_dft_error_string(rc).decode()
    return RuntimeError(f"dft {what} failed: {msg}")


@functools.cache
def _prepare(route: str, device_index: int, *size: int) -> int | None:
    """A kernel's once-per-(process, device, size) set-up, its dynamic
    shared memory limit (``c_ofdm_*_prepare``): the radix kernel of n, the
    mixed kernel (no size), the cluster kernel of (c, L), which also checks
    that one of its clusters fits on the device and returns how many fit at
    once (``cudaOccupancyMaxActiveClusters``), the four-step kernels of
    (N1, N2, cols, group), which refuse a block that does not fit, the
    Bluestein kernel of m.  Runs at the first launch on the device, which is
    never inside a CUDA-graph capture: the captured call's warm-up launches
    first (``utils/graphs.py``).  A refused set-up raises RuntimeError."""
    lib = _lib()
    fits = None
    with torch.cuda.device(device_index):
        if route == "cluster":
            c, L = size
            fits = ctypes.c_int(0)
            rc = lib.c_ofdm_cluster_prepare(c, L, *_plan_word(L),
                                            ctypes.byref(fits))
            fits = fits.value
        elif route == "fourstep":
            n1, n2, cols, group = size
            rc = lib.c_ofdm_fourstep_prepare(n1, n2, cols, group,
                                             *_plan_word(n1),
                                             *_plan_word(n2))
        else:
            rc = {"radix": lambda: lib.c_ofdm_fft_prepare(*size),
                  "mixed": lib.c_ofdm_mixed_prepare,
                  "bluestein": lambda: lib.c_ofdm_bluestein_prepare(*size)
                  }[route]()
    if rc != 0:
        raise _fail(f"{route} kernel set-up for size {size}", rc)
    return fits


def _fourstep(x2: torch.Tensor, out: torch.Tensor, sign: int, scale: float,
              stream: int, post: torch.Tensor | None) -> int:
    """The four-step route's two launches on x2 [rows, n] into out, at
    ``_fourstep_split(n)`` and ``_fourstep_shape``, through a workspace
    from ``torch.empty`` (so from the graph's pool under a capture);
    ``post`` [n], where given, multiplies launch 2's stores.  Returns the C
    return code."""
    n = x2.shape[-1]
    n1, n2 = _fourstep_split(n)
    cols, group = _fourstep_shape(n1, n2)
    dev = x2.device
    _prepare("fourstep", dev.index, n1, n2, cols, group)
    z = torch.empty(out.shape, dtype=torch.complex64, device=dev)
    tw1 = (fft_twiddles if cols == 0 else mixed_twiddles)(n1, sign, dev)
    return _lib().c_ofdm_fourstep_fft(
        x2.data_ptr(), x2.stride(0), tw1.data_ptr(),
        fourstep_twiddles(n, n1, sign, dev).data_ptr(),
        mixed_twiddles(n2, sign, dev).data_ptr(),
        None if post is None else post.data_ptr(), z.data_ptr(),
        out.data_ptr(), x2.shape[0], n1, n2, cols, group, *_plan_word(n1),
        *_plan_word(n2), sign, float(scale), stream)


def _count(route: str, launches: int) -> None:
    """Adds CUDA launches of the kernels of ``route``, once made, to
    ``dft.launches`` and ``dft.<route>_launches``."""
    dft.launches += launches
    setattr(dft, f"{route}_launches",
            getattr(dft, f"{route}_launches") + launches)


def _fft_into(x2: torch.Tensor, out: torch.Tensor, sign: int, scale: float,
              route: str, stream: int,
              post: torch.Tensor | None = None) -> None:
    """One transform of x2 [rows, n] (row stride x2.stride(0), unit column
    stride) into out [rows, n] on the kernels of ``route`` (any but chirp;
    ``post`` the four-step's fused product), its launches counted; a
    failed launch raises."""
    n = x2.shape[-1]
    lib = _lib()
    dev = x2.device
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
            x2.shape[0], c, L, *_plan_word(L), sign, float(scale), stream)
    elif route == "fourstep":
        rc = _fourstep(x2, out, sign, scale, stream, post)
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
        raise _fail(f"{route} kernel launch (rows={x2.shape[0]}, n={n})", rc)
    _count(route, 2 if route == "fourstep" else 1)


def _chirp(x2: torch.Tensor, out: torch.Tensor, sign: int, scale: float,
           stream: int) -> None:
    """The chirp route on x2 [rows, n] into out: (1) x·c zero-padded to m
    points (``c_ofdm_chirp_pre``); (2) the forward m-point FFT on m's route
    kernel; (3) the product with the filter's spectrum, fused into launch
    2's stores where m is on the four-step route, else
    ``c_ofdm_chirp_product`` in place; (4) the backward m-point FFT; (5) the
    first n points times c and scale/m (``c_ofdm_chirp_post``).  Two
    [rows, m] buffers from ``torch.empty``; steps 1, 3 and 5 count on the
    chirp route, the FFTs on m's route; a failed step raises."""
    n = x2.shape[-1]
    rows = x2.shape[0]
    m = _chirp_m(n)
    inner = _route(m)
    dev = x2.device
    lib = _lib()
    c = bluestein_chirp(n, sign, dev)
    h = chirp_filter(n, sign, dev)
    a = torch.empty((rows, m), dtype=torch.complex64, device=dev)
    f = torch.empty_like(a)

    def own(what: str, rc: int) -> None:
        if rc != 0:
            raise _fail(f"chirp route's {what} (rows={rows}, n={n}, m={m})",
                        rc)
        _count("chirp", 1)

    own("chirp product", lib.c_ofdm_chirp_pre(
        x2.data_ptr(), x2.stride(0), c.data_ptr(), a.data_ptr(), rows, n, m,
        stream))
    fused = inner == "fourstep"
    _fft_into(a, f, -1, 1.0, inner, stream, post=h if fused else None)
    if not fused:
        own("filter product", lib.c_ofdm_chirp_product(
            f.data_ptr(), h.data_ptr(), rows, m, stream))
    _fft_into(f, a, +1, 1.0, inner, stream)
    own("chirp and scale", lib.c_ofdm_chirp_post(
        a.data_ptr(), c.data_ptr(), out.data_ptr(), rows, n, m,
        _post_scale(scale, m), stream))


def _launch(x: torch.Tensor, sign: int, scale: float,
            route: str) -> torch.Tensor:
    """One transform on the kernels of ``route`` of CUDA complex64 x
    [..., n], each launch counted; ValueError, before anything runs, where
    that route does not take n."""
    n = x.shape[-1]
    if not _fits(route, n):
        raise ValueError(f"dft: the {route} route does not take n={n}")
    x2 = _rows(x.resolve_conj())
    if x2.stride(1) != 1:
        x2 = x2.contiguous()
    out = torch.empty(x2.shape, dtype=torch.complex64, device=x.device)
    if out.numel() == 0:
        return out.reshape(x.shape)
    dev = x.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "chirp":
            _chirp(x2, out, sign, scale, stream)
        else:
            _fft_into(x2, out, sign, scale, route, stream)
    return out.reshape(x.shape)


def dft(x: torch.Tensor, sign: int = -1, scale: float = 1.0) -> torch.Tensor:
    """K4: x [..., n] -> y [..., n] with y = scale · x · W along the last
    axis (sign -1: FFTW forward, +1: FFTW backward).

    ValueError, before anything is built, for an n that no route takes
    (``_route``: past 2^25).  CUDA complex64 tensors: the kernels of the
    route ``_route(n)`` names, on the current stream (no synchronise), each
    launch adding one to ``dft.launches`` and to the counter of its
    kernel's route, ``dft.<route>_launches``.  Rows may be
    strided (a view such as ``sig.reshape(B, S, L)[..., cp:]`` is read in
    place); the last axis must have stride 1 or is copied.  CPU tensors:
    the plain version of the cluster, four-step and chirp routes at their
    sizes, else ``dft_ref``."""
    n = x.shape[-1]
    route = _route(n)
    if route is None:
        raise ValueError(f"dft: no route takes n={n} (at most 2^25 points, "
                         f"or a 7-smooth n up to {FOURSTEP_MAX_N} that "
                         f"splits as N1·N2, both from {RADIX_MIN_N} to "
                         f"{RADIX_MAX_N})")
    if x.device.type == "cpu":
        plain = {"cluster": dft_cluster_ref, "fourstep": dft_fourstep_ref,
                 "chirp": dft_chirp_ref}.get(route, dft_ref)
        return plain(x, sign, scale)
    if x.device.type != "cuda":
        raise ValueError(f"dft: no kernel for device {x.device}")
    if x.dtype != torch.complex64:
        raise TypeError(f"dft: the kernel takes complex64, got {x.dtype}")
    return _launch(x, sign, scale, _forced or route)


dft.launches = 0
for _r in ROUTES:
    setattr(dft, f"{_r}_launches", 0)
del _r
graphs.counted(dft)
