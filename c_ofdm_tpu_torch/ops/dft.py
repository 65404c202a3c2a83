"""K4: the DFT y = scale · x · W, W[j, k] = exp(sign · 2πi · jk / n).

Counterpart of ``c_ofdm_tpu/ops/pallas_fft.py`` (the Pallas TPU kernel
``_dft_kernel``, public ``dft_pallas``), reached through
``ops.fft.fft_fwd`` / ``ifft_unnorm`` under ``fft_backend="pallas"`` for
complex64 inputs.  On a CUDA complex64 tensor ``dft`` launches one of two
hand-written Hopper kernels in ``csrc/dft.cu``, chosen by n alone
(``_route``): the radix route, a Stockham FFT with each row in shared
memory, for every power of two from 16 to 8192; the dense route, the complex
GEMM against the n x n twiddle planes, for every other n.  Each launch adds
one to ``dft.launches`` and to ``dft.radix_launches`` or
``dft.dense_launches``.  On a CPU tensor ``dft`` runs the plain version
``dft_ref`` (4 real float32 GEMMs on the twiddle planes, as the Pallas
kernel computes), whatever the route.  Anything else raises.

``dft_radix_ref`` is the radix kernel's arithmetic in plain PyTorch (the
same passes, index maps and float32 twiddle table); the CPU tests hold it
against the float64 DFT and ``dft_pallas`` and the card's tests hold the
kernel against it.  No path of the modem calls it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import _kernels, fft

RADIX_MIN_N = 16      # n / 8 threads per row, 8 points each
RADIX_MAX_N = 8192    # n / 8 = 1024 threads, the most a block can have


def _route(n: int) -> str:
    """"radix" for a power of two from 16 to 8192, else "dense"."""
    if RADIX_MIN_N <= n <= RADIX_MAX_N and n & (n - 1) == 0:
        return "radix"
    return "dense"


@functools.lru_cache(maxsize=16)
def dft_planes(n: int, sign: int, scale: float,
               device: torch.device) -> torch.Tensor:
    """(Re W, Im W) as one float32 tensor [2, n, n] on ``device``: the
    twiddles in complex128 times ``scale``, rounded once to float32 (the
    Pallas kernel's ``_dft_planes``); cached."""
    return fft.basis_pair(fft._dft_matrix_np(n, sign) * scale, device,
                          torch.float32)


@functools.lru_cache(maxsize=16)
def fft_twiddles(n: int, sign: int, device: torch.device) -> torch.Tensor:
    """exp(sign · 2πi · k / n) for k < n, complex64 [n] on ``device``:
    computed in float64 and rounded once; cached."""
    w = np.exp(sign * 2j * np.pi * np.arange(n) / n)
    return torch.from_numpy(w.astype(np.complex64)).to(device)


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


def _radices(n: int) -> list[int]:
    """The radix of each pass: 2^(log2 n mod 3, or 3) first, then 8s."""
    lg = n.bit_length() - 1
    return [1 << (lg % 3 or 3)] + [8] * ((lg - 1) // 3)


def _dft_small(u: list[torch.Tensor], s: int) -> list[torch.Tensor]:
    """The kernel's radix-2/4/8 butterflies on lists of complex tensors:
    y_k = Σ_m u_m · exp(s·2πi·mk/R)."""
    if len(u) == 2:
        return [u[0] + u[1], u[0] - u[1]]
    if len(u) == 4:
        t0, t1 = u[0] + u[2], u[0] - u[2]
        t2, t3 = u[1] + u[3], (u[1] - u[3]) * (s * 1j)
        return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]
    e = _dft_small(u[0::2], s)
    o = _dft_small(u[1::2], s)
    c = math.sqrt(0.5)
    o = [o[0], o[1] * complex(c, s * c), o[2] * (s * 1j),
         o[3] * complex(-c, s * c)]
    return [e[k] + o[k] for k in range(4)] + [e[k] - o[k] for k in range(4)]


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
    if _route(n) != "radix":
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
def _lib() -> ctypes.CDLL:
    lib = _kernels.library("dft")
    fn = lib.c_ofdm_dft
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.c_ofdm_fft
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.c_ofdm_dft_error_string.argtypes = [ctypes.c_int]
    lib.c_ofdm_dft_error_string.restype = ctypes.c_char_p
    return lib


def dft(x: torch.Tensor, sign: int = -1, scale: float = 1.0) -> torch.Tensor:
    """K4: x [..., n] -> y [..., n] with y = scale · x · W along the last
    axis (sign -1: FFTW forward, +1: FFTW backward).

    CUDA complex64 tensors: one launch on the current stream (no
    synchronise) of the kernel ``_route(n)`` names, adding one to
    ``dft.launches`` and to ``dft.radix_launches`` or
    ``dft.dense_launches``.  Rows may be strided (a view such as
    ``sig.reshape(B, S, L)[..., cp:]`` is read in place); the last axis
    must have stride 1 or is copied.  CPU tensors: ``dft_ref``.
    """
    if x.device.type == "cpu":
        return dft_ref(x, sign, scale)
    if x.device.type != "cuda":
        raise ValueError(f"dft: no kernel for device {x.device}")
    if x.dtype != torch.complex64:
        raise TypeError(f"dft: the kernel takes complex64, got {x.dtype}")
    n = x.shape[-1]
    x2 = _rows(x.resolve_conj())
    if x2.stride(1) != 1:
        x2 = x2.contiguous()
    out = torch.empty(x2.shape, dtype=torch.complex64, device=x.device)
    if out.numel() == 0:
        return out.reshape(x.shape)
    route = _route(n)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "radix":
            tw = fft_twiddles(n, sign, x.device)
            rc = lib.c_ofdm_fft(x2.data_ptr(), x2.stride(0), tw.data_ptr(),
                                out.data_ptr(), x2.shape[0], n, sign,
                                float(scale), stream)
        else:
            w = dft_planes(n, sign, float(scale), x.device)
            rc = lib.c_ofdm_dft(x2.data_ptr(), x2.stride(0), w[0].data_ptr(),
                                w[1].data_ptr(), out.data_ptr(), x2.shape[0],
                                n, stream)
    if rc != 0:
        msg = lib.c_ofdm_dft_error_string(rc).decode()
        raise RuntimeError(f"dft {route} kernel launch failed: {msg} "
                           f"(rows={x2.shape[0]}, n={n})")
    dft.launches += 1
    if route == "radix":
        dft.radix_launches += 1
    else:
        dft.dense_launches += 1
    return out.reshape(x.shape)


dft.launches = 0
dft.radix_launches = 0
dft.dense_launches = 0
