"""K4: the dense DFT y = x · W, W[j, k] = scale · exp(sign · 2πi · jk / n).

Counterpart of ``c_ofdm_tpu/ops/pallas_fft.py`` (the Pallas TPU kernel
``_dft_kernel``, public ``dft_pallas``), reached through
``ops.fft.fft_fwd`` / ``ifft_unnorm`` under ``fft_backend="pallas"`` for
complex64 inputs.  On a CUDA complex64 tensor ``dft`` launches the
hand-written Hopper kernel ``csrc/dft.cu`` and adds one to ``dft.launches``;
on a CPU tensor it runs the plain version ``dft_ref`` (4 real float32 GEMMs
on the twiddle planes, as the Pallas kernel computes).  Anything else
raises.  The twiddle planes are built once per (n, sign, scale, device).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _kernels, fft


@functools.lru_cache(maxsize=16)
def dft_planes(n: int, sign: int, scale: float,
               device: torch.device) -> torch.Tensor:
    """(Re W, Im W) as one float32 tensor [2, n, n] on ``device``: the
    twiddles in complex128 times ``scale``, rounded once to float32 (the
    Pallas kernel's ``_dft_planes``); cached."""
    return fft.basis_pair(fft._dft_matrix_np(n, sign) * scale, device,
                          torch.float32)


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


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _kernels.library("dft")
    fn = lib.c_ofdm_dft
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.c_ofdm_dft_error_string.argtypes = [ctypes.c_int]
    lib.c_ofdm_dft_error_string.restype = ctypes.c_char_p
    return lib


def dft(x: torch.Tensor, sign: int = -1, scale: float = 1.0) -> torch.Tensor:
    """K4: x [..., n] -> y [..., n] with y = x · W along the last axis
    (sign -1: FFTW forward, +1: FFTW backward; ``scale`` fused into W).

    CUDA complex64 tensors: one launch on the current stream (no
    synchronise), adding one to ``dft.launches``.  Rows may be strided (a
    view such as ``sig.reshape(B, S, L)[..., cp:]`` is read in place); the
    last axis must have stride 1 or is copied.  CPU tensors: ``dft_ref``.
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
    w = dft_planes(n, sign, float(scale), x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.c_ofdm_dft(x2.data_ptr(), x2.stride(0), w[0].data_ptr(),
                            w[1].data_ptr(), out.data_ptr(), x2.shape[0], n,
                            stream)
    if rc != 0:
        msg = lib.c_ofdm_dft_error_string(rc).decode()
        raise RuntimeError(f"dft kernel launch failed: {msg} "
                           f"(rows={x2.shape[0]}, n={n})")
    dft.launches += 1
    return out.reshape(x.shape)


dft.launches = 0
