"""Batched DFT primitives (counterpart of ``c_ofdm_tpu/ops/fft.py``).

Six interchangeable backends, the JAX package's names:

* ``xla``          — ``torch.fft`` (the JAX package's ``jnp.fft``).
* ``matmul``       — the DFT as 4 real GEMMs against a basis held as a real
  pair ``w[0] = Re W``, ``w[1] = Im W``; also *partial* DFTs (only the bins
  a caller reads).
* ``matmul_bf16``  — the same with the GEMM operands rounded to bfloat16 and
  the products summed in the working real type.
* ``ct``, ``ct_bf16`` — two-stage Cooley-Tukey (``ct_dft``): two small GEMMs
  and a twiddle multiply, for power-of-two sizes (the wideband transform).
* ``pallas``       — complex64 inputs go to K4 (``ops.dft.dft``, the dense
  DFT kernel); complex128 inputs take the ``xla`` branch, as in the JAX
  package.

The GEMMs go to ``torch.matmul``, as the JAX package left them to XLA;
float32 products must run in full float32
(``torch.backends.cuda.matmul.allow_tf32 = False``, set by
``models.frame.make_frame_spec`` for CUDA devices).  Conventions match FFTW:
``fft_fwd`` is the unnormalized forward transform, ``ifft_unnorm`` the
unnormalized backward transform.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import graphs
from . import dft
from .modulation import real_dtype

BACKENDS = ("xla", "matmul", "matmul_bf16", "ct", "ct_bf16", "pallas")
MATMUL_BACKENDS = ("matmul", "matmul_bf16")

# at or above this element count a DFT basis is built on the device
# (``dft_basis``): a float64 host array of the wideband bases is hundreds of MB
DEVICE_BASIS_MIN_ELEMS = 1 << 23
# the device basis computes the phase index r*k mod n in int32
MAX_DEVICE_BASIS_N = 32768


def check_backend(backend: str) -> None:
    """Raise ValueError unless ``backend`` is one of BACKENDS (the JAX
    package falls through to ``jnp.fft`` on an unknown name instead)."""
    if backend not in BACKENDS:
        raise ValueError(f"fft_backend must be one of {BACKENDS}, got "
                         f"{backend!r}")


@functools.lru_cache(maxsize=32)
def _dft_matrix_np(n: int, sign: int) -> np.ndarray:
    k = np.arange(n)
    return np.exp(sign * 2j * np.pi * np.outer(k, k) / n)


def dft_rows(n: int, rows: np.ndarray, sign: int = -1) -> np.ndarray:
    """Selected rows of the (unnormalized) DFT matrix: [len(rows), n]."""
    k = np.arange(n)
    return np.exp(sign * 2j * np.pi * np.outer(np.asarray(rows), k) / n)


def basis_pair(w: np.ndarray, device, dtype: torch.dtype) -> torch.Tensor:
    """Complex numpy matrix [k, m] -> real tensor [2, k, m] (Re, Im) in the
    real ``dtype``, rounded once from float64."""
    return torch.from_numpy(np.stack([w.real, w.imag])).to(device=device,
                                                          dtype=dtype)


def dft_basis(n: int, rows: np.ndarray, sign: int = -1, scale: float = 1.0,
              transpose: bool = False, *, device,
              rdt: torch.dtype) -> torch.Tensor:
    """DFT-basis rows ``scale * W[rows, :]`` as a real pair [2, R, n]
    ([2, n, R] with ``transpose``).  Below DEVICE_BASIS_MIN_ELEMS elements
    the basis is computed in float64 on the host and rounded once to
    ``rdt``; at or above it, on ``device``: the phase index r*k mod n exactly
    in int32, then one cos/sin pass in ``rdt``."""
    rows = np.asarray(rows)
    if n * rows.size < DEVICE_BASIS_MIN_ELEMS:
        w = dft_rows(n, rows, sign) * scale
        return basis_pair(w.T if transpose else w, device, rdt)
    if n > MAX_DEVICE_BASIS_N:
        raise ValueError(f"dft_basis: n={n} > {MAX_DEVICE_BASIS_N} overflows "
                         f"the int32 phase index")
    r = torch.as_tensor(rows % n, dtype=torch.int32, device=device)
    k = torch.arange(n, dtype=torch.int32, device=device)
    ph = torch.remainder(r[:, None] * k[None, :], n).to(rdt)
    ang = ph * torch.tensor(sign * 2 * np.pi / n, dtype=rdt, device=device)
    s = torch.tensor(scale, dtype=rdt, device=device)
    w = torch.stack([torch.cos(ang) * s, torch.sin(ang) * s])
    return w.transpose(1, 2) if transpose else w


def complex_matmul(x: torch.Tensor, w: torch.Tensor,
                   bf16: bool = False) -> torch.Tensor:
    """x [..., k] (complex) @ W [k, m] for W given as the real pair
    ``w`` [2, k, m], as 4 real matrix products -> [..., m] complex.

    ``bf16`` rounds the operands to bfloat16 and multiplies and sums in the
    working real type, as the JAX package's bfloat16 dot with
    ``preferred_element_type`` does (products of bfloat16 values are exact
    in float32)."""
    wr, wi = w[0], w[1]
    xr, xi = x.real, x.imag
    if bf16:
        rdt = xr.dtype
        xr, xi, wr, wi = (t.to(torch.bfloat16).to(rdt)
                          for t in (xr, xi, wr, wi))
    yr = xr @ wr - xi @ wi
    yi = xr @ wi + xi @ wr
    return torch.complex(yr, yi)


@graphs.device_cache(maxsize=32)
def _full_basis(n: int, sign: int, device: torch.device,
                rdt: torch.dtype) -> torch.Tensor:
    return basis_pair(_dft_matrix_np(n, sign), device, rdt)


def _matmul_dft(x: torch.Tensor, sign: int, bf16: bool) -> torch.Tensor:
    return complex_matmul(
        x, _full_basis(x.shape[-1], sign, x.device, x.real.dtype), bf16)


def _ct_factors(n: int) -> tuple:
    """Near-square power-of-two split n = N1 * N2, N1 <= N2."""
    a = n.bit_length() - 1
    if n < 1 or 1 << a != n:
        raise ValueError(f"the ct backends need a power-of-two size, got {n}")
    return 1 << (a // 2), 1 << (a - a // 2)


@graphs.device_cache(maxsize=32)
def _ct_constants(n: int, sign: int, device: torch.device,
                  dtype: torch.dtype):
    """(w1 [2, N1, N1], w2 [2, N2, N2], twiddle [N2, N1] complex) of
    ``ct_dft``, each rounded once from float64."""
    n1, n2 = _ct_factors(n)
    rdt = real_dtype(dtype)
    tw = np.exp(sign * 2j * np.pi * np.outer(np.arange(n2), np.arange(n1))
                / n)
    return (basis_pair(_dft_matrix_np(n1, sign), device, rdt),
            basis_pair(_dft_matrix_np(n2, sign), device, rdt),
            torch.from_numpy(tw).to(device=device, dtype=dtype))


def ct_dft(x: torch.Tensor, sign: int, bf16: bool = False) -> torch.Tensor:
    """Two-stage Cooley-Tukey DFT along the last axis as batched GEMMs.

    n = N1*N2 (8192 = 64*128): with input index n = N2*n1 + n2 and output
    k = k1 + N1*k2,
        A[k1, n2]  = sum_{n1} x[N2 n1 + n2] W_{N1}^{n1 k1}      (GEMM 1)
        B[k1, n2]  = A * W_N^{n2 k1}                            (twiddle)
        X[k1+N1 k2] = sum_{n2} B[k1, n2] W_{N2}^{n2 k2}         (GEMM 2)
    n*(N1 + N2) multiply-adds per transform instead of n^2.  Exact; ``bf16``
    rounds the GEMM operands only, the twiddle multiply runs in full
    precision."""
    n = x.shape[-1]
    n1, n2 = _ct_factors(n)
    lead = x.shape[:-1]
    w1, w2, tw = _ct_constants(n, sign, x.device, x.dtype)
    xv = x.reshape(*lead, n1, n2)
    a = complex_matmul(xv.transpose(-1, -2), w1, bf16)     # [..., n2, k1]
    b = a * tw
    y = complex_matmul(b.transpose(-1, -2), w2, bf16)      # [..., k1, k2]
    # flatten with k2 major: k = N1*k2 + k1
    return y.transpose(-1, -2).reshape(*lead, n)


def fft_fwd(x: torch.Tensor, backend: str = "xla") -> torch.Tensor:
    """Unnormalized forward DFT along the last axis."""
    check_backend(backend)
    if backend in MATMUL_BACKENDS:
        return _matmul_dft(x, -1, backend.endswith("bf16"))
    if backend in ("ct", "ct_bf16"):
        return ct_dft(x, -1, backend.endswith("bf16"))
    if backend == "pallas" and x.dtype == torch.complex64:
        return dft.dft(x, sign=-1)
    return torch.fft.fft(x)


def ifft_unnorm(x: torch.Tensor, backend: str = "xla") -> torch.Tensor:
    """Unnormalized backward DFT (FFTW convention) along the last axis."""
    check_backend(backend)
    if backend in MATMUL_BACKENDS:
        return _matmul_dft(x, +1, backend.endswith("bf16"))
    if backend in ("ct", "ct_bf16"):
        return ct_dft(x, +1, backend.endswith("bf16"))
    if backend == "pallas" and x.dtype == torch.complex64:
        return dft.dft(x, sign=+1)
    return torch.fft.ifft(x) * x.shape[-1]


def partial_dft(x: torch.Tensor, rows: np.ndarray, sign: int = -1) -> torch.Tensor:
    """Project x[..., n] onto selected DFT bins: returns [..., len(rows)].
    The flagship path calls ``complex_matmul`` with the FrameSpec's prebuilt
    bases instead."""
    w = dft_basis(x.shape[-1], rows, sign, transpose=True, device=x.device,
                  rdt=x.real.dtype)
    return complex_matmul(x, w)
