"""K1, K2, K3: window extraction at data-dependent starts.

Counterparts of ``c_ofdm_tpu/ops/pallas_extract.py`` (the Pallas TPU kernels
``_extract_kernel`` and ``_single_kernel``, the latter also behind the flat
multi-ring caller ``_extract_multi_call``):

* ``extract_windows``        (K1) captures [B, n], starts [B]    -> [B, win]
* ``extract_windows_single`` (K2) ring [n],        starts [K]    -> [K, win]
* ``extract_windows_multi``  (K3) rings [C, n],    starts [C, K] -> [C, K, win]

K1 gathers the batch receiver's frame windows; K2 and K3 gather the
streaming receiver's candidate search regions and frame windows out of one
ring or out of C channel rings.  On a CUDA tensor each wrapper launches the
hand-written Hopper kernel ``csrc/extract_windows.cu`` (one template for all
three) and adds one to its own ``launches`` count; on a CPU tensor it runs
its plain PyTorch version (``*_ref``).  Starts follow ``lax.dynamic_slice``
in both: a negative start counts from the end once (s + n), then the start
is clamped to [0, n - win].
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _kernels

_ELEM_BYTES = {torch.complex64: 8, torch.complex128: 16}


def _slice_starts(starts: torch.Tensor, n: int, win: int) -> torch.Tensor:
    """The start ``lax.dynamic_slice`` reads from: s < 0 -> s + n, then
    clamped to [0, n - win]."""
    s = starts.to(torch.int64)
    s = torch.where(s < 0, s + n, s)
    return torch.clamp(s, 0, n - win)


def extract_windows_ref(captures: torch.Tensor, starts: torch.Tensor,
                        win: int) -> torch.Tensor:
    """Plain version of K1: captures [B, n], starts [B] -> windows [B, win]
    with out[b, j] = captures[b, s_b + j]."""
    n = captures.shape[-1]
    idx = (_slice_starts(starts, n, win)[:, None]
           + torch.arange(win, device=captures.device))
    return torch.gather(captures, 1, idx)


def extract_windows_single_ref(ring: torch.Tensor, starts: torch.Tensor,
                               win: int) -> torch.Tensor:
    """Plain version of K2: ring [n], starts [K] -> windows [K, win] with
    out[k, j] = ring[s_k + j]."""
    n = ring.shape[-1]
    idx = (_slice_starts(starts, n, win)[:, None]
           + torch.arange(win, device=ring.device))
    return torch.gather(ring.expand(idx.shape[0], n), 1, idx)


def extract_windows_multi_ref(rings: torch.Tensor, starts: torch.Tensor,
                              win: int) -> torch.Tensor:
    """Plain version of K3: rings [C, n], starts [C, K] -> windows
    [C, K, win] with out[c, k, j] = rings[c, s_ck + j]."""
    C, n = rings.shape
    idx = (_slice_starts(starts, n, win)[..., None]
           + torch.arange(win, device=rings.device))
    return torch.gather(rings[:, None, :].expand(C, idx.shape[1], n), 2, idx)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _kernels.library("extract_windows")
    fn = lib.c_ofdm_extract_windows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.c_ofdm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.c_ofdm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_common(name: str, x: torch.Tensor, starts: torch.Tensor,
                  win: int) -> None:
    if x.dtype not in _ELEM_BYTES:
        raise TypeError(f"{name}: input must be complex64 or complex128, "
                        f"got {x.dtype}")
    if starts.dtype != torch.int32:
        raise TypeError(f"{name}: starts must be int32, got {starts.dtype}")
    if starts.device != x.device:
        raise ValueError(f"{name}: starts on {starts.device}, input on "
                         f"{x.device}")
    if not (x.is_contiguous() and starts.is_contiguous()):
        raise ValueError(f"{name}: input and starts must be contiguous")
    if not 0 < win <= x.shape[-1]:
        raise ValueError(f"{name}: win={win} must be in (0, n={x.shape[-1]}]")


def _check_cuda_args(captures: torch.Tensor, starts: torch.Tensor,
                     win: int) -> None:
    if captures.dim() != 2 or starts.dim() != 1:
        raise ValueError(f"extract_windows: need captures [B, n] and starts "
                         f"[B], got {tuple(captures.shape)} and "
                         f"{tuple(starts.shape)}")
    if starts.shape[0] != captures.shape[0]:
        raise ValueError(f"extract_windows: {starts.shape[0]} starts for "
                         f"{captures.shape[0]} rows")
    _check_common("extract_windows", captures, starts, win)


def _check_single_args(ring: torch.Tensor, starts: torch.Tensor,
                       win: int) -> None:
    if ring.dim() != 1 or starts.dim() != 1:
        raise ValueError(f"extract_windows_single: need ring [n] and starts "
                         f"[K], got {tuple(ring.shape)} and "
                         f"{tuple(starts.shape)}")
    _check_common("extract_windows_single", ring, starts, win)


def _check_multi_args(rings: torch.Tensor, starts: torch.Tensor,
                      win: int) -> None:
    if rings.dim() != 2 or starts.dim() != 2:
        raise ValueError(f"extract_windows_multi: need rings [C, n] and "
                         f"starts [C, K], got {tuple(rings.shape)} and "
                         f"{tuple(starts.shape)}")
    if starts.shape[0] != rings.shape[0]:
        raise ValueError(f"extract_windows_multi: starts for "
                         f"{starts.shape[0]} rings, got {rings.shape[0]} "
                         f"rings")
    _check_common("extract_windows_multi", rings, starts, win)


def _device_of(name: str, x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return x.device.type


def _launch(name: str, x: torch.Tensor, starts: torch.Tensor,
            out: torch.Tensor, rows: int, per_row: int, win: int) -> None:
    """One launch of the shared kernel on the current stream (no
    synchronise); raises if the launch was refused."""
    n = x.shape[-1]
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.c_ofdm_extract_windows(
            x.data_ptr(), starts.data_ptr(), out.data_ptr(), rows, per_row,
            n, win, _ELEM_BYTES[x.dtype], stream)
    if rc != 0:
        msg = lib.c_ofdm_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} "
                           f"(rows={rows}, windows per row={per_row}, "
                           f"n={n}, win={win})")


def extract_windows(captures: torch.Tensor, starts: torch.Tensor,
                    win: int) -> torch.Tensor:
    """K1: captures [B, n] complex, starts [B] int32 -> windows [B, win].

    CUDA tensors: launches the kernel on the current stream (no synchronise)
    and adds one to ``extract_windows.launches``.  CPU tensors:
    ``extract_windows_ref``.
    """
    if _device_of("extract_windows", captures) == "cpu":
        return extract_windows_ref(captures, starts, win)
    _check_cuda_args(captures, starts, win)
    B = captures.shape[0]
    out = torch.empty((B, win), dtype=captures.dtype, device=captures.device)
    if B == 0:
        return out
    _launch("extract_windows", captures, starts, out, B, 1, win)
    extract_windows.launches += 1
    return out


def extract_windows_single(ring: torch.Tensor, starts: torch.Tensor,
                           win: int) -> torch.Tensor:
    """K2: ring [n] complex, starts [K] int32 -> windows [K, win].

    CUDA tensors: launches the kernel and adds one to
    ``extract_windows_single.launches``.  CPU tensors:
    ``extract_windows_single_ref``.
    """
    if _device_of("extract_windows_single", ring) == "cpu":
        return extract_windows_single_ref(ring, starts, win)
    _check_single_args(ring, starts, win)
    K = starts.shape[0]
    out = torch.empty((K, win), dtype=ring.dtype, device=ring.device)
    if K == 0:
        return out
    _launch("extract_windows_single", ring, starts, out, 1, K, win)
    extract_windows_single.launches += 1
    return out


def extract_windows_multi(rings: torch.Tensor, starts: torch.Tensor,
                          win: int) -> torch.Tensor:
    """K3: rings [C, n] complex, starts [C, K] int32 -> windows [C, K, win],
    read from the rings in place (no flat copy, no chunking).

    CUDA tensors: launches the kernel and adds one to
    ``extract_windows_multi.launches``.  CPU tensors:
    ``extract_windows_multi_ref``.
    """
    if _device_of("extract_windows_multi", rings) == "cpu":
        return extract_windows_multi_ref(rings, starts, win)
    _check_multi_args(rings, starts, win)
    C, K = starts.shape
    out = torch.empty((C, K, win), dtype=rings.dtype, device=rings.device)
    if C == 0 or K == 0:
        return out
    _launch("extract_windows_multi", rings, starts, out, C, K, win)
    extract_windows_multi.launches += 1
    return out


extract_windows.launches = 0
extract_windows_single.launches = 0
extract_windows_multi.launches = 0
