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
hand-written Hopper kernel ``csrc/extract_windows.cu`` (one source for all
three) and adds one to its own ``launches`` count and to
``class_launches[name]``; on a CPU tensor it runs its plain PyTorch version
(``*_ref``).  Starts are int32 or int64 and follow ``lax.dynamic_slice`` in
both: a negative start counts from the end once (s + n), then the start is
clamped to [0, n - win].

The kernel has two bodies.  The wide body copies each window as 16-byte
pairs of 8-byte halves, cut per window by ``plan_window`` (mirrored line for
line in the ``.cu``), 4 pairs per thread; the scalar body copies one
element per thread.  ``launch_plan`` picks the class (``scalar`` or
``wide``) and its grid from the shape and the element width alone: small
launches, whose time is the launch and two memory latencies, keep the scalar
body, which measured a few percent faster there; all others take the wide
body.  ``body=`` on a wrapper forces a class, so that the card tests check
both bodies; nothing gives way to another class after a failure.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils import graphs
from . import _kernels

_ELEM_BYTES = {torch.complex64: 8, torch.complex128: 16}
_START_BYTES = {torch.int32: 4, torch.int64: 8}

# The wide body copies WIDE_UNITS 16-byte pairs per thread: 64 bytes in
# flight.  The threshold comes from timing both bodies at the receiver's
# shapes on an H100 (PERF.md, section 6): up to 1 MiB each way (the
# candidate regions of one ring) the scalar body is faster, above it (frame
# windows of one ring and everything larger) the wide body is.
CLASSES = ("scalar", "wide")
WIDE_UNITS = 4
MAX_THREADS = 256
MIN_WIDE_HALVES = 8         # a shorter window (< 64 bytes) is not paired
SCALAR_MAX_PAIRS = 1 << 16  # launches of up to 1 MiB each way stay scalar


class WindowPlan(NamedTuple):
    """How the wide body copies one window of 8-byte halves."""
    head: int      # 0 or 1 half copied alone in front
    pairs: int     # 16-byte units, each stored with one aligned store
    tail: int      # 0 or 1 half copied alone behind
    aligned: bool  # the pairs' source is 16-byte aligned: one load per pair


def plan_window(src_addr: int, dst_addr: int, halves: int) -> WindowPlan:
    """The wide body's cut of one window of ``halves`` 8-byte halves (one per
    complex64 element, two per complex128), from the byte addresses of its
    first source and destination halves (both 8-byte aligned).  The kernel's
    ``plan_window`` repeats this line for line."""
    head = 1 if (dst_addr & 15) != 0 and halves > 0 else 0
    pairs = (halves - head) // 2
    tail = halves - head - 2 * pairs
    aligned = ((src_addr + 8 * head) & 15) == 0
    return WindowPlan(head, pairs, tail, aligned)


class LaunchPlan(NamedTuple):
    """One launch: its class, 16-byte pairs per thread (0: scalar body),
    block size, and tiles (blocks) per window."""
    name: str
    units: int
    threads: int
    tiles: int


def launch_class(windows: int, win: int, elem_bytes: int) -> str:
    """The class a shape runs, from the shape and the element width alone."""
    halves = win * elem_bytes // 8
    pairs = windows * (halves // 2)
    if halves < MIN_WIDE_HALVES or pairs <= SCALAR_MAX_PAIRS:
        return "scalar"
    return "wide"


def launch_plan(windows: int, win: int, elem_bytes: int,
                body: str | None = None) -> LaunchPlan:
    """Class and grid of one launch of ``windows`` windows of ``win``
    elements.  ``body`` names a class to force; by default ``launch_class``
    chooses.  A window gets the fewest tiles a block of ``MAX_THREADS``
    allows and then the smallest block of whole warps that covers it, so no
    tile is more than one warp short."""
    name = body or launch_class(windows, win, elem_bytes)
    if name not in CLASSES:
        raise ValueError(f"body must be one of {CLASSES}, got {body!r}")
    units = WIDE_UNITS if name == "wide" else 0
    # work items of a window: elements (scalar) or 16-byte pairs (wide)
    items = win if units == 0 else max(1, win * elem_bytes // 16)
    per_thread = max(1, units)
    tiles = -(-items // (MAX_THREADS * per_thread))
    threads = 32 * -(-items // (tiles * per_thread * 32))
    return LaunchPlan(name, units, threads, tiles)


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
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.c_ofdm_stage_mark.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.c_ofdm_stage_mark.restype = ctypes.c_int
    lib.c_ofdm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.c_ofdm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_common(name: str, x: torch.Tensor, starts: torch.Tensor,
                  win: int) -> None:
    if x.dtype not in _ELEM_BYTES:
        raise TypeError(f"{name}: input must be complex64 or complex128, "
                        f"got {x.dtype}")
    if starts.dtype not in _START_BYTES:
        raise TypeError(f"{name}: starts must be int32 or int64, got "
                        f"{starts.dtype}")
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


def _launch(fn, x: torch.Tensor, starts: torch.Tensor, out: torch.Tensor,
            rows: int, per_row: int, win: int, body: str | None) -> None:
    """One launch of the shared kernel on the current stream (no
    synchronise) in the class ``launch_plan`` gives, counted on the wrapper
    ``fn``; raises if the launch was refused.  Under a CUDA-graph capture
    the current stream is the capture stream, so the launch is recorded
    into the graph; the kernel's per-window plan (``plan_window``) reads
    the operands' addresses, which a graph fixes (its static inputs and its
    pool), so the captured plan holds on every replay."""
    n = x.shape[-1]
    plan = launch_plan(rows * per_row, win, _ELEM_BYTES[x.dtype], body)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.c_ofdm_extract_windows(
            x.data_ptr(), starts.data_ptr(), out.data_ptr(), rows, per_row,
            n, win, _ELEM_BYTES[x.dtype], _START_BYTES[starts.dtype],
            plan.units, plan.threads, plan.tiles, stream)
    if rc != 0:
        msg = lib.c_ofdm_cuda_error_string(rc).decode()
        raise RuntimeError(f"{fn.__name__} kernel launch failed: {msg} "
                           f"(rows={rows}, windows per row={per_row}, "
                           f"n={n}, win={win}, {plan})")
    fn.launches += 1
    fn.class_launches[plan.name] += 1


def extract_windows(captures: torch.Tensor, starts: torch.Tensor,
                    win: int, *, body: str | None = None) -> torch.Tensor:
    """K1: captures [B, n] complex, starts [B] int32 or int64 -> windows
    [B, win].

    CUDA tensors: launches the kernel on the current stream (no synchronise)
    and adds one to ``extract_windows.launches`` and to its class's entry of
    ``extract_windows.class_launches``.  CPU tensors:
    ``extract_windows_ref``.
    """
    if _device_of("extract_windows", captures) == "cpu":
        return extract_windows_ref(captures, starts, win)
    _check_cuda_args(captures, starts, win)
    B = captures.shape[0]
    out = torch.empty((B, win), dtype=captures.dtype, device=captures.device)
    if B == 0:
        return out
    _launch(extract_windows, captures, starts, out, B, 1, win, body)
    return out


def extract_windows_single(ring: torch.Tensor, starts: torch.Tensor,
                           win: int, *,
                           body: str | None = None) -> torch.Tensor:
    """K2: ring [n] complex, starts [K] int32 or int64 -> windows [K, win].

    CUDA tensors: launches the kernel and adds one to
    ``extract_windows_single.launches`` and to its class's entry of
    ``class_launches``.  CPU tensors: ``extract_windows_single_ref``.
    """
    if _device_of("extract_windows_single", ring) == "cpu":
        return extract_windows_single_ref(ring, starts, win)
    _check_single_args(ring, starts, win)
    K = starts.shape[0]
    out = torch.empty((K, win), dtype=ring.dtype, device=ring.device)
    if K == 0:
        return out
    _launch(extract_windows_single, ring, starts, out, 1, K, win, body)
    return out


def extract_windows_multi(rings: torch.Tensor, starts: torch.Tensor,
                          win: int, *,
                          body: str | None = None) -> torch.Tensor:
    """K3: rings [C, n] complex, starts [C, K] int32 or int64 -> windows
    [C, K, win], read from the rings in place (no flat copy, no chunking).

    CUDA tensors: launches the kernel and adds one to
    ``extract_windows_multi.launches`` and to its class's entry of
    ``class_launches``.  CPU tensors: ``extract_windows_multi_ref``.
    """
    if _device_of("extract_windows_multi", rings) == "cpu":
        return extract_windows_multi_ref(rings, starts, win)
    _check_multi_args(rings, starts, win)
    C, K = starts.shape
    out = torch.empty((C, K, win), dtype=rings.dtype, device=rings.device)
    if C == 0 or K == 0:
        return out
    _launch(extract_windows_multi, rings, starts, out, C, K, win, body)
    return out


def stage_mark(stage: int, device: torch.device) -> None:
    """Start ``stage_mark_kernel<stage>`` (one thread that does nothing)
    on ``device``'s current stream: ``io/trace.py``'s mark of a stage
    boundary in the device timeline.  Counted nowhere."""
    lib = _lib()
    rc = lib.c_ofdm_stage_mark(stage,
                               torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stage mark launch failed: "
                           f"{lib.c_ofdm_cuda_error_string(rc).decode()} "
                           f"(stage={stage})")


for _fn in (extract_windows, extract_windows_single, extract_windows_multi):
    _fn.launches = 0
    _fn.class_launches = dict.fromkeys(CLASSES, 0)
    graphs.counted(_fn)
