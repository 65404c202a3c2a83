"""Receive chain: capture IQ -> synchronized, corrected, demodulated bytes
(counterpart of ``c_ofdm_tpu/models/rx.py``, the batch receiver).

Mirrors the canonical demod recipe of `main.cpp:46-82` / `rx.cpp:158-221`:
t2sin coarse detect -> preamble fine timing -> coarse pilot CFO -> derotate ->
per-symbol CP CFO -> common phase -> linear-phase channel est -> partial DFT +
pilot equalization -> hard demap.  Sync is written out over a leading batch
axis; the frame windows are gathered by K1 (``ops.extract``), and the
streaming receiver's ring windows by K2 (one ring) and K3 (C rings).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..io import trace
from ..ops import cfo, chanest, extract, modulation, sync
from ..utils import graphs
from .frame import FrameSpec


class RxResult(NamedTuple):
    mac_bytes: torch.Tensor       # uint8 [..., frame_bytes]
    constellation: torch.Tensor   # [..., nsym*num_data_subc]
    chan_est: torch.Tensor        # [..., num_data_subc]
    cfo: torch.Tensor             # [...] coarse CFO estimate (cycles/sample)


class SyncResult(NamedTuple):
    frame_start: torch.Tensor   # [B] start of the frame (t2sin burst) in the capture
    t2_begin: torch.Tensor      # [B] first detected t2 block (or -1)
    pr_begin: torch.Tensor      # [B] preamble position (+1 applied, reference quirk)
    found: torch.Tensor         # [B] bool


def demod_sig(spec: FrameSpec, sig: torch.Tensor,
              estimator: str = "lq") -> RxResult:
    """Demodulate the post-burst span [..., preamble_len + message_len]
    (preamble at offset 0) whose exact start is known.  All preamble+message
    symbols go through ONE partial-DFT product, then pilot equalization runs
    per group (the preamble group and the message group).  Marks the
    recover, dft and equalize stages (``io/trace.py``)."""
    cfg = spec.cfg
    trace.mark("recover", sig)
    sig, shift = cfo.recover_fused(spec, sig)
    lead = sig.shape[:-1]
    nsym_all = cfg.num_pr_symb + cfg.num_symb
    syms = sig.reshape(*lead, nsym_all, cfg.ofdm_len)[..., cfg.cp_size:]
    trace.mark("dft", sig)
    pil, data = chanest.bins_transform(spec, syms)
    trace.mark("equalize", sig)
    P = cfg.num_pr_symb
    pre_pts = chanest.pilot_equalize(spec, pil[..., :P, :], data[..., :P, :])
    const = chanest.pilot_equalize(spec, pil[..., P:, :], data[..., P:, :])
    if estimator == "lq":
        chan = chanest.chan_est_lq(spec, pre_points=pre_pts)
    elif estimator == "full":
        chan = chanest.chan_est_full(spec, pre_points=pre_pts)
    else:
        raise ValueError(f"estimator must be 'lq' or 'full', got {estimator!r}")
    const = chanest.equalize(spec, const, chan)
    mac_bytes = modulation.demap_bytes(const, cfg.mod_type)
    return RxResult(mac_bytes, const, chan, shift)


def demod_frame(spec: FrameSpec, frame_sig: torch.Tensor,
                estimator: str = "lq") -> RxResult:
    """Demodulate frames whose exact start is known.
    frame_sig [..., frame_len] with the t2sin burst at offset 0."""
    return demod_sig(spec, frame_sig[..., spec.cfg.t2sin_size:], estimator)


def demod_frames(spec: FrameSpec, frames: torch.Tensor,
                 estimator: str = "lq") -> RxResult:
    """``demod_frame`` over a batch of frames [..., frame_len]: the eager
    body of ``demod_frames_jit`` (the entry ``apps/ber_sweep.py`` calls)."""
    return demod_frame(spec, frames, estimator)


def synchronize(spec: FrameSpec, captures: torch.Tensor,
                start=0) -> SyncResult:
    """Single-frame sync of every row of captures [B, n], per `main.cpp:50-58`:
    coarse detect from ``start`` (an int, or a [B] tensor of per-row starts),
    preamble search in the following sync window, +1 empirical offset —
    replaced by the local correlation peak when the config's ``peak_refine``
    is in effect."""
    cfg = spec.cfg
    t2_begin, t2_found = sync.find_t2sin(spec, captures, start)
    pr_start = torch.clamp(t2_begin, min=0)
    find = sync.find_preamble_peak if cfg.peak_refine else sync.find_preamble
    if isinstance(start, int) and start % cfg.t2sin_size == 0:
        pr, pr_found = find(spec, captures, pr_start)
    else:
        # from a start off the block grid, the JAX package reads the
        # preamble window from the t2 block that holds the detection but
        # counts lags from the detection itself (sync.aligned_window): the
        # positions come out late by the detection's offset into its block
        late = pr_start % cfg.t2sin_size
        pr, pr_found = find(spec, captures, pr_start - late)
        pr = torch.where(pr_found, pr + late, pr)
    if cfg.peak_refine:
        pr_begin = torch.where(pr_found, pr, pr + 1)  # not-found: -9 contract
    else:
        pr_begin = pr + 1
    found = t2_found & pr_found
    frame_start = torch.where(found, pr_begin - cfg.t2sin_size, 0)
    frame_start = torch.clamp(frame_start, min=0)
    return SyncResult(frame_start, t2_begin, pr_begin, found)


def _dynamic_slice(capture: torch.Tensor, start, length: int) -> torch.Tensor:
    """``lax.dynamic_slice_in_dim`` along the last axis: ``length`` samples
    from ``start`` (an int or a 0-d integer tensor); a negative start counts
    from the end once, then the start is clamped to [0, n - length], so the
    window always lies inside the capture."""
    n = capture.shape[-1]
    if isinstance(start, int):
        s = min(max(start + n if start < 0 else start, 0), n - length)
        return capture[..., s:s + length]
    s = extract._slice_starts(start.to(capture.device), n, length)
    return capture[..., s + torch.arange(length, device=capture.device)]


def extract_frame(spec: FrameSpec, capture: torch.Tensor,
                  frame_start) -> torch.Tensor:
    """One frame window [frame_len] of one capture [n] at ``frame_start``,
    clamped as ``lax.dynamic_slice`` clamps."""
    return _dynamic_slice(capture, frame_start, spec.cfg.frame_len)


def extract_sig(spec: FrameSpec, capture: torch.Tensor,
                frame_start) -> torch.Tensor:
    """The post-burst span [preamble_len + message_len] of the frame at
    ``frame_start`` in one capture [n] (demod never reads the t2sin burst),
    clamped as ``lax.dynamic_slice`` clamps."""
    cfg = spec.cfg
    return _dynamic_slice(capture, frame_start + cfg.t2sin_size,
                          cfg.preamble_len + cfg.message_len)


def _sig_starts(spec: FrameSpec, n: int, frame_starts: torch.Tensor):
    """(starts of the post-burst span clamped to [0, n - sig], in the index
    type of ``frame_starts``; sig)."""
    cfg = spec.cfg
    ln = cfg.preamble_len + cfg.message_len
    return torch.clamp(frame_starts + cfg.t2sin_size, 0, n - ln), ln


def extract_sigs_rows(spec: FrameSpec, captures: torch.Tensor,
                      frame_starts: torch.Tensor) -> torch.Tensor:
    """The post-burst span [preamble_len + message_len] of each row's frame:
    captures [B, n], frame_starts [B] -> [B, sig], starts clamped to
    [0, n - sig] (K1 on CUDA tensors)."""
    starts, ln = _sig_starts(spec, captures.shape[-1], frame_starts)
    return extract.extract_windows(captures, starts, ln)


def extract_sigs_single(spec: FrameSpec, capture: torch.Tensor,
                        frame_starts: torch.Tensor) -> torch.Tensor:
    """K windows out of ONE capture (the streaming-ring gather):
    capture [n], frame_starts [K] -> [K, sig], starts clamped to
    [0, n - sig] (K2 on CUDA tensors)."""
    starts, ln = _sig_starts(spec, capture.shape[-1], frame_starts)
    return extract.extract_windows_single(capture, starts, ln)


def extract_sigs_ring(spec: FrameSpec, ring: torch.Tensor,
                      frame_starts: torch.Tensor) -> torch.Tensor:
    """Streaming-ring gather with an optional channel axis: ring [n] +
    starts [K] -> [K, sig] (K2), or ring [C, n] + starts [C, K] ->
    [C, K, sig] (K3 on CUDA tensors)."""
    if ring.dim() == 1:
        return extract_sigs_single(spec, ring, frame_starts)
    starts, ln = _sig_starts(spec, ring.shape[-1], frame_starts)
    return extract.extract_windows_multi(ring, starts, ln)


def receive_batch(spec: FrameSpec, captures: torch.Tensor,
                  estimator: str = "lq"):
    """Batched single-frame RX: captures [B, n] -> (RxResult, SyncResult).
    RxResult rows are garbage where found is False (mask downstream).
    Marks the sync and extract stages, then ``demod_sig``'s."""
    trace.mark("sync", captures)
    s = synchronize(spec, captures)
    trace.mark("extract", captures)
    sigs = extract_sigs_rows(spec, captures, s.frame_start)
    return demod_sig(spec, sigs, estimator), s


def receive_capture(spec: FrameSpec, capture: torch.Tensor,
                    estimator: str = "lq"):
    """Full single-frame RX on one capture [n]: ``receive_batch`` at B = 1."""
    res, s = receive_batch(spec, capture[None], estimator)
    return (RxResult(*(f[0] for f in res)), SyncResult(*(f[0] for f in s)))


# The JAX package's compiled entry points (``c_ofdm_tpu/models/rx.py``):
# on CUDA tensors each call is one CUDA-graph replay, captured on the first
# call for each (spec, estimator, input shape and dtype, device); on CPU
# tensors the eager function runs (``utils/graphs.py::jit``).  JAX's
# ``receive_batch_jit`` vmaps ``receive_capture`` over the batch; the
# port's is the batch-native ``receive_batch`` (the same results, held
# against each other in tests/test_torch_jit.py).
receive_capture_jit = graphs.jit(receive_capture, static_argnums=(0, 2))
receive_batch_jit = graphs.jit(receive_batch, static_argnums=(0, 2))
demod_frames_jit = graphs.jit(demod_frames, static_argnums=(0, 2))
