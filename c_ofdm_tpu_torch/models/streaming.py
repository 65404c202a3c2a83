"""Streaming receiver: continuous capture -> stream of decoded frames
(counterpart of ``c_ofdm_tpu/models/streaming.py``).

Reference counterpart: the real-time RX loop (`rx.cpp:94-237`), a serial
pointer walk over a 41-frame ring with carry-over memcpy and early-exit
scans.  Its semantics are kept (one-frame overlap-save carry, each frame
decoded exactly once, in order); the work is restructured.  Production path
(``sync_mode="gated"``):

1. overlapping-window two-tone energy track over the whole ring (skinny
   partial-DFT products) gates up to max_frames + t2_gate_slack candidate
   regions, the reference's cheap-detect-then-correlate order
   (`rx.cpp:133,158`);
2. each candidate's search region is gathered (K2 for one ring, K3 for C
   rings), the banded-Toeplitz matched filter runs over its lags, the advance
   rule (next preamble at least ``message_len`` past the previous,
   `rx.cpp:198`) is closed in parallel, and accepted hits are compacted into
   fixed slots;
3. up to ``max_frames`` frame windows are gathered (K2/K3 again) and
   demodulated in one batch; invalid slots are masked by ``valid``.

The dense fallback (``sync_mode="dense"``, single channel) matched-filters
every ring lag and walks hits greedily (``extract_hits``): detector-
independent, kept for parity testing.  It runs no kernel of the port.

Everything is batch-first: blocks and state may carry a leading [C] axis for
C independent channel streams processed in one step per buffer.  The gated
path has static shapes and no host synchronisation (no ``.item()``, no
``nonzero``, no boolean-mask indexing, no per-call host constants).

State between calls is small: the carry-over halo (one frame length,
`rx.cpp:147-156`) plus scalar cursors, the resumable state the reference
keeps implicitly in ``pos``/ring/counters (`rx.cpp:69,114-124`).  In memory
the carry is complex; ``save_state``/``load_state`` read and write the JAX
package's ``.npz`` layout (carry as [..., frame_len, 2] re/im reals), so a
checkpoint resumes in either package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..ops import extract, sync
from ..utils import graphs
from .frame import FrameSpec
from . import rx as rxm
from . import tx as txm


_COMPLEX_OF = {torch.float32: torch.complex64, torch.float64: torch.complex128}


class StreamState(NamedTuple):
    carry: torch.Tensor         # [..., frame_len] complex tail of the last ring
    carry_valid: torch.Tensor   # [...] bool, False before the first buffer
    next_min_pos: torch.Tensor  # [...] int32 first admissible preamble lag in
    #                             the next ring (no re-detecting carried frames)
    frames_seen: torch.Tensor   # [...] int32 running count of decoded frames


class StreamOut(NamedTuple):
    # every field gains a leading [C] axis under multi-channel operation
    mac_bytes: torch.Tensor     # [max_frames, frame_bytes] uint8
    diag: torch.Tensor          # [max_frames, nsym*ndata] re+im soft metric
    positions: torch.Tensor     # [max_frames] int32 preamble positions in the ring
    valid: torch.Tensor         # [max_frames] bool
    num_found: torch.Tensor     # [] int32
    cfo: torch.Tensor           # [max_frames]


def init_state(spec: FrameSpec, dtype=None, channels: int = 0) -> StreamState:
    """``channels`` 0 = a single stream (scalar state); C > 0 = C independent
    channel streams (leading axis [C] on every state field and on the blocks
    fed to ``process_buffer``).  The carry is complex, of ``dtype`` (default
    the spec's; a real dtype names its complex counterpart, as the JAX
    package's re/im carry does).  The state lies on the spec's device."""
    dtype = _COMPLEX_OF.get(dtype, dtype) or spec.dtype
    lead = (channels,) if channels else ()
    dev = spec.device
    return StreamState(
        carry=torch.zeros((*lead, spec.cfg.frame_len), dtype=dtype,
                          device=dev),
        carry_valid=torch.zeros(lead, dtype=torch.bool, device=dev),
        next_min_pos=torch.zeros(lead, dtype=torch.int32, device=dev),
        frames_seen=torch.zeros(lead, dtype=torch.int32, device=dev),
    )


def dense_preamble_corr(spec: FrameSpec, ring: torch.Tensor) -> torch.Tensor:
    """Normalized matched-filter score at every lag of ``ring`` [..., n]
    (see ``ops.sync.matched_filter_scores``)."""
    return sync.matched_filter_scores(spec, ring)


def extract_hits(spec: FrameSpec, score: torch.Tensor, min_pos: torch.Tensor,
                 max_frames: int):
    """Greedy first-hit walk over a dense score [n]: repeatedly take the
    first lag over pr_level at or after the cursor, then advance the cursor
    by ``message_len`` (`rx.cpp:158-198` advance rule).  Returns (positions
    [max_frames] int32, valid [max_frames]).  Positions carry the
    reference's +1 quirk (`main.cpp:53`, `rx.cpp:158`), or the local
    correlation peak under the config's ``peak_refine``."""
    cfg = spec.cfg
    n = score.shape[-1]
    lags = torch.arange(n, device=score.device)
    refine = cfg.peak_refine
    if refine:
        # zero sub-peak crossings against the LOCAL window max, as the gated
        # path does per candidate region (sync.suppress_sidelobes_local)
        score = sync.suppress_sidelobes_local(score, cfg.message_len)
    # a decodable hit needs a full frame window in the ring: the frame
    # spans [p+1-t2sin, p+1-t2sin+frame_len)
    last_ok = n - cfg.frame_len + cfg.t2sin_size - 1
    hit = (score > cfg.pr_level) & (lags <= last_ok)
    # refinement reads decodable lags only, so it never steps past last_ok
    score_ok = torch.where(lags <= last_ok, score, 0.0)

    cursor = torch.clamp(min_pos.to(torch.int64), min=0)
    positions, valid = [], []
    for _ in range(max_frames):
        cand = hit & (lags >= cursor)
        idx = torch.argmax(cand.to(torch.uint8), dim=-1)
        found = cand.any(dim=-1)
        if refine:
            peak = sync.refine_to_peak(score_ok, idx, sync.peak_radius(cfg))
            pos = torch.where(found, peak, -1)
        else:
            pos = torch.where(found, idx + 1, -1)           # +1 quirk
        cursor = torch.where(found, pos + cfg.message_len, n)
        positions.append(pos)
        valid.append(found)
    return (torch.stack(positions, dim=-1).to(torch.int32),
            torch.stack(valid, dim=-1))


def _first_ge(rank: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """First index along the last axis where the nondecreasing ``rank``
    reaches each target (== count of entries below it): a batch-friendly
    searchsorted."""
    return (rank[..., None, :] < targets[..., :, None]).sum(-1)


def gated_hits(spec: FrameSpec, ring: torch.Tensor, min_pos: torch.Tensor,
               max_frames: int):
    """Two-tone-gated sync over ring [..., n] (`rx.cpp:133,158` order):

    1. hop track over the whole ring; hot local maxima become candidates,
       the strongest K = max_frames + t2_gate_slack kept (top-K) and put in
       position order, so weak spurious peaks lose slots first;
    2. each candidate's region of G + L samples (G = gated_search_lags) is
       gathered by K2 (one ring) or K3 (C rings) at a start clipped to
       [0, n - G - L], and the matched filter scores its G lags;
    3. lags before ``min_pos`` or past the last decodable lag are masked; the
       first crossing of each region (refined to the local peak under
       ``peak_refine``) is its hit;
    4. the advance rule (next accepted preamble at least message_len past the
       previous, `rx.cpp:198`) is closed in parallel over the position-
       ordered candidates (one-hot successor matrix, log2(K) boolean matrix
       squarings) and the accepted hits are compacted into the output slots.

    Invalid candidate slots (top-K ties among non-peaks, all scoring -1)
    carry found = False, so the result never depends on which slots the
    top-K picked for them.  Returns (positions [..., max_frames] int32,
    valid [..., max_frames]), the same contract as ``extract_hits``.
    """
    cfg = spec.cfg
    lead = ring.shape[:-1]            # () or [C]
    n = ring.shape[-1]
    dev = ring.device
    hop = cfg.t2sin_size // 2
    G = cfg.gated_search_lags
    K = max_frames + cfg.t2_gate_slack
    win = G + cfg.pr_sin_len

    track = sync.t2_ratio_track_hop(spec, ring)            # [..., nwin]
    lo = torch.full((*lead, 1), -torch.inf, dtype=track.dtype, device=dev)
    prev = torch.cat([lo, track[..., :-1]], dim=-1)
    nxt = torch.cat([track[..., 1:], lo], dim=-1)
    peak = (track > cfg.t2_gate_level) & (track >= prev) & (track > nxt)
    vals = torch.where(peak, track, -1.0)
    cand_idx = torch.topk(vals, K, dim=-1).indices         # strongest K
    cand_w = torch.sort(cand_idx, dim=-1).values           # position order
    cand_valid = torch.gather(vals, -1, cand_w) > 0.0
    cand_w = torch.where(cand_valid, cand_w, 0)
    start = torch.clamp(cand_w * hop - hop, 0, n - win)    # [..., K]

    if lead:
        regions = extract.extract_windows_multi(ring, start, win)
    else:
        regions = extract.extract_windows_single(ring, start, win)
    scores = sync.matched_filter_scores(spec, regions)[..., :G]

    lags = start[..., None] + torch.arange(G, device=dev)
    last_ok = n - cfg.frame_len + cfg.t2sin_size - 1
    min_lag = torch.clamp(min_pos.to(torch.int64), min=0)
    ok = ((lags >= min_lag[..., None, None]) & (lags <= last_ok)
          & cand_valid[..., None])
    scores = torch.where(ok, scores, 0.0)
    if cfg.peak_refine:
        rel, found = sync.first_above_peak(sync.suppress_sidelobes(scores),
                                           cfg.pr_level,
                                           radius=sync.peak_radius(cfg))
        pr = torch.where(found, start + rel, -1)
    else:
        rel, found = sync.first_above(scores, cfg.pr_level)
        pr = torch.where(found, start + rel + 1, -1)      # +1 quirk

    # advance-rule chain closure: the greedy accept set is the chain
    # i0 -> nxt(i0) -> ... where nxt(i) is the first later found candidate
    # with p >= p_i + message_len
    idx = torch.arange(K, device=dev)
    later = idx[None, :] > idx[:, None]
    adm = pr[..., None, :] >= pr[..., :, None] + cfg.message_len
    succ = found[..., None, :] & later & adm               # [..., K, K]
    nxt1 = succ & (torch.cumsum(succ, dim=-1) == 1)        # first True/row
    A = nxt1.to(torch.float32) + torch.eye(K, dtype=torch.float32,
                                           device=dev)     # step-or-stay
    for _ in range(max(1, (K - 1).bit_length())):
        A = torch.clamp(A @ A, max=1.0)
    start_ok = found & (pr >= min_lag[..., None])
    i0 = start_ok & (torch.cumsum(start_ok, dim=-1) == 1)
    accept = (i0.to(torch.float32)[..., None, :] @ A)[..., 0, :] > 0.5

    arank = torch.cumsum(accept, dim=-1)
    targets = torch.arange(1, max_frames + 1, device=dev)
    slot = _first_ge(arank, targets.expand(*lead, max_frames))
    svalid = slot < K
    slot = torch.where(svalid, slot, 0)
    positions = torch.where(svalid, torch.gather(pr, -1, slot), -1)
    return positions.to(torch.int32), svalid


def _as_complex(spec: FrameSpec, block: torch.Tensor) -> torch.Tensor:
    """Complex [..., n], interleaved real [..., n, 2], or int16 wire samples
    [..., n, 2] (scaled down by the config's ``mult`` staging scale) ->
    complex [..., n] in the spec's dtype.  The scale-down multiplies by the
    reciprocal rounded to the working precision, as XLA compiles the JAX
    package's division by a constant."""
    if not block.is_complex():
        if not block.is_floating_point():
            block = block.to(spec.real_dtype) * (1.0 / spec.cfg.mult)
        rdt = spec.real_dtype
        return torch.complex(block[..., 0].to(rdt), block[..., 1].to(rdt))
    return block.to(spec.dtype)


def process_buffer(spec: FrameSpec, state: StreamState, block: torch.Tensor,
                   max_frames: int = 0, sync_mode: str = "gated"):
    """Consume one ingest buffer of IQ; return (new_state, StreamOut) with up
    to ``max_frames`` decoded frames (default rx_buf_size + 1).

    ``block`` is [..., rx_buf_size * frame_len] complex, or [..., n, 2]
    interleaved re/im floats or int16 wire samples; an optional leading axis
    carries independent channel streams (state fields then carry the same
    axis, see ``init_state``).  The ring is [carry | block] (`rx.cpp:73-91`
    double-buffer update with the one-frame carry in front).  ``sync_mode``
    "gated" (production) gates the matched filter on the two-tone track;
    "dense" correlates every ring lag (single channel only).
    """
    cfg = spec.cfg
    max_frames = max_frames or (cfg.rx_buf_size + 1)
    if sync_mode not in ("gated", "dense"):
        raise ValueError(f"sync_mode must be 'gated' or 'dense', got "
                         f"{sync_mode!r}")
    block = _as_complex(spec, block)
    lead = block.shape[:-1]
    carry = torch.where(state.carry_valid[..., None],
                        state.carry.to(spec.dtype), 0)
    ring = torch.cat([carry, block], dim=-1)
    n = ring.shape[-1]

    if sync_mode == "gated":
        positions, valid = gated_hits(spec, ring, state.next_min_pos,
                                      max_frames)
    else:
        if lead:
            raise NotImplementedError(
                "dense sync_mode is single-channel only")
        score = dense_preamble_corr(spec, ring)
        positions, valid = extract_hits(spec, score, state.next_min_pos,
                                        max_frames)

    # frame windows (invalid slots read position 0, masked by ``valid``)
    starts = torch.where(valid, positions - cfg.t2sin_size, 0)
    starts = torch.clamp(starts, 0, n - cfg.frame_len)
    res = rxm.demod_sig(spec, rxm.extract_sigs_ring(spec, ring, starts))
    diag = res.constellation.real + res.constellation.imag
    num_found = valid.sum(-1).to(torch.int32)

    # carry the ring tail; the next admissible lag maps back by the slide
    slide = n - cfg.frame_len
    new_carry = ring[..., slide:].to(state.carry.dtype).clone()
    last_pos = torch.where(valid, positions, -1).amax(dim=-1)
    cursor_end = torch.where(num_found > 0, last_pos + cfg.message_len, 0)
    next_min = torch.clamp(cursor_end - slide, min=0).to(torch.int32)

    new_state = StreamState(
        carry=new_carry,
        carry_valid=torch.ones(lead, dtype=torch.bool, device=ring.device),
        next_min_pos=next_min,
        frames_seen=state.frames_seen + num_found,
    )
    return new_state, StreamOut(res.mac_bytes, diag, positions, valid,
                                num_found, res.cfo)


def save_state(path, state: StreamState) -> None:
    """Checkpoint the stream state in the JAX package's ``.npz`` layout
    (``c_ofdm_tpu.models.streaming.save_state``): carry as re/im reals
    [..., frame_len, 2], carry_valid bool, next_min_pos and frames_seen
    int32.  ``path`` is a file name (numpy appends ``.npz``) or a binary
    file object."""
    carry = torch.view_as_real(state.carry.detach().cpu().resolve_conj())
    np.savez(path,
             carry=carry.numpy(),
             carry_valid=state.carry_valid.cpu().numpy(),
             next_min_pos=state.next_min_pos.cpu().numpy().astype(np.int32),
             frames_seen=state.frames_seen.cpu().numpy().astype(np.int32))


def load_state(path, *, device) -> StreamState:
    """Read a checkpoint written by ``save_state`` of either package onto
    ``device`` (required: there is no implicit default device); the carry
    becomes complex64 (float32 planes) or complex128 (float64 planes)."""
    if isinstance(path, str) and not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as z:
        carry = np.ascontiguousarray(z["carry"])
        if carry.dtype not in (np.float32, np.float64) or carry.shape[-1] != 2:
            raise ValueError(f"load_state: carry must be float32/float64 "
                             f"[..., frame_len, 2], got {carry.dtype} "
                             f"{carry.shape}")
        return StreamState(
            carry=torch.view_as_complex(torch.from_numpy(carry)).to(device),
            carry_valid=torch.from_numpy(z["carry_valid"].astype(bool)).to(
                device),
            next_min_pos=torch.from_numpy(
                z["next_min_pos"].astype(np.int32)).to(device),
            frames_seen=torch.from_numpy(
                z["frames_seen"].astype(np.int32)).to(device),
        )


class StreamingReceiver(nn.Module):
    """Feed ingest buffers, collect frames: the role of the rx.cpp main
    loop.  The spec's device constants and the stream state are buffers, so
    ``.to(device)`` moves both.  ``channels`` C > 0 takes blocks with a
    leading [C] axis (C independent streams).

    On the card ``feed`` is one CUDA-graph replay per buffer, as the JAX
    package's ``process_buffer`` is one compiled program: a graph is
    captured on the first buffer of each block shape and dtype (complex,
    interleaved float and int16 blocks are each their own key).  The state
    stays in this module's buffers: the captured step ends by writing the
    new state into them, so one replay feeds the next.  Setting ``state``
    copies into those buffers when every field keeps its shape, dtype and
    device, and otherwise rebinds them and drops the graphs, as ``.to()``
    does.  On CPU tensors ``feed`` runs the same step eagerly.
    """

    def __init__(self, spec: FrameSpec, max_frames: int = 0,
                 sync_mode: str = "gated", channels: int = 0):
        super().__init__()
        self.spec = spec
        self.max_frames = max_frames or (spec.cfg.rx_buf_size + 1)
        self.sync_mode = sync_mode
        for name, t in spec.tensors.items():
            self.register_buffer(name, t)
        for name, t in zip(StreamState._fields,
                           init_state(spec, channels=channels)):
            self.register_buffer(name, t, persistent=False)
        self.graphs = graphs.CapturedCall("StreamingReceiver.feed")

    def _apply(self, fn, recurse=True):
        self.graphs.clear()
        return super()._apply(fn, recurse)

    def _state_buffers(self) -> StreamState:
        return StreamState(*(getattr(self, f) for f in StreamState._fields))

    @property
    def state(self) -> StreamState:
        """A copy of the stream state (later buffers do not change it)."""
        return StreamState(*(t.clone() for t in self._state_buffers()))

    @state.setter
    def state(self, state: StreamState) -> None:
        cur = self._state_buffers()
        if all(t.shape == c.shape and t.dtype == c.dtype
               and t.device == c.device for t, c in zip(state, cur)):
            with torch.no_grad():
                for c, t in zip(cur, state):
                    c.copy_(t)
            return
        for name, t in zip(StreamState._fields, state):
            setattr(self, name, t)
        self.graphs.clear()

    def bound_spec(self) -> FrameSpec:
        """The spec reading its constants from this module's buffers."""
        return self.spec.with_tensors(dict(self.named_buffers()))

    def _step(self, block: torch.Tensor) -> StreamOut:
        """``process_buffer`` on the state buffers, the new state written
        back into them (the captured step)."""
        cur = self._state_buffers()
        new, out = process_buffer(self.bound_spec(), cur, block,
                                  self.max_frames, self.sync_mode)
        for c, t in zip(cur, new):
            c.copy_(t)
        return out

    def feed(self, block: torch.Tensor) -> StreamOut:
        """One ingest buffer (see ``process_buffer``) -> its StreamOut."""
        lead = block.shape[:-1] if block.is_complex() else block.shape[:-2]
        if lead != self.frames_seen.shape:
            raise ValueError(f"StreamingReceiver.feed: a block of "
                             f"{tuple(lead)} channels for state of "
                             f"{tuple(self.frames_seen.shape)}")
        return self.graphs(self._step, (block,),
                           restore=self._state_buffers())

    def feed_int16(self, raw: torch.Tensor) -> StreamOut:
        """Interleaved int16 [..., 2*n] (``tx.from_int16``) -> StreamOut."""
        return self.feed(txm.from_int16(self.spec, raw))
