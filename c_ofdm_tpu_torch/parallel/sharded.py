"""Sharded receiver over a {channel, time} mesh of torch.distributed ranks
(counterpart of ``c_ofdm_tpu/parallel/sharded.py``).

Long captures are split into contiguous time blocks, one per rank along the
``time`` axis; independent streams ride the ``channel`` axis.  Each rank
receives its right neighbour's first ``frame_len`` samples (the distributed
overlap-save halo, where the JAX package runs a ``ppermute``; reference
counterpart: the single-process carry-over memcpy, `rx.cpp:147-156`),
detects every frame whose *start* lies inside its own block (exactly-once
ownership rule), and demodulates locally.  After the one halo exchange,
blocks are independent: every estimator reads only within one frame.

Transfers follow the group's backend: NCCL takes the card's tensors, gloo
takes host tensors (a gloo group with data on the card stages every
transfer through host memory, ``ModemMesh.staged``).  Neither has a complex
or (NCCL) a bool type, so complex tensors travel as ``view_as_real`` reals
and bool ones as uint8.

The JAX package compiles both sharded steps (``jax.jit``); here, on CUDA
tensors, each is one CUDA-graph replay per call (``utils/graphs.py``).  The
receiver's halo exchange stays outside its graph: a gloo transfer goes
through host memory, which a capture refuses, and one card runs only an
NCCL world of one, which sends nothing.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from ..models import rx as rxm
from ..models import streaming
from ..models.frame import FrameSpec
from ..utils import graphs
from .mesh import ModemMesh


def _to_wire(mesh: ModemMesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor the group's transfers take."""
    if x.is_complex():
        x = torch.view_as_real(x.resolve_conj())
    elif x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return (x.cpu() if mesh.staged else x).contiguous()


def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The inverse of ``_to_wire`` for a tensor of ``like``'s dtype."""
    w = w.to(like.device)
    if like.is_complex():
        return torch.view_as_complex(w)
    return w.to(torch.bool) if like.dtype == torch.bool else w


def exchange_halo(mesh: ModemMesh, heads: torch.Tensor):
    """Pass each block's head [ch_local, frame_len] one time rank LEFT:
    rank (c, t > 0) sends to (c, t - 1), rank (c, t < n_time - 1) receives
    from (c, t + 1).  Returns (halo, halo_valid): the last time rank has no
    right neighbour and gets zeros with ``halo_valid`` False, a Python bool
    known from its coordinates.  Unlike the JAX ``ppermute`` nothing wraps
    around, so a world of one sends nothing."""
    halo_valid = mesh.t < mesh.n_time - 1
    ops, recv = [], None
    if mesh.t > 0:
        ops.append(dist.P2POp(dist.isend, _to_wire(mesh, heads),
                              mesh.global_rank(mesh.c, mesh.t - 1),
                              mesh.group))
    if halo_valid:
        recv = torch.empty_like(_to_wire(mesh, heads))
        ops.append(dist.P2POp(dist.irecv, recv,
                              mesh.global_rank(mesh.c, mesh.t + 1),
                              mesh.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if not halo_valid:
        return torch.zeros_like(heads), False
    return _from_wire(recv, heads), True


def _hits_dense(spec: FrameSpec, ext: torch.Tensor, max_frames: int):
    """The dense fallback's hits of every channel row of ``ext`` [C, n]:
    ``extract_hits`` walks one channel's score, so it runs per row (the JAX
    package vmaps it over the rank's channels)."""
    score = streaming.dense_preamble_corr(spec, ext)
    zero = torch.zeros((), dtype=torch.int32, device=ext.device)
    hits = [streaming.extract_hits(spec, s, zero, max_frames) for s in score]
    return (torch.stack([p for p, _ in hits]),
            torch.stack([v for _, v in hits]))


def _local_receive(spec: FrameSpec, block: torch.Tensor, halo: torch.Tensor,
                   halo_valid: bool, max_frames: int,
                   sync_mode: str = "gated") -> streaming.StreamOut:
    """Decode frames starting inside ``block`` [C, block_len], using ``halo``
    [C, frame_len] (the right neighbour's head) to complete boundary frames.

    Without a valid halo (the last time rank: zeros, no right neighbour)
    frames must fit entirely inside the block, the single-buffer path's
    "window runs past the end -> not decodable" rule, so a frame cut off by
    the capture end is dropped instead of demodulated into garbage.  The
    rank's channels go through K3 (``extract_windows_multi``) twice: the
    gated sync's candidate regions, then the frame windows."""
    cfg = spec.cfg
    if sync_mode not in ("gated", "dense"):
        raise ValueError(f"sync_mode must be 'gated' or 'dense', got "
                         f"{sync_mode!r}")
    block_len = block.shape[-1]
    ext = torch.cat([block, halo], dim=-1)
    if sync_mode == "gated":
        zero = torch.zeros(ext.shape[:-1], dtype=torch.int32,
                           device=ext.device)
        positions, valid = streaming.gated_hits(spec, ext, zero, max_frames)
    else:
        positions, valid = _hits_dense(spec, ext, max_frames)
    starts = positions.to(torch.int64) - cfg.t2sin_size
    # ownership: the frame's first sample lies in this rank's block
    valid = valid & (starts >= 0) & (starts < block_len)
    if not halo_valid:
        # capture tail: without a real halo the frame must fit the block
        valid = valid & (starts + cfg.frame_len <= block_len)
    gather = torch.clamp(torch.where(valid, starts, 0), 0,
                         ext.shape[-1] - cfg.frame_len)
    res = rxm.demod_sig(spec, rxm.extract_sigs_ring(spec, ext, gather))
    diag = res.constellation.real + res.constellation.imag
    return streaming.StreamOut(res.mac_bytes, diag, positions, valid,
                               valid.sum(-1).to(torch.int32), res.cfo)


def _shard_body(spec: FrameSpec, halo_valid: bool, max_frames: int,
                sync_mode: str, block: torch.Tensor, halo: torch.Tensor):
    """``_local_receive`` in the JAX per-shard layout [ch_local, 1, ...]."""
    out = _local_receive(spec, block, halo, halo_valid, max_frames, sync_mode)
    return streaming.StreamOut(*(x[:, None] for x in out))


def replay_local(call: graphs.CapturedCall, spec: FrameSpec,
                 block: torch.Tensor, halo: torch.Tensor, halo_valid: bool,
                 max_frames: int, sync_mode: str = "gated"):
    """``_shard_body`` through ``call``: on CUDA tensors one replay of the
    graph keyed by (spec, halo_valid, max_frames, sync_mode) and the
    shapes of ``block`` and ``halo``, captured on its first call; on CPU
    tensors the body itself."""
    static = (spec, halo_valid, max_frames, sync_mode)
    return call(functools.partial(_shard_body, *static), (block, halo),
                static=static)


def make_sharded_receiver(spec: FrameSpec, mesh: ModemMesh,
                          max_frames_per_block: int,
                          sync_mode: str = "gated"):
    """Build this rank's sharded bulk receiver.  The returned callable takes
    the rank's block [ch_local, block_len] (complex, on the spec's device;
    ``ingest.make_global_capture`` cuts and places it), exchanges the halo
    with its time neighbours and returns the rank's ``StreamOut`` in the JAX
    per-shard layout [ch_local, 1, max_frames, ...] (positions are
    block-local; ``valid`` masks ownership).  ``gather_outputs`` assembles
    the global [C, n_time, ...] view.  ``sync_mode`` as in
    ``streaming.process_buffer``: "gated" (production) or "dense".

    On the card the halo exchange runs eagerly and the rest of the call is
    one CUDA-graph replay (``replay_local``), block and halo copied into
    the graph's static inputs; ``receive.graphs`` (a ``CapturedCall``)
    holds the graphs.  On CPU tensors the call runs eagerly."""
    frame_len = spec.cfg.frame_len
    call = graphs.CapturedCall("make_sharded_receiver")

    def receive(local: torch.Tensor) -> streaming.StreamOut:
        if local.dim() != 2 or local.shape[-1] < frame_len:
            raise ValueError(f"sharded receiver: the block must be [ch_local, "
                             f"block_len >= {frame_len}], got "
                             f"{tuple(local.shape)}")
        local = local.to(spec.dtype)
        halo, halo_valid = exchange_halo(mesh, local[:, :frame_len])
        return replay_local(call, spec, local, halo, halo_valid,
                            max_frames_per_block, sync_mode)

    receive.graphs = call
    return receive


def _gather_grid(mesh: ModemMesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's x [ch_local, n_t, ...] -> [n_channel * ch_local,
    n_time * n_t, ...], on every rank (one ``all_gather``)."""
    if mesh.group is None:
        return x
    w = _to_wire(mesh, x)
    parts = [torch.empty_like(w) for _ in range(mesh.size)]
    dist.all_gather(parts, w, group=mesh.group)
    rows = [torch.cat(parts[c * mesh.n_time:(c + 1) * mesh.n_time], dim=1)
            for c in range(mesh.n_channel)]
    return _from_wire(torch.cat(rows, dim=0), x)


def gather_outputs(mesh: ModemMesh, out: streaming.StreamOut):
    """The JAX global view [C_total, n_time, max_frames, ...] of every rank's
    receiver output [ch_local, 1, max_frames, ...], assembled on every rank
    (the JAX callers read the global array)."""
    return type(out)(*(_gather_grid(mesh, x) for x in out))


def gather_channels(mesh: ModemMesh, tree):
    """The global [C_total, ...] view of channel-sharded arrays [ch_local,
    ...] (``make_sharded_streaming``'s state and outputs; replicas along the
    time axis are equal and the first is taken), on every rank."""
    return type(tree)(*(_gather_grid(mesh, x[:, None])[:, 0] for x in tree))


def make_sharded_streaming(spec: FrameSpec, mesh: ModemMesh, max_frames: int,
                           sync_mode: str = "gated"):
    """Channel-sharded CONTINUOUS streaming: the C channel streams spread
    over the mesh's ``channel`` axis, every rank running the same
    ``streaming.process_buffer`` step on its local channels with its local
    carry state.  The streaming step's time dimension is the buffer
    sequence, so only the channel axis shards and no collective runs per
    buffer.  Returns ``step(state, block) -> (state, StreamOut)`` on the
    rank's [ch_local, ...] state and block (``ingest.make_global_stream_state``
    and ``make_global_channel_array`` place them): on the card one
    CUDA-graph replay per buffer, the state copied in and the new state
    returned as fresh tensors, as ``jax.jit`` returns new arrays;
    ``step.graphs`` holds the graphs.  On CPU tensors the step runs
    eagerly."""
    del mesh    # nothing crosses ranks; the mesh fixes where the data lies
    jitted = graphs.jit(streaming.process_buffer, static_argnums=(0, 3, 4))

    def step(state: streaming.StreamState, block: torch.Tensor):
        return jitted(spec, state, block, max_frames, sync_mode)

    step.graphs = jitted.graphs
    return step


def global_positions(spec: FrameSpec, out: streaming.StreamOut,
                     block_len: int) -> torch.Tensor:
    """Block-local preamble positions of the global view [C, n_time, K] ->
    capture-global ones, -1 where not valid."""
    n_time = out.positions.shape[1]
    offs = (torch.arange(n_time, device=out.positions.device)
            * block_len)[None, :, None]
    return torch.where(out.valid, out.positions + offs, -1)
