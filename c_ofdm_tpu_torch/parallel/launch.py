"""A world of N ranks, one process each: what the JAX apps get from
``jax.devices()`` (one process driving every device), in the PyTorch idiom.

``run_world`` spawns N processes (start method ``spawn``), initialises a
process group of the backend the caller names on a free localhost TCP port,
calls ``target(device, *args)`` in every rank and returns each rank's
(picklable) result, rank order.  A rank that raises or exits non-zero fails
the call with that rank's traceback, after the other ranks are stopped.
Targets are named by module and function (``"pkg.mod:fn"``), since spawned
processes import them afresh; a target's module must not import jax.

Two targets come with it, for callers that hold a whole global capture and
want the mesh-wide result back (the tests): ``receive_rank`` (the sharded
bulk receiver) and ``stream_rank`` (the channel-sharded stream).  Each cuts
its rank's part with ``ingest``, runs the path, and returns the gathered
view as numpy arrays with the kernel launches the path made on the rank
(by wrapper name) and, on the card, the CUDA graphs its captured calls
hold.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing as mp
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

from ..utils import graphs


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, device, target, args, timeout_s,
               results):
    """One rank: join the group, run the target, report (rank, ok, value)."""
    try:
        dev = torch.device(device.format(rank=rank))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:   # the ranks of a CPU world share the host's cores
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s),
            device_id=dev if backend == "nccl" else None)
        try:
            mod, fn = target.split(":")
            value = getattr(importlib.import_module(mod), fn)(dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise


def run_world(n: int, target: str, *, backend: str, device: str,
              args=(), timeout: float = 600.0) -> list:
    """Run ``target(device, *args)`` in each of ``n`` spawned ranks joined in
    one ``backend`` ("nccl" or "gloo") process group; return the ranks'
    results in rank order.  ``device`` names each rank's device and may hold
    ``{rank}`` ("cuda:{rank}": one card per rank; "cuda:0": every rank on
    one card; "cpu").  Raises RuntimeError with the rank's traceback if a
    rank fails, exits without a result, or the world outlives ``timeout``
    seconds."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, port, backend, device, target,
                               tuple(args), timeout, results))
             for r in range(n)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < n:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if time.monotonic() > deadline:
                    raise RuntimeError(f"run_world {target}: no result from "
                                       f"ranks {sorted(set(range(n)) - set(got))}"
                                       f" within {timeout} s")
                if not dead:
                    continue
                try:    # a rank that exited may have left its result behind
                    rank, ok, value = results.get(timeout=2.0)
                except queue.Empty:
                    raise RuntimeError(
                        f"run_world {target}: rank {dead[0]} exited with "
                        f"code {procs[dead[0]].exitcode} and no result"
                    ) from None
            if not ok:
                raise RuntimeError(f"run_world {target}: rank {rank} of {n} "
                                   f"failed:\n{value}")
            got[rank] = value
        for p in procs:
            p.join(timeout=60)
            if p.exitcode != 0:
                raise RuntimeError(f"run_world {target}: rank "
                                   f"{procs.index(p)} exited with code "
                                   f"{p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(n)]


def _numpy(tree) -> dict:
    return {k: v.cpu().numpy() for k, v in tree._asdict().items()}


def _launches_since(before: dict) -> dict:
    """{wrapper name: launches} each kernel wrapper made since ``before``
    (``graphs.launch_counts()``)."""
    return {fn.__name__: n - before.get((fn, name, k), 0)
            for (fn, name, k), n in graphs.launch_counts().items()
            if name == "launches"}


def _graphs_of(call) -> list:
    """Each graph of a captured call: its static key without the spec, its
    input shapes, its pool MiB and its capture seconds."""
    from ..models.frame import FrameSpec
    return [{"static": [s for s in static if not isinstance(s, FrameSpec)],
             "shapes": [shape for shape, _, _ in tensors],
             "pool_mib": g.pool_bytes / 2**20, "capture_s": g.capture_s}
            for (static, tensors), g in call.graphs.items()]


def _spec(cfg, dtype, fft_backend, device):
    from ..models.frame import make_frame_spec
    return make_frame_spec(cfg, dtype, device=device, fft_backend=fft_backend)


def receive_rank(device, cfg, dtype, fft_backend, captures, n_channel,
                 n_time, max_frames, sync_mode="gated") -> dict:
    """Target: the sharded bulk receiver on this rank's block of the global
    numpy ``captures`` [C, total_len] over a {n_channel, n_time} mesh of the
    world.  Returns the rank's coordinates, its block, the gathered
    [C, n_time, max_frames, ...] output, the rank's launch counts and its
    graphs (``_graphs_of``)."""
    from .ingest import capture_sharding, make_global_capture
    from .mesh import make_modem_mesh
    from .sharded import gather_outputs, make_sharded_receiver
    spec = _spec(cfg, dtype, fft_backend, device)
    mesh = make_modem_mesh(n_channel, n_time, device=device)
    idx = capture_sharding(mesh).index(captures.shape)
    block = make_global_capture(mesh, torch.from_numpy(captures[idx]),
                                captures.shape)
    recv = make_sharded_receiver(spec, mesh, max_frames, sync_mode)
    before = graphs.launch_counts()
    out = recv(block)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = _launches_since(before)
    return {"coords": (mesh.c, mesh.t), "block": block.cpu().numpy(),
            "out": _numpy(gather_outputs(mesh, out)), "launches": launches,
            "graphs": _graphs_of(recv.graphs)}


def stream_rank(device, cfg, dtype, fft_backend, blocks, n_channel, n_time,
                max_frames) -> dict:
    """Target: the channel-sharded stream over the global numpy ``blocks``
    [S, C, n], each rank feeding its channels' S buffers from the state
    ``make_global_stream_state`` places.  Returns every buffer's gathered
    [C, ...] output, the gathered final state, the rank's launch counts
    and its graphs (``_graphs_of``)."""
    from ..models import streaming
    from .ingest import (channel_sharding, make_global_channel_array,
                         make_global_stream_state)
    from .mesh import make_modem_mesh
    from .sharded import gather_channels, make_sharded_streaming
    spec = _spec(cfg, dtype, fft_backend, device)
    mesh = make_modem_mesh(n_channel, n_time, device=device)
    C = blocks.shape[1]
    rows = channel_sharding(mesh).index(blocks.shape[1:])[0]
    state = make_global_stream_state(
        mesh, streaming.init_state(spec, channels=rows.stop - rows.start),
        C)
    step = make_sharded_streaming(spec, mesh, max_frames)
    local = [make_global_channel_array(mesh, torch.from_numpy(b[rows]), C)
             for b in blocks]
    before = graphs.launch_counts()
    outs = []
    for blk in local:
        state, out = step(state, blk)
        outs.append(out)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = _launches_since(before)
    return {"outs": [_numpy(gather_channels(mesh, o)) for o in outs],
            "state": _numpy(gather_channels(mesh, state)),
            "launches": launches, "graphs": _graphs_of(step.graphs)}
