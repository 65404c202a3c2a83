"""Scaling benchmark: the sharded bulk receiver across {channel, time} mesh
sizes (counterpart of ``c_ofdm_tpu/apps/scaling_bench.py``).

Measures samples/s of the sharded receiver in worlds of 1, 2, 4, ... ranks
(one process each, ``parallel/launch.py``) on a {channel: 1, time: n} mesh
and reports scaling efficiency against the first size.  ``--device cuda``
(the default) runs NCCL with one process per card, so sizes go up to
``torch.cuda.device_count()``: NCCL takes one process per GPU, and a
larger ``--devices`` than the cards raises the mesh's ValueError.
``--device cpu`` runs gloo with one process per rank (default 8 ranks).

Usage: python -m c_ofdm_tpu_torch.apps.scaling_bench [--devices 8]
       [--device cpu] [--frames-per-block 4] [--channels 1] [--reps 5]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

from . import add_device_arg, resolve_device

CPU_WORLD = 8     # the JAX app's virtual CPU device count under --cpu


def build_capture(spec, mac, payloads, n_time, block_len):
    """[channels, n_time * block_len] complex capture: each channel's MAC
    frame planted once per time block, at b * block_len + 97."""
    import torch
    from ..models import tx as txm
    cfg = spec.cfg
    channels = payloads.shape[0]
    wire = mac.write(torch.from_numpy(payloads).to(spec.device),
                     torch.arange(channels, device=spec.device))
    frame = txm.transmit(spec, wire)
    cap = torch.zeros((channels, n_time * block_len), dtype=spec.dtype,
                      device=spec.device)
    for b in range(n_time):
        s = b * block_len + 97
        cap[:, s:s + cfg.frame_len] = frame
    return cap


def _rank(device, n_time, payloads, frames_per_block, reps):
    """Target of one rank: build the capture, receive this rank's block,
    check every frame was found, then time ``reps`` calls, each ended by a
    barrier and a readback of ``num_found``.  Returns (found, best s)."""
    import torch
    import torch.distributed as dist
    from ..config import ModemConfig
    from ..mac.mac import Mac
    from ..models.frame import make_frame_spec
    from ..parallel.ingest import capture_sharding, make_global_capture
    from ..parallel.mesh import make_modem_mesh
    from ..parallel.sharded import gather_outputs, make_sharded_receiver

    # the JAX app's spec: make_frame_spec's default there, jnp.fft
    spec = make_frame_spec(ModemConfig(), torch.complex64, device=device,
                           fft_backend="xla")
    cfg = spec.cfg
    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    block_len = frames_per_block * cfg.frame_len
    mesh = make_modem_mesh(1, n_time, device=device)
    cap = build_capture(spec, mac, payloads, n_time, block_len)
    local = make_global_capture(
        mesh, cap[capture_sharding(mesh).index(cap.shape)], cap.shape)
    recv = make_sharded_receiver(spec, mesh, frames_per_block)
    out = gather_outputs(mesh, recv(local))      # warm-up + correctness
    found = int(out.num_found.sum())
    if found != payloads.shape[0] * n_time:
        raise RuntimeError(f"scaling-bench: found {found} frames in a world "
                           f"of {n_time}, planted {payloads.shape[0] * n_time}")
    best = float("inf")
    for r in range(reps):
        x = local * (1.0 + 1e-6 * r)               # distinct inputs
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier()
        t0 = time.perf_counter()
        o = recv(x)
        int(o.num_found.sum())                     # forced readback
        dist.barrier()
        best = min(best, time.perf_counter() - t0)
    return found, best


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--devices", type=int, default=0,
                   help="max devices (default: all cards, or 8 CPU ranks)")
    add_device_arg(p)
    p.add_argument("--channels", type=int, default=1)
    p.add_argument("--frames-per-block", type=int, default=4)
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)

    import torch
    from ..config import ModemConfig
    from ..mac.mac import Mac
    from ..parallel.launch import run_world
    from ..parallel.mesh import mesh_grid

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        have, backend, rank_dev = torch.cuda.device_count(), "nccl", "cuda:{rank}"
    else:
        have, backend, rank_dev = args.devices or CPU_WORLD, "gloo", "cpu"
    n_dev_total = args.devices or have
    mesh_grid(1, n_dev_total, have)      # more ranks than cards: ValueError

    cfg = ModemConfig()
    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    rng = np.random.default_rng(0)
    block_len = args.frames_per_block * cfg.frame_len

    results = {}
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_dev_total]
    for n_time in sizes:
        payloads = rng.integers(0, 256, (args.channels, mac.payload),
                                dtype=np.uint8)
        found, best = run_world(
            n_time, "c_ofdm_tpu_torch.apps.scaling_bench:_rank",
            backend=backend, device=rank_dev,
            args=(n_time, payloads, args.frames_per_block, args.reps))[0]
        results[n_time] = n_time * block_len * args.channels / best
        print(f"n_time={n_time}: {results[n_time]/1e6:.1f} Msamples/s "
              f"({found} frames)", file=sys.stderr)

    base = results[sizes[0]]
    eff = {n: results[n] / (base * n / sizes[0]) for n in sizes}
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        print(smi.stdout.strip(), file=sys.stderr)
    print(json.dumps({
        "metric": "sharded_rx_scaling",
        "samples_per_s": {str(n): round(results[n], 1) for n in sizes},
        "efficiency_vs_linear": {str(n): round(eff[n], 3) for n in sizes},
        "devices": sizes,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
