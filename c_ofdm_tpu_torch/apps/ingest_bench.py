"""Ingest micro-benchmark — the reference ``st_rx`` binary's role
(`st_rx.cpp:43-114`): measure raw host ingest + int16 conversion throughput
through the native double-buffered ring, separately from device compute.

Usage: python -m c_ofdm_tpu_torch.apps.ingest_bench [--buffers N]
       [--source PATH] [--to-device]

``--to-device`` pops each buffer into a pinned host tensor, copies it to the
card and synchronizes (a CUDA device is required; none raises).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--buffers", type=int, default=500)
    p.add_argument("--samples", type=int, default=246656,
                   help="complex samples per buffer (reference ring size)")
    p.add_argument("--source", default="",
                   help="file to replay (default synthetic)")
    p.add_argument("--to-device", action="store_true",
                   help="include host->device transfer (CUDA)")
    args = p.parse_args(argv)

    from c_ofdm_tpu_torch.io.ingest import (NativeIngest, SRC_FILE_REPLAY,
                                            SRC_SYNTH_ZERO)

    kind = SRC_FILE_REPLAY if args.source else SRC_SYNTH_ZERO
    pinned = None
    if args.to_device:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("--to-device: no CUDA device is available")
        dev = torch.device("cuda", torch.cuda.current_device())
        # the interleaved float32 wire format [n, 2], popped straight into
        # pinned memory so the copy is one DMA
        pinned = torch.empty((args.samples, 2), dtype=torch.float32,
                             pin_memory=True)
        flat = pinned.numpy().reshape(-1)

    with NativeIngest(kind, args.source, args.samples, 4) as ing:
        # warmup
        for _ in range(5):
            ing.pop_f32()
        t0 = time.perf_counter()
        for _ in range(args.buffers):
            if pinned is None:
                ing.pop_f32()
            else:
                ing.pop_f32(out=flat)
                pinned.to(dev, non_blocking=True)
                torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        st = ing.stats()

    sps = args.buffers * args.samples / dt
    print(f"{args.buffers} buffers x {args.samples} samples in {dt:.3f}s; "
          f"producer_waits={st.producer_waits} consumer_waits={st.consumer_waits}",
          file=sys.stderr)
    print(json.dumps({
        "metric": "ingest_samples_per_s" + ("_to_device" if args.to_device else ""),
        "value": round(sps, 1),
        "unit": "samples/s",
        "vs_baseline": round(sps / (246656 / 0.0444), 3),  # ref SDR wall: 44.4ms/buffer
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
