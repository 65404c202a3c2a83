"""Streaming transmitter app — the reference ``tx`` binary's role
(`tx.cpp:18-46`): read a payload file in MAC-sized chunks, frame, modulate,
and emit int16 IQ to a file or stdout until EOF.

Usage:
  python -m c_ofdm_tpu_torch.apps.txstream --in FILE --out stream.bin [--gap N]
      [--batch 32] [--device cuda]

``Mac.write``, ``transmit`` and ``to_int16`` run on the device, ``--batch``
frames per call; only the int16 rows come back to the host.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import add_device_arg, resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--in", dest="inp", required=True, help="payload file")
    p.add_argument("--out", default="-", help="output .bin (int16 IQ) or -")
    p.add_argument("--config", default="")
    p.add_argument("--gap", type=int, default=0,
                   help="zero samples between frames")
    p.add_argument("--batch", type=int, default=32,
                   help="frames modulated per device call")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from c_ofdm_tpu_torch import ModemConfig, load_config, make_frame_spec
    from c_ofdm_tpu_torch.mac.mac import Mac
    from c_ofdm_tpu_torch.models import tx as txm

    cfg = load_config(args.config) if args.config else ModemConfig()
    spec = make_frame_spec(cfg, torch.complex64, device=dev,
                           fft_backend="matmul")
    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)

    with open(args.inp, "rb") as f:
        data = np.frombuffer(f.read(), dtype=np.uint8)
    n_frames = (data.size + mac.payload - 1) // mac.payload
    data = np.pad(data, (0, n_frames * mac.payload - data.size))
    chunks = data.reshape(n_frames, mac.payload)

    out = sys.stdout.buffer if args.out == "-" else open(args.out, "wb")
    total = 0
    gap = np.zeros(2 * args.gap, dtype=np.int16)
    for i in range(0, n_frames, args.batch):
        batch = torch.from_numpy(chunks[i:i + args.batch]).to(dev)
        seqs = torch.arange(i, i + batch.shape[0], dtype=torch.int64,
                            device=dev)
        wire = mac.write(batch, seqs)
        frames = txm.transmit(spec, wire)
        i16 = txm.to_int16(spec, frames).cpu().numpy()
        for row in i16:
            out.write(row.tobytes())
            if args.gap:
                out.write(gap.tobytes())
        total += batch.shape[0]
    if args.out != "-":
        out.close()
    print(f"transmitted {total} frames "
          f"({total * (cfg.frame_len + args.gap)} samples, "
          f"{total * mac.payload} payload bytes)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
