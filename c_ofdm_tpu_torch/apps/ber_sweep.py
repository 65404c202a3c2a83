"""BER/EVM vs SNR sweep over the channel simulator.

Completes the analysis suite (the reference measures accuracy only on live
hardware, `main.cpp:86-104` / `log.py`): characterize each modulation order
against AWGN+CFO with the deterministic simulator, batch-first on device.

Usage:
  python -m c_ofdm_tpu_torch.apps.ber_sweep [--mods 2,4,6] [--snrs 5:30:5]
      [--frames 32] [--cfo 1e-4] [--out ber.jsonl] [--png ber.png] [--soft]
      [--device cuda]

``--soft`` sweeps the MAC's bit-repetition scheme instead of raw PHY bytes,
comparing the hard majority vote (``Mac.read_bytes``) against max-log LLR
soft combining (``ops.modulation.soft_llrs`` + ``Mac.read_llr``) — the
soft-decision capability the hard-decision-only reference lacks
(`OFDM/modulation.cpp:53-87`).  The noise of each SNR point comes from a
``torch.Generator`` on the device seeded with ``int(snr * 10)``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import add_device_arg, resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mods", default="2,4,6")
    p.add_argument("--snrs", default="5:31:5", help="start:stop:step dB")
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--cfo", type=float, default=1e-4)
    p.add_argument("--out", default="")
    p.add_argument("--png", default="")
    p.add_argument("--soft", action="store_true",
                   help="sweep MAC-spread logical BER: hard majority vote "
                        "vs soft LLR combining")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if args.png:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib not available", file=sys.stderr)
            return 1

    from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
    from c_ofdm_tpu_torch.channel.sim import ChannelParams, apply_channel
    from c_ofdm_tpu_torch.io.trace import link_metrics
    from c_ofdm_tpu_torch.mac.mac import Mac
    from c_ofdm_tpu_torch.models import rx as rxm
    from c_ofdm_tpu_torch.models import tx as txm
    from c_ofdm_tpu_torch.ops import modulation

    mods = [int(m) for m in args.mods.split(",")]
    lo, hi, st = (float(x) for x in args.snrs.split(":"))
    snrs = np.arange(lo, hi, st)

    rows = []
    for mod in mods:
        cfg = ModemConfig(mod_type=mod)
        spec = make_frame_spec(cfg, torch.complex64, device=dev,
                               fft_backend="matmul")
        rng = np.random.default_rng(mod)
        if args.soft:
            mac = Mac(frame_bytes=cfg.frame_bytes, spread=mod)
            payload = rng.integers(0, 256, (args.frames, mac.payload),
                                   dtype=np.uint8)
            wire = mac.write(torch.from_numpy(payload).to(dev),
                             torch.arange(args.frames, device=dev))
            frames = txm.transmit(spec, wire)
        else:
            payload = rng.integers(0, 256, (args.frames, cfg.frame_bytes),
                                   dtype=np.uint8)
            frames = txm.transmit(spec, torch.from_numpy(payload).to(dev))
        for snr in snrs:
            params = ChannelParams(snr_db=float(snr), cfo=args.cfo,
                                   amplitude=1.0)
            cap = apply_channel(
                params, frames,
                generator=torch.Generator(dev).manual_seed(int(snr * 10)))
            res = rxm.demod_frames_jit(spec, cap)
            if args.soft:
                hard = mac.read_bytes(res.mac_bytes)
                llrs = modulation.soft_llrs(res.constellation, mod)
                soft = mac.read_llr(llrs)
                bits = lambda x: np.unpackbits(  # noqa: E731
                    x.cpu().numpy() ^ payload, axis=-1)
                row = {"mod_type": mod, "snr_db": float(snr),
                       "ber_hard": round(float(bits(hard.payload).mean()), 6),
                       "ber_soft": round(float(bits(soft.payload).mean()), 6),
                       "fer_hard": round(float(
                           1 - hard.valid.double().mean()), 6),
                       "fer_soft": round(float(
                           1 - soft.valid.double().mean()), 6)}
            else:
                m = link_metrics(res.constellation, mod,
                                 ref_bytes=payload,
                                 decoded_bytes=res.mac_bytes)
                row = {"mod_type": mod, "snr_db": float(snr), **
                       {k: round(v, 6) for k, v in m.items()}}
            rows.append(row)
            print(json.dumps(row), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    if args.png:
        fig, ax = plt.subplots(figsize=(7, 5))
        for mod in mods:
            name = f"QAM{1 << mod}" if mod > 1 else "BPSK"
            if args.soft:
                for key, style in (("ber_hard", "o--"), ("ber_soft", "s-")):
                    pts = [(r["snr_db"], max(r[key], 1e-7))
                           for r in rows if r["mod_type"] == mod]
                    ax.semilogy(*zip(*pts), style, label=f"{name} {key[4:]}")
            else:
                pts = [(r["snr_db"], max(r["ber"], 1e-7))
                       for r in rows if r["mod_type"] == mod]
                ax.semilogy(*zip(*pts), "o-", label=name)
        ax.set_xlabel("SNR (dB)")
        ax.set_ylabel("BER")
        ax.grid(True, which="both", alpha=0.3)
        ax.legend()
        fig.tight_layout()
        fig.savefig(args.png, dpi=110)
        print(f"wrote {args.png}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
