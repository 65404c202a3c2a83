"""Live link dashboard — the reference's FIFO dashboards
(`python_code/frame_pipe.py`, `real_time_graph.py`) counterpart: tails the
rxstream metrics jsonl and renders link state (frame rate, CFO track, seq
continuity, CRC health) as terminal output or a refreshing PNG.

Usage:
  python -m c_ofdm_tpu_torch.apps.dashboard --metrics metrics.jsonl [--follow]
  python -m c_ofdm_tpu_torch.apps.dashboard --metrics metrics.jsonl --png live.png

The text output needs only the standard library; ``--png`` needs matplotlib.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _load(path):
    rows = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
    except FileNotFoundError:
        pass
    return rows


def _render_text(rows, out=None):
    out = out or sys.stdout     # read at call time, so redirection works
    if not rows:
        print("no frames yet", file=out)
        return
    n = len(rows)
    crc_ok = sum(r["crc_ok"] for r in rows)
    seqs = [r["seq"] for r in rows]
    gaps = sum(1 for a, b in zip(seqs, seqs[1:]) if b != a + 1)
    cfos = [r["cfo"] for r in rows]
    mean_cfo = sum(cfos) / n
    print(f"frames={n} crc_ok={crc_ok} ({100*crc_ok/max(n,1):.1f}%) "
          f"seq_gaps={gaps} last_seq={seqs[-1]} "
          f"cfo_mean={mean_cfo:+.2e} cfo_last={cfos[-1]:+.2e}", file=out)


def _render_png(rows, path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, axs = plt.subplots(1, 3, figsize=(14, 4))
    if rows:
        seqs = [r["seq"] for r in rows]
        axs[0].plot(seqs, ".-")
        axs[0].set_title("sequence numbers")
        axs[1].plot([r["cfo"] for r in rows], ".-")
        axs[1].set_title("CFO per frame")
        axs[2].plot([int(r["crc_ok"]) for r in rows], ".")
        axs[2].set_ylim(-0.1, 1.1)
        axs[2].set_title("CRC ok")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--metrics", required=True)
    p.add_argument("--follow", action="store_true")
    p.add_argument("--interval", type=float, default=1.0)
    p.add_argument("--png", default="")
    args = p.parse_args(argv)

    while True:
        rows = _load(args.metrics)
        if args.png:
            _render_png(rows, args.png)
        _render_text(rows)
        if not args.follow:
            break
        time.sleep(args.interval)
    return 0


if __name__ == "__main__":
    sys.exit(main())
