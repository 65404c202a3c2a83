"""Read the two ends of each cell's soft-value limit: the program's widest
gap to the reference on many seeds, and the control's (the reference in
TF32, ``reference/receiver.py``) on the same frames, in one process so that
the program's set-up is paid once.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 \
        --first-seed <n> [--seconds 2]

Each seed makes its own traffic, serves one lap of it from a fresh state,
then runs a window of ``--seconds`` as ``run.py`` does and prints one JSON
line: the frames due and failed, the program's gap and the control's gap
on the same sampled frames.  A last line gives the largest program gap and
the smallest control gap.  Needs one CUDA card; not part of the benchmark's
runs.
"""

import time

T_PROCESS = time.perf_counter()

import argparse   # noqa: E402
import json       # noqa: E402
import sys        # noqa: E402
from pathlib import Path   # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def calibrate(bench, cell: str, seeds, seconds: float, device: str):
    import torch
    from portbench import harness
    from portbench.reference.config import ModemConfig
    from portbench.traffic import generate

    work = bench.workload(cell)
    conf = bench.config(work["config"])
    mix = bench.mix(work["traffic"])
    cfg = ModemConfig(**conf["modem"])
    cuda = torch.device(device).type == "cuda"
    entry_cls = harness.entry_class(mix["entry"])
    entry = None
    rows_out = []
    for seed in seeds:
        traffic = generate.make(cfg, mix, seed, device)
        if entry is None:
            entry = entry_cls(conf, mix, traffic, device)
        else:
            entry.reset(traffic)
        for i in range(traffic.calls):
            entry.call(i)
        rec = harness.run_window(entry, traffic, seconds, seed, None, 0,
                                 mix["soft_calls"], cuda)
        rows = harness.soft_rows(entry, rec["sample"], seed,
                                 mix["soft_frames"])
        more_failed, undetected = entry.resolve()
        line = {"cell": cell, "seed": seed, "calls": rec["calls"],
                "due": rec["due"], "failed": rec["failed"] + more_failed,
                "undetected": undetected,
                "frames": len(rows),
                "program_gap": harness.soft_gap(entry_cls, traffic, rows),
                "control_gap": harness.soft_gap(entry_cls, traffic, rows,
                                                control=True)}
        print(json.dumps(line), flush=True)
        rows_out.append(line)
        del traffic, rec, rows
    summary = {"cell": cell, "seeds": len(rows_out),
               "failed": sum(r["failed"] for r in rows_out),
               "program_gap_max": max(r["program_gap"] for r in rows_out),
               "control_gap_min": min(r["control_gap"] for r in rows_out)}
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("portbench calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.Bench.load()
    calibrate(bench, args.workload,
              [args.first_seed + 7919 * k for k in range(args.seeds)],
              args.seconds, "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
