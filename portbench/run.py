"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json`` and the
program (``c_ofdm_tpu_torch``).  Needs as many CUDA cards as the cell's
``chips``: without them it exits 2 and prints no result.  ``--trace 1``
reports the cell's per-layer metrics instead of its end-to-end ones and
writes the profiler's chrome trace to ``portbench_out/<cell>.trace.json``
in the checkout.  The last line of standard output is the result (JSON);
the last lines of standard error give each number the correctness check
compared, beside its limit.
"""

import time

T_PROCESS = time.perf_counter()

import argparse   # noqa: E402
import json       # noqa: E402
import sys        # noqa: E402
from pathlib import Path   # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    from portbench import harness

    bench = harness.Bench.load()
    chips = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA card(s), "
              f"found {have}; no result", file=sys.stderr)
        return 2
    result, lines = harness.run(bench, args.workload, args.seed, args.seconds,
                                bool(args.trace), "cuda", T_PROCESS)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}; no result",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
