"""The yardstick's fixed numbers and the trace arithmetic the per-layer
metrics share.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): HBM bandwidth and float32 rate outside the tensor cores (the port's
products run in full float32).  A kernel's bound is the larger of its
function's bytes over the bandwidth and its FLOPs over the rate, counting
each input byte read once and each output byte written once.
"""

from __future__ import annotations

import re

HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12

# the port's kernels by the names of their device functions in csrc/*.cu;
# each name must not be preceded by a letter or "_" ("fft_kernel" is not
# "mixed_fft_kernel")
EXTRACT_KERNELS = ("extract_wide_kernel", "extract_scalar_kernel")
K4_KERNELS = ("fft_kernel", "mixed_fft_kernel", "cluster_fft_kernel",
              "fourstep_", "bluestein_kernel", "chirp_", "dft_kernel")


def named(name: str, names) -> bool:
    return any(re.search(rf"(?<![A-Za-z_]){n}", name) for n in names)


def kernel_seconds(rec: dict, match) -> float | None:
    """Seconds a profiled call spent in the device kernels ``match(name)``
    takes, or None without a trace or without such kernels."""
    trace = rec.get("trace")
    if not trace or not trace["steps"]:
        return None
    total = sum(s for n, s in trace["kernels"].items() if match(n))
    return total / trace["steps"] if total > 0 else None


def bound_seconds(nbytes: float, flops: float = 0.0) -> tuple:
    """(least seconds the card could take, "bytes" or "flops": which binds)."""
    tb, tf = nbytes / HBM_BYTES_S, flops / FP32_FLOP_S
    return (tb, "bytes") if tb >= tf else (tf, "flops")


def roofline_pct(nbytes: float, flops: float, seconds: float | None):
    """100 x bound / kernel time, or None where no kernel time was read."""
    if not seconds:
        return None
    return 100.0 * bound_seconds(nbytes, flops)[0] / seconds


def load_read(path) -> callable:
    """The ``read`` function of the metric file at ``path``."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{Path(path).stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def reader(name: str) -> callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    from pathlib import Path
    return load_read(Path(__file__).resolve().parent / "metrics"
                     / f"{name}.py")
