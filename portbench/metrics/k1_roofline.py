"""K1 (``ops/extract.py::extract_windows``): its bound over its kernel time
a call, in percent.  A batch call gathers each row's post-burst span
(preamble + message samples, complex64) once: bytes = 2 x rows x span x 8,
no FLOPs.  PERF.md's fixed point: [256, 6016] rows -> 5760 samples is
7.043 us."""

from portbench import peaks


def bytes_per_call(rows: int, span: int, itemsize: int = 8) -> int:
    return 2 * rows * span * itemsize


def read(rec):
    cfg, mix = rec["cfg"], rec["mix"]
    rows = mix["frames"] + mix["zero_rows"]
    span = cfg.preamble_len + cfg.message_len
    s = peaks.kernel_seconds(rec, lambda n: peaks.named(
        n, peaks.EXTRACT_KERNELS))
    return peaks.roofline_pct(bytes_per_call(rows, span), 0.0, s)
