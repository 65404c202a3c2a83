"""K4 (``ops/dft.py::dft``, every route): its bound over its kernel time a
call, in percent.  A batch receive transforms every symbol of every row
once: rows x (num_pr_symb + num_symb) DFTs of n = fft_size points.  One
formula counts a DFT's work whatever route runs it: bytes = 2 x DFTs x n x
8 (complex64 in and out), FLOPs = 5 n log2(n) a DFT."""

import math

from portbench import peaks


def work(dfts: int, n: int) -> tuple:
    return 2 * dfts * n * 8, 5.0 * n * math.log2(n) * dfts


def read(rec):
    cfg, mix = rec["cfg"], rec["mix"]
    dfts = (mix["frames"] + mix["zero_rows"]) * (cfg.num_pr_symb + cfg.num_symb)
    s = peaks.kernel_seconds(rec, lambda n: peaks.named(n, peaks.K4_KERNELS))
    return peaks.roofline_pct(*work(dfts, cfg.fft_size), s)
