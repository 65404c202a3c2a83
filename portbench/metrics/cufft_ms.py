"""Device milliseconds a call in cuFFT's kernels (torch.fft: the matched
filter's overlap-save chunks, the coarse CFO's preamble spectrum), from the
trace.  K4's kernels also carry "fft" in their names and are left out."""

import re

from portbench import peaks


def _cufft(name):
    return (re.search("fft|radix", name, re.IGNORECASE) is not None
            and not peaks.named(name, peaks.K4_KERNELS))


def read(rec):
    s = peaks.kernel_seconds(rec, _cufft)
    return None if s is None else 1e3 * s
