"""The hop-track kernel (``ops/sync.py::t2_ratio_track_hop``, the device
function ``t2_hop_track_kernel``): its bound over its kernel time a call,
in percent.  A stream call runs it once over the C rings of the buffer with
the one-frame carry in front (n = frame_len + buffer_len samples, nh = n //
hop half-blocks, hop = t2sin_size / 2): each ring read once, nh - 1 ratios
a ring written once in the real type, and the direct projection's
operations, 8 x rows x nh x hop x nbins, nbins the nonzero bins of the
two-tone detect mask.  None where the program has no such kernel."""

import numpy as np

from portbench import peaks
from portbench.reference import oracle

KERNELS = ("t2_hop_track_kernel",)


def work(cfg, rows: int, itemsize: int = 8) -> tuple:
    """(bytes, FLOPs) of one launch over ``rows`` rings of the config."""
    hop = cfg.t2sin_size // 2
    n = cfg.frame_len + cfg.buffer_len
    nh = n // hop
    nbins = int(np.count_nonzero(oracle.t2_detect_mask(cfg)))
    nbytes = rows * n * itemsize + rows * (nh - 1) * itemsize // 2
    return nbytes, 8 * rows * nh * hop * nbins


def read(rec):
    s = peaks.kernel_seconds(rec, lambda n: peaks.named(n, KERNELS))
    if s is None:
        return None
    itemsize = 16 if rec["config"].get("dtype") == "complex128" else 8
    return peaks.roofline_pct(
        *work(rec["cfg"], max(rec["mix"]["channels"], 1), itemsize), s)
