"""K3 (``ops/extract.py::extract_windows_multi``): its bound over its kernel
time a call, in percent.  A stream call over C channels launches it twice:
the gated sync's K candidate regions of G + L samples a channel (K =
rx_buf_size + 1 + t2_gate_slack, G the gated search lags, L = pr_sin_len),
then the rx_buf_size + 1 frame spans (preamble + message) a channel,
complex64.  Every window is written once.  What must be read depends on
the data: slots with no frame, and regions with no candidate, all read the
ring's first samples again, and regions overlap the spans of their frames.
So the reads counted are the spans of the frames due in the call, which
are disjoint; that is the least the call must read."""

from portbench import peaks


def gated_search_lags(cfg) -> int:
    raw = 2 * cfg.t2sin_size + cfg.t2sin_size // 2 + cfg.pr_sin_len
    return -(-raw // 128) * 128


def bytes_per_call(cfg, channels: int, frames_due: float,
                   itemsize: int = 8) -> float:
    slots = cfg.rx_buf_size + 1
    span = cfg.preamble_len + cfg.message_len
    regions = (slots + cfg.t2_gate_slack) * (gated_search_lags(cfg)
                                             + cfg.pr_sin_len)
    written = channels * (regions + slots * span)
    return (written + frames_due * span) * itemsize


def read(rec):
    cfg = rec["cfg"]
    s = peaks.kernel_seconds(rec, lambda n: peaks.named(
        n, peaks.EXTRACT_KERNELS))
    if not rec["calls"]:
        return None
    due = rec["due"] / rec["calls"]
    return peaks.roofline_pct(
        bytes_per_call(cfg, max(rec["mix"]["channels"], 1), due), 0.0, s)
