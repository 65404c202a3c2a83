"""The plain float64 model of the C-OFDM signal chain, one frame at a time.

A frozen copy of the TX chain and of the RX chain at a known frame start
from the port's ``oracle/reference.py`` (itself a copy of the JAX package's
oracle), which restates the reference modem's algorithms in numpy (cited per
function).  It imports nothing of the program.  ``traffic/`` and
``reference/receiver.py`` are its batched forms; ``tests/`` hold them to
these functions.

One departure from the C++ reference, stated by the configuration and kept
here so that the reference computes what the configuration asks for:
``pilot_freq_shift`` applies ``cfo_outlier_bins``.
"""

from __future__ import annotations

import numpy as np

from .config import ModemConfig
from .mt19937 import uniform_bytes


def subcarrier_maps(cfg: ModemConfig):
    """Pilot bins and data bins (in segment order) of one OFDM symbol.

    Layout: DC null; below-DC half has ``num_pilot_subc/2`` segments of
    ``segment_size`` data bins each followed by their pilot; the mirrored upper
    half has pilot first then segment; mid-band guard is null.
    """
    half = cfg.num_pilot_subc // 2
    pilots, data_bins = [], []
    pos = 1 + cfg.segment_size
    for _ in range(half):
        pilots.append(pos)
        data_bins.extend(range(pos - cfg.segment_size, pos))
        pos += cfg.segment_step
    pos = cfg.fft_size - cfg.segment_step * half
    for _ in range(half, cfg.num_pilot_subc):
        pilots.append(pos)
        data_bins.extend(range(pos + 1, pos + 1 + cfg.segment_size))
        pos += cfg.segment_step
    return np.asarray(pilots, dtype=np.int64), np.asarray(data_bins, dtype=np.int64)



def constellation(mod_type: int) -> np.ndarray:
    """BPSK diagonal (`modulation.cpp:28-30`) or square QAM (`modulation.cpp:12-20`),
    non-Gray, row-major (imag from high bits, real from low bits).

    QAM is peak-normalized: the corner symbol has |x| = 1, i.e. per-axis
    levels {±1/(side-1), ...}/sqrt(2) — verified against the committed
    `source.bin` message spectrum (data corner axis = pilot_ampl/(2.5*sqrt2))
    and `constell.bin` (points at ±0.707/±0.236).  BPSK (unit diagonal) is
    already peak-normalized."""
    if mod_type == 1:
        return np.exp(1j * (np.pi * np.arange(2) + 5 * np.pi / 4))
    side = 1 << (mod_type // 2)
    idx = np.arange(1 << mod_type)
    re = 2.0 / (side - 1) * (idx % side) - 1.0
    im = 2.0 / (side - 1) * (idx >> (mod_type // 2)) - 1.0
    return (re + 1j * im) / np.sqrt(2.0)



def bytes_to_symbols(data: np.ndarray, mod_type: int) -> np.ndarray:
    """MSB-first split of bytes into ``mod_type``-bit symbol indices
    (`modulation.cpp:90-125` with output block = mod_type)."""
    bits = np.unpackbits(np.asarray(data, dtype=np.uint8))
    bits = bits[: bits.size - bits.size % mod_type].reshape(-1, mod_type)
    weights = 1 << np.arange(mod_type - 1, -1, -1)
    return (bits * weights).sum(axis=1).astype(np.int64)



def symbols_to_bytes(symbols: np.ndarray, mod_type: int) -> np.ndarray:
    """Inverse of bytes_to_symbols: pack symbol indices MSB-first into bytes."""
    n = len(symbols)
    bits = ((symbols[:, None] >> np.arange(mod_type - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(-1))[: n * mod_type // 8]



def modulate(data: np.ndarray, mod_type: int) -> np.ndarray:
    return constellation(mod_type)[bytes_to_symbols(data, mod_type)]



def hard_demod(points: np.ndarray, mod_type: int) -> np.ndarray:
    """Hard decision (`modulation.cpp:53-87` semantics): clamp, round to the
    peak-normalized grid (see ``constellation``).  The reference's own demod
    rounds on the UNSCALED grid — a latent self-inconsistency that survives
    QAM4/16 (margins) but would misdecode QAM64+; we round on the true TX
    grid instead (SURVEY §5.6: do not replicate latent bugs)."""
    if mod_type == 1:
        return (points.real + points.imag > 0).astype(np.uint8)
    s = 1.0 / np.sqrt(2.0)
    side = 1 << (mod_type // 2)
    inv_step = (side - 1) / (2.0 * s)
    re = np.clip(points.real, -s, s)
    im = np.clip(points.imag, -s, s)
    ire = ((re + s) * inv_step + 0.5).astype(np.int64)
    iim = ((im + s) * inv_step + 0.5).astype(np.int64)
    return (ire | (iim * side)).astype(np.int64)



def demodulate_bytes(points: np.ndarray, mod_type: int) -> np.ndarray:
    sym = hard_demod(points, mod_type)
    if mod_type == 1:
        return np.packbits(sym.astype(np.uint8))
    return symbols_to_bytes(sym, mod_type)



def ofdm_modulate(cfg: ModemConfig, const_points: np.ndarray, num_symb: int) -> np.ndarray:
    """Segment-order data points -> time symbols [num_symb, ofdm_len] incl. CP.

    FFTW backward (unnormalized) then / sqrt(N)  ==  sqrt(N) * numpy ifft.
    """
    pilots, data_bins = subcarrier_maps(cfg)
    freq = np.zeros((num_symb, cfg.fft_size), dtype=np.complex128)
    freq[:, pilots] = cfg.pilot_ampl
    freq[:, data_bins] = const_points.reshape(num_symb, cfg.num_data_subc)
    time = np.fft.ifft(freq, axis=-1) * np.sqrt(cfg.fft_size)
    return np.concatenate([time[:, -cfg.cp_size:], time], axis=-1)



def ofdm_demodulate(cfg: ModemConfig, time_syms: np.ndarray) -> np.ndarray:
    """CP-stripped time symbols [n, fft] -> equalized segment-order data points.

    Pilot amplitude normalization + per-segment phase equalization against the
    same pilot in symbol 0 (`Frame.cpp:73-96`).
    """
    pilots, data_bins = subcarrier_maps(cfg)
    n = time_syms.shape[0]
    freq = np.fft.fft(time_syms, axis=-1)
    pil = freq[:, pilots]
    phys = np.abs(pil).mean() / cfg.pilot_ampl
    freq = freq / phys
    pil = freq[:, pilots]
    coef = pil / pil[0:1, :]
    data = freq[:, data_bins].reshape(n, cfg.num_pilot_subc, cfg.segment_size)
    return (data / coef[:, :, None]).reshape(-1)



def preamble_bytes(cfg: ModemConfig) -> np.ndarray:
    return uniform_bytes(cfg.pr_seed, cfg.preamble_bytes)



def preamble_points(cfg: ModemConfig) -> np.ndarray:
    return modulate(preamble_bytes(cfg), 1)



def preamble_time(cfg: ModemConfig) -> np.ndarray:
    """The known preamble OFDM symbol(s) incl CP (reference ofdm_preamble)."""
    return ofdm_modulate(cfg, preamble_points(cfg), cfg.num_pr_symb).reshape(-1)



def t2sin_burst(cfg: ModemConfig) -> np.ndarray:
    """Two 0.5-amplitude tones through an *unnormalized* inverse FFT
    (`Frame.cpp:139-154`: FFTW backward with no scaling)."""
    freq = np.zeros(cfg.t2sin_size, dtype=np.complex128)
    freq[cfg.t2_sin_f1] = 0.5
    freq[cfg.t2_sin_f2] = 0.5
    return np.fft.ifft(freq) * cfg.t2sin_size



def tx_frame(cfg: ModemConfig, mac_frame_bytes: np.ndarray) -> np.ndarray:
    """MAC frame bytes -> one frame of complex IQ [frame_len]."""
    msg = ofdm_modulate(cfg, modulate(mac_frame_bytes, cfg.mod_type),
                        cfg.num_symb).reshape(-1)
    return np.concatenate([t2sin_burst(cfg), preamble_time(cfg), msg])



def to_int16(cfg: ModemConfig, iq: np.ndarray) -> np.ndarray:
    """C++ double->int16 conversion truncates toward zero (`Frame.cpp:249-256`)."""
    return (np.trunc(iq.real * cfg.mult) + 1j * np.trunc(iq.imag * cfg.mult))



def pilot_freq_shift(cfg: ModemConfig, preamble_sig: np.ndarray) -> float:
    """Coarse CFO from fftshifted preamble spectrum pilot-window argmaxes
    (`Frame.hpp:285-337`; the reference's out-of-bounds border write at
    `Frame.hpp:322` is replaced by clamping the true last border).  With
    ``cfg.cfo_outlier_bins`` > 0 a window whose peak lies more than that
    many bins from the median window's offset takes the median offset
    instead: the rule the configuration states (``ModemConfig``'s
    ``cfo_outlier_bins``), beyond the C++ reference."""
    size = cfg.preamble_len
    amp = np.abs(np.fft.fftshift(np.fft.fft(preamble_sig[:size])))
    rel_bw = (cfg.num_data_subc + cfg.num_pilot_subc) / cfg.fft_size
    rel_pw = rel_bw / cfg.num_pilot_subc
    pw = int(size * rel_pw)
    j0 = int((1.0 - rel_bw - rel_pw) / 2.0 * size)
    borders = j0 + pw * np.arange(cfg.num_pilot_subc + 2)
    borders[0] = max(0, borders[0])
    borders[-1] = min(size, borders[-1])
    used = [i for i in range(cfg.num_pilot_subc + 1)
            if i != cfg.num_pilot_subc // 2]
    lo = borders[used]
    delta = np.array([np.argmax(amp[borders[i]:borders[i + 1]]) for i in used])
    if cfg.cfo_outlier_bins > 0:
        med = np.sort(delta)[delta.size // 2]
        delta = np.where(np.abs(delta - med) <= cfg.cfo_outlier_bins,
                         delta, med)
    shift = (lo + delta).sum() / cfg.num_pilot_subc
    shift -= size / 2
    return shift / size


def apply_freq_shift(sig: np.ndarray, shift: float) -> np.ndarray:
    """Derotate by e^{-2πi·shift·n} (`Frame.hpp:340-348`)."""
    return sig * np.exp(-2j * np.pi * shift * np.arange(sig.size))



def cp_freq_correct(cfg: ModemConfig, sig: np.ndarray) -> np.ndarray:
    """Per-symbol fine CFO from CP<->tail correlation, phase accumulated across
    symbols (`Frame.hpp:238-263`).

    The reference's serial loop is algebraically parallel: the scalar
    accumulated shift cancels in conj products, so every symbol's phase is
    estimable independently; the applied ramp is a cumsum.
    """
    ol, fft, cp = cfg.ofdm_len, cfg.fft_size, cfg.cp_size
    sym = sig.reshape(-1, ol)
    ph = np.angle((np.conj(sym[:, :cp]) * sym[:, fft:]).sum(-1))
    theta = ph / fft
    acc = np.concatenate([[0.0], np.cumsum(theta[:-1] * ol)])
    j = np.arange(ol)
    corr = np.exp(-1j * (acc[:, None] + theta[:, None] * j[None, :]))
    return (sym * corr).reshape(-1)



def common_phase_correct(cfg: ModemConfig, sig: np.ndarray) -> np.ndarray:
    """Common phase vs the known preamble (`Frame.hpp:265-274`)."""
    pre = preamble_time(cfg)
    phase = np.angle((np.conj(pre) * sig[: pre.size]).sum())
    return sig * np.exp(-1j * phase)



def unwrap_one_step(phase: np.ndarray) -> np.ndarray:
    """The reference's non-accumulating unwrap (`Frame.hpp:407-414`): each
    element is shifted by at most ±2π relative to its *corrected* predecessor."""
    out = phase.copy()
    for i in range(1, out.size):
        d = out[i] - out[i - 1]
        if d > np.pi:
            out[i] -= 2 * np.pi
        elif d < -np.pi:
            out[i] += 2 * np.pi
    return out



def chan_est_lq(cfg: ModemConfig, preamble_sig: np.ndarray) -> np.ndarray:
    """Linear-phase least-squares channel estimate (`Frame.hpp:389-434`).

    Reproduces the reference's exact (nonstandard) fit: sums are used where a
    standard LS would use means — self-consistent once the common phase has
    been removed upstream.
    """
    pr = ofdm_demodulate(cfg, preamble_sig.reshape(cfg.num_pr_symb, cfg.ofdm_len)[:, cfg.cp_size:])
    mod_pre = preamble_points(cfg)
    half = cfg.num_data_subc // 2
    phase = unwrap_one_step(np.angle(pr[:half] / mod_pre[:half]))
    i = np.arange(half, dtype=np.float64)
    sx, sy = i.sum(), phase.sum()
    sxy, sxx = (phase * i).sum(), (i * i).sum()
    b = (sxy - sx * sy) / (sxx - sx * sx)
    a = sy - b * sx
    n = cfg.num_data_subc
    k = np.arange(n, dtype=np.float64)
    return np.exp(1j * np.where(k < half, b * k + a, b * (k - n) + a + b * (n - 2 * half)))



def rx_frame(cfg: ModemConfig, frame_sig: np.ndarray):
    """Demodulate one frame given its exact start (frame_sig[0] == frame start,
    i.e. the t2sin burst).  Returns (mac_frame_bytes, constellation,
    chan_est, coarse_cfo)."""
    sig = frame_sig[cfg.t2sin_size:].copy()
    shift = pilot_freq_shift(cfg, sig)
    sig = apply_freq_shift(sig, shift)
    sig = cp_freq_correct(cfg, sig)
    sig = common_phase_correct(cfg, sig)
    chan = chan_est_lq(cfg, sig[: cfg.preamble_len])
    msg = sig[cfg.preamble_len:].reshape(cfg.num_symb, cfg.ofdm_len)[:, cfg.cp_size:]
    const = ofdm_demodulate(cfg, msg)
    const = const / np.tile(chan, cfg.num_symb)
    return demodulate_bytes(const, cfg.mod_type), const, chan, shift


# ---------------------------------------------------------------------------
# single-frame capture sync (reference: T2SIN_FORM::find_t2sin /
# PREAMBLE_FORM::find_preamble, main.cpp:50-58)
# ---------------------------------------------------------------------------

def matched_filter(cfg: ModemConfig) -> np.ndarray:
    """Unit-norm conjugated first pr_sin_len samples (`Frame.cpp:285-294`)."""
    mf = np.conj(preamble_time(cfg)[: cfg.pr_sin_len])
    return mf / np.sqrt((np.abs(mf) ** 2).sum())


def t2_detect_mask(cfg: ModemConfig) -> np.ndarray:
    mask = np.zeros(cfg.t2sin_size)
    for f in (cfg.t2_sin_f1, cfg.t2_sin_f2):
        a = max(0, f - cfg.smooth)
        b = min(cfg.t2sin_size - 1, f + cfg.smooth)
        mask[a:b + 1] += 1.0
    return mask


def t2_ratio_track(cfg: ModemConfig, capture: np.ndarray, start: int = 0) -> np.ndarray:
    """Masked-to-total energy ratio per t2sin_size block, blocks aligned to
    ``start`` (`Frame.hpp:150-197`)."""
    size = cfg.t2sin_size
    nblk = (capture.size - start) // size
    blocks = capture[start:start + nblk * size].reshape(nblk, size)
    spec = np.fft.fft(blocks, axis=-1)
    e = np.abs(spec) ** 2
    total = e.sum(-1)
    masked = (e * t2_detect_mask(cfg)).sum(-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio = np.where(total > 0, masked / total, 0.0)
    return np.nan_to_num(ratio)


def find_t2sin(cfg: ModemConfig, capture: np.ndarray, start: int = 0) -> int:
    ratio = t2_ratio_track(cfg, capture, start)
    hits = np.nonzero(ratio > cfg.t2_sin_level)[0]
    if hits.size == 0:
        return -1
    return int(hits[0]) * cfg.t2sin_size + start


def preamble_corr_track(cfg: ModemConfig, capture: np.ndarray, start: int) -> np.ndarray:
    """Normalized matched-filter correlation at lags [start, start+sync_window)
    (`Frame.cpp:297-335`).  Positions with window energy <= 1 score 0; lags
    whose window runs past the capture score 0."""
    mf = matched_filter(cfg)
    L = cfg.pr_sin_len
    window = cfg.t2sin_size * 2 + cfg.pr_sin_len
    out = np.zeros(window)
    seg = capture[start:start + window + L - 1]
    n = max(0, min(window, seg.size - L + 1))
    if n == 0:
        return out
    w = np.lib.stride_tricks.sliding_window_view(seg, L)[:n]
    norm = (np.abs(w) ** 2).sum(-1)
    corr = np.abs(w @ mf)
    with np.errstate(invalid="ignore", divide="ignore"):
        out[:n] = np.where(norm > 1.0, corr / np.sqrt(norm), 0.0)
    return out


def find_preamble(cfg: ModemConfig, capture: np.ndarray, start: int) -> int:
    track = preamble_corr_track(cfg, capture, start)
    hits = np.nonzero(track > cfg.pr_level)[0]
    if hits.size == 0:
        return -10
    return int(hits[0]) + start


def sync_capture(cfg: ModemConfig, capture: np.ndarray) -> int:
    """The frame start single-frame sync finds in a capture (`main.cpp:50-58`:
    first two-tone block, preamble search after it, +1), or -1 if it finds
    none.  For configurations whose ``pr_level`` puts the peak refinement in
    effect (> 0.55) the port refines to the local peak instead; the
    benchmark's configurations keep the reference's +1."""
    if cfg.pr_level > 0.55:
        raise NotImplementedError("sync_capture follows the +1 rule only")
    t2 = find_t2sin(cfg, capture, 0)
    if t2 < 0:
        return -1
    pr = find_preamble(cfg, capture, t2) + 1
    if pr < 0:
        return -1
    return pr - cfg.t2sin_size
