"""Time synchronization: two-tone coarse detect + preamble matched filter
(counterpart of ``c_ofdm_tpu/ops/sync.py``).

The reference scans serially with early exit (`OFDM/Frame.hpp:150-197`,
`OFDM/Frame.cpp:338-378`); here dense tracks are computed for every row of a
batch at once and reduced with a first-hit argmax, which reproduces the
serial first-hit semantics exactly.  The detector projects each 256-sample
block onto only the masked bins (a skinny partial-DFT product) and takes the
total energy from Parseval in the time domain.  The streaming receiver adds
the 50%-overlap hop track, the FFT and overlap-save branches of
``matched_filter_scores`` (``torch.fft``) and the sliding-window sidelobe
suppression.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fft as fftops

# chunk length of the overlap-save matched filter (long captures)
OVERLAP_SAVE_LEN = 4096

# crossings below this fraction of the search window's best score are
# ignored in peak_refine mode (pilot-lattice sidelobes reach ~0.75x the true
# preamble peak at high pilot power fractions)
SIDELOBE_SUPPRESS = 0.85
# local refinement radius of first_above_peak at the stock geometry
PEAK_REFINE_RADIUS = 2


def _t2_masked_bins(t2_mask: np.ndarray):
    """Bins with nonzero detect-mask weight and their weights."""
    bins = np.nonzero(t2_mask)[0]
    return bins, t2_mask[bins]


def _t2_basis_np(t2_mask: np.ndarray) -> np.ndarray:
    """Partial DFT basis onto the masked bins: [t2sin_size, nbins]."""
    bins, _ = _t2_masked_bins(t2_mask)
    return fftops.dft_rows(t2_mask.shape[0], bins).T


def t2_ratio_track(spec, capture: torch.Tensor,
                   backend: str = "partial") -> torch.Tensor:
    """Per-block masked/total energy ratio.  capture [..., n]; blocks are
    aligned to the start of the last axis.  Returns [..., n // t2sin_size].

    backend "partial": partial DFT onto the masked bins + Parseval (fast).
    backend "fft":     full per-block FFT (the reference's own track)."""
    if backend not in ("partial", "fft"):
        raise ValueError(f"t2_ratio_track backend must be 'partial' or "
                         f"'fft', got {backend!r}")
    size = spec.cfg.t2sin_size
    nblk = capture.shape[-1] // size
    blocks = capture[..., : nblk * size].reshape(*capture.shape[:-1], nblk, size)
    if backend == "fft":
        e = fftops.fft_fwd(blocks).abs() ** 2
        total = e.sum(-1)
        masked = (e * spec.tensors["t2_mask"].to(e.dtype)).sum(-1)
    else:
        s = fftops.complex_matmul(blocks, spec.tensors["t2_basis"])
        e = s.abs() ** 2
        masked = (e * spec.tensors["t2_weights"]).sum(-1)
        # Parseval: sum_k |X_k|^2 == N * sum_n |x_n|^2 for the unnormalized
        # DFT
        total = size * (blocks.abs() ** 2).sum(-1)
    return torch.where(total > 0, masked / torch.clamp(total, min=1e-30), 0.0)


def _t2_hop_np(t2_mask: np.ndarray):
    """The hop track's constants: the truncated half-block basis
    [t2sin_size/2, nbins] (first half of the full-window basis) and the
    half-period phase (-1)^b of each masked bin b."""
    bins, _ = _t2_masked_bins(t2_mask)
    size = t2_mask.shape[0]
    w = fftops.dft_rows(size, bins)[:, :size // 2].T
    return w, np.where(bins % 2, -1.0, 1.0)


def t2_ratio_track_hop(spec, capture: torch.Tensor) -> torch.Tensor:
    """Per-window masked/total energy ratio at 50% window overlap
    (hop = t2sin_size/2).  capture [..., n] -> [..., nwin], window w starts
    at sample w*hop.  With 50% overlap some window always covers >= 3/4 of a
    burst, whatever its alignment to the blocks.

    Fused half-block form: each HALF-block h is projected onto the masked
    bins with the truncated basis, A_h[b] = sum_{m<hop} x[h*hop+m]
    e^{-2 pi i b m / size}; the second half of window w contributes with the
    half-period phase (-1)^b, so S_w[b] = A_w[b] + (-1)^b A_{w+1}[b] exactly.
    Parseval totals come from per-half-block energies the same way."""
    size = spec.cfg.t2sin_size
    hop = size // 2
    nh = capture.shape[-1] // hop
    halves = capture[..., : nh * hop].reshape(*capture.shape[:-1], nh, hop)
    w = spec.tensors["t2_hop_basis"]
    sgn = spec.tensors["t2_hop_sign"]
    xr, xi = halves.real, halves.imag
    ar = xr @ w[0] - xi @ w[1]
    ai = xr @ w[1] + xi @ w[0]                       # A_h [..., nh, nbins]
    sr = ar[..., :-1, :] + sgn * ar[..., 1:, :]
    si = ai[..., :-1, :] + sgn * ai[..., 1:, :]      # S_w [..., nh-1, nbins]
    e = sr * sr + si * si
    masked = (e * spec.tensors["t2_weights"]).sum(-1)
    h = (xr * xr + xi * xi).sum(-1)                  # [..., nh]
    total = size * (h[..., :-1] + h[..., 1:])
    return torch.where(total > 0, masked / torch.clamp(total, min=1e-30), 0.0)


def first_above(track: torch.Tensor, level: float):
    """First index along the last axis where track > level; (-1, False) if
    none.  Replicates the serial early-exit semantics of the reference."""
    hit = track > level
    # argmax refuses bool; it returns the FIRST maximal index
    idx = torch.argmax(hit.to(torch.uint8), dim=-1)
    found = hit.any(dim=-1)
    return torch.where(found, idx, -1), found


def peak_radius(cfg) -> int:
    """Geometry-aware refinement radius: a band occupying 1/os of the FFT
    widens the matched-filter peak ~os-fold.  The classic radius 2 at the
    stock geometry."""
    occ = cfg.num_data_subc + cfg.num_pilot_subc + 2
    return max(PEAK_REFINE_RADIUS, round(cfg.fft_size / occ))


def suppress_sidelobes(track: torch.Tensor) -> torch.Tensor:
    """Zero every lag scoring below SIDELOBE_SUPPRESS x the window max."""
    tmax = track.amax(dim=-1, keepdim=True)
    return torch.where(track >= SIDELOBE_SUPPRESS * tmax, track, 0.0)


def _shift_left(t: torch.Tensor, s: int) -> torch.Tensor:
    if s == 0:
        return t
    pad = torch.full((*t.shape[:-1], s), -torch.inf, dtype=t.dtype,
                     device=t.device)
    return torch.cat([t[..., s:], pad], dim=-1)


def sliding_max(track: torch.Tensor, radius: int) -> torch.Tensor:
    """max over [i-radius, i+radius] along the last axis in O(n log radius):
    sparse-table doubling, then two overlapping power-of-two windows."""
    w = 2 * radius + 1
    lead = track.shape[:-1]
    padded = torch.cat([torch.full((*lead, radius), -torch.inf,
                                   dtype=track.dtype, device=track.device),
                        track], dim=-1)
    k = max(w.bit_length() - 1, 0)          # largest 2^k <= w
    m = padded
    for j in range(k):
        m = torch.maximum(m, _shift_left(m, 1 << j))
    m = torch.maximum(m, _shift_left(m, w - (1 << k)))
    return m[..., :track.shape[-1]]


def suppress_sidelobes_local(track: torch.Tensor, radius: int) -> torch.Tensor:
    """Windowed ``suppress_sidelobes`` for dense full-ring tracks: zero lags
    scoring below SIDELOBE_SUPPRESS x the local maximum within ``radius``
    lags, so one strong frame cannot suppress a weaker frame's crossing
    (true neighbouring peaks are >= frame_len > message_len apart)."""
    return torch.where(track >= SIDELOBE_SUPPRESS * sliding_max(track, radius),
                       track, 0.0)


def refine_to_peak(track: torch.Tensor, idx: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """argmax of ``track`` over lags [idx, idx+radius] (clipped to the
    track); idx [...] indexes the last axis of track [..., n]."""
    c = torch.clamp(idx, min=0)
    n = track.shape[-1]
    lags = torch.clamp(c[..., None] + torch.arange(radius + 1, device=c.device),
                       max=n - 1)
    vals = torch.gather(track, -1, lags)
    return c + torch.argmax(vals, dim=-1)


def first_above_peak(track: torch.Tensor, level: float,
                     radius: int = PEAK_REFINE_RADIUS):
    """First threshold crossing, refined to the local score peak within
    ``radius`` lags: returns (peak_idx, found), (-1, False) if none.  Engaged
    by ``ModemConfig.peak_refine`` (auto: pr_level > 0.55); at the stock
    threshold the reference's crossing + 1 is kept instead."""
    idx, found = first_above(track, level)
    return torch.where(found, refine_to_peak(track, idx, radius), idx), found


def find_t2sin(spec, capture: torch.Tensor, start=0,
               backend: str = "partial"):
    """Sample index of the first detected block at/after ``start`` (blocks
    aligned to ``start``), or -1, with the trailing partial block dropped
    (`T2SIN_FORM::find_t2sin`, `OFDM/Frame.hpp:150-197`).  capture [..., n];
    ``start`` an int or an integer tensor broadcasting over the leading dims
    (one start per row) -> (t2_begin [...], found [...]).  Blocks that would
    run past the end of the capture are invalid."""
    size = spec.cfg.t2sin_size
    n = capture.shape[-1]
    level = spec.cfg.t2_sin_level
    if isinstance(start, int) and start == 0:
        # the receivers' case: every block lies inside the capture
        idx, found = first_above(t2_ratio_track(spec, capture, backend), level)
        return torch.where(found, idx * size, -1), found
    # the capture from the start clamped to [0, n], zero-padded to n samples
    # (the JAX package's jax_dynamic_window); blocks that reach into the
    # padding are invalid
    if isinstance(start, int):
        s = min(max(start, 0), n)
        shifted = torch.nn.functional.pad(capture[..., s:], (0, s))
        room = n - start
    else:
        shifted = window_rows(capture, torch.clamp(start, 0, n), n)
        room = (n - start)[..., None]
    track = t2_ratio_track(spec, shifted, backend)
    ends = (torch.arange(track.shape[-1], device=track.device) + 1) * size
    idx, found = first_above(torch.where(ends <= room, track, 0.0), level)
    return torch.where(found, idx * size + start, -1), found


def _toeplitz_mf_np(mf: np.ndarray, L: int) -> np.ndarray:
    """Banded-Toeplitz correlation operator for one L-lag chunk, [2L, L]:
    T[i, l] = mf[i-l] for 0 <= i-l < L, so (window @ T)[l] = sum_j
    w[l+j]*mf[j].  The stored filter is already conjugated."""
    mf = np.asarray(mf, dtype=np.complex128)
    T = np.zeros((2 * L, L), dtype=np.complex128)
    i = np.arange(2 * L)[:, None]
    lag = np.arange(L)[None, :]
    d = i - lag
    band = (d >= 0) & (d < L)
    T[band] = mf[d[band]]
    return T


def _corr_toeplitz(spec, x: torch.Tensor) -> torch.Tensor:
    """|correlation| with the matched filter at every lag of x [..., n],
    L lags at a time against the constant [2L, L] band."""
    n = x.shape[-1]
    L = spec.cfg.pr_sin_len
    nchunks = -(-n // L)
    xp = torch.nn.functional.pad(x, (0, nchunks * L + L - n))
    win = xp.unfold(-1, 2 * L, L)                      # [..., nchunks, 2L]
    band = spec.tensors["mf_band"]
    xr, xi = win.real, win.imag
    yr = xr @ band[0] - xi @ band[1]
    yi = xr @ band[1] + xi @ band[0]
    mag = torch.sqrt(yr * yr + yi * yi)                # [..., nchunks, L]
    return mag.reshape(*x.shape[:-1], nchunks * L)[..., :n]


def _next_pow2(n: int) -> int:
    return 1 << int(np.ceil(np.log2(n)))


def _mf_spectrum_np(mf: np.ndarray, m: int) -> np.ndarray:
    """conj(fft(conj(mf zero-padded to m))): the m-point spectrum that turns
    a circular convolution into the correlation with the stored filter
    (already conjugated, Frame.cpp:285-294)."""
    mf_pad = np.zeros(m, dtype=np.complex128)
    mf_pad[:mf.shape[0]] = mf
    return np.conj(np.fft.fft(np.conj(mf_pad)))


def mf_spectrum_key(m: int) -> str:
    """The ``FrameSpec.tensors`` entry holding the m-point spectrum: m is
    4096 (the overlap-save chunk, also the single-FFT size up to n + L =
    4096) or 8192, the only two sizes ``matched_filter_scores`` takes."""
    return "mf_fft_os" if m == OVERLAP_SAVE_LEN else f"mf_fft_{m}"


def _corr_fft(x: torch.Tensor, mf_f: torch.Tensor, m: int) -> torch.Tensor:
    """Circular correlation of x[..., m_or_less] with the matched filter via
    an m-point FFT pair, given the filter's spectrum ``mf_f`` [m]."""
    return torch.fft.ifft(torch.fft.fft(x, n=m) * mf_f)


def matched_filter_scores(spec, x: torch.Tensor) -> torch.Tensor:
    """Normalized matched-filter score at every lag of x [..., n] -> [..., n]:
    score[i] = |sum_j x[i+j] * mf[j]| / sqrt(sum_j |x[i+j]|^2), the statistic
    of `PREAMBLE_FORM::find_preamble` (`OFDM/Frame.cpp:338-378`).  Lags whose
    window energy is <= 1 or whose window runs past the end score 0.

    Three branches, as in the JAX package: the banded-Toeplitz product for
    short windows (n <= 2048), one FFT pair for m = next_pow2(n + L) <= 8192,
    and 4096-point overlap-save chunks beyond that (``torch.fft``)."""
    n = x.shape[-1]
    L = spec.cfg.pr_sin_len
    m = _next_pow2(n + L)
    if n <= 2048:
        corr = _corr_toeplitz(spec, x)
    elif m <= 8192:
        corr = _corr_fft(x, spec.tensors[mf_spectrum_key(m)],
                         m)[..., :n].abs()
    else:
        C = OVERLAP_SAVE_LEN
        hop = C - L + 1
        nchunks = -(-n // hop)
        xp = torch.nn.functional.pad(x, (0, nchunks * hop + L - n))
        chunks = xp.unfold(-1, C, hop)                 # [..., nchunks, C]
        cc = _corr_fft(chunks, spec.tensors["mf_fft_os"], C)[..., :hop]
        corr = cc.reshape(*x.shape[:-1], nchunks * hop)[..., :n].abs()
    e = x.abs() ** 2
    ce = torch.nn.functional.pad(torch.cumsum(e, dim=-1), (1, 0))
    norm = ce[..., L:] - ce[..., : n + 1 - L]          # [..., n+1-L]
    norm = torch.nn.functional.pad(norm, (0, L - 1))[..., :n]
    return torch.where(norm > 1.0,
                       corr / torch.sqrt(torch.clamp(norm, min=1e-30)), 0.0)


def window_rows(x: torch.Tensor, start: torch.Tensor,
                length: int) -> torch.Tensor:
    """x [..., n], start [...] (>= 0, broadcasting over x's leading dims)
    -> [..., length] with out[..., j] = x[..., start + j], zero where
    start + j runs past the end."""
    n = x.shape[-1]
    idx = start[..., None] + torch.arange(length, device=x.device)
    idx = idx.expand(*x.shape[:-1], length)
    past = idx >= n
    out = torch.gather(x, -1, torch.clamp(idx, max=n - 1))
    return out.masked_fill(past, 0)


def preamble_corr_track(spec, capture: torch.Tensor,
                        start: torch.Tensor) -> torch.Tensor:
    """Normalized matched-filter correlation at lags [start, start +
    sync_window) of each row: capture [B, n], start [B] -> [B, sync_window].
    Positions whose window energy is <= 1 score 0 (`Frame.cpp:357-364`).

    ``start`` is a multiple of t2sin_size, as the two-tone detector gives
    it from a block-aligned capture start (the JAX package reads its window
    from the block that holds any other start; ``models.rx.synchronize``
    reproduces that)."""
    L = spec.cfg.pr_sin_len
    W = spec.cfg.sync_window
    region = window_rows(capture, start, W + L)
    return matched_filter_scores(spec, region)[..., :W]


def find_preamble(spec, capture: torch.Tensor, start: torch.Tensor):
    """First lag over pr_level, or -10 (`PREAMBLE_FORM::find_preamble`,
    `OFDM/Frame.cpp:338-378`).  Returns (position [B], found [B])."""
    track = preamble_corr_track(spec, capture, start)
    idx, found = first_above(track, spec.cfg.pr_level)
    return torch.where(found, idx + start, -10), found


def find_preamble_peak(spec, capture: torch.Tensor, start: torch.Tensor):
    """Like ``find_preamble`` but returns the local correlation PEAK at/after
    the first crossing, with crossings below SIDELOBE_SUPPRESS x the window's
    best score suppressed.  The caller must NOT re-apply the +1 quirk."""
    track = preamble_corr_track(spec, capture, start)
    idx, found = first_above_peak(suppress_sidelobes(track),
                                  spec.cfg.pr_level,
                                  radius=peak_radius(spec.cfg))
    return torch.where(found, idx + start, -10), found
