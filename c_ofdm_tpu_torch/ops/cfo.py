"""Carrier-frequency-offset and phase recovery, batch-vectorized
(counterpart of ``c_ofdm_tpu/ops/cfo.py``).

Four estimators in the reference RX order (`main.cpp:60-63`): coarse pilot
CFO -> derotation -> per-symbol CP fine CFO -> common phase.  The receiver
runs them fused (``recover_fused``); the sequential stages are kept as the
reference the fused form is tested against.

Shapes: ``sig`` is [..., n] with leading batch dims; all returns broadcast.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..io import trace
from . import fft as fftops
from .modulation import real_dtype


def _cfo_window_segments(borders: np.ndarray, window_mask: np.ndarray):
    """[(lo, hi)) fftshifted-spectrum ranges actually searched for peaks."""
    return [(int(borders[i]), int(borders[i + 1]))
            for i in range(len(window_mask)) if window_mask[i]]


def cfo_basis(preamble_len: int, segments, device,
              rdt: torch.dtype) -> torch.Tensor:
    """Partial DFT basis onto the inspected bins of the preamble spectrum:
    fftshifted index j reads unshifted bin (j + ceil(size/2)) % size.
    [2, preamble_len, n_inspected] (``fft.dft_basis``)."""
    shifted = np.concatenate([np.arange(lo, hi) for lo, hi in segments])
    rows = (shifted + (preamble_len + 1) // 2) % preamble_len
    return fftops.dft_basis(preamble_len, rows, transpose=True,
                            device=device, rdt=rdt)


def cfo_window_index(segments, preamble_len: int,
                     partial: bool) -> np.ndarray:
    """[n_windows, w_max] int64: row i holds the bins of window i of
    ``segments`` as columns of the spectrum ``pilot_freq_shift`` makes:
    the partial product's concatenated windows where ``partial``, else the
    unshifted FFT, in which fftshifted bin j is bin (j + ceil(size/2)) %
    size.  A window narrower than w_max repeats its first bin: a repeat of
    position 0 never wins argmax's first maximum, so no mask is needed."""
    w_max = max(hi - lo for lo, hi in segments)
    rows = []
    off = 0
    for lo, hi in segments:
        cols = np.arange(off, off + hi - lo) if partial else np.arange(lo, hi)
        rows.append(np.concatenate([cols, np.full(w_max - len(cols),
                                                  cols[0])]))
        off += hi - lo
    idx = np.stack(rows).astype(np.int64)
    return idx if partial else (idx + (preamble_len + 1) // 2) % preamble_len


# how many times slower than the partial product, per FLOP, the preamble's
# whole FFT runs at the coarse CFO's shapes: the product is taken while its
# 8·n·m FLOPs a row stay under FFT_SLOWDOWN times the FFT's 5·n·log2(n).
# Measured on an H100 (PERF.md §6) at 68 rows: 28-69 at preambles of
# 640-18432 points, 69 the highest, at 4608.  Every size measured above that
# ratio (125 and up) ran faster on the FFT; the stock 640-point preamble
# (ratio 56) keeps the product, though the FFT ran it 2x faster (PERF.md §7).
FFT_SLOWDOWN = 69


def uses_partial_spectrum(backend: str, preamble_len: int, bins: int) -> bool:
    """Whether ``pilot_freq_shift`` projects the preamble onto its ``bins``
    inspected bins (the spec then holds ``cfo_basis``) rather than
    transforming the whole preamble: only while the product's work,
    8·preamble_len·bins FLOPs a row, stays under ``FFT_SLOWDOWN`` times the
    FFT's 5·preamble_len·log2(preamble_len).  The stock geometry's 328 bins
    of a 640-point preamble take the product; DVB-T2 16K's 15552 of 18432
    take the FFT.  Besides, ``xla`` and ``ct*`` always take the FFT, as the
    JAX package's estimator does under them.  Past ``fft.MAX_DEVICE_BASIS_N``
    points every backend takes the FFT: the basis's int32 phase index
    overflows there and the JAX package's partial DFT asserts, so the
    projection has no reference at such sizes."""
    return (backend != "xla" and not backend.startswith("ct")
            and preamble_len <= fftops.MAX_DEVICE_BASIS_N
            and 8 * bins < FFT_SLOWDOWN * 5 * math.log2(preamble_len))


def pilot_freq_shift(spec, preamble_sig: torch.Tensor) -> torch.Tensor:
    """Coarse CFO (cycles/sample) from pilot peaks of the fftshifted preamble
    spectrum (`OFDM/Frame.hpp:285-337`).  preamble_sig [..., preamble_len]
    -> [...].  The spectrum is one full-precision partial-DFT product onto
    only the bins the peak-search windows inspect where the spec holds
    ``cfo_basis`` (``uses_partial_spectrum``), else the full forward FFT
    (``torch.fft``, whatever the spec's backend), left unshifted.  One
    search then serves every window: one gather of the spectrum by the
    spec's constant ``cfo_win_idx`` (``cfo_window_index``) into [...,
    n_windows, w_max], its magnitude, and one argmax, which returns the
    first maximum, as jnp.argmax does.  The recorder's ``cfo_windows``
    counts the windows searched (rows x windows), and ``cfo_bins`` the
    spectrum's bins made (rows x the basis's columns on the partial
    product, rows x preamble_len on the FFT)."""
    size = spec.cfg.preamble_len
    x = preamble_sig[..., :size]
    basis = spec.tensors.get("cfo_basis")
    if basis is not None:
        full = fftops.complex_matmul(x, basis)
    else:
        full = fftops.fft_fwd(x)
    rows = math.prod(x.shape[:-1])
    idx = spec.tensors["cfo_win_idx"]                   # [n_windows, w_max]
    trace.count("cfo_windows", idx.shape[0] * rows)
    trace.count("cfo_bins", full.shape[-1] * rows)
    amp = full.index_select(-1, idx.flatten()).unflatten(-1, idx.shape).abs()
    delta = torch.argmax(amp, dim=-1)       # [..., n_windows]: peak - lo
    tol = spec.cfg.cfo_outlier_bins
    if tol > 0:
        # beyond the reference: replace any per-window offset deviating more
        # than tol bins from the median offset with the median (at low SNR a
        # single window's argmax on a noise bin corrupts the mean).  Clean
        # windows agree within ~2 bins, so nothing is rejected there.
        med = torch.sort(delta, dim=-1).values[..., delta.shape[-1] // 2]
        keep = torch.abs(delta - med[..., None]) <= tol
        delta = torch.where(keep, delta, med[..., None])
    total = (spec.tensors["cfo_lo"] + delta).sum(dim=-1)
    # the reference divides by num_pilot_subc (== number of used windows)
    shift = total.to(amp.dtype) / spec.cfg.num_pilot_subc
    return (shift - size / 2) / size


def apply_freq_shift(sig: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Derotate by e^{-2πi·shift·n} (`OFDM/Frame.hpp:340-348`).
    shift broadcasts over leading dims of sig [..., n]."""
    rdt = sig.real.dtype
    n = torch.arange(sig.shape[-1], dtype=rdt, device=sig.device)
    ang = -2 * np.pi * shift[..., None] * n
    return sig * torch.exp(1j * ang.to(rdt)).to(sig.dtype)


def cp_freq_correct(spec, sig: torch.Tensor) -> torch.Tensor:
    """Per-symbol fine CFO from CP<->tail correlation with cross-symbol phase
    accumulation (`OFDM/Frame.hpp:238-263`): the accumulated scalar shift
    cancels inside each symbol's conj product, so all symbol phases are
    estimated independently and the applied ramp is a cumsum.
    sig [..., nsym*ofdm_len]."""
    ol, fft, cp = spec.cfg.ofdm_len, spec.cfg.fft_size, spec.cfg.cp_size
    lead = sig.shape[:-1]
    nsym = sig.shape[-1] // ol
    sym = sig.reshape(*lead, nsym, ol)
    ph = torch.angle((torch.conj(sym[..., :cp]) * sym[..., fft:]).sum(-1))
    theta = ph / fft                                         # [..., nsym]
    acc = torch.cumsum(theta * ol, dim=-1) - theta * ol      # exclusive cumsum
    j = torch.arange(ol, dtype=ph.dtype, device=sig.device)
    ang = -(acc[..., None] + theta[..., None] * j)
    corr = torch.exp(1j * ang.to(sym.real.dtype)).to(sym.dtype)
    return (sym * corr).reshape(*lead, nsym * ol)


def _pow_ladder(u: torch.Tensor, m: int) -> torch.Tensor:
    """Powers u^0..u^{m-1} along a new trailing axis, built by log2(m)
    doublings (vector multiplies only, no per-element transcendentals)."""
    w = torch.ones_like(u)[..., None]
    p = u[..., None]
    size = 1
    while size < m:
        w = torch.cat([w, w * p], dim=-1)
        p = p * p
        size *= 2
    return w[..., :m]


def phase_ramp(shift: torch.Tensor, theta: torch.Tensor, acc: torch.Tensor,
               nsym: int, ol: int, dtype: torch.dtype) -> torch.Tensor:
    """exp(-i(2π·shift·(s·ol+j) + acc_s + theta_s·j)) as [..., nsym, ol].

    The angle is linear in j within each symbol, so each symbol's rotation is
    a geometric sequence head_s·u_s^j, built from ~log2(ol) vector doublings
    and one outer product (j = 16h + l) instead of ol sincos evaluations."""
    rdt = real_dtype(dtype)
    two_pi = 2 * np.pi
    s_idx = torch.arange(nsym, dtype=rdt, device=shift.device)
    A = (two_pi * ol) * shift[..., None].to(rdt) * s_idx + acc.to(rdt)
    B = two_pi * shift[..., None].to(rdt) + theta.to(rdt)
    u = torch.exp(-1j * B).to(dtype)                     # [..., nsym]
    head = torch.exp(-1j * A).to(dtype)                  # [..., nsym]
    if ol % 16 == 0:
        lo = _pow_ladder(u, 16)                          # [..., nsym, 16]
        hi = _pow_ladder(lo[..., -1] * u, ol // 16)      # [..., nsym, ol/16]
        ramp = (head[..., None] * hi)[..., None] * lo[..., None, :]
        return ramp.reshape(*u.shape, ol)
    return head[..., None] * _pow_ladder(u, ol)


def recover_fused(spec, sig: torch.Tensor):
    """All four recovery stages in one pass: coarse pilot CFO + per-symbol CP
    CFO + common phase, applied as a SINGLE complex rotation.

    Algebraically identical to the sequential chain (`main.cpp:60-63`): the
    CP phase of a derotated symbol equals the raw CP phase rotated by
    e^{-2πi·f·fft}, and scalar phases cancel inside conj products, so all
    estimates come from the raw signal and compose into one per-sample angle.

    Returns (corrected_sig, coarse_shift)."""
    cfg = spec.cfg
    ol, fft, cp = cfg.ofdm_len, cfg.fft_size, cfg.cp_size
    lead = sig.shape[:-1]
    n = sig.shape[-1]
    nsym = n // ol
    rdt = sig.real.dtype

    shift = pilot_freq_shift(spec, sig)                      # [...]
    sym = sig.reshape(*lead, nsym, ol)
    raw = (torch.conj(sym[..., :cp]) * sym[..., fft:]).sum(-1)  # [..., nsym]
    # derotation adds a constant -2π·shift·fft to each CP-product's phase
    off = (-2 * np.pi * fft) * shift
    rot = torch.exp(1j * off.to(rdt))[..., None].to(sig.dtype)
    theta = torch.angle(raw * rot) / fft                     # [..., nsym]
    acc = torch.cumsum(theta * ol, dim=-1) - theta * ol      # exclusive
    corr = phase_ramp(shift, theta, acc, nsym, ol,
                      sig.dtype).reshape(*lead, n)
    # common phase vs the known preamble, measured on the corrected prefix
    pre = spec.tensors["pre_conj"]
    L = pre.shape[0]
    p = torch.angle((pre * sig[..., :L] * corr[..., :L]).sum(-1))
    scalar = torch.exp(-1j * p.to(rdt)).to(sig.dtype)
    return sig * corr * scalar[..., None], shift


def common_phase_correct(spec, sig: torch.Tensor) -> torch.Tensor:
    """Common phase vs the known preamble (`OFDM/Frame.hpp:265-274`).
    sig [..., n] with the preamble at the front."""
    pre = spec.tensors["pre_conj"]
    L = pre.shape[0]
    phase = torch.angle((pre * sig[..., :L]).sum(-1))
    rot = torch.exp(-1j * phase.to(sig.real.dtype)).to(sig.dtype)
    return sig * rot[..., None]
