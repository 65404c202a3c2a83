"""Channel estimation, equalization and the OFDM symbol transforms
(counterpart of ``c_ofdm_tpu/ops/chanest.py``).

* ``chan_est_lq``   — linear-phase least-squares fit over the unwrapped phase
  of the lower half-band (the reference's production estimator).
* ``chan_est_full`` — mean per-subcarrier complex ratio.
* ``bins_transform`` / ``pilot_equalize`` — the symbol-level pilot
  equalization of ``FFT_FORM::read`` (`OFDM/Frame.cpp:73-96`).

The symbol transforms follow the spec's ``fft_backend``: the matmul
backends run a *partial* DFT over only the pilot and data bins (bases built
once per spec by ``models.frame``; the functions that make them live here
beside the code that reads them); every other backend transforms the full
spectrum (``ops.fft``) and reads or writes the bins with slices and reshapes
(``rx_split_bins`` / ``tx_assemble_freq``), or with index gathers where the
layout is not the canonical segment layout.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fft as fftops


def rx_basis(cfg, pilot_bins, data_bins, device,
             rdt: torch.dtype) -> torch.Tensor:
    """DFT basis restricted to the bins the demodulator reads, pilot-major:
    [2, fft, P + D] (matmul backends).  Same math as the full transform
    (the other bins are guard/DC nulls nobody reads); built on the device
    at wideband sizes (``fft.dft_basis``)."""
    rows = np.concatenate([np.asarray(pilot_bins), np.asarray(data_bins)])
    return fftops.dft_basis(cfg.fft_size, rows, sign=-1, transpose=True,
                            device=device, rdt=rdt)


def tx_basis(cfg, pilot_bins, data_bins, device, rdt: torch.dtype):
    """Inverse-DFT basis over only the data bins [2, D, fft] (1/sqrt(N)
    folded in, built like ``rx_basis``) and the constant pilot-tone
    waveform [fft] (float64 numpy): the TX spectrum is zero everywhere
    else, and the pilot contribution is data-independent."""
    scale = 1.0 / np.sqrt(cfg.fft_size)
    w = fftops.dft_basis(cfg.fft_size, np.asarray(data_bins), sign=+1,
                         scale=scale, device=device, rdt=rdt)
    w_pil = fftops.dft_rows(cfg.fft_size, np.asarray(pilot_bins), sign=+1)
    return w, float(cfg.pilot_ampl) * scale * w_pil.sum(axis=0)


def _chan_index_np(num_data_subc: int):
    """Fit abscissae of ``chan_est_lq``: i = 0..half-1 over the lower half,
    and the mirrored subcarrier index karr [num_data_subc]."""
    half = num_data_subc // 2
    n = num_data_subc
    k = np.arange(n)
    karr = (np.where(k < half, k, k - n)
            + (0 if n == 2 * half else n - 2 * half))
    return np.arange(half), karr


def bins_transform(spec, time_syms: torch.Tensor):
    """CP-stripped time symbols [..., nsym, fft] -> raw (pilot, data) bins
    ([..., nsym, P], [..., nsym, D]).  Matmul backends: one partial-DFT
    product over the pilot+data bins only.  Others: the full forward
    transform of the spec's backend, then the bins."""
    backend = spec.fft_backend
    P = spec.cfg.num_pilot_subc
    if backend in fftops.MATMUL_BACKENDS:
        y = fftops.complex_matmul(time_syms, spec.tensors["rx_basis"],
                                  bf16=backend.endswith("bf16"))
        return y[..., :P], y[..., P:]
    freq = fftops.fft_fwd(time_syms, backend)
    if spec.structured:
        return rx_split_bins(spec, freq)
    return (freq[..., spec.tensors["pilot_idx"]],
            freq[..., spec.tensors["data_idx"]])


def pilot_equalize(spec, pil: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Pilot normalization + per-segment equalization of raw bins
    (`OFDM/Frame.cpp:73-96`): divide by mean |pilot| over ALL symbols of the
    group, then divide each segment by (its pilot / same pilot in symbol 0).
    """
    cfg = spec.cfg
    phys = pil.abs().mean(dim=(-1, -2)) / cfg.pilot_ampl      # [...]
    data = data / phys[..., None, None].to(data.dtype)
    pil = pil / phys[..., None, None].to(pil.dtype)
    coef = pil / pil[..., 0:1, :]                              # vs symbol 0
    lead = data.shape[:-2]
    nsym = data.shape[-2]
    data = data.reshape(*lead, nsym, cfg.num_pilot_subc, cfg.segment_size)
    data = data / coef[..., None]
    return data.reshape(*lead, nsym * cfg.num_data_subc)


def ofdm_demodulate(spec, time_syms: torch.Tensor) -> torch.Tensor:
    """CP-stripped time symbols [..., nsym, fft] -> equalized segment-order
    points [..., nsym*num_data_subc]."""
    pil, data = bins_transform(spec, time_syms)
    return pilot_equalize(spec, pil, data)


def _tx_bin_maps(spec) -> np.ndarray:
    """Gather-based frequency-bin construction: each FFT bin reads from
    index ``src[bin]`` of [pilot_ampl, data..., 0]."""
    return tx_bin_maps_np(spec.cfg, spec.pilot_bins, spec.data_bins)


def tx_bin_maps_np(cfg, pilot_bins, data_bins) -> np.ndarray:
    """``_tx_bin_maps`` from the config and the bin maps."""
    src = np.full(cfg.fft_size, 1 + cfg.num_data_subc, dtype=np.int32)  # zero slot
    src[pilot_bins] = 0                                                 # pilot slot
    src[data_bins] = 1 + np.arange(cfg.num_data_subc, dtype=np.int32)
    return src


def layout_is_structured(cfg, pilot_bins: np.ndarray,
                         data_bins: np.ndarray) -> bool:
    """True when (pilot_bins, data_bins) follow the canonical segment layout
    (`OFDM/Frame.cpp:31-44`, oracle.subcarrier_maps): lower half =
    num_pilot_subc/2 repeats of [seg data | pilot] from bin 1, upper half =
    as many repeats of [pilot | seg data] ending at bin fft_size-1, guard
    between.  Always true for specs built by make_frame_spec; checked once
    per spec so the slice-based bin paths can never silently diverge from
    the gathers."""
    seg, step, half = cfg.segment_size, cfg.segment_step, cfg.num_pilot_subc // 2
    p, d = [], []
    pos = 1 + seg
    for _ in range(half):
        p.append(pos)
        d.extend(range(pos - seg, pos))
        pos += step
    pos = cfg.fft_size - step * half
    for _ in range(half):
        p.append(pos)
        d.extend(range(pos + 1, pos + 1 + seg))
        pos += step
    return (np.array_equal(p, np.asarray(pilot_bins))
            and np.array_equal(d, np.asarray(data_bins)))


def tx_assemble_freq(spec, data: torch.Tensor) -> torch.Tensor:
    """Segment-order data points [..., nsym, D] -> full TX spectrum
    [..., nsym, fft_size] by reshape/concat only; exactly equal to
    ``lookup[..., _tx_bin_maps(spec)]`` for the canonical layout."""
    cfg = spec.cfg
    lead = data.shape[:-1]
    half = cfg.num_pilot_subc // 2
    seg, step = cfg.segment_size, cfg.segment_step
    dt, dev = data.dtype, data.device
    dl = data[..., :half * seg].reshape(*lead, half, seg)
    du = data[..., half * seg:].reshape(*lead, half, seg)
    pil = torch.full((*lead, half, 1), cfg.pilot_ampl, dtype=dt, device=dev)
    lower = torch.cat([dl, pil], dim=-1).reshape(*lead, half * step)
    upper = torch.cat([pil, du], dim=-1).reshape(*lead, half * step)
    guard = cfg.fft_size - 1 - 2 * half * step
    z1 = torch.zeros((*lead, 1), dtype=dt, device=dev)
    zg = torch.zeros((*lead, guard), dtype=dt, device=dev)
    return torch.cat([z1, lower, zg, upper], dim=-1)


def rx_split_bins(spec, freq: torch.Tensor):
    """Full spectrum [..., fft_size] -> (pilot [..., P], data [..., D] in
    segment order) by slicing/reshape only: the inverse of
    ``tx_assemble_freq``."""
    cfg = spec.cfg
    lead = freq.shape[:-1]
    half = cfg.num_pilot_subc // 2
    seg, step = cfg.segment_size, cfg.segment_step
    lower = freq[..., 1:1 + half * step].reshape(*lead, half, step)
    upper = freq[..., cfg.fft_size - half * step:].reshape(*lead, half, step)
    pil = torch.cat([lower[..., seg], upper[..., 0]], dim=-1)
    data = torch.cat([lower[..., :seg].reshape(*lead, half * seg),
                      upper[..., 1:].reshape(*lead, half * seg)], dim=-1)
    return pil, data


def ofdm_modulate(spec, points: torch.Tensor, num_symb: int) -> torch.Tensor:
    """Segment-order points [..., nsym*num_data_subc] -> time
    [..., nsym, ofdm_len] incl. CP (`OFDM/Frame.cpp:54-70,185-198`): pilots
    at pilot_ampl, backward DFT / sqrt(N), CP = copy of the symbol tail.

    Matmul backends synthesize the time domain from the data points alone
    (partial inverse DFT + the precomputed pilot waveform: the spectrum is
    zero outside the pilot/data bins); the others assemble the full
    spectrum and run the backend's full inverse transform."""
    cfg = spec.cfg
    backend = spec.fft_backend
    lead = points.shape[:-1]
    data = points.reshape(*lead, num_symb, cfg.num_data_subc)
    if backend in fftops.MATMUL_BACKENDS:
        time = fftops.complex_matmul(data, spec.tensors["tx_basis"],
                                     bf16=backend.endswith("bf16"))
        time = time + spec.tensors["tx_pilot_time"]
    else:
        if spec.structured:
            freq = tx_assemble_freq(spec, data)
        else:
            pilot = torch.full((*lead, num_symb, 1), cfg.pilot_ampl,
                               dtype=points.dtype, device=points.device)
            zero = torch.zeros((*lead, num_symb, 1), dtype=points.dtype,
                               device=points.device)
            lookup = torch.cat([pilot, data, zero], dim=-1)
            freq = lookup[..., spec.tensors["tx_bin_src"]]
        time = fftops.ifft_unnorm(freq, backend) / np.sqrt(cfg.fft_size)
    return torch.cat([time[..., -cfg.cp_size:], time], dim=-1)


def unwrap_one_step(phase: torch.Tensor) -> torch.Tensor:
    """The reference's non-accumulating unwrap (`OFDM/Frame.hpp:407-414`):
    each element shifted by at most ±2π relative to its corrected
    predecessor.  Runs serially along the last axis (one step per element);
    leading dims are vectorized."""
    prev = phase[..., 0]
    out = [prev]
    for k in range(1, phase.shape[-1]):
        cur = phase[..., k]
        d = cur - prev
        prev = torch.where(d > np.pi, cur - 2 * np.pi,
                           torch.where(d < -np.pi, cur + 2 * np.pi, cur))
        out.append(prev)
    return torch.stack(out, dim=-1)


def unwrap_fast(phase: torch.Tensor) -> torch.Tensor:
    """Accumulating unwrap via diff + round + cumsum along the last axis.
    Identical to the reference's non-accumulating one-step unwrap
    (`OFDM/Frame.hpp:407-414`) whenever successive corrected differences stay
    within 3π, which holds for any timing offset this modem can sync to."""
    d = torch.diff(phase, dim=-1)
    k = torch.round(d / (2 * np.pi))
    corr = torch.cumsum(k, dim=-1) * (2 * np.pi)
    return torch.cat([phase[..., :1], phase[..., 1:] - corr], dim=-1)


def preamble_demod(spec, preamble_sig: torch.Tensor) -> torch.Tensor:
    """Demodulate the preamble span [..., preamble_len] into segment-order
    points [..., num_pr_symb*num_data_subc]."""
    cfg = spec.cfg
    lead = preamble_sig.shape[:-1]
    syms = preamble_sig.reshape(*lead, cfg.num_pr_symb,
                                cfg.ofdm_len)[..., cfg.cp_size:]
    return ofdm_demodulate(spec, syms)


def chan_est_lq(spec, preamble_sig: torch.Tensor = None,
                exact_unwrap: bool = False,
                pre_points: torch.Tensor = None) -> torch.Tensor:
    """Linear-phase LS estimate over the lower half-band, mirrored to the
    upper half (`OFDM/Frame.hpp:389-434`), with the reference's exact fit
    formula (sums where a standard LS uses means).  With several preamble
    symbols the complex ratio is averaged across them before the phase fit,
    as in the JAX package.

    preamble_sig [..., preamble_len] -> chan [..., num_data_subc]; callers may
    pass already-demodulated ``pre_points`` instead.  ``exact_unwrap`` takes
    the reference's serial one-step unwrap in place of the parallel one."""
    cfg = spec.cfg
    pr = pre_points if pre_points is not None else preamble_demod(
        spec, preamble_sig)
    half = cfg.num_data_subc // 2
    lead = pr.shape[:-1]
    ratio = (pr / spec.tensors["pre_points"]).reshape(
        *lead, cfg.num_pr_symb, cfg.num_data_subc).mean(dim=-2)
    unwrap = unwrap_one_step if exact_unwrap else unwrap_fast
    phase = unwrap(torch.angle(ratio[..., :half]))
    i = spec.tensors["chan_i"]
    sx, sxx = i.sum(), (i * i).sum()
    sy = phase.sum(-1)
    sxy = (phase * i).sum(-1)
    b = (sxy - sx * sy) / (sxx - sx * sx)
    a = sy - b * sx
    ang = b[..., None] * spec.tensors["chan_k"] + a[..., None]
    return torch.exp(1j * ang).to(pr.dtype)


def chan_est_full(spec, preamble_sig: torch.Tensor = None,
                  pre_points: torch.Tensor = None) -> torch.Tensor:
    """Mean per-subcarrier complex ratio (`OFDM/Frame.hpp:375-385`)."""
    cfg = spec.cfg
    pr = pre_points if pre_points is not None else preamble_demod(
        spec, preamble_sig)
    lead = pr.shape[:-1]
    ratio = (pr / spec.tensors["pre_points"]).reshape(
        *lead, cfg.num_pr_symb, cfg.num_data_subc)
    return ratio.mean(dim=-2)


def equalize(spec, points: torch.Tensor, chan: torch.Tensor) -> torch.Tensor:
    """Divide message points [..., nsym*D] by the channel estimate [..., D]
    (`main.cpp:69-71`), as one reciprocal on D points + a broadcast multiply."""
    D = chan.shape[-1]
    nsym = points.shape[-1] // D
    lead = points.shape[:-1]
    inv = 1.0 / chan
    out = points.reshape(*lead, nsym, D) * inv[..., None, :]
    return out.reshape(*lead, nsym * D)
