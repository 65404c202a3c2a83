"""The plain reference receiver: ``oracle.rx_frame`` over a batch of frames.

Plain PyTorch on the CPU, float64 (complex128) by default: frames whose
starts are known (the traffic planted them) go through the coarse pilot CFO
with the configuration's outlier rule, derotation, the per-symbol CP fine
CFO, the common phase against the known preamble, the linear-phase channel
fit and the pilot-equalised demodulation, exactly as ``oracle.rx_frame``
does one frame at a time.  It imports nothing of the program and takes
nothing the program made: its inputs are the wire samples the traffic handed
to the program.

``tf32=True`` is the correctness check's control: the same computation in
float32 (complex64), with every DFT's input rounded to TF32 (10 mantissa
bits, round to nearest), which is what the configuration's float32 products
would become with TF32 switched on.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import oracle
from .config import ModemConfig


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 or complex64 values rounded to TF32's 10 mantissa bits."""
    if x.is_complex():
        return torch.view_as_complex(round_tf32(torch.view_as_real(x)))
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _cfo_windows(cfg: ModemConfig):
    """(lower border, upper border) of each pilot-peak window searched."""
    size = cfg.preamble_len
    rel_bw = (cfg.num_data_subc + cfg.num_pilot_subc) / cfg.fft_size
    rel_pw = rel_bw / cfg.num_pilot_subc
    pw = int(size * rel_pw)
    j0 = int((1.0 - rel_bw - rel_pw) / 2.0 * size)
    borders = j0 + pw * np.arange(cfg.num_pilot_subc + 2)
    borders[0] = max(0, borders[0])
    borders[-1] = min(size, borders[-1])
    return [(int(borders[i]), int(borders[i + 1]))
            for i in range(cfg.num_pilot_subc + 1)
            if i != cfg.num_pilot_subc // 2]


class Receiver:
    """Demodulates frames [F, frame_len] at their known starts."""

    def __init__(self, cfg: ModemConfig, tf32: bool = False):
        self.cfg = cfg
        self.tf32 = tf32
        self.cdt = torch.complex64 if tf32 else torch.complex128
        self.rdt = torch.float32 if tf32 else torch.float64
        pilots, data_bins = oracle.subcarrier_maps(cfg)
        self.pilots = torch.from_numpy(pilots)
        self.data_bins = torch.from_numpy(data_bins)
        self.windows = _cfo_windows(cfg)
        self.pre = torch.from_numpy(oracle.preamble_time(cfg)).to(self.cdt)
        self.pre_points = torch.from_numpy(
            oracle.preamble_points(cfg)).to(self.cdt)

    def _fft(self, x: torch.Tensor) -> torch.Tensor:
        return torch.fft.fft(round_tf32(x) if self.tf32 else x, dim=-1)

    def coarse_cfo(self, sig: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        size = cfg.preamble_len
        amp = torch.fft.fftshift(self._fft(sig[:, :size]), dim=-1).abs()
        delta = torch.stack([torch.argmax(amp[:, lo:hi], dim=-1)
                             for lo, hi in self.windows], dim=-1)
        if cfg.cfo_outlier_bins > 0:
            med = torch.sort(delta, dim=-1).values[:, delta.shape[-1] // 2]
            keep = (delta - med[:, None]).abs() <= cfg.cfo_outlier_bins
            delta = torch.where(keep, delta, med[:, None])
        lo = torch.tensor([lo for lo, _ in self.windows])
        total = (lo + delta).sum(-1).to(self.rdt)
        return (total / cfg.num_pilot_subc - size / 2) / size

    def demod_symbols(self, syms: torch.Tensor) -> torch.Tensor:
        """``oracle.ofdm_demodulate`` over frames: CP-stripped symbols
        [F, n, fft] -> equalised data points [F, n * num_data_subc]."""
        cfg = self.cfg
        F, n = syms.shape[:2]
        freq = self._fft(syms)
        pil = freq[..., self.pilots]
        phys = pil.abs().mean(dim=(1, 2)) / cfg.pilot_ampl
        freq = freq / phys[:, None, None]
        pil = freq[..., self.pilots]
        coef = pil / pil[:, 0:1, :]
        data = freq[..., self.data_bins].reshape(F, n, cfg.num_pilot_subc,
                                                 cfg.segment_size)
        return (data / coef[..., None]).reshape(F, -1)

    def chan_est_lq(self, pre_sig: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        F = pre_sig.shape[0]
        syms = pre_sig.reshape(F, cfg.num_pr_symb, cfg.ofdm_len)[..., cfg.cp_size:]
        pr = self.demod_symbols(syms)
        half = cfg.num_data_subc // 2
        phase = torch.angle(pr[:, :half] / self.pre_points[:half])
        # the reference's one-step unwrap (`Frame.hpp:407-414`): each
        # element moves by at most 2 pi against its corrected predecessor
        out = phase.clone()
        for i in range(1, half):
            d = out[:, i] - out[:, i - 1]
            out[:, i] -= 2 * math.pi * (d > math.pi).to(self.rdt)
            out[:, i] += 2 * math.pi * (d < -math.pi).to(self.rdt)
        i = torch.arange(half, dtype=self.rdt)
        sx, sy = i.sum(), out.sum(-1)
        sxy, sxx = (out * i).sum(-1), (i * i).sum()
        b = (sxy - sx * sy) / (sxx - sx * sx)
        a = sy - b * sx
        n = cfg.num_data_subc
        k = torch.arange(n, dtype=self.rdt)
        lin = torch.where(k < half, b[:, None] * k + a[:, None],
                          b[:, None] * (k - n) + a[:, None]
                          + b[:, None] * (n - 2 * half))
        return torch.polar(torch.ones_like(lin), lin)

    def __call__(self, frames: torch.Tensor):
        """frames [F, frame_len] -> (constellation [F, num_symb *
        num_data_subc], coarse CFO [F]), in this receiver's precision."""
        cfg = self.cfg
        F = frames.shape[0]
        sig = frames[:, cfg.t2sin_size:].to(self.cdt)
        shift = self.coarse_cfo(sig)
        k = torch.arange(sig.shape[-1], dtype=self.rdt)
        sig = sig * torch.polar(torch.ones_like(k) * 1.0,
                                -2 * math.pi * shift[:, None] * k)
        ol, fft, cp = cfg.ofdm_len, cfg.fft_size, cfg.cp_size
        sym = sig.reshape(F, -1, ol)
        ph = torch.angle((torch.conj(sym[..., :cp]) * sym[..., fft:]).sum(-1))
        theta = ph / fft
        acc = torch.cumsum(theta * ol, dim=-1) - theta * ol
        j = torch.arange(ol, dtype=self.rdt)
        ang = -(acc[..., None] + theta[..., None] * j)
        sig = (sym * torch.polar(torch.ones_like(ang), ang)).reshape(F, -1)
        L = self.pre.shape[0]
        phase = torch.angle((torch.conj(self.pre) * sig[:, :L]).sum(-1))
        sig = sig * torch.polar(torch.ones_like(phase), -phase)[:, None]
        chan = self.chan_est_lq(sig[:, :cfg.preamble_len])
        msg = sig[:, cfg.preamble_len:].reshape(F, cfg.num_symb, ol)[..., cp:]
        const = self.demod_symbols(msg) / chan.repeat(1, cfg.num_symb)
        return const, shift


def demodulate(cfg: ModemConfig, frames: torch.Tensor, tf32: bool = False,
               block: int = 64):
    """``Receiver(cfg, tf32)`` over ``frames`` in blocks of ``block`` rows,
    so that a broadcast frame batch fits in host memory."""
    rx = Receiver(cfg, tf32)
    outs = [rx(frames[i:i + block]) for i in range(0, frames.shape[0], block)]
    return (torch.cat([c for c, _ in outs]), torch.cat([s for _, s in outs]))
