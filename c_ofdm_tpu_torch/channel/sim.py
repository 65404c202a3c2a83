"""Deterministic channel simulator (counterpart of
``c_ofdm_tpu/channel/sim.py``): the hardware-free loop the reference never
had (its only 'channel' is two physical PlutoSDRs, `python_code/channel.py`).

The impairments of the real AD9361 link, batch-first, on the frames' device:

* complex AWGN at a target SNR,
* carrier frequency offset (cycles/sample) + random initial phase,
* integer timing offset (frame placed at an arbitrary position in a longer
  capture window, embedded in noise),
* sample-clock offset (fractional resampling by linear interpolation),
* multipath: static FIR with complex taps,
* amplitude scale + int16 quantization (the SDR's fixed-point path).

The JAX package draws its randomness from a ``jax.random`` key; those
streams cannot be reproduced with ``torch.Generator``.  So the random inputs
are either drawn from an explicit ``torch.Generator`` on the frames' device
(a given (generator seed, params) pair is reproducible) or passed in as
tensors (``phi0``, ``noise``), which makes the output equal to the JAX
package's for the same draws.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.modulation import real_dtype


@dataclasses.dataclass(frozen=True)
class ChannelParams:
    snr_db: float = 30.0
    cfo: float = 0.0             # cycles/sample, e.g. 2e-4
    timing_offset: int = 0       # samples of delay before the frame
    capture_len: int = 0         # total output length (0 = frame length + offset)
    multipath: tuple = ()        # complex FIR taps after the direct tap, e.g. (0.2+0.1j,)
    amplitude: float = 1.0       # channel gain
    quantize_mult: int = 0       # if >0: int16 round-trip at this scale (e.g. 200)
    sco_ppm: float = 0.0         # RX sample-clock offset vs TX, parts/million


def apply_channel(params: ChannelParams, frames: torch.Tensor, *,
                  generator: torch.Generator = None,
                  phi0: torch.Tensor = None,
                  noise: torch.Tensor = None) -> torch.Tensor:
    """frames [..., n] complex -> impaired capture [..., capture_len or
    n + offset].

    ``phi0`` [...] is the initial carrier phase of each row (radians) and
    ``noise`` [..., capture, 2] the unit-variance normal draws of the AWGN
    (re, im last), as the JAX package draws them; each one not given is
    drawn from ``generator`` (the device's default generator if None):
    phi0 uniform in [0, 2π) first, then the noise."""
    x = frames
    dtype = x.dtype
    rdtype = real_dtype(dtype)
    dev = x.device

    # multipath FIR (direct tap 1.0 + echoes)
    if params.multipath:
        taps = np.concatenate([[1.0], np.asarray(params.multipath)]).astype(
            np.complex128)
        lags = torch.arange(x.shape[-1], device=dev)
        y = torch.zeros_like(x)
        for d, t in enumerate(taps):
            y = y + complex(t) * torch.roll(x, d, dims=-1) * (lags >= d)
        x = y

    # CFO + random initial phase (a real LO never starts at zero phase)
    n = torch.arange(x.shape[-1], dtype=rdtype, device=dev)
    if phi0 is None:
        phi0 = torch.rand(x.shape[:-1], generator=generator, dtype=rdtype,
                          device=dev) * (2 * np.pi)
    ang = (2 * np.pi * params.cfo) * n + phi0.to(rdtype)[..., None]
    x = x * torch.exp(1j * ang).to(dtype)

    x = x * params.amplitude

    # timing offset + capture window
    n_in = x.shape[-1]
    total = params.capture_len or (n_in + params.timing_offset)
    pad_front = params.timing_offset
    pad_back = max(0, total - n_in - pad_front)
    x = torch.nn.functional.pad(x, (pad_front, pad_back))[..., :total]

    # sample-clock offset: the RX converter samples the continuous waveform
    # at (1 + ppm*1e-6) x the TX rate; linear interpolation at indices and
    # fractions computed in numpy float64, as the JAX package does
    if params.sco_ppm:
        total_now = x.shape[-1]
        t = np.arange(total_now) * (1.0 + params.sco_ppm * 1e-6)
        i0 = np.minimum(t.astype(np.int64), total_now - 2)
        frac = (t - i0).astype(np.float64)
        w = torch.as_tensor(frac, dtype=rdtype, device=dev)
        i0 = torch.as_tensor(i0, device=dev)
        x = x[..., i0] * (1 - w) + x[..., i0 + 1] * w

    # AWGN at SNR relative to the *frame* signal power
    sig_pow = (frames.abs() ** 2).mean() * params.amplitude ** 2
    noise_pow = sig_pow * 10.0 ** (-params.snr_db / 10.0)
    if noise is None:
        noise = torch.randn((*x.shape, 2), generator=generator, dtype=rdtype,
                            device=dev)
    nr = noise.to(rdtype)
    x = x + (torch.complex(nr[..., 0], nr[..., 1])
             * torch.sqrt(noise_pow / 2).to(rdtype)).to(dtype)

    # int16 quantization round-trip (SDR fixed-point path)
    if params.quantize_mult:
        m = params.quantize_mult
        q = torch.clamp(torch.round(x.real * m), -32768, 32767) / m
        qi = torch.clamp(torch.round(x.imag * m), -32768, 32767) / m
        x = torch.complex(q, qi).to(dtype)

    return x
