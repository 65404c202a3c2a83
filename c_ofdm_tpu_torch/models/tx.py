"""Transmit chain: MAC-frame bytes -> frame IQ, batch-first (counterpart of
``c_ofdm_tpu/models/tx.py``).

Reference path: `FRAME_FORM::write` -> `OFDM_FORM::write` -> `FFT_FORM::write`
-> CP prepend -> int16 staging (`OFDM/Frame.cpp:185-198,235-237,249-256`).
The t2sin burst and preamble are spec constants concatenated per frame.
"""

from __future__ import annotations

import torch

from ..ops import chanest, modulation
from ..utils import graphs
from .frame import FrameSpec


def transmit(spec: FrameSpec, mac_bytes: torch.Tensor) -> torch.Tensor:
    """mac_bytes uint8 [..., frame_bytes] -> IQ [..., frame_len]."""
    cfg = spec.cfg
    points = modulation.map_bytes(mac_bytes, cfg.mod_type, dtype=spec.dtype)
    msg = chanest.ofdm_modulate(spec, points, cfg.num_symb)
    lead = mac_bytes.shape[:-1]
    msg = msg.reshape(*lead, cfg.message_len)
    burst = spec.tensors["t2_burst"].expand(*lead, cfg.t2sin_size)
    pre = spec.tensors["preamble_time"].expand(*lead, cfg.preamble_len)
    return torch.cat([burst, pre, msg], dim=-1)


transmit_jit = graphs.jit(transmit, static_argnums=(0,))
transmit_jit.__doc__ = """``transmit`` as the JAX package's ``transmit_jit``:
on CUDA tensors one CUDA-graph replay per call, captured on the first call
for each (spec, payload shape and dtype, device); on CPU tensors eager
(``utils/graphs.py::jit``)."""


def to_int16(spec: FrameSpec, iq: torch.Tensor) -> torch.Tensor:
    """Float IQ -> interleaved int16 [..., 2*n] with C-style truncation toward
    zero (`FRAME_FORM::get_int16`, `OFDM/Frame.cpp:249-256`)."""
    scaled_re = torch.trunc(iq.real * spec.cfg.mult)
    scaled_im = torch.trunc(iq.imag * spec.cfg.mult)
    out = torch.stack([scaled_re, scaled_im], dim=-1)
    return out.reshape(*iq.shape[:-1], iq.shape[-1] * 2).to(torch.int16)


def from_int16(spec: FrameSpec, raw: torch.Tensor) -> torch.Tensor:
    """Interleaved int16 [..., 2*n] -> complex IQ [..., n]
    (`FRAME_FORM::form_int16_to_double`, `OFDM/Frame.hpp:472-516`)."""
    f = raw.to(spec.real_dtype)
    return torch.complex(f[..., 0::2], f[..., 1::2])
