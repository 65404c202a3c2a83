"""Constellation mapping / demapping on tensors (counterpart of
``c_ofdm_tpu/ops/modulation.py``).

Reference semantics (`OFDM/modulation.cpp`): non-Gray square QAM with the real
index in the low half-bits and imaginary in the high half-bits, diagonal BPSK
at 5π/4, hard decision by clamp + round on the peak-normalized grid, and
max-log soft LLRs (``soft_llrs``), which the reference lacks.
"""

from __future__ import annotations


import numpy as np
import torch

from ..utils import graphs
from . import bits as bitops

MOD_BPSK, MOD_QAM4, MOD_QAM16, MOD_QAM64, MOD_QAM256 = 1, 2, 4, 6, 8


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The real component type of a complex dtype."""
    return {torch.complex64: torch.float32,
            torch.complex128: torch.float64}[dtype]


def constellation(mod_type: int) -> np.ndarray:
    """Lookup table indexed by symbol value (numpy float64), QAM
    peak-normalized (|corner| = 1, per-axis levels / sqrt(2))."""
    if mod_type == 1:
        return np.exp(1j * (np.pi * np.arange(2) + 5 * np.pi / 4))
    side = 1 << (mod_type // 2)
    idx = np.arange(1 << mod_type)
    re = 2.0 / (side - 1) * (idx % side) - 1.0
    im = 2.0 / (side - 1) * (idx >> (mod_type // 2)) - 1.0
    # componentwise division, so that ``map_symbols`` is bit-identical to
    # this table in float64
    return re / np.sqrt(2.0) + 1j * (im / np.sqrt(2.0))


def map_symbols(symbols: torch.Tensor, mod_type: int,
                dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """Symbol indices -> constellation points, computed arithmetically with
    the same operation sequence as ``constellation`` (float64 results are
    bit-identical to the table)."""
    rdt = real_dtype(dtype)
    if mod_type == 1:
        tab = _bpsk_table(dtype, symbols.device)
        return torch.where(symbols == 0, tab[0], tab[1])
    side = 1 << (mod_type // 2)
    scale = 2.0 / (side - 1)
    re = scale * (symbols % side).to(rdt) - 1.0
    im = scale * (symbols >> (mod_type // 2)).to(rdt) - 1.0
    # sqrt(2) rounded to the working precision first, as the JAX package does
    rt2 = float(np.asarray(np.sqrt(2.0), dtype=np.float32 if rdt == torch.float32
                           else np.float64))
    return torch.complex(re / rt2, im / rt2)


@graphs.device_cache(maxsize=8)
def _bpsk_table(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``constellation(1)`` in ``dtype`` on ``device``, made once."""
    return torch.as_tensor(constellation(1), dtype=dtype, device=device)


def map_bytes(data: torch.Tensor, mod_type: int,
              dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """uint8 [..., nbytes] -> points [..., nbytes*8/mod_type]."""
    return map_symbols(bitops.bytes_to_symbols(data, mod_type), mod_type, dtype)


def hard_demap(points: torch.Tensor, mod_type: int) -> torch.Tensor:
    """Constellation points -> int32 symbol indices: clamp + round on the
    peak-normalized grid (the true TX grid)."""
    if mod_type == 1:
        return (points.real + points.imag > 0).to(torch.int32)
    s = 1.0 / np.sqrt(2.0)
    side = 1 << (mod_type // 2)
    inv_step = (side - 1) / (2.0 * s)
    re = torch.clamp(points.real, -s, s)
    im = torch.clamp(points.imag, -s, s)
    ire = torch.floor((re + s) * inv_step + 0.5).to(torch.int32)
    iim = torch.floor((im + s) * inv_step + 0.5).to(torch.int32)
    return ire | (iim << (mod_type // 2))


def demap_bytes(points: torch.Tensor, mod_type: int) -> torch.Tensor:
    """points [..., nsym] -> uint8 [..., nsym*mod_type/8] via hard decision."""
    return bitops.symbols_to_bytes(hard_demap(points, mod_type), mod_type)


@graphs.device_cache(maxsize=32)
def _llr_tables(mod_type: int, dtype: torch.dtype, device: torch.device):
    """(constellation [S] in ``dtype``, bit-is-0 mask [mod_type, S]) on
    ``device``: bit b of each symbol index, MSB first to match
    ``bytes_to_symbols``."""
    table = constellation(mod_type)
    idx = np.arange(table.size)
    bit_of = (idx[:, None] >> np.arange(mod_type - 1, -1, -1)[None, :]) & 1
    return (torch.as_tensor(table, dtype=dtype, device=device),
            torch.as_tensor((bit_of == 0).T, device=device))


def soft_llrs(points: torch.Tensor, mod_type: int,
              noise_var: float = 1.0) -> torch.Tensor:
    """Max-log LLRs, [..., nsym, mod_type]; positive favours bit 0, bits MSB
    first, divided by ``noise_var``.  Not present in the reference
    (hard-decision only)."""
    tbl, mask0 = _llr_tables(mod_type, points.dtype, points.device)
    d2 = (points[..., None] - tbl).abs() ** 2            # [..., nsym, S]
    d2 = d2[..., None, :]                                # [..., nsym, 1, S]
    d0 = torch.where(mask0, d2, torch.inf).amin(-1)      # [..., nsym, nbits]
    d1 = torch.where(~mask0, d2, torch.inf).amin(-1)
    return (d1 - d0) / noise_var
