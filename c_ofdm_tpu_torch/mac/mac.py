"""MAC framing layer (counterpart of ``c_ofdm_tpu/mac/mac.py``).

The reference includes `mac/mac_frame.hpp` (`main.cpp:18`, `rx.cpp:17`) but the
file was never committed; its wire format was reverse-engineered from the
committed capture (`data/constell.bin` + `data.txt`):

* a logical MAC frame of ``frame_bytes / spread`` bytes: an 8-byte header
  ``[tx_id u8][rx_id u8][seq u32 BE][tail u16]`` followed by the payload
  (248 bytes at the reference config);
* each bit is then repeated ``spread`` times (spread = mod_type = 4 in the
  capture), so every constellation symbol carries one payload bit on the QAM
  diagonal — decoded optimally as ``sign(re + im)``;
* the observed tail is the constant ``0x7E57``.  A real CRC16-CCITT over
  header+payload is transmitted by default (``crc=True``) and either is
  accepted on read.

Everything runs on the device of its input, batch leading, with no host
synchronisation.  Integer fields are computed in int64 (torch's uint16 and
uint32 lack shifts and bitwise ops on some devices): ``seq`` and ``crc16``
come back as int64 holding the JAX package's uint32 / uint16 values.

``crc16`` is not the reference's byte-serial table walk (one step per byte,
254 at the stock body, each an eager launch on a GPU): CRC16-CCITT over a
fixed length n is affine over GF(2), ``crc(d) = M_n · bits(d) ⊕ c_n``, so it
is one 0/1 matrix product of the message bits, reduced mod 2, packed and
XORed with ``c_n``.  The integer sums are at most 8n, exact in float32 (and
in TF32: its operands are 0 or 1), so the result is bit-exact.  The launch
count does not depend on n.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops import bits as bitops
from ..utils import graphs

MAGIC = 0x7E57
HEADER_BYTES = 8

# CRC16-CCITT (poly 0x1021, init 0xFFFF) lookup table, as in the JAX package.
_CRC_TABLE = np.zeros(256, dtype=np.uint16)
for _b in range(256):
    _c = _b << 8
    for _ in range(8):
        _c = ((_c << 1) ^ 0x1021) & 0xFFFF if _c & 0x8000 else (_c << 1) & 0xFFFF
    _CRC_TABLE[_b] = _c


def _crc16_affine_np(n: int):
    """(M [8n, 16] uint8, c int) with crc16(d) = (bits(d) @ M mod 2) packed
    MSB first, XOR c, for every n-byte message d.  Row j of M is the
    zero-init CRC of the message whose only set bit is bit j (MSB first);
    c is the CRC of n zero bytes from init 0xFFFF.  Built by walking the
    table over all 8n unit messages at once (n vectorized steps)."""
    table = _CRC_TABLE.astype(np.int64)
    j = np.arange(8 * n)
    msgs = np.zeros((8 * n, n), dtype=np.int64)
    msgs[j, j // 8] = 1 << (7 - j % 8)
    crc = np.zeros(8 * n, dtype=np.int64)
    c = 0xFFFF
    for k in range(n):
        crc = ((crc << 8) & 0xFFFF) ^ table[((crc >> 8) ^ msgs[:, k]) & 0xFF]
        c = ((c << 8) & 0xFFFF) ^ int(table[(c >> 8) & 0xFF])
    m = ((crc[:, None] >> np.arange(15, -1, -1)) & 1).astype(np.uint8)
    return m, c


@graphs.device_cache(maxsize=32)
def _crc16_affine(n: int, device: torch.device):
    """``_crc16_affine_np(n)`` as device tensors: (M float32 [8n, 16],
    c int64 [], bit weights int64 [16])."""
    m, c = _crc16_affine_np(n)
    return (torch.from_numpy(m).to(device=device, dtype=torch.float32),
            torch.tensor(c, dtype=torch.int64, device=device),
            torch.arange(15, -1, -1, device=device))


def crc16(data: torch.Tensor) -> torch.Tensor:
    """CRC16-CCITT over the last axis of uint8 [..., n] -> int64 [...]
    (values 0..0xFFFF), as one GF(2) matrix product.  The first call per
    (n, device) builds M_n and copies it to the device; later calls make no
    host synchronisation."""
    m, c, w = _crc16_affine(data.shape[-1], data.device)
    bits = bitops.unpack_bits(data.to(torch.uint8)).to(torch.float32)
    parity = (bits @ m).to(torch.int64) & 1
    return ((parity << w).sum(-1)) ^ c


class MacFrame(NamedTuple):
    payload: torch.Tensor   # uint8 [..., payload_bytes]
    tx_id: torch.Tensor     # uint8 [...]
    rx_id: torch.Tensor     # uint8 [...]
    seq: torch.Tensor       # int64 [...] (the JAX package's uint32 values)
    valid: torch.Tensor     # bool [...]  (tail matches CRC or MAGIC)


@dataclasses.dataclass(frozen=True)
class Mac:
    """MAC codec for a fixed over-the-air frame size.

    ``frame_bytes`` is the PHY frame capacity (`FRAME_FORM::usefull_size`,
    1024 at the reference config); ``spread`` the bit-repetition factor.
    """

    tx_id: int = 1
    rx_id: int = 0
    frame_bytes: int = 1024
    spread: int = 4
    crc: bool = True

    def __post_init__(self):
        if self.frame_bytes % self.spread:
            raise ValueError("frame_bytes must be divisible by spread")
        if self.logical_bytes <= HEADER_BYTES:
            raise ValueError("frame too small for MAC header")

    @property
    def logical_bytes(self) -> int:
        return self.frame_bytes // self.spread

    @property
    def payload(self) -> int:
        """Usable payload bytes per frame (reference ``mac.payload``)."""
        return self.logical_bytes - HEADER_BYTES

    # ---- encode ----

    def write(self, payload: torch.Tensor, seq) -> torch.Tensor:
        """payload uint8 [..., payload], seq (int or integer tensor
        broadcasting to [...], taken mod 2**32) -> uint8 [..., frame_bytes]
        ready for the PHY."""
        dev = payload.device
        lead = payload.shape[:-1]
        if isinstance(seq, torch.Tensor):
            seq = (seq.to(device=dev, dtype=torch.int64)
                   & 0xFFFFFFFF).expand(lead)
        else:
            seq = torch.full(lead, int(seq) & 0xFFFFFFFF, dtype=torch.int64,
                             device=dev)
        hdr = torch.stack([
            torch.full(lead, self.tx_id, dtype=torch.int64, device=dev),
            torch.full(lead, self.rx_id, dtype=torch.int64, device=dev),
            seq >> 24, seq >> 16, seq >> 8, seq], dim=-1)
        hdr = (hdr & 0xFF).to(torch.uint8)
        payload = payload.to(torch.uint8)
        if self.crc:
            tail = crc16(torch.cat([hdr, payload], dim=-1))
        else:
            tail = torch.full(lead, MAGIC, dtype=torch.int64, device=dev)
        tail8 = (torch.stack([tail >> 8, tail], dim=-1) & 0xFF).to(torch.uint8)
        # header layout on the wire: [tx rx seq4][tail2] then payload --
        # matching the observed capture (tail at bytes 6..7)
        logical = torch.cat([hdr, tail8, payload], dim=-1)
        if self.spread == 1:
            return logical
        # each bit `spread` times in a row (jnp.repeat along the last axis),
        # as a broadcast: no output size to compute on the host
        lbits = bitops.unpack_bits(logical)[..., None]
        sbits = lbits.expand(*lbits.shape[:-1], self.spread)
        return bitops.pack_bits(sbits.reshape(*lead, -1))

    # ---- decode ----

    def read_bytes(self, frame: torch.Tensor) -> MacFrame:
        """Hard-decision path: frame uint8 [..., frame_bytes] (PHY demod
        output) -> MacFrame.  Bit groups are majority-voted; a tie (even
        spread) reads 0."""
        if self.spread == 1:
            logical = frame
        else:
            fbits = bitops.unpack_bits(frame)
            lead = fbits.shape[:-1]
            groups = fbits.reshape(*lead, -1, self.spread)
            logical = bitops.pack_bits(
                (groups.sum(-1) * 2 > self.spread).to(torch.uint8))
        return self._parse(logical)

    def read_soft(self, diag_metric: torch.Tensor) -> MacFrame:
        """ML path for the diagonal-spread scheme: ``diag_metric`` is re+im
        per constellation symbol, [..., nsym] with nsym == logical bits."""
        return self._parse(bitops.pack_bits((diag_metric > 0).to(torch.uint8)))

    def read_llr(self, llrs: torch.Tensor) -> MacFrame:
        """Soft-combining path: max-log LLRs (``ops.modulation.soft_llrs``,
        [..., nsym, bits_per_sym]) -> each logical bit's ``spread`` wire
        copies' LLRs summed -> sign decision.  Positive LLR favours bit 0."""
        lead = llrs.shape[:-2]
        wire = llrs.reshape(*lead, -1)              # wire-bit LLRs, in order
        groups = wire.reshape(*lead, -1, self.spread).sum(-1)
        return self._parse(bitops.pack_bits((groups < 0).to(torch.uint8)))

    def _parse(self, logical: torch.Tensor) -> MacFrame:
        f = logical[..., :HEADER_BYTES].to(torch.int64)
        seq = (f[..., 2] << 24) | (f[..., 3] << 16) | (f[..., 4] << 8) | f[..., 5]
        tail = (f[..., 6] << 8) | f[..., 7]
        payload = logical[..., HEADER_BYTES:]
        want = crc16(torch.cat([logical[..., :6], payload], dim=-1))
        valid = (tail == want) | (tail == MAGIC)
        return MacFrame(payload, logical[..., 0], logical[..., 1], seq, valid)
