"""The benchmark's one traffic generator: frames, impairments and layouts
from a mix's parameters and the run's seed.

A traffic mix is a JSON file under ``mixes/`` (see ``README.md``).  Every
mix is one of two layouts, named by its ``entry``:

* ``stream``: ``buffers`` consecutive ingest buffers (``rx_buf_size`` frame
  lengths each) a channel, for ``channels`` channels (0: one stream with no
  channel axis).  ``fill`` frames a frame length are placed at random gaps
  (``bench.py::_make_rings_cpu``'s construction, with the slack split at
  random proportions), so no frame crosses the end of the pool and the pool
  replays lap after lap seamlessly.
* ``batch``: ``batches`` distinct captures of ``frames`` rows, each frame at
  a random offset in [0, ``extra``] of a row of frame_len + ``extra``
  samples, followed by ``zero_rows`` all-zero rows
  (``chip_smoke.py::impaired_captures``' construction).

Both then apply ``amplitude``, a CFO of ``cfo`` cycles a sample and AWGN at
``snr_db``, and hand the program its wire format: ``int16`` interleaved
samples, truncated toward zero after scaling by the configuration's ``mult``
as the reference modem's TX does (`Frame.cpp:249-256`, saturating as an
ADC does), or ``complex64``.

The frames are the float64 TX chain of ``reference/oracle.py`` written out
over a batch of frames on the device; payload bytes and noise come from a
``torch.Generator`` seeded with the run's seed, offsets and gaps from
``numpy.random.default_rng(seed)``.  The same seed gives the same traffic
on the same kind of device.  Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..reference import oracle
from ..reference.config import ModemConfig


def _seed(seed: int) -> int:
    return int(seed) % (1 << 63)


def transmit(cfg: ModemConfig, payload: torch.Tensor) -> torch.Tensor:
    """payload uint8 [F, frame_bytes] -> frames complex128 [F, frame_len] on
    the payload's device: ``oracle.tx_frame`` over a batch of frames."""
    dev = payload.device
    F = payload.shape[0]
    pilots, data_bins = oracle.subcarrier_maps(cfg)
    shifts = torch.arange(7, -1, -1, device=dev, dtype=torch.uint8)
    bits = ((payload[..., None] >> shifts) & 1).reshape(F, -1, cfg.mod_type)
    weights = 1 << torch.arange(cfg.mod_type - 1, -1, -1, device=dev)
    symbols = (bits.to(torch.int64) * weights).sum(-1)
    points = torch.from_numpy(oracle.constellation(cfg.mod_type)).to(dev)
    freq = torch.zeros((F, cfg.num_symb, cfg.fft_size), dtype=torch.complex128,
                       device=dev)
    freq[..., torch.from_numpy(pilots).to(dev)] = cfg.pilot_ampl
    freq[..., torch.from_numpy(data_bins).to(dev)] = points[symbols].reshape(
        F, cfg.num_symb, cfg.num_data_subc)
    time = torch.fft.ifft(freq, dim=-1) * math.sqrt(cfg.fft_size)
    msg = torch.cat([time[..., -cfg.cp_size:], time], dim=-1).reshape(F, -1)
    head = np.concatenate([oracle.t2sin_burst(cfg), oracle.preamble_time(cfg)])
    head = torch.from_numpy(head).to(dev).expand(F, -1)
    return torch.cat([head, msg], dim=-1)


def impair(sig: torch.Tensor, frames: torch.Tensor, amplitude: float,
           cfo: float, snr_db: float, gen: torch.Generator) -> torch.Tensor:
    """sig [..., n] (frames placed at unit amplitude) -> amplitude x
    e^{2 pi i cfo k} x sig + AWGN whose variance is the frames' mean power
    times amplitude^2 at ``snr_db`` below it (bench.py's rings)."""
    n = sig.shape[-1]
    k = torch.arange(n, dtype=torch.float64, device=sig.device)
    rot = torch.polar(torch.full_like(k, float(amplitude)), 2 * math.pi * cfo * k)
    power = float((frames.abs() ** 2).mean())
    std = math.sqrt(power * amplitude ** 2 * 10 ** (-snr_db / 10) / 2)
    noise = torch.randn((2, *sig.shape), generator=gen, dtype=torch.float64,
                        device=sig.device)
    return sig * rot + torch.complex(noise[0], noise[1]) * std


def to_wire(cfg: ModemConfig, sig: torch.Tensor, wire: str) -> torch.Tensor:
    """complex128 [..., n] -> the wire format: int16 [..., n, 2]
    (``oracle.to_int16``: trunc(x * mult), saturated to int16) or
    complex64 [..., n]."""
    if wire == "complex64":
        return sig.to(torch.complex64)
    if wire != "int16":
        raise ValueError(f"wire must be 'int16' or 'complex64', got {wire!r}")
    x = torch.view_as_real(sig) * cfg.mult
    return torch.trunc(x).clamp(-32768, 32767).to(torch.int16)


def from_wire(cfg: ModemConfig, x: torch.Tensor) -> torch.Tensor:
    """The wire samples as the complex128 signal they stand for."""
    if x.is_complex():
        return x.to(torch.complex128)
    x = x.to(torch.float64) / cfg.mult
    return torch.complex(x[..., 0], x[..., 1])


@dataclasses.dataclass
class Traffic:
    """What one run offers the program, and what it must get back.

    stream: ``pool`` [buffers, C, n, 2] int16 or [buffers, C, n] complex64
    (no C axis when channels is 0), on the device or as numpy on the host;
    per buffer index, channel and output slot the expected preamble
    position in that call's ring (``exp_pos``, -1 past the frames due),
    its frame's start in the channel's pool (``exp_start``) and bytes.
    batch: ``pool`` [batches, rows, n] complex64 on the device; per batch
    the planted offsets and bytes of its first ``frames`` rows."""
    cfg: ModemConfig
    mix: dict
    pool: object
    exp_pos: np.ndarray           # stream [B, C, M] int32 | batch [K, frames]
    exp_bytes: np.ndarray         # [B, C, M, fb] | [K, frames, fb] uint8
    exp_start: Optional[np.ndarray] = None   # stream [B, C, M]

    @property
    def calls(self) -> int:
        """Distinct inputs in the pool (buffers or batches)."""
        return self.exp_pos.shape[0]

    def input(self, i: int):
        return self.pool[i]

    def row(self, i: int, r: int) -> np.ndarray:
        """Capture row ``r`` of batch ``i`` as the complex128 signal it
        stands for (numpy, on the host)."""
        return from_wire(self.cfg, self.pool[i][r]).cpu().numpy()

    def samples_per_call(self) -> int:
        """Capture samples a call hands the program."""
        if self.mix["entry"] == "stream":
            return max(self.mix["channels"], 1) * self.cfg.buffer_len
        return (self.mix["frames"] + self.mix["zero_rows"]) * (
            self.cfg.frame_len + self.mix["extra"])

    def frame_windows(self, i: int, index: np.ndarray) -> torch.Tensor:
        """complex128 [F, frame_len] on the CPU: the wire samples of the
        expected frames ``index`` of pool entry ``i`` (stream: (channel,
        slot) pairs [F, 2]; batch: rows [F]), as the signal they stand for."""
        L = self.cfg.frame_len
        if self.mix["entry"] == "batch":
            pool = self.pool[i]
            rows = torch.as_tensor(index, device=pool.device)
            offs = torch.as_tensor(self.exp_pos[i][index], device=pool.device)
            idx = offs[:, None] + torch.arange(L, device=pool.device)
            return from_wire(self.cfg, pool[rows[:, None], idx]).cpu()
        n = self.cfg.buffer_len
        pool = torch.as_tensor(self.pool)
        c = torch.as_tensor(index[:, 0], device=pool.device)
        s = torch.as_tensor(self.exp_start[i][index[:, 0], index[:, 1]],
                            device=pool.device)
        g = s[:, None] + torch.arange(L, device=pool.device)
        b, k = g // n, g % n
        if self.mix["channels"]:
            x = pool[b, c[:, None], k]
        else:
            x = pool[b, k]
        return from_wire(self.cfg, x).cpu()


def make(cfg: ModemConfig, mix: dict, seed: int,
         device: torch.device) -> Traffic:
    """The traffic of ``mix`` for this seed, made on ``device``."""
    if mix["entry"] == "stream":
        return _stream(cfg, mix, seed, torch.device(device))
    if mix["entry"] == "batch":
        return _batch(cfg, mix, seed, torch.device(device))
    raise ValueError(f"unknown entry kind {mix['entry']!r}")


def _stream(cfg, mix, seed, dev) -> Traffic:
    C = max(mix["channels"], 1)
    B = mix["buffers"]
    n = cfg.buffer_len
    L = cfg.frame_len
    M = cfg.rx_buf_size + 1
    total = B * n
    rng = np.random.default_rng(_seed(seed))
    gen = torch.Generator(device=dev).manual_seed(_seed(seed))
    nf = int(mix["fill"] * total / L)
    # the slack between frames is split at random proportions (uniform
    # spacings: Poisson arrivals given their count), so frames straddle
    # buffer boundaries and the receiver's carry between buffers is used;
    # bench.py's equal-probability split spaces them so evenly that at
    # fill 0.8 none crosses a boundary
    gaps = np.stack([rng.multinomial(total - nf * L,
                                     rng.dirichlet(np.ones(nf + 1)))
                     for _ in range(C)])
    starts = np.cumsum(gaps[:, :nf], axis=1) + L * np.arange(nf)   # [C, nf]
    payload = torch.randint(0, 256, (C * nf, cfg.frame_bytes), generator=gen,
                            device=dev, dtype=torch.uint8)
    frames = transmit(cfg, payload)
    flat = torch.from_numpy(starts + total * np.arange(C)[:, None]).to(dev)
    sig = torch.zeros(C * total, dtype=torch.complex128, device=dev)
    sig[(flat.reshape(-1, 1) + torch.arange(L, device=dev)).reshape(-1)] = \
        frames.reshape(-1)
    del flat
    sig = impair(sig.view(C, total), frames, mix["amplitude"], mix["cfo"],
                 mix["snr_db"], gen)
    del frames
    wire = to_wire(cfg, sig, mix["wire"])
    del sig
    wire = wire.view(C, B, n, *wire.shape[2:]).transpose(0, 1).contiguous()
    if not mix["channels"]:
        wire = wire[:, 0]
    pool = wire if mix["inputs"] == "device" else wire.cpu().numpy()

    # frame f of channel c is decoded by the call on the buffer where it
    # ends, at preamble position (ring = one carried frame length + buffer)
    call = (starts + L - 1) // n                                    # [C, nf]
    pos = starts - call * n + L + cfg.t2sin_size
    exp_pos = np.full((B, C, M), -1, np.int32)
    exp_start = np.full((B, C, M), -1, np.int64)
    exp_bytes = np.zeros((B, C, M, cfg.frame_bytes), np.uint8)
    pay = payload.view(C, nf, -1).cpu().numpy()
    for c in range(C):
        first = np.searchsorted(call[c], np.arange(B))
        slot = np.arange(nf) - first[call[c]]
        if slot.max() >= M:
            raise ValueError(f"mix places {slot.max() + 1} frames in one "
                             f"buffer, more than the {M} a call decodes")
        exp_pos[call[c], c, slot] = pos[c]
        exp_start[call[c], c, slot] = starts[c]
        exp_bytes[call[c], c, slot] = pay[c]
    return Traffic(cfg, mix, pool, exp_pos, exp_bytes, exp_start)


def _batch(cfg, mix, seed, dev) -> Traffic:
    if mix["wire"] != "complex64":
        raise ValueError("a batch entry takes complex64 captures")
    K, nb, z, extra = (mix["batches"], mix["frames"], mix["zero_rows"],
                       mix["extra"])
    L = cfg.frame_len
    n = L + extra
    rng = np.random.default_rng(_seed(seed))
    gen = torch.Generator(device=dev).manual_seed(_seed(seed))
    offs = rng.integers(0, extra + 1, (K, nb))
    payload = torch.randint(0, 256, (K, nb, cfg.frame_bytes), generator=gen,
                            device=dev, dtype=torch.uint8)
    pool = torch.zeros((K, nb + z, n), dtype=torch.complex64, device=dev)
    for k in range(K):
        frames = transmit(cfg, payload[k])
        sig = torch.zeros((nb, n), dtype=torch.complex128, device=dev)
        idx = torch.from_numpy(offs[k]).to(dev)[:, None] + torch.arange(
            L, device=dev)
        sig.scatter_(1, idx, frames)
        sig = impair(sig, frames, mix["amplitude"], mix["cfo"], mix["snr_db"],
                     gen)
        pool[k, :nb] = to_wire(cfg, sig, mix["wire"])
    return Traffic(cfg, mix, pool, offs.astype(np.int64),
                   payload.cpu().numpy())
