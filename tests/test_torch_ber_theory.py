"""BER-vs-theory validation of the port: the three cases of
tests/test_ber_theory.py on the port's ``receive_batch`` and
``process_buffer``, with the same implementation-loss budgets, erasure
bounds and sanity bounds (see that file's docstring for the Es/N0
accounting and why each budget is what it is).

The batch cases draw the channel from a seeded ``torch.Generator`` through
``apply_channel`` (the JAX tests' ``jax.random`` keys cannot be replayed in
PyTorch), so the error counts differ from the JAX run's draw by draw, not in
distribution.  The streaming case builds its impaired stream in numpy, as
the JAX test does, with the same seed.
"""

import math

import numpy as np
import pytest
import torch

from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
from c_ofdm_tpu_torch.channel.sim import ChannelParams, apply_channel
from c_ofdm_tpu_torch.models import rx as rxm
from c_ofdm_tpu_torch.models import streaming
from c_ofdm_tpu_torch.models import tx as txm
from c_ofdm_tpu_torch.ops import modulation

torch.set_num_threads(1)

ERASURE_BER = 0.25     # a frame above this is an estimator blowup, not noise


def _qfunc(x):
    return 0.5 * math.erfc(x / math.sqrt(2))


def _binary_qam_ber(mod_type: int, ebn0_db: float) -> float:
    """Closed-form nearest-neighbor BER for the reference's binary-labeled
    square QAM (tests/test_ber_theory.py:62-70)."""
    e = 10 ** (ebn0_db / 10)
    if mod_type == 2:                    # QAM4 == QPSK, 1 bit/axis
        return _qfunc(math.sqrt(2 * e))
    if mod_type == 4:                    # QAM16, binary-labeled 4-PAM/axis
        return _qfunc(math.sqrt(0.8 * e))
    raise NotImplementedError(mod_type)


def _ebn0_db(mod_type, s_time, snr_db):
    es = float(np.mean(np.abs(modulation.constellation(mod_type)) ** 2))
    esn0_db = 10 * math.log10(es / s_time) + snr_db
    return esn0_db - 10 * math.log10(mod_type)


@pytest.mark.parametrize(
    "mod_type,snr_points,t2_level,loss_budget_db,max_erasure", [
        (2, (7.5, 8.5), 0.5, 2.5, 0.08),    # QAM4 at Eb/N0 ~7.4-8.4 dB
        (4, (12.0, 14.5), 0.8, 1.25, 0.0),  # QAM16 at Eb/N0 ~8.4-10.9 dB
    ])
def test_ber_within_budget_of_theory(mod_type, snr_points, t2_level,
                                     loss_budget_db, max_erasure):
    cfg = ModemConfig(mod_type=mod_type, t2_sin_level=t2_level)
    spec = make_frame_spec(cfg, torch.complex64, device="cpu")
    B = 48
    rng = np.random.default_rng(mod_type)
    wire_np = rng.integers(0, 256, (B, cfg.frame_bytes), dtype=np.uint8)
    frames = txm.transmit(spec, torch.from_numpy(wire_np))
    s_time = float((frames.abs() ** 2).mean())

    for i, snr_db in enumerate(snr_points):
        params = ChannelParams(snr_db=snr_db, cfo=1e-4, timing_offset=256,
                               capture_len=cfg.frame_len + 2048)
        caps = apply_channel(params, frames,
                             generator=torch.Generator().manual_seed(100 + i))
        res, s = rxm.receive_batch(spec, caps)
        found = s.found.numpy()
        assert found.all(), (f"mod{mod_type} snr{snr_db}: sync missed "
                             f"{int((~found).sum())}/{B} frames")
        per_frame = np.unpackbits(res.mac_bytes.numpy() ^ wire_np,
                                  axis=1).mean(1)
        erased = per_frame > ERASURE_BER
        assert erased.mean() <= max_erasure, (
            f"mod{mod_type} snr{snr_db}: {int(erased.sum())}/{B} frames "
            f"erased (budget {max_erasure:.0%})")
        ber = float(per_frame[~erased].mean())
        n_err = int(per_frame[~erased].sum() * cfg.frame_bytes * 8)

        ebn0_db = _ebn0_db(mod_type, s_time, snr_db)
        t_mid = _binary_qam_ber(mod_type, ebn0_db)
        t_budget = _binary_qam_ber(mod_type, ebn0_db - loss_budget_db)
        t_sanity = _binary_qam_ber(mod_type, ebn0_db + 2.0)
        assert n_err >= 20, (f"mod{mod_type} snr{snr_db}: too few errors "
                             f"({n_err}) for a meaningful BER estimate")
        assert ber <= t_budget, (
            f"mod{mod_type} snr{snr_db}dB: BER {ber:.2e} exceeds theory at "
            f"{loss_budget_db} dB loss {t_budget:.2e} (theory {t_mid:.2e} "
            f"@ Eb/N0 {ebn0_db:.1f} dB)")
        assert ber >= t_sanity, (
            f"mod{mod_type} snr{snr_db}dB: BER {ber:.2e} is better than "
            f"theory at +2 dB {t_sanity:.2e} — SNR accounting is off")


def test_streaming_ber_within_budget_of_theory():
    """The streaming path (gated sync, carry-over halo, boundary-straddling
    frames) meets the same QAM16 budget as the batch path
    (tests/test_ber_theory.py:128-187)."""
    mod_type, snr_db, loss_budget_db = 4, 14.5, 1.25
    cfg = ModemConfig(mod_type=mod_type)
    spec = make_frame_spec(cfg, torch.complex64, device="cpu")

    rng = np.random.default_rng(99)
    buf_len = cfg.rx_buf_size * cfg.frame_len
    n_bufs = 3
    n_frames = 90        # dense enough that many frames straddle boundaries
    wire = rng.integers(0, 256, (n_frames, cfg.frame_bytes), dtype=np.uint8)
    frames = txm.transmit(spec, torch.from_numpy(wire)).numpy()
    s_time = float((np.abs(frames) ** 2).mean())

    total = n_bufs * buf_len
    slack = total - n_frames * cfg.frame_len
    gaps = rng.multinomial(slack, np.ones(n_frames + 1) / (n_frames + 1))
    sig = np.zeros(total, dtype=np.complex64)
    pos = 0
    for i in range(n_frames):
        pos += gaps[i]
        sig[pos:pos + cfg.frame_len] = frames[i]
        pos += cfg.frame_len
    n = np.arange(total)
    sig = sig * np.exp(2j * np.pi * 1e-4 * n) * 60.0
    noise = (rng.standard_normal(total) + 1j * rng.standard_normal(total))
    sig = (sig + noise * np.sqrt(s_time * 3600 * 10 ** (-snr_db / 10) / 2)
           ).astype(np.complex64)

    state = streaming.init_state(spec)
    got = []
    for b in range(n_bufs):
        state, out = streaming.process_buffer(
            spec, state, torch.from_numpy(sig[b * buf_len:(b + 1) * buf_len]),
            cfg.rx_buf_size + 1)
        for k in torch.nonzero(out.valid).flatten().tolist():
            got.append(out.mac_bytes[k].numpy())
    assert len(got) == n_frames, f"streaming decoded {len(got)}/{n_frames}"

    per_frame = np.unpackbits(np.stack(got) ^ wire, axis=1).mean(1)
    erased = per_frame > ERASURE_BER
    assert not erased.any(), f"{int(erased.sum())} streaming frames erased"
    ber = float(per_frame.mean())
    n_err = int(per_frame.sum() * cfg.frame_bytes * 8)
    ebn0_db = _ebn0_db(mod_type, s_time, snr_db)
    t_budget = _binary_qam_ber(mod_type, ebn0_db - loss_budget_db)
    t_sanity = _binary_qam_ber(mod_type, ebn0_db + 2.0)
    assert n_err >= 20, f"too few errors ({n_err}) for a meaningful estimate"
    assert t_sanity <= ber <= t_budget, (
        f"streaming BER {ber:.2e} outside [theory+2dB {t_sanity:.2e}, "
        f"budget {t_budget:.2e}] @ Eb/N0 {ebn0_db:.1f} dB")
