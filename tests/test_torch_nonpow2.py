"""The port at FFT sizes that are no power of two, on the CPU, against the
JAX package under ``fft_backend="pallas"``: every complex64 FFT goes
through K4 (the port's plain version here; the JAX ``dft_pallas`` in
interpret mode), whose mixed-radix and Bluestein routes serve these sizes on
the card.

Geometries: LTE's 15 MHz numerology (3GPP TS 36.211: a 1536-point FFT,
normal CP 108) with 768 data and 16 pilot subcarriers, and ModemConfig's
500-point FFT with 256 data and 8 pilot subcarriers, CP 125.

Tolerances: transmit within 2e-6·max|x| (two float32 DFTs of the same
float32 planes, summed in another order); positions, ``found`` /
``valid`` and decoded bytes exactly, and the bytes equal to the payloads.
``torch.set_num_threads(1)``; a few seconds of JAX compiles per test.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_ofdm_tpu import ModemConfig as JModemConfig
from c_ofdm_tpu.models import frame as jframe
from c_ofdm_tpu.models import rx as jrx
from c_ofdm_tpu.models import streaming as jst
from c_ofdm_tpu.models import tx as jtx

from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
from c_ofdm_tpu_torch.models import rx as trx
from c_ofdm_tpu_torch.models import streaming as tst
from c_ofdm_tpu_torch.models import tx as ttx
from c_ofdm_tpu_torch.ops import dft

torch.set_num_threads(1)

GEOMETRIES = {
    "lte1536": dict(fft_size=1536, num_data_subc=768, num_pilot_subc=16,
                    cp_size=108),
    "n500": dict(fft_size=500, num_data_subc=256, num_pilot_subc=8,
                 cp_size=125),
}
_jit_receive_batch = jax.jit(jrx.receive_batch, static_argnums=(0,))


@functools.cache
def _specs(name, **kw):
    fields = dict(GEOMETRIES[name], **kw)
    js = jframe.make_frame_spec(JModemConfig(**fields), dtype=jnp.complex64,
                                fft_backend="pallas", extract_backend="pallas")
    ts = make_frame_spec(ModemConfig(**fields), torch.complex64, device="cpu",
                         fft_backend="pallas")
    return js, ts


def _captures(frames, rng, extra=256, amp=40.0, cfo=1e-4, snr_db=30.0):
    """Each frame at a random offset in a capture of frame_len + extra
    samples, with CFO, amplitude and AWGN; returns (complex64 captures,
    offsets)."""
    b, n = frames.shape
    offs = rng.integers(1, extra + 1, b)
    caps = np.zeros((b, n + extra), np.complex128)
    for i in range(b):
        caps[i, offs[i]:offs[i] + n] = frames[i]
    k = np.arange(n + extra)
    std = np.sqrt((np.abs(frames) ** 2).mean() * amp ** 2
                  * 10 ** (-snr_db / 10) / 2)
    caps = (caps * amp * np.exp(2j * np.pi * cfo * k)
            + std * (rng.standard_normal(caps.shape)
                     + 1j * rng.standard_normal(caps.shape)))
    return caps.astype(np.complex64), offs


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_transmit_and_receive_batch_match_jax(name):
    """transmit, then receive_batch of B = 4 impaired captures (random
    offsets, amplitude 40, CFO 1e-4, 30 dB): the port equals the JAX package
    in frame_start, t2_begin, pr_begin, found and the decoded bytes; the
    bytes are the payloads, at the 500-point geometry on the clean frames
    (there both packages mis-decode a CFO of exactly +1e-4, ROADMAP Queue
    3)."""
    js, ts = _specs(name)
    assert dft._route(js.cfg.fft_size) == "mixed"
    rng = np.random.default_rng(js.cfg.fft_size)
    payload = rng.integers(0, 256, (4, js.cfg.frame_bytes), dtype=np.uint8)
    fj = np.asarray(jtx.transmit(js, jnp.asarray(payload)))
    ft = ttx.transmit(ts, torch.from_numpy(payload)).numpy()
    assert ft.dtype == np.complex64 and ft.shape == fj.shape
    np.testing.assert_allclose(ft, fj, rtol=0, atol=2e-6 * np.abs(fj).max())
    caps, offs = _captures(fj.astype(np.complex128), rng)
    rj, sj = _jit_receive_batch(js, jnp.asarray(caps))
    rt, st = trx.receive_batch(ts, torch.from_numpy(caps))
    for field in ("frame_start", "t2_begin", "pr_begin", "found"):
        np.testing.assert_array_equal(getattr(st, field).numpy(),
                                      np.asarray(getattr(sj, field)),
                                      err_msg=field)
    assert st.found.numpy().all()
    np.testing.assert_array_equal(st.frame_start.numpy(), offs)
    np.testing.assert_array_equal(rt.mac_bytes.numpy(),
                                  np.asarray(rj.mac_bytes))
    if name == "lte1536":
        np.testing.assert_array_equal(rt.mac_bytes.numpy(), payload)
    clean, _ = trx.receive_batch(ts, torch.from_numpy(ft))
    np.testing.assert_array_equal(clean.mac_bytes.numpy(), payload)


def test_streaming_1536_matches_jax():
    """Three consecutive 4-frame buffers of the 1536 geometry (frames at
    random gaps, straddling buffer boundaries, CFO 1e-4, 26 dB) through both
    packages' gated process_buffer: positions, valid and the valid slots'
    bytes exactly equal, and every planted frame decoded once."""
    js, ts = _specs("lte1536", rx_buf_size=4)
    cfg = js.cfg
    buf = cfg.rx_buf_size * cfg.frame_len
    S = 3
    total = S * buf
    rng = np.random.default_rng(36)
    nf = int(0.8 * total / cfg.frame_len)
    payload = rng.integers(0, 256, (nf, cfg.frame_bytes), dtype=np.uint8)
    frames = np.asarray(jtx.transmit(js, jnp.asarray(payload)),
                        dtype=np.complex128)
    gaps = rng.multinomial(total - nf * cfg.frame_len,
                           rng.dirichlet(np.ones(nf + 1)))
    starts = np.cumsum(gaps[:nf]) + cfg.frame_len * np.arange(nf)
    sig = np.zeros(total, np.complex128)
    for s, f in zip(starts, frames):
        sig[s:s + cfg.frame_len] = f
    k = np.arange(total)
    std = np.sqrt((np.abs(frames) ** 2).mean() * 3600 * 10 ** -2.6 / 2)
    sig = (sig * 60 * np.exp(2j * np.pi * 1e-4 * k)
           + std * (rng.standard_normal(total)
                    + 1j * rng.standard_normal(total)))
    blocks = sig.astype(np.complex64).reshape(S, buf)
    jstate, tstate = jst.init_state(js), tst.init_state(ts)
    decoded = []
    for b, blk in enumerate(blocks):
        jstate, jo = jst.process_buffer(js, jstate, jnp.asarray(blk))
        tstate, to = tst.process_buffer(ts, tstate, torch.from_numpy(blk))
        for field in ("positions", "valid", "num_found"):
            np.testing.assert_array_equal(getattr(to, field).numpy(),
                                          np.asarray(getattr(jo, field)),
                                          err_msg=f"buffer {b} {field}")
        v = to.valid.numpy()
        np.testing.assert_array_equal(to.mac_bytes.numpy()[v],
                                      np.asarray(jo.mac_bytes)[v])
        decoded += [(b * buf - cfg.frame_len + int(p) - cfg.t2sin_size,
                     bytes(m)) for p, m in zip(to.positions.numpy()[v],
                                               to.mac_bytes.numpy()[v])]
    np.testing.assert_array_equal(tstate.frames_seen.numpy(),
                                  np.asarray(jstate.frames_seen))
    want = [(int(s), payload[i].tobytes()) for i, s in enumerate(starts)
            if s + cfg.frame_len < total]
    assert len(want) >= 8
    assert decoded == want
