"""The port at LTE 5G broadcast's 0.37 kHz numerology, on the CPU.

3GPP TS 36.211 (Rel-16) gives the LTE-based 5G terrestrial broadcast a
subcarrier spacing of 0.37 kHz: an 82944-point FFT at 30.72 MHz with a
9216-sample cyclic prefix, 100 RB x 486 = 48600 occupied subcarriers at
20 MHz.  The geometry here occupies those 48600 (48000 data, 600 pilots),
2 QAM64 symbols a frame (276 736 samples, 72 000 bytes).  82944 = 2^10·3^4
is past 65536, so K4 takes it on the cluster route with a non-portable
cluster (``dft._cluster_split``: 12 blocks of 6912 points); its plain
version ``dft_cluster_ref`` runs here.  The port under ``fft_backend=
"pallas"`` is held against the JAX package under ``xla``.

The matched filter here is 4096 taps long.  The JAX package's overlap-save
chunk is 4096 points at every filter length, so each of its chunks yields
one lag (hop 1); the port sizes its chunk from the filter
(``sync.overlap_save_len``: 16384 points, 12289 lags a chunk), so the
sync's 8704-lag regions take one chunk a row.  The port's chunks are held
against the JAX package's hop 1, within one chunk and across two seams.

Tolerances: transmit within 2e-6·max|x| (two float32 inverse DFTs of
~1.7e-7·max|x| error each); the matched-filter scores within 1e-5 of the
largest (float32 FFT correlations of 4096 taps); positions, ``found`` and
decoded bytes exactly, the bytes equal to the payloads.
``torch.set_num_threads(1)``; the JAX run is made once per module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from c_ofdm_tpu import ModemConfig as JModemConfig
from c_ofdm_tpu.models import frame as jframe
from c_ofdm_tpu.models import rx as jrx
from c_ofdm_tpu.models import tx as jtx
from c_ofdm_tpu.ops import sync as jsync

from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
from c_ofdm_tpu_torch.models import rx as trx
from c_ofdm_tpu_torch.models import tx as ttx
from c_ofdm_tpu_torch.ops import dft
from c_ofdm_tpu_torch.ops import sync as tsync

torch.set_num_threads(1)

BROADCAST = dict(fft_size=82944, num_data_subc=48000, num_pilot_subc=600,
                 cp_size=9216, num_symb=2, pr_sin_len=4096, mod_type=6)
B = 2
CFO = 2e-6          # 0.17 of a subcarrier
EXTRA = 4096        # captures are frame_len + EXTRA samples


def _impaired(frames, rng, amp=10.0, snr_db=30.0):
    """Each frame at a random offset in [0, EXTRA] of a capture of
    frame_len + EXTRA samples, with CFO, amplitude and AWGN; returns
    (complex64 captures, offsets)."""
    b, n = frames.shape
    offs = rng.integers(0, EXTRA + 1, b)
    caps = np.zeros((b, n + EXTRA), np.complex128)
    for i in range(b):
        caps[i, offs[i]:offs[i] + n] = frames[i]
    k = np.arange(n + EXTRA)
    std = np.sqrt((np.abs(frames) ** 2).mean() * amp ** 2
                  * 10 ** (-snr_db / 10) / 2)
    caps = (caps * amp * np.exp(2j * np.pi * CFO * k)
            + std * (rng.standard_normal(caps.shape)
                     + 1j * rng.standard_normal(caps.shape)))
    return caps.astype(np.complex64), offs


@functools.cache
def _jax_run():
    """The JAX package under xla: payloads, transmitted frames, impaired
    captures with their offsets, and receive_batch's results on them."""
    js = jframe.make_frame_spec(JModemConfig(**BROADCAST),
                                dtype=jnp.complex64, fft_backend="xla")
    rng = np.random.default_rng(82944)
    payload = rng.integers(0, 256, (B, js.cfg.frame_bytes), dtype=np.uint8)
    frames = np.asarray(jtx.transmit(js, jnp.asarray(payload)))
    caps, offs = _impaired(frames.astype(np.complex128), rng)
    res, sync = jax.jit(jrx.receive_batch, static_argnums=(0,))(
        js, jnp.asarray(caps))
    return js, payload, frames, caps, offs, jax.device_get((res, sync))


@functools.cache
def _spec():
    return make_frame_spec(ModemConfig(**BROADCAST), torch.complex64,
                           device="cpu", fft_backend="pallas")


@functools.cache
def _port_tx():
    _, payload, *_ = _jax_run()
    return ttx.transmit(_spec(), torch.from_numpy(payload))


def test_broadcast_geometry():
    """The configuration's frame and K4's route at its FFT size: the
    cluster route at 12 blocks of 6912 points, past 65536 points."""
    cfg = _spec().cfg
    assert (cfg.frame_len, cfg.frame_bytes, cfg.preamble_len) == (
        276736, 72000, 92160)
    assert dft._route(cfg.fft_size) == "cluster"
    assert dft._cluster_split(cfg.fft_size) == (12, 6912)


def test_broadcast_matched_filter_at_one_lag_a_chunk_matches_jax():
    """matched_filter_scores with a 4096-tap filter on 6000 lags (the
    overlap-save branch: one 16384-point chunk a row in the port, 6000
    4096-point chunks of one lag each in the JAX package) equals the JAX
    package's within 1e-5 of the largest score."""
    js, *_ = _jax_run()
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((B, 6000))
         + 1j * rng.standard_normal((B, 6000))).astype(np.complex64) * 4
    want = np.asarray(jsync.matched_filter_scores(js, jnp.asarray(x)))
    got = tsync.matched_filter_scores(_spec(), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_broadcast_matched_filter_across_chunk_seams_matches_jax():
    """The same on 30000 lags, where the port's three 12289-lag chunks
    meet at two seams (lags 12289 and 24578) and a preamble is planted at
    the first: within 1e-5 of the largest of the JAX package's scores,
    which it computes here on 5000-lag pieces of the row (at hop 1 each
    lag is its own chunk, so a piece runs the same 4096-point chunks as
    the whole row), the planted lag the largest."""
    js, *_ = _jax_run()
    L, n, piece = 4096, 30000, 5000
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((1, n))
         + 1j * rng.standard_normal((1, n))) * 4
    x[:, 12289:12289 + L] += 100 * np.conj(js.matched_filter)
    x = x.astype(np.complex64)
    want = np.concatenate(
        [np.asarray(jsync.matched_filter_scores(
            js, jnp.asarray(x[:, a:a + piece + L - 1])))[:, :piece]
         for a in range(0, n, piece)], axis=-1)
    got = tsync.matched_filter_scores(_spec(), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == x.shape
    assert tsync.overlap_save_len(L) - L + 1 == 12289
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert np.argmax(want[0]) == np.argmax(got[0]) == 12289


def test_broadcast_transmit_pallas_matches_jax_xla():
    """transmit at B = 2 under pallas (K4's cluster route: its plain
    version here) within 2e-6·max|x| of the JAX package under xla, with
    no n x n twiddle planes built."""
    _, payload, fj, *_ = _jax_run()
    planes = dft.dft_planes.cache_info()
    ft = _port_tx().numpy()
    assert ft.dtype == np.complex64 and ft.shape == fj.shape
    np.testing.assert_allclose(ft, fj, rtol=0, atol=2e-6 * np.abs(fj).max())
    assert dft.dft_planes.cache_info() == planes


def test_broadcast_receive_pallas_matches_jax_xla():
    """receive_batch under pallas on impaired captures (offsets in [0,
    4096], CFO 2e-6, 30 dB): frame_start, t2_begin, pr_begin, found and the
    bytes exactly the JAX package's under xla, the offsets the planted
    ones and the bytes the payloads; the port's clean frames decode to the
    payloads; no n x n twiddle planes built."""
    _, payload, _, caps, offs, (rj, sj) = _jax_run()
    planes = dft.dft_planes.cache_info()
    rt, st = trx.receive_batch(_spec(), torch.from_numpy(caps))
    for field in ("frame_start", "t2_begin", "pr_begin", "found"):
        np.testing.assert_array_equal(getattr(st, field).numpy(),
                                      np.asarray(getattr(sj, field)),
                                      err_msg=field)
    assert st.found.numpy().all()
    np.testing.assert_array_equal(st.frame_start.numpy(), offs)
    np.testing.assert_array_equal(rt.mac_bytes.numpy(),
                                  np.asarray(rj.mac_bytes))
    np.testing.assert_array_equal(rt.mac_bytes.numpy(), payload)
    clean, s = trx.receive_batch(_spec(), _port_tx())
    assert s.found.numpy().all() and not s.frame_start.numpy().any()
    np.testing.assert_array_equal(clean.mac_bytes.numpy(), payload)
    assert dft.dft_planes.cache_info() == planes
