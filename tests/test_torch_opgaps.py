"""The last op gaps of the port against the JAX package on the CPU:
``find_t2sin`` and ``synchronize`` at a nonzero or per-row start,
``unwrap_one_step`` and ``chan_est_lq(exact_unwrap=True)``, the
single-capture slices ``extract_frame`` / ``extract_sig``,
``demod_frames``, ``dense_preamble_corr`` and ``init_state(spec, dtype,
channels)`` in the JAX argument order.

Positions, flags and bytes exactly; complex128 floats within 1e-9.  The
complex64 dense score within 2e-3: its energy normalisation is a float32
running sum over the whole ring (values to ~1e7, one ulp ~1), which XLA and
PyTorch accumulate in different orders.
"""

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
from c_ofdm_tpu.ops import chanest as jchanest
from c_ofdm_tpu.ops import sync as jsync

from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
from c_ofdm_tpu_torch.models import rx as trx
from c_ofdm_tpu_torch.models import streaming as tst
from c_ofdm_tpu_torch.ops import chanest as tchanest
from c_ofdm_tpu_torch.ops import sync as tsync

torch.set_num_threads(1)

DT = {"c64": (jnp.complex64, torch.complex64, np.complex64),
      "c128": (jnp.complex128, torch.complex128, np.complex128)}
CFG = ModemConfig()
EXTRA = 2048


def _specs(dtype_name="c128", **kw):
    jdt, tdt, _ = DT[dtype_name]
    js = jframe.make_frame_spec(JModemConfig(**kw), dtype=jdt,
                                fft_backend="matmul")
    return js, make_frame_spec(ModemConfig(**kw), tdt, device="cpu")


def _captures(js, np_dtype, rows=4, seed=0):
    """rows captures of frame_len + EXTRA samples, each holding one frame at
    a random offset with CFO 1e-4, amplitude 40 and AWGN at 30 dB; returns
    (captures, offsets)."""
    cfg = js.cfg
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, (rows, cfg.frame_bytes), dtype=np.uint8)
    frames = np.asarray(jtx.transmit(js, jnp.asarray(payload)),
                        dtype=np.complex128)
    n = cfg.frame_len + EXTRA
    offs = rng.integers(0, EXTRA, rows)
    caps = np.zeros((rows, n), np.complex128)
    for b in range(rows):
        caps[b, offs[b]:offs[b] + cfg.frame_len] = frames[b] * 40.0
    caps *= np.exp(2j * np.pi * 1e-4 * np.arange(n))
    std = np.sqrt((np.abs(frames) ** 2).mean() * 1600 * 1e-3 / 2)
    caps += std * (rng.standard_normal((rows, n))
                   + 1j * rng.standard_normal((rows, n)))
    return caps.astype(np_dtype), offs


def _starts(n, size):
    """Starts through the capture, near its end and past both ends."""
    return [0, 37, 300, 1000, n - 2 * size - 5, n - size, n - size + 1,
            n - 3, n, n + 5, -5]


@pytest.mark.parametrize("backend", ["partial", "fft"])
@pytest.mark.parametrize("dtype_name", sorted(DT))
def test_find_t2sin_at_int_starts(dtype_name, backend):
    js, ts = _specs(dtype_name)
    caps, _ = _captures(js, DT[dtype_name][2])
    n = caps.shape[-1]
    for start in _starts(n, CFG.t2sin_size):
        pj, fj = jsync.find_t2sin(js, jnp.asarray(caps), start, backend)
        pt, ft = tsync.find_t2sin(ts, torch.from_numpy(caps), start, backend)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj),
                                      err_msg=str(start))
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))


@pytest.mark.parametrize("dtype_name", sorted(DT))
def test_find_t2sin_at_per_row_starts(dtype_name):
    """A [B] tensor of starts, one per row (the JAX function under vmap),
    including starts near n; and a 0-d tensor start."""
    js, ts = _specs(dtype_name)
    caps, _ = _captures(js, DT[dtype_name][2], rows=11, seed=1)
    n = caps.shape[-1]
    starts = np.asarray(_starts(n, CFG.t2sin_size), dtype=np.int64)
    pj, fj = jax.vmap(lambda c, s: jsync.find_t2sin(js, c, s))(
        jnp.asarray(caps), jnp.asarray(starts))
    for st in (torch.from_numpy(starts), torch.from_numpy(starts).int()):
        pt, ft = tsync.find_t2sin(ts, torch.from_numpy(caps), st)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert ft[:3].all() and not ft[-4:-1].any()
    p0, _ = tsync.find_t2sin(ts, torch.from_numpy(caps[2]),
                             torch.tensor(300))
    assert int(p0) == int(pj[2])


def test_synchronize_at_a_start():
    js, ts = _specs("c64")
    caps, offs = _captures(js, np.complex64, rows=4, seed=2)
    starts = np.asarray([0, 64, int(offs[2]) // 2, 100], dtype=np.int64)
    sj = jax.vmap(lambda c, s: jrx.synchronize(js, c, s))(
        jnp.asarray(caps), jnp.asarray(starts))
    for start in (torch.from_numpy(starts), 64):
        want = sj if not isinstance(start, int) else jax.vmap(
            lambda c: jrx.synchronize(js, c, 64))(jnp.asarray(caps))
        st = trx.synchronize(ts, torch.from_numpy(caps), start)
        for name in ("frame_start", "t2_begin", "pr_begin", "found"):
            np.testing.assert_array_equal(getattr(st, name).numpy(),
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)
    # from a block-aligned start the frames are found where they were put;
    # from another start both packages read the preamble window from the
    # start of its t2 block but count lags from the start itself, so the
    # positions above are shifted by the start's remainder (start % 256)
    st = trx.synchronize(ts, torch.from_numpy(caps), 0)
    np.testing.assert_array_equal(st.frame_start.numpy(), offs)


def test_unwrap_one_step_and_exact_chan_est():
    rng = np.random.default_rng(3)
    phase = np.cumsum(rng.uniform(-4.5, 4.5, (3, 127)), axis=-1)
    uj = np.asarray(jchanest.unwrap_one_step(jnp.asarray(phase)))
    ut = tchanest.unwrap_one_step(torch.from_numpy(phase)).numpy()
    np.testing.assert_array_equal(ut, uj)
    assert not np.array_equal(
        tchanest.unwrap_fast(torch.from_numpy(phase)).numpy(), ut)
    for kw in ({}, dict(num_pr_symb=2)):
        js, ts = _specs("c128", **kw)
        caps, offs = _captures(js, np.complex128, rows=2, seed=4)
        cfg = ts.cfg
        pre = np.stack([caps[b, offs[b] + cfg.t2sin_size:
                             offs[b] + cfg.t2sin_size + cfg.preamble_len]
                        for b in range(2)])
        for exact in (True, False):
            cj = np.asarray(jchanest.chan_est_lq(js, jnp.asarray(pre),
                                                 exact))
            ct = tchanest.chan_est_lq(ts, torch.from_numpy(pre), exact)
            np.testing.assert_allclose(ct.numpy(), cj, rtol=0, atol=1e-9)


def test_extract_frame_sig_and_demod_frames():
    js, ts = _specs("c128")
    caps, offs = _captures(js, np.complex128, rows=2, seed=5)
    cap = caps[0]
    n, cfg = cap.size, ts.cfg
    for s in (0, int(offs[0]), n - cfg.frame_len, n - 3, -40, 10 ** 6):
        for fn_j, fn_t in ((jrx.extract_frame, trx.extract_frame),
                           (jrx.extract_sig, trx.extract_sig)):
            want = np.asarray(fn_j(js, jnp.asarray(cap), s))
            for start in (s, torch.tensor(s)):
                got = fn_t(ts, torch.from_numpy(cap), start)
                np.testing.assert_array_equal(got.numpy(), want)
    frames = np.stack([trx.extract_frame(ts, torch.from_numpy(caps[b]),
                                         int(offs[b])).numpy()
                       for b in range(2)])
    for est in ("lq", "full"):
        dj = jrx.demod_frames_jit(js, jnp.asarray(frames), est)
        dt = trx.demod_frames(ts, torch.from_numpy(frames), est)
        np.testing.assert_array_equal(dt.mac_bytes.numpy(),
                                      np.asarray(dj.mac_bytes))
        for name in ("constellation", "chan_est", "cfo"):
            np.testing.assert_allclose(getattr(dt, name).numpy(),
                                       np.asarray(getattr(dj, name)),
                                       rtol=0, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("dtype_name", sorted(DT))
def test_dense_preamble_corr(dtype_name):
    """The dense score over a 4-frame ring (the overlap-save branch) and a
    short window (the banded-Toeplitz branch), with a channel axis."""
    js, ts = _specs(dtype_name, rx_buf_size=4)
    caps, _ = _captures(js, DT[dtype_name][2], rows=2, seed=6)
    for x in (caps, caps[:, :1500]):
        want = np.asarray(jst.dense_preamble_corr(js, jnp.asarray(x)))
        got = tst.dense_preamble_corr(ts, torch.from_numpy(x)).numpy()
        atol = 1e-9 if dtype_name == "c128" else 2e-3
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_init_state_takes_the_jax_argument_order():
    js, ts = _specs("c64")
    for args in ((), (None, 3), (torch.complex128, 3), (torch.float64, 3),
                 (torch.float32,)):
        jargs = tuple({torch.complex128: jnp.complex128,
                       torch.float64: jnp.float64,
                       torch.float32: jnp.float32}.get(a, a) for a in args)
        sj = jst.init_state(js, *jargs)
        st = tst.init_state(ts, *args)
        # the JAX carry is re/im reals [..., frame_len, 2]; the port's is
        # complex [..., frame_len] of the matching precision
        assert st.carry.shape == sj.carry.shape[:-1]
        assert st.carry.real.dtype == {jnp.float32: torch.float32,
                                       jnp.float64: torch.float64}[
            jnp.dtype(sj.carry.dtype).type]
        for name in ("carry_valid", "next_min_pos", "frames_seen"):
            assert getattr(st, name).shape == getattr(sj, name).shape
            assert not getattr(st, name).any()
    assert tst.init_state(ts, channels=2).carry.dtype == torch.complex64
