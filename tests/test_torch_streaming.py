"""The port's streaming receiver on the CPU against the JAX package's
``models/streaming.process_buffer`` on the same numpy-seeded streams.

Streams: random frame_bytes payloads through the JAX ``transmit``, planted at
random gaps (fill 0.8) so frames straddle buffer boundaries, then CFO 1e-4,
amplitude 60 and AWGN at 26 dB, as ``bench.py::_make_rings_cpu`` builds its
rings.  Each
parity test feeds the same S >= 3 consecutive buffers (rx_buf_size 4, except
the one stock-ring test) to both packages and compares every buffer:

* positions, valid, num_found, next_min_pos, frames_seen and the carry
  exactly, in complex64 and complex128;
* mac_bytes exactly: on every slot in complex128, on the valid slots in
  complex64 (an invalid slot demodulates the window at ring start 0, masked
  by ``valid``; its hard decisions on noise flip at float32 rounding);
* diag and cfo within 1e-9 in complex128; in complex64 within 1e-4 on the
  valid slots (two float32 receive paths, as tests/test_torch_chain.py
  holds its constellations).

The JAX gated path gathers with its Pallas kernels in interpret mode
(``extract_backend="pallas"``) or with its XLA gathers (``"xla"``); the port
is held against both.  complex128 runs against ``"xla"`` (the Pallas kernels
are complex64 only).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_ofdm_tpu import ModemConfig as JModemConfig
from c_ofdm_tpu.models import frame as jframe
from c_ofdm_tpu.models import streaming as jst
from c_ofdm_tpu.models import tx as jtx

from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
from c_ofdm_tpu_torch.models import streaming as tst
from c_ofdm_tpu_torch.ops import extract

torch.set_num_threads(1)

ATOL128 = 1e-9
ATOL64 = 1e-4
DT = {"c64": (jnp.complex64, torch.complex64, np.complex64),
      "c128": (jnp.complex128, torch.complex128, np.complex128)}
SMALL = dict(rx_buf_size=4)
CONFIGS = {"stock": {}, "peak_refine": dict(pr_level=0.6),
           "t2sin512": dict(t2sin_size=512)}
EXACT = ("positions", "valid", "num_found")


@functools.cache
def _specs(dtype_name, extract_backend="pallas", config="stock", **kw):
    """(JAX spec, port spec) of one config; cached so each JAX spec
    compiles its process_buffer once per shape."""
    jdt, tdt, _ = DT[dtype_name]
    fields = dict(SMALL, **CONFIGS[config], **kw)
    js = jframe.make_frame_spec(JModemConfig(**fields), dtype=jdt,
                                fft_backend="matmul",
                                extract_backend=extract_backend)
    return js, make_frame_spec(ModemConfig(**fields), tdt, device="cpu")


def _stream(js, seed, S=3, C=0, amp=60.0, snr_db=26.0, cfo=1e-4, fill=0.8):
    """S consecutive buffers [S, n] (C = 0) or [S, C, n] complex128 and the
    planted truth per channel: a list of (stream start, payload)."""
    cfg = js.cfg
    buf = cfg.rx_buf_size * cfg.frame_len
    total = S * buf
    rng = np.random.default_rng(seed)
    rows, truth = [], []
    for _ in range(max(C, 1)):
        nf = int(fill * total / cfg.frame_len)
        payload = rng.integers(0, 256, (nf, cfg.frame_bytes), dtype=np.uint8)
        frames = np.asarray(jtx.transmit(js, jnp.asarray(payload)),
                            dtype=np.complex128)
        # Dirichlet-weighted gaps: equal weights would give a near-regular
        # frame lattice that can miss every buffer boundary
        gaps = rng.multinomial(total - nf * cfg.frame_len,
                               rng.dirichlet(np.ones(nf + 1)))
        sig = np.zeros(total, np.complex128)
        starts = np.cumsum(gaps[:nf]) + cfg.frame_len * np.arange(nf)
        for s, f in zip(starts, frames):
            sig[s:s + cfg.frame_len] = f
        k = np.arange(total)
        std = np.sqrt((np.abs(frames) ** 2).mean() * amp ** 2
                      * 10 ** (-snr_db / 10) / 2)
        sig = (sig * amp * np.exp(2j * np.pi * cfo * k)
               + std * (rng.standard_normal(total)
                        + 1j * rng.standard_normal(total)))
        rows.append(sig)
        truth.append(list(zip(starts.tolist(), payload)))
    blocks = np.stack(rows).reshape(len(rows), S, buf).transpose(1, 0, 2)
    return (blocks[:, 0] if C == 0 else blocks), truth


def _straddles(js, truth, S):
    """Whether some planted frame crosses a buffer boundary."""
    cfg = js.cfg
    buf = cfg.rx_buf_size * cfg.frame_len
    return any(s // buf != (s + cfg.frame_len - 1) // buf
               for ch in truth for s, _ in ch
               if s + cfg.frame_len <= S * buf)


def _run_jax(js, blocks, state=None, max_frames=0, mode="gated", C=0):
    state = state if state is not None else jst.init_state(js, channels=C)
    outs = []
    for blk in blocks:
        state, out = jst.process_buffer(js, state, jnp.asarray(blk),
                                        max_frames, mode)
        outs.append((out, state))
    return outs, state


def _run_port(ts, blocks, state=None, max_frames=0, mode="gated", C=0):
    state = state if state is not None else tst.init_state(ts, channels=C)
    outs = []
    for blk in blocks:
        state, out = tst.process_buffer(ts, state, torch.from_numpy(blk),
                                        max_frames, mode)
        outs.append((out, state))
    return outs, state


def _assert_same(jouts, touts, dtype_name):
    assert len(jouts) == len(touts)
    for b, ((jo, js_), (to, ts_)) in enumerate(zip(jouts, touts)):
        for name in EXACT:
            np.testing.assert_array_equal(np.asarray(getattr(jo, name)),
                                          getattr(to, name).numpy(),
                                          err_msg=f"buffer {b}: {name}")
        for name in ("next_min_pos", "frames_seen", "carry_valid"):
            np.testing.assert_array_equal(np.asarray(getattr(js_, name)),
                                          getattr(ts_, name).numpy(),
                                          err_msg=f"buffer {b}: {name}")
        jc = np.asarray(js_.carry)
        np.testing.assert_array_equal(jc[..., 0] + 1j * jc[..., 1],
                                      ts_.carry.numpy(),
                                      err_msg=f"buffer {b}: carry")
        valid = to.valid.numpy()
        jm, tm = np.asarray(jo.mac_bytes), to.mac_bytes.numpy()
        if dtype_name == "c64":
            jm, tm = jm[valid], tm[valid]
        np.testing.assert_array_equal(jm, tm, err_msg=f"buffer {b}: mac_bytes")
        for name in ("diag", "cfo"):
            want = np.asarray(getattr(jo, name))
            got = getattr(to, name).numpy()
            if dtype_name == "c128":
                np.testing.assert_allclose(want, got, rtol=0, atol=ATOL128,
                                           err_msg=f"buffer {b}: {name}")
            else:
                np.testing.assert_allclose(want[valid], got[valid], rtol=0,
                                           atol=ATOL64,
                                           err_msg=f"buffer {b}: {name}")


def _assert_truth(js, touts, truth, S):
    """Every planted frame that fits in the S buffers decodes exactly once,
    in order, at its planted start, with its payload."""
    cfg = js.cfg
    buf = cfg.rx_buf_size * cfg.frame_len
    for c, planted in enumerate(truth):
        got = []
        for b, (out, _) in enumerate(touts):
            pos = out.positions.numpy()
            valid = out.valid.numpy()
            mac = out.mac_bytes.numpy()
            if pos.ndim == 2:
                pos, valid, mac = pos[c], valid[c], mac[c]
            for k in np.flatnonzero(valid):
                got.append((b * buf - cfg.frame_len + int(pos[k])
                            - cfg.t2sin_size, mac[k]))
        want = [(s, p) for s, p in planted if s + cfg.frame_len < S * buf]
        assert [s for s, _ in got] == [s for s, _ in want], c
        for (_, gb), (_, wb) in zip(got, want):
            np.testing.assert_array_equal(gb, wb)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("C", [0, 3])
def test_gated_matches_jax_c64(backend, C):
    """The slice's acceptance check: gated process_buffer over 3 buffers,
    single-channel (K2) and C = 3 (K3), against both JAX gathers."""
    js, ts = _specs("c64", backend)
    blocks, truth = _stream(js, seed=11 + C, C=C)
    assert _straddles(js, truth, 3)
    blocks = blocks.astype(np.complex64)
    jouts, _ = _run_jax(js, blocks, C=C)
    touts, _ = _run_port(ts, blocks, C=C)
    _assert_same(jouts, touts, "c64")
    _assert_truth(js, touts, truth, 3)


@pytest.mark.parametrize("config,backend", [("peak_refine", "pallas"),
                                            ("t2sin512", "pallas"),
                                            ("t2sin512", "xla")])
def test_gated_configs_match_jax_c64(config, backend):
    js, ts = _specs("c64", backend, config)
    blocks, truth = _stream(js, seed=21)
    assert _straddles(js, truth, 3)
    blocks = blocks.astype(np.complex64)
    jouts, _ = _run_jax(js, blocks)
    touts, _ = _run_port(ts, blocks)
    _assert_same(jouts, touts, "c64")
    _assert_truth(js, touts, truth, 3)


@pytest.mark.parametrize("C", [0, 3])
def test_gated_matches_jax_c128(C):
    js, ts = _specs("c128", "xla")
    blocks, truth = _stream(js, seed=31 + C, C=C)
    jouts, _ = _run_jax(js, blocks, C=C)
    touts, _ = _run_port(ts, blocks, C=C)
    _assert_same(jouts, touts, "c128")
    _assert_truth(js, touts, truth, 3)


@pytest.mark.parametrize("dtype_name,config", [("c64", "stock"),
                                               ("c128", "stock"),
                                               ("c64", "peak_refine")])
def test_dense_matches_jax(dtype_name, config):
    """The dense fallback (overlap-save matched filter over every ring lag,
    greedy walk; sliding-window sidelobe suppression under peak_refine)
    against the JAX dense path, and against the port's own gated path."""
    js, ts = _specs(dtype_name, "xla", config)
    blocks, truth = _stream(js, seed=41)
    blocks = blocks.astype(DT[dtype_name][2])
    jouts, _ = _run_jax(js, blocks, mode="dense")
    touts, _ = _run_port(ts, blocks, mode="dense")
    _assert_same(jouts, touts, dtype_name)
    _assert_truth(js, touts, truth, 3)
    gouts, _ = _run_port(ts, blocks)
    for (d, _), (g, _) in zip(touts, gouts):
        assert torch.equal(d.positions, g.positions)
        assert torch.equal(d.mac_bytes[d.valid], g.mac_bytes[g.valid])


@pytest.mark.parametrize("wire", ["int16", "float32"])
def test_wire_blocks_match_jax(wire):
    """Interleaved [n, 2] blocks: int16 wire samples (divided by the
    config's ``mult``) and float32 re/im pairs."""
    js, ts = _specs("c64", "pallas")
    blocks, truth = _stream(js, seed=51, amp=40.0)
    iq = np.stack([blocks.real, blocks.imag], axis=-1)
    if wire == "int16":
        scaled = np.trunc(iq * js.cfg.mult)
        assert np.abs(scaled).max() < 2 ** 15
        iq = scaled.astype(np.int16)
    else:
        iq = iq.astype(np.float32)
    jouts, _ = _run_jax(js, iq)
    touts, _ = _run_port(ts, iq)
    _assert_same(jouts, touts, "c64")
    _assert_truth(js, touts, truth, 3)


@pytest.mark.parametrize("mode", ["gated", "dense"])
def test_silent_buffer_finds_nothing(mode):
    """All-zero buffers: every top-K slot is a tie among non-peaks; no frame,
    in either package, whichever slots torch.topk picked."""
    js, ts = _specs("c64", "xla")
    n = js.cfg.rx_buf_size * js.cfg.frame_len
    blocks = np.zeros((3, n), np.complex64)
    jouts, _ = _run_jax(js, blocks, mode=mode)
    touts, _ = _run_port(ts, blocks, mode=mode)
    for (jo, js_), (to, ts_) in zip(jouts, touts):
        assert int(to.num_found) == 0 and not bool(to.valid.any())
        assert (to.positions == -1).all()
        np.testing.assert_array_equal(np.asarray(jo.positions),
                                      to.positions.numpy())
        np.testing.assert_array_equal(np.asarray(js_.next_min_pos),
                                      ts_.next_min_pos.numpy())


def test_flooded_gate_matches_jax():
    """More gate peaks than candidate slots (10 weak spurious bursts before
    3 real frames, t2_gate_slack 0, K = 8): top-K keeps the strongest peaks,
    both packages decode the 3 frames at the same positions (the JAX
    package's tests/test_streaming.py::test_gate_candidates_survive_spurious_
    peaks, at an 8-frame ring)."""
    js, ts = _specs("c64", "pallas", rx_buf_size=8, t2_gate_slack=0)
    cfg = js.cfg
    rng = np.random.default_rng(7)
    payload = rng.integers(0, 256, (3, cfg.frame_bytes), dtype=np.uint8)
    frames = np.asarray(jtx.transmit(js, jnp.asarray(payload)))
    buf = cfg.rx_buf_size * cfg.frame_len
    noise_amp = np.sqrt((np.abs(frames) ** 2).mean() * 3600
                        * 10 ** (-26 / 10) / 2)
    burst = frames[0, :cfg.t2sin_size]
    burst = burst / np.sqrt((np.abs(burst) ** 2).mean()) * 2.2 * noise_amp
    sig = np.zeros(buf, np.complex128)
    pos = 5000
    for _ in range(10):
        sig[pos:pos + cfg.t2sin_size] = burst
        pos += 4 * cfg.t2sin_size
    starts = []
    for f in frames:
        sig[pos:pos + cfg.frame_len] = f * 60.0
        starts.append(pos)
        pos += cfg.frame_len + 3000
    sig = (sig + noise_amp * (rng.standard_normal(buf)
                              + 1j * rng.standard_normal(buf))
           ).astype(np.complex64)
    jouts, _ = _run_jax(js, sig[None], max_frames=8)
    touts, _ = _run_port(ts, sig[None], max_frames=8)
    _assert_same(jouts, touts, "c64")
    out = touts[0][0]
    got = out.positions.numpy()[out.valid.numpy()] - cfg.t2sin_size \
        - cfg.frame_len
    np.testing.assert_array_equal(got, starts)
    np.testing.assert_array_equal(out.mac_bytes.numpy()[:3], payload)


def test_stock_ring_matches_jax():
    """The stock 41-frame ring (rx_buf_size 40, 246 656 samples, K = 49
    candidates) over 3 buffers, as bench.py's streaming metric builds it."""
    js, ts = _specs("c64", "xla", rx_buf_size=40)
    blocks, truth = _stream(js, seed=61)
    assert _straddles(js, truth, 3)
    blocks = blocks.astype(np.complex64)
    jouts, _ = _run_jax(js, blocks)
    touts, _ = _run_port(ts, blocks)
    _assert_same(jouts, touts, "c64")
    _assert_truth(js, touts, truth, 3)


@pytest.mark.parametrize("direction,C", [("jax_to_port", 0),
                                         ("port_to_jax", 3)])
def test_state_files_cross_packages(direction, C, tmp_path):
    """A checkpoint written by one package after buffer 2 resumes in the
    other: buffer 3 gives the same outputs and state as the uninterrupted
    run."""
    js, ts = _specs("c64", "pallas")
    blocks, _ = _stream(js, seed=71 + C, C=C)
    blocks = blocks.astype(np.complex64)
    jouts, _ = _run_jax(js, blocks, C=C)
    path = str(tmp_path / "state")
    if direction == "jax_to_port":
        _, jstate = _run_jax(js, blocks[:2], C=C)
        jst.save_state(path, jstate)
        state = tst.load_state(path, device="cpu")
        assert state.carry.dtype == torch.complex64
        resumed, _ = _run_port(ts, blocks[2:], state=state)
        _assert_same(jouts[2:], resumed, "c64")
    else:
        _, tstate = _run_port(ts, blocks[:2], C=C)
        tst.save_state(path, tstate)
        state = jst.load_state(path)
        assert state.carry.shape == (C, js.cfg.frame_len, 2)
        resumed, _ = _run_jax(js, blocks[2:], state=state)
        touts, _ = _run_port(ts, blocks, C=C)
        _assert_same(resumed, touts[2:], "c64")


def test_streaming_receiver_module():
    """StreamingReceiver: feed equals process_buffer, feed_int16 equals the
    JAX receiver's feed_int16, and .to() moves constants and state."""
    js, ts = _specs("c64", "pallas")
    blocks, _ = _stream(js, seed=81, C=2, amp=40.0)
    blocks = blocks.astype(np.complex64)
    rxr = tst.StreamingReceiver(ts, channels=2)
    want, _ = _run_port(ts, blocks, C=2)
    for blk, (w, _) in zip(blocks, want):
        got = rxr.feed(torch.from_numpy(blk))
        for name in tst.StreamOut._fields:
            torch.testing.assert_close(getattr(got, name), getattr(w, name),
                                       rtol=0, atol=0, equal_nan=True,
                                       msg=name)
    assert int(rxr.state.frames_seen.sum()) == int(
        sum(int(w.num_found.sum()) for w, _ in want))

    raw = np.stack([blocks[:, 0].real, blocks[:, 0].imag], axis=-1)
    raw = np.trunc(raw * js.cfg.mult).astype(np.int16).reshape(3, -1)
    jr = jst.StreamingReceiver(js)
    tr = tst.StreamingReceiver(ts)
    for r in raw:
        jo = jr.feed_int16(r)
        to = tr.feed_int16(torch.from_numpy(r))
        for name in EXACT:
            np.testing.assert_array_equal(np.asarray(getattr(jo, name)),
                                          getattr(to, name).numpy(), name)
        v = to.valid.numpy()
        np.testing.assert_array_equal(np.asarray(jo.mac_bytes)[v],
                                      to.mac_bytes.numpy()[v])
    assert int(to.num_found) > 0

    tr.to("meta")
    assert tr.state.carry.device.type == "meta"
    assert all(t.device.type == "meta" for t in tr.bound_spec().tensors.values())
    assert ts.device == torch.device("cpu")


def test_cpu_path_counts_no_launches_and_rejects_bad_modes():
    js, ts = _specs("c64", "pallas")
    n = ts.cfg.rx_buf_size * ts.cfg.frame_len
    counts = (extract.extract_windows_single.launches,
              extract.extract_windows_multi.launches)
    tst.process_buffer(ts, tst.init_state(ts, channels=2),
                       torch.zeros((2, n), dtype=torch.complex64))
    tst.process_buffer(ts, tst.init_state(ts),
                       torch.zeros(n, dtype=torch.complex64))
    assert counts == (extract.extract_windows_single.launches,
                      extract.extract_windows_multi.launches)
    with pytest.raises(NotImplementedError, match="single-channel"):
        tst.process_buffer(ts, tst.init_state(ts, channels=2),
                           torch.zeros((2, n), dtype=torch.complex64),
                           sync_mode="dense")
    with pytest.raises(ValueError, match="sync_mode"):
        tst.process_buffer(ts, tst.init_state(ts),
                           torch.zeros(n, dtype=torch.complex64),
                           sync_mode="sparse")
