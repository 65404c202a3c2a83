"""The port's compiled entry points on the CPU, against the JAX package's.

``transmit_jit``, ``receive_batch_jit``, ``receive_capture_jit`` and
``demod_frames_jit`` (``c_ofdm_tpu_torch/models/{tx,rx}.py``) run as CUDA
graphs on the card and eagerly on CPU tensors (``utils/graphs.py::jit``).
Here the same numpy-seeded inputs go through the JAX package's jitted
functions and the port's counterparts.  Tolerances: bytes, positions and
``found`` exactly; complex128 within 1e-9; complex64 TX within 1e-5 and the
received constellation within 1e-4 (two float32 receive paths, as
tests/test_torch_chain.py holds them) with the bytes equal.  JAX's
``receive_batch_jit`` vmaps ``receive_capture`` over the batch; the port's
is its batch-native ``receive_batch``: the two agree.

The no-host-constant guard: a step that makes a tensor from host data while
it runs (``torch.as_tensor``, ``torch.from_numpy``, ``torch.tensor``) does a
pageable host-to-device copy on the card, which a CUDA-graph capture
refuses.  After one warm-up call (which fills the per-device caches, as the
captured call's warm-up does), those three are made to raise while each
entry point runs, on the stock config under every ``fft_backend``, the
wideband 8k geometry under ``ct``, a BPSK config, a non-canonical bin
layout, and the streaming receiver gated at C = 0 and C = 2 and dense at
C = 0 (dense is single-channel), with complex, interleaved float and int16
blocks.
"""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_ofdm_tpu import ModemConfig as JModemConfig
from c_ofdm_tpu.models import frame as jframe
from c_ofdm_tpu.models import rx as jrx
from c_ofdm_tpu.models import tx as jtx

from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
from c_ofdm_tpu_torch.models import frame as tframe
from c_ofdm_tpu_torch.models import rx as trx
from c_ofdm_tpu_torch.models import streaming as tst
from c_ofdm_tpu_torch.models import tx as ttx
from c_ofdm_tpu_torch.models.modem import FlagshipStep
from c_ofdm_tpu_torch.ops import dft, extract, fft
from c_ofdm_tpu_torch.utils import graphs

from test_torch_chain import _assert_sync_equal, _mixed_batch

torch.set_num_threads(1)

DT = {"c64": (jnp.complex64, torch.complex64, np.complex64),
      "c128": (jnp.complex128, torch.complex128, np.complex128)}
WIDEBAND = dict(fft_size=8192, num_data_subc=4096, num_pilot_subc=32,
                cp_size=1024, num_symb=2, pr_sin_len=512, mod_type=6)


def _specs(dtype_name, **kw):
    jdt, tdt, _ = DT[dtype_name]
    js = jframe.make_frame_spec(JModemConfig(**kw), dtype=jdt,
                                fft_backend="matmul")
    ts = make_frame_spec(ModemConfig(**kw), tdt, device="cpu")
    return js, ts


def _close(want, got, dtype_name, err_msg=""):
    atol = 1e-9 if dtype_name == "c128" else 1e-4
    np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=0,
                               atol=atol, err_msg=err_msg)


@pytest.mark.parametrize("dtype_name", ["c64", "c128"])
def test_transmit_jit_matches_jax(dtype_name):
    js, ts = _specs(dtype_name)
    payload = np.random.default_rng(1).integers(
        0, 256, (4, js.cfg.frame_bytes), dtype=np.uint8)
    fj = np.asarray(jtx.transmit_jit(js, jnp.asarray(payload)))
    ft = ttx.transmit_jit(ts, torch.from_numpy(payload))
    atol = 1e-9 if dtype_name == "c128" else 1e-5
    np.testing.assert_allclose(fj, ft.numpy(), rtol=0, atol=atol)
    assert torch.equal(ft, ttx.transmit(ts, torch.from_numpy(payload)))
    assert not ttx.transmit_jit.graphs.graphs      # CPU tensors: eager


@pytest.mark.parametrize("dtype_name", ["c64", "c128"])
def test_receive_batch_jit_matches_jax(dtype_name):
    """JAX's vmapped receive_capture against the port's batch-native
    receive_batch on the mixed batch: sync fields exact, bytes of the found
    rows exact and equal to the payloads, constellation within tolerance."""
    js, ts = _specs(dtype_name)
    caps, offs, payload = _mixed_batch(js, np.random.default_rng(2),
                                       DT[dtype_name][2])
    rj, sj = jrx.receive_batch_jit(js, jnp.asarray(caps))
    rt, st = trx.receive_batch_jit(ts, torch.from_numpy(caps))
    _assert_sync_equal(sj, st)
    found = st.found.numpy()
    assert found.tolist() == [True] * 5 + [False]
    np.testing.assert_array_equal(st.frame_start.numpy()[:5], offs)
    np.testing.assert_array_equal(rt.mac_bytes.numpy()[:5], payload)
    np.testing.assert_array_equal(np.asarray(rj.mac_bytes)[found],
                                  rt.mac_bytes.numpy()[found])
    _close(np.asarray(rj.constellation)[found],
           rt.constellation[torch.from_numpy(found)], dtype_name)
    _close(np.asarray(rj.cfo)[found], rt.cfo[torch.from_numpy(found)],
           dtype_name)


@pytest.mark.parametrize("row", [0, 3, 5])
@pytest.mark.parametrize("dtype_name", ["c64", "c128"])
def test_receive_capture_jit_matches_jax(dtype_name, row):
    """One capture: a clean frame at 0, an impaired one at a random offset,
    and the all-zero row (found False in both)."""
    js, ts = _specs(dtype_name)
    caps, _, payload = _mixed_batch(js, np.random.default_rng(3),
                                    DT[dtype_name][2])
    rj, sj = jrx.receive_capture_jit(js, jnp.asarray(caps[row]))
    rt, st = trx.receive_capture_jit(ts, torch.from_numpy(caps[row]))
    for name in ("frame_start", "t2_begin", "pr_begin", "found"):
        assert int(np.asarray(getattr(sj, name))) == int(getattr(st, name))
    assert bool(st.found) == (row < 5)
    if row < 5:
        np.testing.assert_array_equal(np.asarray(rj.mac_bytes),
                                      rt.mac_bytes.numpy())
        np.testing.assert_array_equal(rt.mac_bytes.numpy(), payload[row])
        _close(rj.constellation, rt.constellation, dtype_name)
        _close(rj.chan_est, rt.chan_est, dtype_name)


@pytest.mark.parametrize("dtype_name", ["c64", "c128"])
def test_demod_frames_jit_matches_jax(dtype_name):
    """Frames whose start is known (the ber-sweep's entry), with CFO and
    noise at 20 dB."""
    js, ts = _specs(dtype_name)
    rng = np.random.default_rng(4)
    payload = rng.integers(0, 256, (4, js.cfg.frame_bytes), dtype=np.uint8)
    frames = np.asarray(jtx.transmit(js, jnp.asarray(payload)),
                        dtype=np.complex128)
    k = np.arange(frames.shape[1])
    std = np.sqrt(float((np.abs(frames) ** 2).mean()) * 1e-2 / 2)
    frames = (frames * np.exp(2j * np.pi * 5e-5 * k)
              + std * (rng.standard_normal(frames.shape)
                       + 1j * rng.standard_normal(frames.shape)))
    frames = frames.astype(DT[dtype_name][2])
    rj = jrx.demod_frames_jit(js, jnp.asarray(frames))
    rt = trx.demod_frames_jit(ts, torch.from_numpy(frames))
    np.testing.assert_array_equal(np.asarray(rj.mac_bytes),
                                  rt.mac_bytes.numpy())
    np.testing.assert_array_equal(rt.mac_bytes.numpy(), payload)
    for name in ("constellation", "chan_est", "cfo"):
        _close(getattr(rj, name), getattr(rt, name), dtype_name,
               err_msg=name)


def test_jit_keys_and_arguments():
    """Static arguments and defaults bind as jax.jit binds them; a
    non-tensor dynamic argument raises TypeError, tensors on two devices
    ValueError; the wrapper carries the JAX name."""
    _, ts = _specs("c64")
    payload = torch.zeros((2, ts.cfg.frame_bytes), dtype=torch.uint8)
    frames = ttx.transmit_jit(ts, mac_bytes=payload)
    a = trx.demod_frames_jit(ts, frames)
    b = trx.demod_frames_jit(ts, frames, "lq")
    assert torch.equal(a.mac_bytes, b.mac_bytes)
    with pytest.raises(ValueError):
        trx.demod_frames_jit(ts, frames, "nope")
    with pytest.raises(TypeError):
        trx.demod_frames_jit(ts, frames.numpy())
    with pytest.raises(ValueError):
        graphs.jit(lambda s, x, y: x)(ts, frames, frames.to("meta"))
    assert trx.receive_batch_jit.__name__ == "receive_batch_jit"
    assert trx.receive_batch_jit.graphs.name == "receive_batch_jit"


def test_launch_counts_round_trip():
    """The counters a graph replays: every wrapper's launch counts,
    ``class_launches`` by class; added deltas land on the wrappers."""
    before = graphs.launch_counts()
    keys = {(f.__name__, name, k) for f, name, k in before}
    assert ("dft", "radix_launches", None) in keys
    assert ("extract_windows_multi", "class_launches", "wide") in keys
    delta = {(extract.extract_windows, "launches", None): 2,
             (extract.extract_windows_single, "class_launches", "scalar"): 1,
             (dft.dft, "radix_launches", None): 3}
    try:
        graphs._add_counts(delta)
        assert extract.extract_windows.launches == before[
            (extract.extract_windows, "launches", None)] + 2
        assert extract.extract_windows_single.class_launches["scalar"] == \
            before[(extract.extract_windows_single, "class_launches",
                    "scalar")] + 1
        assert dft.dft.radix_launches == before[
            (dft.dft, "radix_launches", None)] + 3
    finally:
        graphs._set_counts(before)
    assert graphs.launch_counts() == before


def test_captured_call_on_cpu_runs_the_step_eagerly():
    """On CPU tensors a captured call is the step itself: its own outputs,
    the in-place updates made, no graph kept.  StreamingReceiver.feed runs
    the body its graph captures on the card, so the state buffers are
    updated in place."""
    call = graphs.CapturedCall("cpu-step")
    acc = torch.zeros(3)
    x = torch.arange(3.0)
    out = call(lambda t: acc.add_(t) * 2, (x,), restore=(acc,))
    assert torch.equal(out, 2 * x) and torch.equal(acc, x)
    assert not call.graphs
    spec = make_frame_spec(ModemConfig(rx_buf_size=2), torch.complex64,
                           device="cpu")
    rxr = tst.StreamingReceiver(spec)
    buffers = [rxr.carry, rxr.frames_seen, rxr.next_min_pos]
    z = tst.init_state(spec)
    want_state, want = tst.process_buffer(
        spec, z, torch.ones(2 * spec.cfg.frame_len, dtype=torch.complex64))
    got = rxr.feed(torch.ones(2 * spec.cfg.frame_len, dtype=torch.complex64))
    assert all(a is b for a, b in zip(
        buffers, [rxr.carry, rxr.frames_seen, rxr.next_min_pos]))
    for a, b in zip(want_state, rxr.state):
        assert torch.equal(a, b)
    for a, b in zip(want, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert not rxr.graphs.graphs
    with pytest.raises(ValueError, match="channels"):
        rxr.feed(torch.ones((2, 2 * spec.cfg.frame_len),
                            dtype=torch.complex64))


def test_device_cache_hands_a_capture_what_it_reads():
    """A device_cache value returned while a capture runs is held by the
    capture's list (a graph keeps it, so an eviction frees nothing a replay
    reads); outside a capture nothing is held; the cache stays bounded."""
    built = []

    @graphs.device_cache(maxsize=1)
    def const(n, device):
        built.append(n)
        return torch.arange(n, device=device)

    cpu = torch.device("cpu")
    a = const(3, cpu)
    assert const(3, cpu) is a and built == [3]
    with graphs._holding() as held:
        b = const(4, cpu)                      # evicts 3
        c = const(3, cpu)                      # built again, evicts 4
    assert len(held) == 2 and held[0] is b and held[1] is c
    assert built == [3, 4, 3] and const.cache_info().currsize == 1
    const(5, cpu)
    assert len(held) == 2 and graphs._held is None
    const.cache_clear()
    assert const.cache_info().currsize == 0
    assert dft.fft_twiddles.cache_info().maxsize == 16


def test_tree_map_keeps_the_structure():
    res = trx.RxResult(*(torch.arange(3) + i for i in range(4)))
    tree = (res, [torch.ones(2), None], 5)
    out = graphs.tree_map(lambda t: t * 2, tree)
    assert type(out[0]) is trx.RxResult and out[2] == 5 and out[1][1] is None
    assert torch.equal(out[0].cfo, res.cfo * 2)
    assert len(graphs.tree_leaves(tree)) == 5


# ---- the no-host-constant guard

@contextlib.contextmanager
def _no_host_constants():
    """torch.as_tensor, torch.from_numpy and torch.tensor raise while the
    block runs."""
    names = ("as_tensor", "from_numpy", "tensor")
    saved = {n: getattr(torch, n) for n in names}

    def refuse(name):
        def call(*args, **kwargs):
            raise AssertionError(f"torch.{name} called inside a step")
        return call

    for n in names:
        setattr(torch, n, refuse(n))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(torch, n, f)


def _permuted(ts):
    """The spec with its data bins in another order: a non-canonical
    layout, which takes the gather branches."""
    arrays = {k: getattr(ts, k) for k in tframe.ARRAY_FIELDS}
    arrays["data_bins"] = np.random.default_rng(10).permutation(
        ts.data_bins).astype(np.int32)
    tp = tframe.frame_spec_from_arrays(
        dataclasses.asdict(ts.cfg), arrays, device="cpu", dtype=ts.dtype,
        fft_backend=ts.fft_backend)
    assert not tp.structured
    return tp


BATCH_CASES = ([("stock", b) for b in fft.BACKENDS]
               + [("wideband", "ct"), ("bpsk", "matmul"),
                  ("permuted", "xla"), ("permuted", "pallas"),
                  ("permuted", "matmul")])


@pytest.mark.parametrize("config,backend", BATCH_CASES)
def test_batch_entry_points_make_no_host_constants(config, backend):
    kw = {"wideband": WIDEBAND, "bpsk": dict(mod_type=1)}.get(config, {})
    spec = make_frame_spec(ModemConfig(**kw), torch.complex64, device="cpu",
                           fft_backend=backend)
    if config == "permuted":
        spec = _permuted(spec)
    cfg = spec.cfg
    B = 2
    payload = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (B, cfg.frame_bytes), dtype=np.uint8))
    step = FlagshipStep(spec)

    def run():
        frames = ttx.transmit_jit(spec, payload)
        caps = torch.nn.functional.pad(frames, (37, 300))
        out = [trx.receive_batch_jit(spec, caps),
               trx.receive_capture_jit(spec, caps[1]),
               trx.demod_frames_jit(spec, frames), step(payload),
               step.receive(caps)]
        return [graphs.tree_leaves(o) for o in out]

    want = run()                       # warm-up: fills the caches
    with _no_host_constants():
        got = run()
    for w, g in zip(want, got):
        assert all(torch.equal(a, b) for a, b in zip(w, g))
    res, s = step(payload)
    assert bool(s.found.all())
    if config != "permuted":    # its preamble constants keep the canonical
        #                         bins, so only the gathers are exercised
        assert torch.equal(res.mac_bytes, payload)


@pytest.mark.parametrize("mode,C", [("gated", 0), ("gated", 2),
                                    ("dense", 0)])
def test_streaming_makes_no_host_constants(mode, C):
    spec = make_frame_spec(ModemConfig(rx_buf_size=4), torch.complex64,
                           device="cpu")
    n = spec.cfg.rx_buf_size * spec.cfg.frame_len
    lead = (C,) if C else ()
    rng = np.random.default_rng(6)
    z = 50 * (rng.standard_normal((3, *lead, n))
              + 1j * rng.standard_normal((3, *lead, n)))
    blocks = [torch.from_numpy(z[0].astype(np.complex64)),
              torch.from_numpy(np.stack([z[1].real, z[1].imag],
                                        -1).astype(np.float32)),
              torch.from_numpy(np.stack([z[2].real, z[2].imag],
                                        -1).astype(np.int16))]
    rxr = tst.StreamingReceiver(spec, sync_mode=mode, channels=C)
    ref = tst.StreamingReceiver(spec, sync_mode=mode, channels=C)
    want = [ref.feed(b) for b in blocks]         # warm-up and reference
    for b in blocks:
        rxr.feed(b)
    rxr.state = tst.init_state(spec, channels=C)
    state = tst.init_state(spec, channels=C)
    with _no_host_constants():
        got = [rxr.feed(b) for b in blocks]
        for b in blocks:
            state, _ = tst.process_buffer(spec, state, b, sync_mode=mode)
    for w, g in zip(want, got):     # noise blocks: NaN in invalid slots
        for a, b in zip(w, g):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    for a, b in zip(ref.state, rxr.state):
        assert torch.equal(a, b)
    for a, b in zip(state, rxr.state):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1000, 3000, 6000, 20000])
def test_sync_tracks_make_no_host_constants(n):
    """Each branch of the matched filter (Toeplitz band, one 4096- or
    8192-point FFT pair, overlap-save) and the "fft" two-tone track read
    their constants from the spec."""
    from c_ofdm_tpu_torch.ops import sync
    spec = make_frame_spec(ModemConfig(), torch.complex64, device="cpu")
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal((2, n))
                          + 1j * rng.standard_normal((2, n))).astype(
                              np.complex64))

    def run():
        return (sync.matched_filter_scores(spec, x),
                sync.t2_ratio_track(spec, x, backend="fft"))

    want = run()
    with _no_host_constants():
        got = run()
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_state_setter_copies_or_rebinds():
    """Setting ``state`` copies into the receiver's buffers when every
    field keeps its shape, dtype and device, and otherwise rebinds them; the
    getter returns a copy that later buffers do not change."""
    spec = make_frame_spec(ModemConfig(rx_buf_size=2), torch.complex64,
                           device="cpu")
    rxr = tst.StreamingReceiver(spec, channels=2)
    carry = rxr.carry
    new = tst.init_state(spec, channels=2)._replace(
        frames_seen=torch.tensor([3, 4], dtype=torch.int32))
    rxr.state = new
    assert rxr.carry is carry and rxr.frames_seen.tolist() == [3, 4]
    snap = rxr.state
    rxr.feed(torch.zeros((2, 2 * spec.cfg.frame_len), dtype=torch.complex64))
    assert snap.frames_seen.tolist() == [3, 4]
    assert not bool(snap.carry_valid.any()) and bool(rxr.carry_valid.all())
    wider = tst.init_state(spec, channels=3)
    rxr.state = wider
    assert rxr.carry is not carry and rxr.carry.shape[0] == 3
