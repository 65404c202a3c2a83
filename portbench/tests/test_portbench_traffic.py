"""The traffic is the oracle's frames, deterministic in the seed; the
batched reference receiver is the oracle's; the bound functions give
PERF.md's fixed points."""

import numpy as np
import pytest
import torch

from portbench import harness, peaks
from portbench.reference import oracle, receiver
from portbench.reference.config import ModemConfig
from portbench.traffic import generate

MIX = harness.load_json(harness.PORTBENCH / "mixes" / "batch_b256_x1024.json")


def _cfg(name):
    return ModemConfig(**harness.Bench.load().config(name)["modem"])


def test_traffic_deterministic_in_seed():
    mix = dict(MIX, frames=4, batches=2)
    cfg = ModemConfig()
    a = generate.make(cfg, mix, 2**31 + 3, "cpu")
    b = generate.make(cfg, mix, 2**31 + 3, "cpu")
    c = generate.make(cfg, mix, 2**31 + 4, "cpu")
    assert torch.equal(a.pool, b.pool)
    assert np.array_equal(a.exp_bytes, b.exp_bytes)
    assert not torch.equal(a.pool, c.pool)
    stream = dict(harness.load_json(harness.PORTBENCH / "mixes"
                                    / "stream_c64_device.json"),
                  channels=2, buffers=2)
    s1 = generate.make(cfg, stream, 7, "cpu")
    s2 = generate.make(cfg, stream, 7, "cpu")
    assert torch.equal(s1.pool, s2.pool)
    assert np.array_equal(s1.exp_pos, s2.exp_pos)


@pytest.mark.parametrize("config", ["pluto_c_ofdm", "lte_bcast_0p37khz"])
def test_transmit_is_the_oracle(config):
    cfg = _cfg(config)
    rng = np.random.default_rng(1)
    payload = rng.integers(0, 256, (2, cfg.frame_bytes), dtype=np.uint8)
    frames = generate.transmit(cfg, torch.from_numpy(payload)).numpy()
    for f, p in zip(frames, payload):
        assert np.abs(f - oracle.tx_frame(cfg, p)).max() < 1e-9


def test_stream_layout_places_every_frame_once():
    cfg = ModemConfig()
    mix = dict(harness.load_json(harness.PORTBENCH / "mixes"
                                 / "stream_c64_device.json"),
               channels=2, buffers=3)
    t = generate.make(cfg, mix, 11, "cpu")
    nf = int(mix["fill"] * 3 * cfg.buffer_len / cfg.frame_len)
    assert ((t.exp_pos >= 0).sum(axis=(0, 2)) == nf).all()
    # each due frame's wire samples are that frame, impaired
    idx = np.array([[1, 0], [0, 2]])
    win = t.frame_windows(1, idx)
    assert win.shape == (2, cfg.frame_len)
    const, _ = receiver.demodulate(cfg, win)
    for r, (c, k) in enumerate(idx):
        got = oracle.demodulate_bytes(const[r].numpy(), cfg.mod_type)
        assert np.array_equal(got, t.exp_bytes[1][c, k])


@pytest.mark.parametrize("config", ["pluto_c_ofdm", "lte_bcast_0p37khz"])
def test_receiver_is_the_oracle(config):
    cfg = _cfg(config)
    mix = dict(MIX, frames=2 if config == "pluto_c_ofdm" else 1, batches=1,
               extra=1024 if config == "pluto_c_ofdm" else 4096,
               cfo=1e-4 if config == "pluto_c_ofdm" else 2e-6)
    t = generate.make(cfg, mix, 5, "cpu")
    frames = t.frame_windows(0, np.arange(mix["frames"]))
    const, shift = receiver.demodulate(cfg, frames)
    for r in range(mix["frames"]):
        b, c, _, s = oracle.rx_frame(cfg, frames[r].numpy())
        assert np.array_equal(b, t.exp_bytes[0][r])
        assert np.abs(c - const[r].numpy()).max() < 1e-9
        assert s == pytest.approx(float(shift[r]), abs=1e-15)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0 - 2**-9],
                     dtype=torch.float32)
    y = receiver.round_tf32(x)
    assert y.tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, -3.0 - 2**-9]


def test_bound_fixed_points():
    """PERF.md: K1 at [256, 6016] rows -> 5760 samples is 7.043 us.  K3 at
    C = 8 writes 49 regions of 896 samples and 41 spans of 5760 a channel
    and reads the spans of the frames due; K4 reads and writes a DFT's
    complex64 once."""
    bench = harness.Bench.load()
    k1 = bench.reader("k1_roofline").__globals__
    t, which = peaks.bound_seconds(k1["bytes_per_call"](256, 5760))
    assert which == "bytes" and round(t * 1e6, 3) == 7.043
    k3 = bench.reader("k3_roofline").__globals__
    cfg = ModemConfig()
    assert k3["gated_search_lags"](cfg) == 768
    assert k3["bytes_per_call"](cfg, 8, 0) == 8 * (49 * 896 + 41 * 5760) * 8
    assert (k3["bytes_per_call"](cfg, 8, 100) - k3["bytes_per_call"](cfg, 8, 0)
            == 100 * 5760 * 8)
    k4 = bench.reader("k4_roofline").__globals__
    nbytes, flops = k4["work"](60, 82944)
    assert nbytes == 2 * 60 * 82944 * 8
    assert peaks.bound_seconds(nbytes, flops)[1] == "bytes"


def test_int16_wire_is_the_reference_truncation():
    """trunc(x * mult) as ``oracle.to_int16``, saturated at int16's range."""
    cfg = ModemConfig()
    x = np.array([0.1234, -0.1234, 163.83, -163.85, 200.0, 1e-3 - 2e-3j])
    got = generate.to_wire(cfg, torch.from_numpy(x.astype(np.complex128)),
                           "int16").numpy()
    want = oracle.to_int16(cfg, x)
    assert np.array_equal(got[:, 0], np.clip(want.real, -32768, 32767))
    assert np.array_equal(got[:, 1], np.clip(want.imag, -32768, 32767))
    assert got[4, 0] == 32767 and got.dtype == np.int16
