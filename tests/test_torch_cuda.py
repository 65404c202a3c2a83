"""The port on the card: K1, K2, K3 and K4 (each of its seven routes)
against their plain versions, the flagship step (every FFT backend, and
pallas at a 1536-point geometry, at DVB-T2's 16K and 32K FFT sizes, at LTE
5G broadcast's 82944 and at the same numerology sampled at 61.44 Msps,
165888; the wideband 8k step under ct on impaired captures), streams on
MAC-framed rings against their planted frames, the MAC codec, the channel
simulator and the link loop against their CPU runs, the captured calls
(CUDA-graph replays) against their eager runs, the apps, and
``parallel/`` in worlds of 1, 2 and 4 ranks on the one card.

Every test here needs CUDA and skips without it.  This file imports no jax,
so it also runs where jax is not installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import contextlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
from c_ofdm_tpu_torch.channel.sim import ChannelParams, apply_channel
from c_ofdm_tpu_torch.mac import mac as tmac
from c_ofdm_tpu_torch.models import streaming
from c_ofdm_tpu_torch.models.modem import FlagshipStep
from c_ofdm_tpu_torch.ops import dft, extract, fft, sync

pytestmark = pytest.mark.cuda

CFG = ModemConfig()
WIN = CFG.preamble_len + CFG.message_len
# LTE 5G broadcast's 0.37 kHz numerology (82944-point FFT, CP 9216, 48600
# occupied subcarriers, a 4096-tap matched filter)
BROADCAST = ModemConfig(fft_size=82944, num_data_subc=48000,
                        num_pilot_subc=600, cp_size=9216, num_symb=2,
                        pr_sin_len=4096, mod_type=6)
# LTE's 15 MHz numerology (3GPP TS 36.211: 1536-point FFT, normal CP 108)
LTE1536 = ModemConfig(fft_size=1536, num_data_subc=768, num_pilot_subc=16,
                      cp_size=108)


def _dvbt2(n):
    """The wideband layout at DVB-T2's n-point FFT with its 1/8 guard
    interval (ETSI EN 302 755)."""
    return ModemConfig(fft_size=n, num_data_subc=n // 2,
                       num_pilot_subc=n // 256, cp_size=n // 8, num_symb=2,
                       pr_sin_len=n // 16, mod_type=6)


# a rank's launches (``parallel/launch.py``) with no kernel launched
NO_LAUNCHES = dict.fromkeys(["extract_windows", "extract_windows_single",
                             "extract_windows_multi", "dft",
                             "t2_ratio_track_hop"], 0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1-K4 are CUDA kernels with no CPU "
                    "mode")
    return torch.device("cuda", torch.cuda.current_device())


def _captures(rng, B, n, dtype, dev):
    x = rng.standard_normal((B, n)) + 1j * rng.standard_normal((B, n))
    return torch.from_numpy(x).to(device=dev, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_kernel_matches_plain_version(dev, dtype):
    """Bit-exact at the flagship shape and on ragged rows with edge and
    out-of-range starts (which both versions clamp)."""
    rng = np.random.default_rng(0)
    cases = [(256, CFG.frame_len,
              rng.integers(0, CFG.frame_len - WIN + 1, 256)),
             (5, 3 * CFG.frame_len,
              [0, 100, CFG.frame_len, 2 * CFG.frame_len, 3 * CFG.frame_len - WIN]),
             (4, 6000, [-5, 0, 6000 - WIN + 1, 10**6])]
    for B, n, starts in cases:
        caps = _captures(rng, B, n, dtype, dev)
        st = torch.tensor(np.asarray(starts), dtype=torch.int32, device=dev)
        before = extract.extract_windows.launches
        got = extract.extract_windows(caps, st, WIN)
        torch.cuda.synchronize()
        assert extract.extract_windows.launches == before + 1
        assert torch.equal(got, extract.extract_windows_ref(caps, st, WIN))


def test_kernel_rejects_what_it_does_not_take(dev):
    caps = torch.zeros((2, 64), dtype=torch.complex64, device=dev)
    st = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        extract.extract_windows(caps, st.to(torch.int16), 8)
    with pytest.raises(ValueError):
        extract.extract_windows(caps, st, 8, body="wide2")
    with pytest.raises(TypeError):
        extract.extract_windows(caps.real.contiguous(), st, 8)
    with pytest.raises(ValueError):
        extract.extract_windows(caps[:, ::2], st, 8)
    with pytest.raises(ValueError):
        extract.extract_windows(caps, st, 65)
    with pytest.raises(ValueError):
        extract.extract_windows(caps, st.cpu(), 8)


def test_flagship_step_on_card(dev):
    """B = 256 stock payloads through the matmul step: exact, K1 once; then
    the same frames impaired (``_check_impaired``: at their planted
    offsets, no frame in the all-zero rows, every row equal to the CPU
    run), K4 never."""
    rng = np.random.default_rng(1)
    payload = rng.integers(0, 256, (256, CFG.frame_bytes), dtype=np.uint8)
    step = FlagshipStep(make_frame_spec(CFG, torch.complex64, device=dev))
    before = extract.extract_windows.launches
    res, s = step(torch.from_numpy(payload).to(dev))
    torch.cuda.synchronize()
    assert extract.extract_windows.launches == before + 1
    assert bool(s.found.all()) and not bool(s.frame_start.any())
    np.testing.assert_array_equal(res.mac_bytes.cpu().numpy(), payload)
    assert _check_impaired(step, payload, rng, 1024, 40.0,
                           1e-4) == _k4_counts({})


def test_module_moves_to_card(dev):
    step = FlagshipStep(make_frame_spec(CFG, torch.complex64, device="cpu"))
    step.to(dev)
    payload = torch.zeros((2, CFG.frame_bytes), dtype=torch.uint8, device=dev)
    res, s = step(payload)
    assert res.mac_bytes.device == payload.device
    assert torch.equal(res.mac_bytes, payload)


RING = (CFG.rx_buf_size + 1) * CFG.frame_len     # 246 656


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("K,win", [(49, 896), (41, WIN)])
def test_ring_kernels_match_plain_versions(dev, dtype, K, win):
    """K2 (one ring) and K3 (C = 3 rings) bit-exact at the streaming path's
    (K, win) pairs on the stock ring, with edge, negative and past-end
    starts."""
    rng = np.random.default_rng(2)
    rings = _captures(rng, 3, RING, dtype, dev)
    st = rng.integers(0, RING - win + 1, (3, K))
    st[:, :7] = [-RING - 5, -7, -1, 0, RING - win, RING - win + 1, 10**6]
    st = torch.tensor(st, dtype=torch.int32, device=dev)
    before = (extract.extract_windows_single.launches,
              extract.extract_windows_multi.launches)
    got1 = extract.extract_windows_single(rings[0], st[0], win)
    got3 = extract.extract_windows_multi(rings, st, win)
    torch.cuda.synchronize()
    assert (extract.extract_windows_single.launches,
            extract.extract_windows_multi.launches) == (before[0] + 1,
                                                        before[1] + 1)
    assert torch.equal(got1, extract.extract_windows_single_ref(
        rings[0], st[0], win))
    assert torch.equal(got3, extract.extract_windows_multi_ref(rings, st, win))


def test_ring_kernels_reject_what_they_do_not_take(dev):
    ring = torch.zeros(64, dtype=torch.complex64, device=dev)
    st = torch.zeros(3, dtype=torch.int32, device=dev)
    single, multi = (extract.extract_windows_single,
                     extract.extract_windows_multi)
    with pytest.raises(TypeError):
        single(ring, st.to(torch.int16), 8)
    with pytest.raises(TypeError):
        single(ring.real.contiguous(), st, 8)
    with pytest.raises(ValueError):
        single(ring[None], st, 8)
    with pytest.raises(ValueError):
        single(ring, st, 65)
    with pytest.raises(ValueError):
        single(ring, st.cpu(), 8)
    rings = torch.zeros((2, 64), dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError):
        multi(rings, st, 8)                      # starts not [C, K]
    with pytest.raises(ValueError):
        multi(rings, st[None].expand(3, 3).contiguous(), 8)   # C mismatch
    with pytest.raises(ValueError):
        multi(rings[:, ::2], st[None].expand(2, 3).contiguous(), 8)
    with pytest.raises(TypeError):
        multi(rings, st[None].expand(2, 3).to(torch.int16), 8)


def _counts(fn):
    return fn.launches, dict(fn.class_launches)


@pytest.mark.parametrize("body", [None, *extract.CLASSES])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("win", [896, 897, 300, 5, 1])
def test_bodies_match_plain_versions_on_offset_views(dev, dtype, win, body):
    """Every class (and the one the shape picks) bit-exact against the plain
    versions on inputs whose base is 8 bytes past a 16-byte boundary
    (``ring[1:]``, ``rings[:, 1:]`` made contiguous at an odd storage
    offset), odd and even win (an odd win gives odd windows an 8-byte-aligned
    output), odd, even, negative and past-end starts, int32 and int64, with
    the launch counted on the class ``launch_plan`` names."""
    rng = np.random.default_rng(7)
    C, K, n = 3, 9, 4000
    store = _captures(rng, 1, 1 + C * n, dtype, dev)[0]
    rings = store[1:].view(C, n)               # contiguous, odd offset
    assert rings.is_contiguous() and rings.storage_offset() == 1
    st = rng.integers(0, n - win + 1, (C, K))
    st[:, :7] = [-n - 5, -7, -1, 0, n - win, n - win + 1, 10**6]
    st[:, 7:] = [10, 11]
    eb = 8 if dtype == torch.complex64 else 16
    for idt in (torch.int32, torch.int64):
        s = torch.tensor(st, dtype=idt, device=dev)
        for fn, ref, x, ss, windows in (
                (extract.extract_windows_multi,
                 extract.extract_windows_multi_ref, rings, s, C * K),
                (extract.extract_windows_single,
                 extract.extract_windows_single_ref, rings[1], s[1], K),
                (extract.extract_windows, extract.extract_windows_ref,
                 rings, s[:, 8].contiguous(), C)):
            name = extract.launch_plan(windows, win, eb, body).name
            before = _counts(fn)
            got = fn(x, ss, win, body=body)
            torch.cuda.synchronize()
            after = _counts(fn)
            assert after[0] == before[0] + 1
            assert after[1][name] == before[1][name] + 1
            assert sum(after[1].values()) == sum(before[1].values()) + 1
            assert torch.equal(got, ref(x, ss, win)), (fn.__name__, idt)


def test_bodies_equal_each_other_at_the_path_shapes(dev):
    """Scalar and wide bodies give the same bits at the streaming path's two
    (K, win) pairs and at the flagship K1 shape, and the shape alone names
    the class that runs by default."""
    rng = np.random.default_rng(8)
    ring = _captures(rng, 1, RING, torch.complex64, dev)[0]
    for (K, win), name in (((49, 896), "scalar"), ((41, WIN), "wide")):
        st = torch.tensor(rng.integers(0, RING - win + 1, K), device=dev)
        before = dict(extract.extract_windows_single.class_launches)
        outs = [extract.extract_windows_single(ring, st, win, body=b)
                for b in (None, *extract.CLASSES)]
        torch.cuda.synchronize()
        after = extract.extract_windows_single.class_launches
        assert after[name] == before[name] + 2       # default + forced
        assert all(torch.equal(outs[0], o) for o in outs[1:])
        assert torch.equal(outs[0], ring.unfold(-1, win, 1)[st])
    caps = _captures(rng, 256, CFG.frame_len, torch.complex64, dev)
    st = torch.tensor(rng.integers(0, CFG.frame_len - WIN + 1, 256),
                      device=dev)
    outs = [extract.extract_windows(caps, st, WIN, body=b)
            for b in (None, *extract.CLASSES)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert torch.equal(outs[0], caps.unfold(-1, WIN, 1)[
        torch.arange(256, device=dev), st])


def test_empty_shapes_and_far_starts(dev):
    """K = 0 and B = 0 return empty outputs without a launch; int64 starts
    beyond int32 clamp as the plain version clamps them."""
    ring = torch.randn(5000, dtype=torch.complex64, device=dev)
    none = torch.zeros(0, dtype=torch.int64, device=dev)
    fns = (extract.extract_windows, extract.extract_windows_single,
           extract.extract_windows_multi)
    before = [f.launches for f in fns]
    assert extract.extract_windows_single(ring, none, 300).shape == (0, 300)
    assert extract.extract_windows(ring[:0].view(0, 5000), none,
                                   300).shape == (0, 300)
    assert extract.extract_windows_multi(
        ring.view(2, 2500), none.view(2, 0), 300).shape == (2, 0, 300)
    assert [f.launches for f in fns] == before
    far = torch.tensor([2**40, -2**40, 2**31, -2**31 - 1], dtype=torch.int64,
                       device=dev)
    got = extract.extract_windows_single(ring, far, 300)
    torch.cuda.synchronize()
    assert torch.equal(got, extract.extract_windows_single_ref(ring, far, 300))
    assert torch.equal(got[0], ring[-300:]) and torch.equal(got[1], ring[:300])


def test_gated_buffer_on_card_equals_cpu(dev):
    """One C = 2 gated buffer at the stock ring (two frames per channel):
    the card (K3) equals the CPU run, and both decode the payloads."""
    tx_spec = make_frame_spec(CFG, torch.complex64, device="cpu")
    rng = np.random.default_rng(3)
    payload = rng.integers(0, 256, (4, CFG.frame_bytes), dtype=np.uint8)
    from c_ofdm_tpu_torch.models import tx
    frames = tx.transmit(tx_spec, torch.from_numpy(payload)).numpy()
    n = CFG.rx_buf_size * CFG.frame_len
    block = 0.05 * (rng.standard_normal((2, n))
                    + 1j * rng.standard_normal((2, n)))
    for i, (c, s) in enumerate([(0, 1000), (0, 90_000), (1, 17), (1, 150_001)]):
        block[c, s:s + CFG.frame_len] += 60.0 * frames[i]
    block = torch.from_numpy(block.astype(np.complex64))
    outs = {}
    for where in ("cpu", dev):
        spec = make_frame_spec(CFG, torch.complex64, device=where)
        before = extract.extract_windows_multi.launches
        _, out = streaming.process_buffer(
            spec, streaming.init_state(spec, channels=2), block.to(where))
        torch.cuda.synchronize()
        if where == dev:
            assert extract.extract_windows_multi.launches == before + 2
        outs[str(where)] = out
    cpu, card = outs["cpu"], outs[str(dev)]
    for name in ("positions", "valid", "num_found"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name)), name
    valid = cpu.valid
    assert int(cpu.num_found.sum()) == 4
    assert torch.equal(card.mac_bytes.cpu()[valid], cpu.mac_bytes[valid])
    np.testing.assert_array_equal(cpu.mac_bytes[valid].numpy(), payload)


def _hop_rings(spec, lead, n, dtype, dev, seed):
    """Noise with the config's two-tone burst planted every 7 bursts + 13
    samples (ratios up to ~1 at every alignment to the half-blocks); the
    second of three or more rows all zero."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((*lead, n), dtype=dtype, device=dev, generator=g)
    size = spec.cfg.t2sin_size
    burst = spec.tensors["t2_burst"].to(dtype)
    for s in range(0, n - size, 7 * size + 13):
        x[..., s:s + size] += 4 * burst
    if lead and lead[0] > 2:
        x[1] = 0
    return x


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("t2sin", [128, 256, 512])
def test_hop_track_kernel_matches_plain_version(dev, t2sin, dtype):
    """The hop-track kernel against t2_ratio_track_hop_ref on the card: 64
    rings of carry + buffer with three all-zero rows (ratio exactly 0),
    one ring with no leading axis whose length is not a multiple of hop
    (odd, so complex64 takes 8-byte loads), the same ring from its second
    sample (8-byte aligned), and short rings whose tiles span rows.  Within
    1e-5 in complex64 (float32 sums of hop terms in another order, on
    ratios in [0, 1]) and 1e-12 in complex128; one launch a call."""
    cfg = ModemConfig(t2sin_size=t2sin)
    spec = make_frame_spec(cfg, dtype, device=dev)
    hop = t2sin // 2
    ring_len = cfg.frame_len * (cfg.rx_buf_size + 1)
    single = _hop_rings(spec, (), ring_len + 37, dtype, dev, 2)
    cases = [_hop_rings(spec, (64,), ring_len, dtype, dev, 1), single,
             single[1:], _hop_rings(spec, (3,), 5000, dtype, dev, 3)]
    cases[0][2:4] = 0
    atol = 1e-5 if dtype == torch.complex64 else 1e-12
    for x in cases:
        before = sync.t2_ratio_track_hop.launches
        got = sync.t2_ratio_track_hop(spec, x)
        want = sync.t2_ratio_track_hop_ref(spec, x)
        torch.cuda.synchronize()
        assert sync.t2_ratio_track_hop.launches == before + 1
        assert got.shape == want.shape == (*x.shape[:-1],
                                           x.shape[-1] // hop - 1)
        assert got.dtype == want.dtype
        torch.testing.assert_close(got, want, rtol=0, atol=atol)
        assert float(want.max()) > 0.85
        if x.dim() == 2 and x.shape[0] > 2:
            assert not bool(got[1].any())
    assert not bool(got[1].any()) and not bool(cases[0][2:4].any())
    empty = sync.t2_ratio_track_hop(spec, torch.zeros((0, ring_len),
                                                      dtype=dtype, device=dev))
    assert empty.shape == (0, ring_len // hop - 1)


def test_hop_track_rejects_what_it_does_not_take(dev):
    """Strided rings, a ring in another precision than the spec's, real
    rings; and a geometry whose basis, or whose bin groups' threads, no
    block of the device holds (the kernel's own set-up refuses it)."""
    spec = make_frame_spec(CFG, torch.complex64, device=dev)
    x = torch.zeros((2, 4096), dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError):
        sync.t2_ratio_track_hop(spec, x[:, ::2])
    with pytest.raises(ValueError):
        sync.t2_ratio_track_hop(spec, x.to(torch.complex128))
    with pytest.raises(TypeError):
        sync.t2_ratio_track_hop(spec, x.real.contiguous())
    with pytest.raises(RuntimeError, match="no launch fits"):
        sync._hop_launch(dev.index, 4096, 22, 8)
    with pytest.raises(RuntimeError, match="no launch fits"):
        sync._hop_launch(dev.index, 128, 1200, 4)
    warps, resident = sync._hop_launch(dev.index, 128, 22, 4)
    assert warps == 2 and resident >= 1


def test_c64_stream_counts_one_hop_launch_a_feed(dev, recorder_off):
    """A captured 64-channel stream: each feed (a graph replay) adds one
    hop-track launch and, with the recorder on, 64 x 1926 hop windows;
    its positions, flags and bytes equal the CPU run's on MAC-framed rings,
    and every planted frame decodes."""
    trace = recorder_off
    blocks, truth, payload = _planted_rings(64, 41, dev, S=2)
    spec = make_frame_spec(CFG, torch.complex64, device=dev)
    cpu_spec = make_frame_spec(CFG, torch.complex64, device="cpu")
    trace.enable()
    rxr = streaming.StreamingReceiver(spec, channels=64)
    got = []
    for b in blocks:
        before = sync.t2_ratio_track_hop.launches
        got.append(rxr.feed(b))
        assert sync.t2_ratio_track_hop.launches == before + 1
    torch.cuda.synchronize()
    counts = trace.drain()["counts"]
    trace.disable()
    nwin = CFG.frame_len * (CFG.rx_buf_size + 1) // (CFG.t2sin_size // 2) - 1
    assert nwin == 1926
    assert counts["hop_windows"] == len(blocks) * 64 * nwin
    assert len(rxr.graphs.graphs) == 1
    cpu = streaming.StreamingReceiver(cpu_spec, channels=64)
    for b, g in zip(blocks, got):
        w = cpu.feed(b.cpu())
        for name in ("positions", "valid", "num_found"):
            assert torch.equal(getattr(g, name).cpu(), getattr(w, name)), name
        assert torch.equal(g.mac_bytes.cpu()[w.valid], w.mac_bytes[w.valid])
    _assert_planted(got, truth, payload, 64)


def _route_counts():
    """K4's total launch count and its count per route."""
    return {"launches": dft.dft.launches,
            **{r: getattr(dft.dft, f"{r}_launches") for r in dft.ROUTES}}


def _dft64(x, sign, scale):
    x64 = x.to(torch.complex128)
    y = torch.fft.fft(x64) if sign < 0 else torch.fft.ifft(x64) * x.shape[-1]
    return y * scale


@pytest.mark.parametrize("case", ["rx_view", "tx", "ragged", "n500_scaled"])
def test_dft_kernel_matches_plain_version(dev, case):
    """K4 at the flagship step's shapes (the RX input is the strided
    CP-stripped view, row stride 640), a ragged row count and a size that is
    no power of two (the mixed route; the others take the radix route),
    against dft_ref and the float64 DFT: within 1e-5·max|Y| and within 4x
    the plain version's own error; one launch, on the route _route names."""
    g = torch.Generator(device=dev).manual_seed(4)

    def randc(*shape):
        return torch.randn(*shape, dtype=torch.complex64, device=dev,
                           generator=g)

    sign, scale = -1, 1.0
    if case == "rx_view":
        x = randc(256, 9 * 640).reshape(256, 9, 640)[..., 128:]
    elif case == "tx":
        x, sign = randc(256, 8, 512), +1
    elif case == "ragged":
        x = randc(1000, 512)
    else:
        x, scale = randc(3, 77, 500), 1.0 / np.sqrt(500)
    before = _route_counts()
    got = dft.dft(x, sign, scale)
    plain = dft.dft_ref(x, sign, scale)
    torch.cuda.synchronize()
    route = "mixed" if case == "n500_scaled" else "radix"
    assert dft._route(x.shape[-1]) == route
    assert _route_counts() == {k: v + (k in ("launches", route))
                               for k, v in before.items()}
    assert got.shape == x.shape and got.dtype == torch.complex64
    want = _dft64(x, sign, scale)
    err = float((got.to(torch.complex128) - want).abs().max())
    err_plain = float((plain.to(torch.complex128) - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())
    assert err <= 4 * err_plain


@pytest.mark.parametrize("case", [64, 256, 512, 8192, "rx_view"])
def test_dft_radix_kernel_matches_plain_versions(dev, case):
    """The radix route against dft_ref, dft_radix_ref (the same passes in
    plain PyTorch: within 1e-6·max|Y|, each butterfly rounded in its own
    order) and the float64 DFT (within 1e-5·max|Y| and 4x dft_ref's error),
    ragged row counts, both signs; one radix launch, and no n x n planes
    built for it."""
    g = torch.Generator(device=dev).manual_seed(6)
    if case == "rx_view":
        x = torch.randn(256, 9 * 640, dtype=torch.complex64, device=dev,
                        generator=g).reshape(256, 9, 640)[..., 128:]
        sign, scale = -1, 1.0
    else:
        rows = {64: 4099, 256: 1001, 512: 2049, 8192: 37}[case]
        x = torch.randn(rows, case, dtype=torch.complex64, device=dev,
                        generator=g)
        sign, scale = ((+1, 1.0 / np.sqrt(case)) if case in (256, 8192)
                       else (-1, 1.0))
    dft.dft_planes.cache_clear()
    before = (dft.dft.launches, dft.dft.radix_launches,
              dft.dft.dense_launches)
    got = dft.dft(x, sign, scale)
    torch.cuda.synchronize()
    assert (dft.dft.launches, dft.dft.radix_launches,
            dft.dft.dense_launches) == (before[0] + 1, before[1] + 1,
                                        before[2])
    assert dft.dft_planes.cache_info().currsize == 0
    assert got.shape == x.shape and got.dtype == torch.complex64
    want = _dft64(x, sign, scale)
    ymax = float(want.abs().max())
    err = float((got.to(torch.complex128) - want).abs().max())
    err_plain = float((dft.dft_ref(x, sign, scale).to(torch.complex128)
                       - want).abs().max())
    radix = dft.dft_radix_ref(x, sign, scale)
    assert err <= 1e-5 * ymax
    assert err <= 4 * err_plain
    assert float((got - radix).abs().max()) <= 1e-6 * ymax


_NEW_ROUTE_CASES = {
    # name: (rows or a view maker, n, sign, scale)
    "n500": (2304, 500, -1, 1.0),
    "rx_view_1536": ("view", 1536, -1, 1.0),
    "tx_1536": (2048, 1536, +1, 1.0),
    "n600_scaled": (333, 600, +1, 600 ** -0.5),
    "n6144": (37, 6144, -1, 1.0),
    "n448": (1001, 448, +1, 1.0),
    "n7168": (9, 7168, -1, 1.0 / 64),
    "n509": (2304, 509, -1, 1.0),
    "n4093": (21, 4093, +1, 1.0),
    "n17_scaled": (99, 17, -1, 0.25),
    "tx_510": (2048, 510, +1, 1.0),
    "rx_view_510": ("view", 510, -1, 1.0),
}


@pytest.mark.parametrize("case", sorted(_NEW_ROUTE_CASES))
def test_dft_mixed_and_bluestein_kernels_match_plain_versions(dev, case):
    """The mixed and Bluestein routes against their own plain versions
    (dft_mixed_ref, dft_bluestein_ref: the same passes and tables, within
    1e-6·max|Y|), dft_ref and the float64 DFT (within 1e-5·max|Y| and 4x
    dft_ref's error); one launch on the route's counter, and no n x n
    planes built for it."""
    rows, n, sign, scale = _NEW_ROUTE_CASES[case]
    g = torch.Generator(device=dev).manual_seed(11)
    if rows == "view":  # the 1536 and 510 steps' CP-stripped RX symbols
        cp = {1536: 108, 510: 128}[n]
        x = torch.randn(256, 9 * (n + cp), dtype=torch.complex64, device=dev,
                        generator=g).reshape(256, 9, n + cp)[..., cp:]
    else:
        x = torch.randn(rows, n, dtype=torch.complex64, device=dev,
                        generator=g)
    route = dft._route(n)
    assert route == ("bluestein" if n in (509, 4093, 17, 510) else "mixed")
    dft.dft_planes.cache_clear()
    before = _route_counts()
    got = dft.dft(x, sign, scale)
    torch.cuda.synchronize()
    assert _route_counts() == {k: v + (k in ("launches", route))
                               for k, v in before.items()}
    assert dft.dft_planes.cache_info().currsize == 0
    assert got.shape == x.shape and got.dtype == torch.complex64
    want = _dft64(x, sign, scale)
    ymax = float(want.abs().max())
    err = float((got.to(torch.complex128) - want).abs().max())
    err_plain = float((dft.dft_ref(x, sign, scale).to(torch.complex128)
                       - want).abs().max())
    own = (dft.dft_mixed_ref if route == "mixed"
           else dft.dft_bluestein_ref)(x, sign, scale)
    assert err <= 1e-5 * ymax
    assert err <= 4 * err_plain
    assert float((got - own).abs().max()) <= 1e-6 * ymax


def test_dft_launch_runs_a_named_route(dev):
    """Under dft._forced_route, dft runs the route named where that route
    takes n, and counts it: the dense route at n = 500, 509 and 1536, the
    mixed kernel at a power of two, all equal to the route dft picks within
    1e-6·max|Y|; a route that does not take n raises ValueError (the
    cluster route below 8193, above 131072 and at a 7-smooth n among them
    with no split c·L, c <= 16, L <= 8192)."""
    g = torch.Generator(device=dev).manual_seed(12)
    for n, routes in ((500, ("dense",)), (509, ("dense",)),
                      (1536, ("dense",)), (512, ("mixed", "dense"))):
        x = torch.randn(300, n, dtype=torch.complex64, device=dev,
                        generator=g)
        ref = dft.dft(x, +1, 0.5)
        for route in routes:
            before = _route_counts()
            with dft._forced_route(route):
                got = dft.dft(x, +1, 0.5)
            torch.cuda.synchronize()
            assert _route_counts() == {k: v + (k in ("launches", route))
                                       for k, v in before.items()}
            tol = 1e-5 if route == "dense" else 1e-6
            assert (float((got - ref).abs().max())
                    <= tol * float(ref.abs().max())), (n, route)
    for n, routes in ((509, ("radix", "mixed", "cluster")),
                      (512, ("bluestein", "cluster")), (8192, ("cluster",)),
                      (117649, ("cluster", "mixed")),
                      (65537, ("cluster", "bluestein"))):
        x = torch.zeros((4, n), dtype=torch.complex64, device=dev)
        for route in routes:
            with dft._forced_route(route), pytest.raises(
                    ValueError, match="does not take"):
                dft.dft(x, -1, 1.0)


_CLUSTER_CASES = {
    # name: (rows, or "view" for the step's CP-stripped RX symbols, n, sign,
    # scale)
    "n12288": (37, 12288, -1, 1.0),
    "n12288_scaled": (21, 12288, +1, 12288 ** -0.5),
    "tx_16k": (128, 16384, +1, 1.0),
    "rx_view_16k": ("view", 16384, -1, 1.0),
    "tx_32k": (64, 32768, +1, 1.0),
    "rx_view_32k": ("view", 32768, -1, 1.0),
    "n65536": (9, 65536, -1, 1.0),
    "n65536_scaled": (5, 65536, +1, 1.0 / 256),
    "tx_82944": (32, 82944, +1, 1.0),
    "rx_view_82944": ("view", 82944, -1, 1.0),
    "n19683": (37, 19683, -1, 1.0),
    "n39366_scaled": (11, 39366, +1, 39366 ** -0.5),
    "n131072": (5, 131072, -1, 1.0),
}
# each CP-stripped RX view's (cp, frames): DVB-T2's 1/8 guard interval at
# B = 64 / 32, LTE 5G broadcast's 9216 samples at B = 16
_VIEWS = {16384: (2048, 64), 32768: (4096, 32), 82944: (9216, 16)}
# an n for each instance of the cluster kernel (c blocks a cluster, 8 or
# 16 points a thread: blocks of up to 4096 points, or more) that
# dft._cluster_split picks
_INSTANCES = {(3, 8): 12288, (4, 8): 16384, (5, 8): 15625, (5, 16): 30625,
              (6, 8): 13122, (6, 16): 39366, (7, 8): 16807, (7, 16): 42875,
              (8, 8): 32768, (8, 16): 52488, (9, 8): 19683, (9, 16): 59049,
              (10, 8): 31250, (10, 16): 61250, (12, 8): 28812,
              (12, 16): 82944, (14, 8): 33614, (14, 16): 67228,
              (15, 8): 36015, (15, 16): 65625, (16, 8): 65536,
              (16, 16): 131072}


def _cluster_input(case, g, dev):
    rows, n, sign, scale = _CLUSTER_CASES[case]
    if rows == "view":   # rows of stride n + cp, read in place
        cp, b = _VIEWS[n]
        x = torch.randn(b, 3 * (n + cp), dtype=torch.complex64, device=dev,
                        generator=g).reshape(b, 3, n + cp)[..., cp:]
    else:
        x = torch.randn(rows, n, dtype=torch.complex64, device=dev,
                        generator=g)
    return x, sign, scale


@pytest.mark.parametrize("case", sorted(_CLUSTER_CASES))
def test_dft_cluster_kernel_matches_plain_versions(dev, case):
    """The cluster route (one row per thread-block cluster, distributed
    shared memory) against its own plain version dft_cluster_ref (the same
    steps and tables, within 1e-6·max|Y|) and the float64 DFT (within
    2e-6·max|Y|), at the 16K, 32K and 82944 steps' shapes (the RX input
    the strided symbol view) and at 12288, 19683, 39366, 65536 and 131072,
    both signs; one launch on the cluster route's counter, and no n x n
    planes built."""
    x, sign, scale = _cluster_input(case, torch.Generator(
        device=dev).manual_seed(13), dev)
    assert dft._route(x.shape[-1]) == "cluster"
    dft.dft_planes.cache_clear()
    before = _route_counts()
    got = dft.dft(x, sign, scale)
    torch.cuda.synchronize()
    assert _route_counts() == {k: v + (k in ("launches", "cluster"))
                               for k, v in before.items()}
    assert dft.dft_planes.cache_info().currsize == 0
    assert got.shape == x.shape and got.dtype == torch.complex64
    want = _dft64(x, sign, scale)
    ymax = float(want.abs().max())
    assert float((got.to(torch.complex128) - want).abs().max()) <= 2e-6 * ymax
    own = dft.dft_cluster_ref(x, sign, scale)
    assert float((got - own).abs().max()) <= 1e-6 * ymax


@pytest.mark.parametrize("c,points", sorted(_INSTANCES))
def test_dft_cluster_instances_match_plain_version(dev, c, points):
    """Each instance of the cluster kernel that the split rule reaches (c
    from 3 to 16 blocks a cluster, odd and composite, non-portable above 8;
    8 points a thread in blocks of up to 4096 points, else 16) on 3 rows
    against dft_cluster_ref within 1e-6·max|Y| and the float64 DFT within
    2e-6·max|Y|."""
    n = _INSTANCES[c, points]
    assert dft._cluster_split(n)[0] == c
    assert (8 if n // c <= 4096 else 16) == points
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(3, n, dtype=torch.complex64, device=dev, generator=g)
    got = dft.dft(x, +1 if c % 2 else -1)
    want = _dft64(x, +1 if c % 2 else -1, 1.0)
    torch.cuda.synchronize()
    ymax = float(want.abs().max())
    assert float((got.to(torch.complex128) - want).abs().max()) <= 2e-6 * ymax
    own = dft.dft_cluster_ref(x, +1 if c % 2 else -1)
    assert float((got - own).abs().max()) <= 1e-6 * ymax


def test_dft_cluster_kernel_replays_in_a_graph(dev):
    """The cluster launch (cudaLaunchKernelEx with a cluster dimension)
    captured in a CUDA graph: each replay equals the eager launch bit for
    bit, on new data copied into the captured input too."""
    g = torch.Generator(device=dev).manual_seed(14)
    x, sign, scale = _cluster_input("rx_view_32k", g, dev)
    eager = dft.dft(x, sign, scale)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        dft.dft(x, sign, scale)             # warm-up: set-up and tables
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dft.dft(x, sign, scale)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    x2, _, _ = _cluster_input("rx_view_32k", g, dev)
    x.copy_(x2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, dft.dft(x2, sign, scale))


def _scores_f64(spec, x):
    """matched_filter_scores' statistic in float64 on the CPU: one FFT pair
    over the whole row, the window energies from a float64 cumsum."""
    L = spec.cfg.pr_sin_len
    n = x.shape[-1]
    m = 1 << (n + L - 1).bit_length()
    mf = spec.matched_filter.astype(np.complex128)
    corr = np.abs(np.fft.ifft(np.fft.fft(x, m, axis=-1)
                              * np.conj(np.fft.fft(np.conj(mf), m))))[..., :n]
    e = np.cumsum(np.abs(x) ** 2, axis=-1)
    e = np.concatenate([np.zeros((*x.shape[:-1], 1)), e], axis=-1)
    norm = np.zeros(x.shape)
    norm[..., :n + 1 - L] = e[..., L:] - e[..., :n + 1 - L]
    return np.where(norm > 1.0, corr / np.sqrt(np.maximum(norm, 1e-30)), 0.0)


def test_broadcast_matched_filter_on_card_equals_float64(dev, recorder_off):
    """At the broadcast sync's regions, [20, 8704] with 4096 taps (one
    16384-point overlap-save chunk a row: ``mf_chunks`` 20), the scores on
    the card are within 1e-5 of the largest of the float64 correlation on
    the CPU, a planted preamble the largest in its row."""
    from c_ofdm_tpu_torch.ops import sync
    trace = recorder_off
    spec = make_frame_spec(BROADCAST, torch.complex64, device=dev,
                           fft_backend="pallas")
    rng = np.random.default_rng(8704)
    x = 4 * (rng.standard_normal((20, 8704))
             + 1j * rng.standard_normal((20, 8704)))
    at = rng.integers(0, 8704 - 4096, 20)
    for r, a in enumerate(at):
        x[r, a:a + 4096] += 100 * np.conj(spec.matched_filter)
    x = x.astype(np.complex64)
    trace.enable()
    got = sync.matched_filter_scores(spec, torch.from_numpy(x).to(dev))
    assert trace.drain()["counts"]["mf_chunks"] == 20
    want = _scores_f64(spec, x.astype(np.complex128))
    got = got.cpu().numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), at)


def _broadcast_receive(dev):
    """The benchmark cell's shape at the broadcast numerology: 16 frames
    at offsets 0-4096 in rows of 280832 samples, 4 zero rows; returns
    (FlagshipStep, captures, payloads, offsets)."""
    from c_ofdm_tpu_torch.models import tx
    spec = make_frame_spec(BROADCAST, torch.complex64, device=dev,
                           fft_backend="pallas")
    rng = np.random.default_rng(280832)
    payload = rng.integers(0, 256, (16, BROADCAST.frame_bytes),
                           dtype=np.uint8)
    frames = tx.transmit(spec, torch.from_numpy(payload).to(dev))
    offs = rng.integers(0, 4097, 16)
    caps = torch.zeros((20, BROADCAST.frame_len + 4096),
                       dtype=torch.complex64, device=dev)
    for r, o in enumerate(offs):
        caps[r, o:o + BROADCAST.frame_len] = 10 * frames[r]
    return FlagshipStep(spec), caps, payload, offs


def _profile_broadcast_receive(dev, path, calls=10) -> dict:
    """Device ms a call of the untraced broadcast receive's replays, in
    cuFFT's kernels (K4's left out by name) and in all kernels, from a
    profile of ``calls`` replays written to ``path``."""
    step, caps, _, _ = _broadcast_receive(dev)
    step.receive(caps)                      # the capture
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            step.receive(caps)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    k4 = re.compile(r"(?<![A-Za-z_])(fft_kernel|mixed_fft_kernel|"
                    r"cluster_fft_kernel|fourstep_|bluestein_kernel|"
                    r"chirp_|dft_kernel)")
    kernels = [(e["name"], e["dur"]) for e in events
               if e.get("ph") == "X" and e.get("cat") == "kernel"]
    cufft = sum(d for name, d in kernels
                if re.search("fft|radix", name, re.IGNORECASE)
                and not k4.search(name))
    return {"cufft_ms_a_call": cufft / calls / 1e3,
            "kernels_ms_a_call": sum(d for _, d in kernels) / calls / 1e3,
            "card": torch.cuda.get_device_name(dev)}


def _profile_broadcast_stages(dev, path, calls=10) -> dict:
    """Device ms a call by stage of the traced broadcast receive's replays
    (``trace.stage_split`` of a profile of ``calls`` replays written to
    ``path``), and the replays' ``cfo_windows`` a call."""
    from c_ofdm_tpu_torch.io import trace
    step, caps, _, _ = _broadcast_receive(dev)
    trace.enable()
    step.receive(caps)                      # the traced capture
    torch.cuda.synchronize()
    trace.drain()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            step.receive(caps)
        torch.cuda.synchronize()
    counts = trace.drain()["counts"]
    trace.disable()
    prof.export_chrome_trace(str(path))
    split = trace.stage_split(json.loads(path.read_text())["traceEvents"])
    n = max(split["replays"], 1)
    return {"replays": split["replays"], "dropped": split["dropped"],
            "stage_ms_a_call": {k: v / n / 1e3
                                for k, v in split["busy_us"].items()},
            "marks_ms_a_call": split["marks_us"] / n / 1e3,
            "cfo_windows_a_call": counts["cfo_windows"] / calls,
            "card": torch.cuda.get_device_name(dev)}


def test_broadcast_receive_recovers_in_one_search(dev, tmp_path):
    """A traced, captured broadcast receive at the benchmark cell's shape
    ([20, 280832]): its recover stage (between the stage marks) takes
    under 0.6 ms of device time a call, and each replay counts
    ``cfo_windows`` 12000 (20 rows x 600 windows).  Profiled in a process
    of its own, as the test below; every stage's time is printed."""
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, __file__, "profile-broadcast-stages",
         str(tmp_path)],
        cwd=root, env=dict(os.environ, PYTHONPATH=str(root)),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.splitlines()[-1])
    print(json.dumps({"broadcast_stages": got}))
    assert got["replays"] >= 5 and got["cfo_windows_a_call"] == 12000, got
    assert got["stage_ms_a_call"]["recover"] < 0.6, got


def test_broadcast_receive_replays_one_chunk_a_row(dev, recorder_off,
                                                  tmp_path):
    """A captured broadcast receive at the benchmark cell's shape: traced
    replays count ``mf_chunks`` 20 a call (one chunk a row), the frames
    decode exactly at their offsets and the zero rows find none.  The
    untraced graph's cuFFT time a call is printed (not asserted) from a
    profile taken in a process of its own: with a second profiler session
    in the pytest process, the traced-replay test below was seen to lose
    one replay's marks."""
    trace = recorder_off
    step, caps, payload, offs = _broadcast_receive(dev)
    trace.enable()
    for _ in range(3):
        res, s = step.receive(caps)
    torch.cuda.synchronize()
    assert trace.drain()["counts"]["mf_chunks"] == 3 * 20
    trace.disable()
    found = s.found.cpu().numpy()
    assert found[:16].all() and not found[16:].any()
    np.testing.assert_array_equal(s.frame_start.cpu().numpy()[:16], offs)
    np.testing.assert_array_equal(res.mac_bytes.cpu().numpy()[:16], payload)
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, __file__, "profile-broadcast", str(tmp_path)],
        cwd=root, env=dict(os.environ, PYTHONPATH=str(root)),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    print(json.dumps({"broadcast_receive": json.loads(
        out.stdout.splitlines()[-1])}))


def _cfo_tail(spec, pk, rdt):
    """The coarse CFO from its per-window peaks pk [..., windows]: the
    median rule and the mean, as ``ops/cfo.py`` computes them."""
    size = spec.cfg.preamble_len
    lo = spec.tensors["cfo_lo"]
    delta = pk - lo
    med = torch.sort(delta, dim=-1).values[..., delta.shape[-1] // 2]
    keep = torch.abs(delta - med[..., None]) <= spec.cfg.cfo_outlier_bins
    pk = torch.where(keep, pk, lo + med[..., None])
    shift = pk.sum(dim=-1).to(rdt) / spec.cfg.num_pilot_subc
    return (shift - size / 2) / size


def _cfo_spectrum(spec, x):
    """The spectrum the coarse CFO searches: the partial product onto the
    windows' bins where the spec holds its basis, else the full FFT."""
    if "cfo_basis" in spec.tensors:
        return fft.complex_matmul(x, spec.tensors["cfo_basis"])
    return fft.fft_fwd(x)


def _shift_by_window_loop(spec, x):
    """The coarse CFO searched window by window, as the JAX package does:
    one argmax and one add a window over the spectrum's magnitude (the
    partial product's concatenated windows, or the fftshifted FFT)."""
    amp = _cfo_spectrum(spec, x).abs()
    segs = spec.cfo_segments
    if "cfo_basis" in spec.tensors:
        offs = np.cumsum([0] + [hi - lo for lo, hi in segs])
        segs = [(lo, hi, o) for (lo, hi), o in zip(segs, offs)]
    else:
        amp = torch.fft.fftshift(amp, dim=-1)
        segs = [(lo, hi, lo) for lo, hi in segs]
    pk = torch.stack([lo + torch.argmax(amp[..., o:o + hi - lo], dim=-1)
                      for lo, hi, o in segs], dim=-1)
    return _cfo_tail(spec, pk, amp.dtype)


@pytest.mark.parametrize("geometry", ["broadcast", "stock"])
def test_coarse_cfo_one_search_on_card(dev, recorder_off, geometry):
    """The coarse CFO as a captured call, at the broadcast cell's recovery
    input, [20, 92160] (600 windows of 90 bins in the FFT under pallas),
    and at the stock geometry, [256, 640] (8 windows of 41 bins in the
    partial product under matmul); 4 rows zero, the others preambles with
    CFO and noise.  Its shift equals the window loop's bit for bit, each
    replay counts ``cfo_windows`` rows x windows and ``cfo_bins`` rows x
    the spectrum's bins (92160 by the FFT, 328 in the partial product's
    basis), and its graph holds at
    most 6 kernel nodes beside the spectrum's and the median-and-mean
    tail's (the node counts, the loop's among them, are printed)."""
    from c_ofdm_tpu_torch.ops import cfo
    from c_ofdm_tpu_torch.utils import graphs
    trace = recorder_off
    cfg, backend, rows, windows, width, bins = {
        "broadcast": (BROADCAST, "pallas", 20, 600, 90, 92160),
        "stock": (CFG, "matmul", 256, 8, 41, 328)}[geometry]
    spec = make_frame_spec(cfg, torch.complex64, device=dev,
                           fft_backend=backend)
    assert ("cfo_basis" in spec.tensors) == (geometry == "stock")
    rng = np.random.default_rng(cfg.preamble_len)
    k = np.arange(cfg.preamble_len)
    f = rng.uniform(-1e-4, 1e-4, (rows, 1))
    x = (10 * spec.preamble_time * np.exp(2j * np.pi * f * k)
         + 0.5 * (rng.standard_normal((rows, cfg.preamble_len))
                  + 1j * rng.standard_normal((rows, cfg.preamble_len))))
    x[rows - 4:] = 0
    x = torch.from_numpy(x.astype(np.complex64)).to(dev)
    shift = graphs.jit(cfo.pilot_freq_shift)
    trace.enable()
    got = [shift(spec, x) for _ in range(3)]
    torch.cuda.synchronize()
    counts = trace.drain()["counts"]
    assert counts["cfo_windows"] == 3 * rows * windows
    assert counts["cfo_bins"] == 3 * rows * bins
    trace.disable()
    want = _shift_by_window_loop(spec, x)
    for g in got:
        assert torch.equal(g, want)
    pk = spec.tensors["cfo_lo"] + torch.randint(
        0, width, (rows, windows), device=dev,
        generator=torch.Generator(device=dev).manual_seed(windows))
    nodes = {
        "pilot_freq_shift": _kernel_nodes(
            lambda i: cfo.pilot_freq_shift(spec, x)),
        "spectrum": _kernel_nodes(lambda i: _cfo_spectrum(spec, x)),
        "tail": _kernel_nodes(lambda i: _cfo_tail(spec, pk, torch.float32)),
        "window_loop": _kernel_nodes(
            lambda i: _shift_by_window_loop(spec, x)),
    }
    print(json.dumps({"coarse_cfo_nodes": {geometry: nodes}}))
    search = (nodes["pilot_freq_shift"]["kernel"]
              - nodes["spectrum"]["kernel"] - nodes["tail"]["kernel"])
    assert search <= 6, nodes


_FOURSTEP_CASES = {
    # name: (rows, or "view" for rows of stride n + cp read in place, n,
    # sign, scale)
    "tx_165888": (16, 165888, +1, 1.0),
    "rx_view_165888": ("view", 165888, -1, 1.0),
    "n117649": (16, 117649, -1, 1.0),
    "n262144_scaled": (4, 262144, +1, 1.0 / 512),
    "n60025": (5, 60025, +1, 1.0),
    "n390625": (2, 390625, -1, 1.0),      # the shared-memory column kernel
}
_CHIRP_CASES = {
    "n4099": (2304, 4099, -1, 1.0),
    "rx_view_4099": ("view", 4099, -1, 1.0),
    "n8209": (256, 8209, +1, 1.0),
    "n8191": (5, 8191, -1, 1.0),
    "n65537_scaled": (3, 65537, -1, 65537 ** -0.5),
    "n131071": (4, 131071, +1, 1.0),
}
# the views' (cp, frames): the 165888 step's 18432 samples at B = 8; a
# 512-sample gap on 256 frames at 4099
_LARGE_VIEWS = {165888: (18432, 8), 4099: (512, 256)}
# K4's launches per route of one call: the four-step's two; the chirp
# route's pre and post passes, its filter product unless m is on the
# four-step route (fused there), and its two m-point FFTs on m's route
# (8232, 16384 and 16464 on the cluster route, 131220 and 262144 on the
# four-step one)
_LAUNCHES = {165888: {"fourstep": 2}, 117649: {"fourstep": 2},
             262144: {"fourstep": 2}, 60025: {"fourstep": 2},
             390625: {"fourstep": 2},
             4099: {"chirp": 3, "cluster": 2}, 8209: {"chirp": 3,
                                                      "cluster": 2},
             8191: {"chirp": 3, "cluster": 2},
             65537: {"chirp": 2, "fourstep": 4},
             131071: {"chirp": 2, "fourstep": 4}}


def _large_input(cases, case, g, dev):
    rows, n, sign, scale = cases[case]
    if rows == "view":   # rows of stride n + cp, read in place
        cp, b = _LARGE_VIEWS[n]
        x = torch.randn(b, 3 * (n + cp), dtype=torch.complex64, device=dev,
                        generator=g).reshape(b, 3, n + cp)[..., cp:]
    else:
        x = torch.randn(rows, n, dtype=torch.complex64, device=dev,
                        generator=g)
    return x, sign, scale


def _check_fourstep_or_chirp(x, sign, scale, route, launches):
    """dft(x) on ``route`` against its plain version (within 1e-6·max|Y|)
    and the float64 DFT (within 2e-6·max|Y|): ``launches`` ({route: n})
    counted on each route's counter and in all, no n x n planes built."""
    assert dft._route(x.shape[-1]) == route
    dft.dft_planes.cache_clear()
    before = _route_counts()
    got = dft.dft(x, sign, scale)
    torch.cuda.synchronize()
    want_counts = {k: v + launches.get(k, 0) for k, v in before.items()}
    want_counts["launches"] += sum(launches.values())
    assert _route_counts() == want_counts
    assert dft.dft_planes.cache_info().currsize == 0
    assert got.shape == x.shape and got.dtype == torch.complex64
    want = _dft64(x, sign, scale)
    ymax = float(want.abs().max())
    assert float((got.to(torch.complex128) - want).abs().max()) <= 2e-6 * ymax
    own = dft._PLAIN[route](x, sign, scale)
    assert float((got - own).abs().max()) <= 1e-6 * ymax


@pytest.mark.parametrize("case", sorted(_FOURSTEP_CASES) + sorted(
    _CHIRP_CASES))
def test_dft_fourstep_and_chirp_kernels_match_plain_versions(dev, case):
    """The four-step route (two launches through a workspace) and the chirp
    route (Bluestein over the FFT routes) against their own plain versions
    dft_fourstep_ref / dft_chirp_ref (the same steps and tables, within
    1e-6·max|Y|) and the float64 DFT (within 2e-6·max|Y|), at the 165888
    step's shapes and primes past 4096 (strided views among them), both
    signs; each launch on its kernel's route counter, and no n x n planes
    built."""
    cases = _FOURSTEP_CASES if case in _FOURSTEP_CASES else _CHIRP_CASES
    route = "fourstep" if case in _FOURSTEP_CASES else "chirp"
    x, sign, scale = _large_input(cases, case, torch.Generator(
        device=dev).manual_seed(16), dev)
    _check_fourstep_or_chirp(x, sign, scale, route, _LAUNCHES[x.shape[-1]])


# for each launch-1 kernel, the least n past 131072 whose split picks it
# (the register kernel of N1 = A·B), and two n whose N1 is past 64 (the
# shared-memory kernel)
_COLUMN_KERNEL_N = {20: 131220, 21: 137781, 24: 157464, 25: 140625,
                    28: 183708, 32: 209952, 35: 131250, 40: 135000,
                    49: 132300, 56: 134456, 64: 131712, 96: 786432,
                    125: 390625}


@pytest.mark.parametrize("n1", sorted(_COLUMN_KERNEL_N))
def test_dft_fourstep_instances_match_plain_version(dev, n1):
    """Each instance of the four-step's register column kernel (N1 = A·B)
    and the shared-memory one, at an n whose split picks it, on 3 rows:
    against dft_fourstep_ref within 1e-6·max|Y| and the float64 DFT within
    2e-6·max|Y|, two launches on the four-step counter."""
    n = _COLUMN_KERNEL_N[n1]
    assert dft._fourstep_split(n)[0] == n1
    assert (n1 in dft._FOURSTEP_REG) == (n1 <= 64)
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(3, n, dtype=torch.complex64, device=dev, generator=g)
    sign = +1 if n1 % 2 else -1
    _check_fourstep_or_chirp(x, sign, 1.0, "fourstep", {"fourstep": 2})


@pytest.mark.parametrize("case", ["rx_view_165888", "n4099", "n131071"])
@pytest.mark.parametrize("sign", [-1, 1])
def test_dft_fourstep_and_chirp_replay_in_a_graph(dev, case, sign):
    """The four-step and chirp routes captured in a CUDA graph, their
    workspace and buffers allocated inside the capture (from the graph's
    pool): each replay equals the eager launch bit for bit, on new data
    copied into the captured input too."""
    cases = _FOURSTEP_CASES if case in _FOURSTEP_CASES else _CHIRP_CASES
    g = torch.Generator(device=dev).manual_seed(17)
    x, _, scale = _large_input(cases, case, g, dev)
    eager = dft.dft(x, sign, scale)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        dft.dft(x, sign, scale)             # warm-up: set-up and tables
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dft.dft(x, sign, scale)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    x2, _, _ = _large_input(cases, case, g, dev)
    x.copy_(x2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, dft.dft(x2, sign, scale))


def test_dft_fourstep_refused_setup_raises(dev):
    """A four-step set-up the kernels do not take raises RuntimeError and
    runs nothing: a launch-1 block past 1024 threads (64 columns of 8192
    points), a launch-2 row group that does not divide N1, a register
    kernel for an N1 it is not built for (96; 16, which no split past
    131072 picks)."""
    for size in ((8192, 8192, 64, 1), (49, 2401, 0, 4), (96, 2048, 0, 1),
                 (16, 8192, 0, 4)):
        with pytest.raises(RuntimeError, match="set-up"):
            dft._prepare("fourstep", dev.index, *size)


def test_dft_kernel_rejects_what_it_does_not_take(dev):
    with pytest.raises(TypeError):
        dft.dft(torch.zeros((4, 64), dtype=torch.complex128, device=dev))
    with pytest.raises(TypeError):
        dft.dft(torch.zeros((4, 64), dtype=torch.float32, device=dev))


# K4's geometries under fft_backend="pallas": (config, frames a step, K4
# launches a step per route, the impaired captures' extra samples,
# amplitude and CFO in cycles a sample, and the receiver's start of an
# impaired frame less its planted one: at 165888 both packages place it a
# sample early)
PALLAS_GEOMETRIES = {
    # the stock layout: the radix route
    "stock": (CFG, 8, {"radix": 2}, 1024, 40.0, 1e-4, 0),
    # LTE's 15 MHz numerology (1536 = 8·8·8·3): the mixed route
    "1536": (LTE1536, 8, {"mixed": 2}, 1024, 40.0, 3e-5, 0),
    # the stock layout at 510 = 2·3·5·17 points: the Bluestein route
    "510": (ModemConfig(fft_size=510, num_data_subc=256, num_pilot_subc=8,
                        cp_size=128), 8, {"bluestein": 2}, 1024, 40.0, 1e-4,
            0),
    # DVB-T2's 16K and 32K FFT sizes, 1/8 guard interval: the cluster route
    "16k": (_dvbt2(16384), 2, {"cluster": 2}, 4096, 10.0, 1e-5, 0),
    "32k": (_dvbt2(32768), 2, {"cluster": 2}, 4096, 10.0, 2e-6, 0),
    # LTE 5G broadcast's 0.37 kHz numerology: the cluster route at
    # 12-block clusters
    "broadcast": (BROADCAST, 2, {"cluster": 2}, 4096, 10.0, 2e-6, 0),
    # the same numerology sampled at 61.44 Msps (165888 points, CP 18432):
    # the four-step route, two launches a call
    "165888": (ModemConfig(fft_size=165888, num_data_subc=48000,
                           num_pilot_subc=600, cp_size=18432, num_symb=2,
                           pr_sin_len=4096, mod_type=6), 2, {"fourstep": 4},
               4096, 10.0, 1e-6, -1),
    # the same with timing at the matched filter's peak, as the benchmark's
    # lte_bcast_0p37khz_61m sets it: every frame at its planted offset
    "165888_refine": (ModemConfig(fft_size=165888, num_data_subc=48000,
                                  num_pilot_subc=600, cp_size=18432,
                                  num_symb=2, pr_sin_len=4096, mod_type=6,
                                  sync_peak_refine=True), 2,
                      {"fourstep": 4}, 4096, 10.0, 1e-6, 0),
}
ZERO_ROWS = 4
SYNC_FIELDS = ("frame_start", "t2_begin", "pr_begin", "found")


def _k4_counts(routes):
    """``_route_counts()``'s change when K4 launches ``routes`` ({route:
    launches})."""
    return {"launches": sum(routes.values()),
            **{r: routes.get(r, 0) for r in dft.ROUTES}}


def _same_sync(a, b):
    """Two (RxResult, SyncResult) with equal sync fields and bytes."""
    for name in SYNC_FIELDS:
        assert torch.equal(getattr(a[1], name), getattr(b[1], name)), name
    assert torch.equal(a[0].mac_bytes, b[0].mac_bytes)


def _impaired_captures(frames, rng, extra, amp, cfo, snr_db=30.0):
    """frames [B, frame_len] complex128 -> captures [B + ZERO_ROWS,
    frame_len + extra] complex64 (numpy) and the planted offsets: each
    frame at a random offset in [0, extra], amplitude ``amp``, CFO ``cfo``
    cycles a sample, AWGN at ``snr_db`` dB SNR, then ZERO_ROWS all-zero
    rows."""
    nb, flen = frames.shape
    n = flen + extra
    offs = rng.integers(0, extra + 1, nb)
    caps = np.zeros((nb + ZERO_ROWS, n), np.complex128)
    for b in range(nb):
        caps[b, offs[b]:offs[b] + flen] = frames[b] * amp
    caps[:nb] *= np.exp(2j * np.pi * cfo * np.arange(n))
    std = np.sqrt(float((np.abs(frames) ** 2).mean()) * amp ** 2
                  * 10 ** (-snr_db / 10) / 2)
    caps[:nb] += std * (rng.standard_normal((nb, n))
                        + 1j * rng.standard_normal((nb, n)))
    return caps.astype(np.complex64), offs


def _check_impaired(step, payload, rng, extra, amp, cfo, shift=0,
                    cpu_rows=None):
    """The step's frames of ``payload`` [B, frame_bytes] (numpy) as
    ``_impaired_captures`` through ``step.receive``, a graph replay: every
    frame found at its planted offset plus ``shift`` with exact bytes, no
    frame in a zero row, K1 once; sync fields and bytes equal to the same
    receive run eagerly, and to the CPU run on the first ``cpu_rows`` rows
    (all by default).  Returns ``_route_counts()``'s change in the
    replay."""
    from c_ofdm_tpu_torch.models import rx, tx
    spec = step.bound_spec()
    frames = tx.transmit(spec, torch.from_numpy(payload).to(spec.device))
    caps_np, offs = _impaired_captures(
        frames.cpu().numpy().astype(np.complex128), rng, extra, amp, cfo)
    caps = torch.from_numpy(caps_np).to(spec.device)
    before, k1 = _route_counts(), extract.extract_windows.launches
    res, s = step.receive(caps)
    torch.cuda.synchronize()
    k4 = {k: v - before[k] for k, v in _route_counts().items()}
    assert extract.extract_windows.launches == k1 + 1
    nb = payload.shape[0]
    found = s.found.cpu()
    assert bool(found[:nb].all()) and not bool(found[nb:].any())
    np.testing.assert_array_equal(s.frame_start[:nb].cpu().numpy(),
                                  offs + shift)
    np.testing.assert_array_equal(res.mac_bytes[:nb].cpu().numpy(), payload)
    _same_sync(rx.receive_batch(spec, caps), (res, s))
    rows = slice(None, cpu_rows)
    cpu = FlagshipStep(make_frame_spec(spec.cfg, torch.complex64,
                                       device="cpu",
                                       fft_backend=spec.fft_backend))
    res_c, s_c = cpu.receive(torch.from_numpy(caps_np[rows]))
    for name in SYNC_FIELDS:
        assert torch.equal(getattr(s, name)[rows].cpu(),
                           getattr(s_c, name)), name
    fc = s_c.found
    assert torch.equal(res.mac_bytes[rows].cpu()[fc], res_c.mac_bytes[fc])
    return k4


@pytest.mark.parametrize("geometry", sorted(PALLAS_GEOMETRIES))
def test_pallas_flagship_step_on_card(dev, geometry):
    """FlagshipStep under fft_backend="pallas" at each of K4's geometries
    (``PALLAS_GEOMETRIES``), a graph replay a call: clean payloads exact,
    K4 launched on the geometry's route only, K1 once, sync fields and
    bytes equal to the step run eagerly and the bytes to the CPU run; then
    the frames impaired (``_check_impaired``), K4 half the step's
    launches."""
    from c_ofdm_tpu_torch.models import rx, tx
    cfg, B, routes, extra, amp, cfo, shift = PALLAS_GEOMETRIES[geometry]
    rng = np.random.default_rng(cfg.fft_size)
    payload = rng.integers(0, 256, (B, cfg.frame_bytes), dtype=np.uint8)
    step = FlagshipStep(make_frame_spec(cfg, torch.complex64, device=dev,
                                        fft_backend="pallas"))
    spec = step.bound_spec()
    p = torch.from_numpy(payload).to(dev)
    before, k1 = _route_counts(), extract.extract_windows.launches
    res, s = step(p)
    torch.cuda.synchronize()
    assert extract.extract_windows.launches == k1 + 1
    assert {k: v - before[k] for k, v in _route_counts().items()} == \
        _k4_counts(routes)
    assert bool(s.found.all()) and not bool(s.frame_start.any())
    np.testing.assert_array_equal(res.mac_bytes.cpu().numpy(), payload)
    _same_sync(rx.receive_batch(spec, tx.transmit(spec, p)), (res, s))
    cpu = FlagshipStep(make_frame_spec(cfg, torch.complex64, device="cpu",
                                       fft_backend="pallas"))
    res_c, _ = cpu(torch.from_numpy(payload))
    assert torch.equal(res.mac_bytes.cpu(), res_c.mac_bytes)
    assert _check_impaired(step, payload, rng, extra, amp, cfo, shift,
                           cpu_rows=2) == _k4_counts(
        {r: n // 2 for r, n in routes.items()})


# DVB-T2 16K at its published occupancy (portbench/configs/dvbt2_16k.json):
# 13248 data + 576 pilot carriers, CP 2048 (GI 1/8), QAM64, the preamble's
# whole CP as matched-filter taps, timing at the filter's peak; 2 of the
# configuration's 24 data symbols a frame, so the CPU plain path it is
# held against stays quick (the cell itself runs all 24)
DVBT2_16K = ModemConfig(fft_size=16384, num_data_subc=13248,
                        num_pilot_subc=576, cp_size=2048, num_symb=2,
                        pr_sin_len=2048, mod_type=6, sync_peak_refine=True)


def test_dvbt2_16k_published_step_on_card(dev, recorder_off):
    """The benchmark cell ``dvbt2_16k_batch_b64``'s step at B = 16 (+ 4 zero
    rows): the pallas spec's coarse CFO takes the preamble's FFT, so it
    holds no partial-spectrum basis, and a traced call counts ``cfo_bins``
    20 x 18432; frames at offsets in [0, 4096] with CFO 1e-5, amplitude 10
    and 34 dB AWGN (the cell's traffic) through the captured ``receive``
    (a graph replay), K4 launched once, on the cluster route.  Its sync
    fields and bytes equal the CPU plain path's on the same captures, row
    for row; every frame it finds lies at its planted offset with the
    payload's bytes, no zero row holds one, and a frame it misses the
    benchmark's plain reference sync misses too (the single-frame sync's
    blind alignments, as the benchmark counts ``undetected``)."""
    from c_ofdm_tpu_torch.models import tx
    from portbench.reference import oracle
    from portbench.reference.config import ModemConfig as RefModemConfig
    B = 16
    rng = np.random.default_rng(DVBT2_16K.frame_len)
    payload = rng.integers(0, 256, (B, DVBT2_16K.frame_bytes),
                           dtype=np.uint8)
    step = FlagshipStep(make_frame_spec(DVBT2_16K, torch.complex64,
                                        device=dev, fft_backend="pallas"))
    spec = step.bound_spec()
    assert "cfo_basis" not in spec.tensors
    frames = tx.transmit(spec, torch.from_numpy(payload).to(dev))
    caps_np, offs = _impaired_captures(
        frames.cpu().numpy().astype(np.complex128), rng, 4096, 10.0, 1e-5,
        snr_db=34.0)
    caps = torch.from_numpy(caps_np).to(dev)
    step.receive(caps)
    before = _route_counts()
    res, s = step.receive(caps)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in _route_counts().items()} == \
        _k4_counts({"cluster": 1})
    assert len(step.graphs.graphs) == 1
    cpu = FlagshipStep(make_frame_spec(DVBT2_16K, torch.complex64,
                                       device="cpu", fft_backend="pallas"))
    res_c, s_c = cpu.receive(torch.from_numpy(caps_np))
    for name in SYNC_FIELDS:
        assert torch.equal(getattr(s, name).cpu(), getattr(s_c, name)), name
    found = s.found.cpu().numpy()
    assert torch.equal(res.mac_bytes.cpu()[found], res_c.mac_bytes[found])
    assert not found[B:].any() and found[:B].sum() >= B // 2, found
    ref_cfg = RefModemConfig(**{
        k: getattr(DVBT2_16K, k) for k in ("fft_size", "num_data_subc",
                                           "num_pilot_subc", "cp_size",
                                           "num_symb", "pr_sin_len",
                                           "mod_type")})
    for r in np.flatnonzero(~found[:B]):
        assert oracle.sync_capture(
            ref_cfg, caps_np[r].astype(np.complex128)) < 0, r
    hit = found[:B]
    np.testing.assert_array_equal(s.frame_start.cpu().numpy()[:B][hit],
                                  offs[hit])
    np.testing.assert_array_equal(res.mac_bytes.cpu().numpy()[:B][hit],
                                  payload[hit])
    trace = recorder_off
    trace.enable()
    step.receive(caps)
    torch.cuda.synchronize()
    assert trace.drain()["counts"]["cfo_bins"] == caps.shape[0] * 18432
    print(f"dvbt2_16k on the card: {int(hit.sum())} of {B} frames found")


def test_pallas_complex128_takes_torch_fft(dev):
    """complex128 under pallas: the xla branch (torch.fft), never K4, in
    the transforms and in a whole step."""
    x = torch.randn(6, 512, dtype=torch.complex128, device=dev)
    before = dft.dft.launches
    y = fft.fft_fwd(x, "pallas")
    z = fft.ifft_unnorm(x, "pallas")
    torch.cuda.synchronize()
    assert torch.equal(y, torch.fft.fft(x))
    assert torch.equal(z, torch.fft.ifft(x) * 512)
    spec = make_frame_spec(CFG, torch.complex128, device=dev,
                           fft_backend="pallas")
    payload = torch.zeros((2, CFG.frame_bytes), dtype=torch.uint8, device=dev)
    res, s = FlagshipStep(spec)(payload)
    torch.cuda.synchronize()
    assert dft.dft.launches == before
    assert torch.equal(res.mac_bytes, payload) and bool(s.found.all())


def test_wideband_ct_step_on_card(dev):
    """B = 128 frames of the 8k-QAM64 wideband layout under
    fft_backend="ct": clean payloads exact at offset 0; each frame again at
    a random offset in [0, 4096] with CFO 1e-5, amplitude 10 and 30 dB
    AWGN, decoded exactly at its offset with K1 once and K4 never, sync
    fields and bytes equal to the receive run eagerly; the first 4 rows'
    equal to the CPU run."""
    from c_ofdm_tpu_torch.models import rx, tx
    cfg = ModemConfig(fft_size=8192, num_data_subc=4096, num_pilot_subc=32,
                      cp_size=1024, num_symb=2, pr_sin_len=512, mod_type=6)
    step = FlagshipStep(make_frame_spec(cfg, torch.complex64, device=dev,
                                        fft_backend="ct"))
    rng = np.random.default_rng(17)
    payload = rng.integers(0, 256, (128, cfg.frame_bytes), dtype=np.uint8)
    res, s = step(torch.from_numpy(payload).to(dev))
    assert bool(s.found.all()) and not bool(s.frame_start.any())
    np.testing.assert_array_equal(res.mac_bytes.cpu().numpy(), payload)
    frames = tx.transmit(step.bound_spec(), torch.from_numpy(payload).to(
        dev)).cpu().numpy().astype(np.complex128)
    n = cfg.frame_len + 4096
    offs = rng.integers(0, 4097, 128)
    caps = np.zeros((128, n), np.complex128)
    for b, o in enumerate(offs):
        caps[b, o:o + cfg.frame_len] = 10.0 * frames[b]
    caps *= np.exp(2j * np.pi * 1e-5 * np.arange(n))
    std = np.sqrt(float((np.abs(frames) ** 2).mean()) * 100.0
                  * 10 ** (-30.0 / 10) / 2)
    caps += std * (rng.standard_normal(caps.shape)
                   + 1j * rng.standard_normal(caps.shape))
    caps = caps.astype(np.complex64)
    on_card = torch.from_numpy(caps).to(dev)
    k1, k4 = extract.extract_windows.launches, dft.dft.launches
    res, s = step.receive(on_card)
    torch.cuda.synchronize()
    assert (extract.extract_windows.launches, dft.dft.launches) == (k1 + 1,
                                                                    k4)
    assert bool(s.found.all())
    np.testing.assert_array_equal(s.frame_start.cpu().numpy(), offs)
    np.testing.assert_array_equal(res.mac_bytes.cpu().numpy(), payload)
    _same_sync(rx.receive_batch(step.bound_spec(), on_card), (res, s))
    cpu = FlagshipStep(make_frame_spec(cfg, torch.complex64, device="cpu",
                                       fft_backend="ct"))
    res_c, s_c = cpu.receive(torch.from_numpy(caps[:4]))
    for name in ("frame_start", "t2_begin", "pr_begin", "found"):
        assert torch.equal(getattr(s, name)[:4].cpu(), getattr(s_c, name))
    assert torch.equal(res.mac_bytes[:4].cpu(), res_c.mac_bytes)


def _mac_frames(mac, B, seed):
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, (B, mac.payload), dtype=np.uint8)
    seq = rng.integers(0, 2**32, B, dtype=np.int64)
    return torch.from_numpy(payload), torch.from_numpy(seq)


@pytest.mark.parametrize("crc", [True, False])
@pytest.mark.parametrize("mod", [1, 2, 4, 6, 8])
def test_mac_on_card_equals_cpu(dev, mod, crc):
    """write, then read_bytes / read_soft / read_llr of noisy inputs: every
    field equal on the card and on the CPU."""
    mac = tmac.Mac(frame_bytes=256 * mod, spread=mod, crc=crc)
    payload, seq = _mac_frames(mac, 16, mod)
    wire = mac.write(payload, seq)
    wire_d = mac.write(payload.to(dev), seq.to(dev))
    assert wire_d.device.type == "cuda"
    assert torch.equal(wire_d.cpu(), wire)
    g = torch.Generator().manual_seed(mod)
    bits = ((wire[..., None] >> torch.arange(7, -1, -1)) & 1).reshape(16, -1)
    flips = (torch.rand(bits.shape, generator=g) < 0.02).to(torch.uint8)
    noisy = ((bits ^ flips).reshape(16, -1, 8)
             * (1 << torch.arange(7, -1, -1))).sum(-1).to(torch.uint8)
    diag = ((bits[:, ::mod].double() * 2 - 1)
            + 0.5 * torch.randn(16, bits.shape[1] // mod, generator=g,
                                dtype=torch.float64))
    llr = ((1 - 2 * bits.double())
           + 0.8 * torch.randn(bits.shape, generator=g,
                               dtype=torch.float64)).reshape(16, -1, mod)
    for read, x in ((mac.read_bytes, noisy), (mac.read_soft, diag),
                    (mac.read_llr, llr)):
        cpu, card = read(x), read(x.to(dev))
        for name, a, b in zip(tmac.MacFrame._fields, cpu, card):
            assert b.device.type == "cuda", name
            assert torch.equal(a, b.cpu()), name
    assert bool(mac.read_bytes(wire_d).valid.all())


def test_crc16_on_card_equals_table(dev):
    rng = np.random.default_rng(7)
    for n in (1, 9, 254, 300):
        data = rng.integers(0, 256, (256, n), dtype=np.uint8)
        want = []
        for row in data:
            crc = 0xFFFF
            for byte in row:
                crc = ((crc << 8) & 0xFFFF) ^ int(
                    tmac._CRC_TABLE[((crc >> 8) ^ int(byte)) & 0xFF])
            want.append(crc)
        got = tmac.crc16(torch.from_numpy(data).to(dev))
        assert got.device.type == "cuda" and got.cpu().tolist() == want


def test_mac_write_and_read_soft_make_no_host_sync(dev):
    mac = tmac.Mac(frame_bytes=CFG.frame_bytes, spread=CFG.mod_type)
    payload, seq = _mac_frames(mac, 256, 3)
    payload, seq = payload.to(dev), seq.to(dev)
    diag = torch.randn(256, mac.logical_bytes * 8, device=dev)
    mac.read_soft(diag)                 # builds and caches crc16's matrix
    wire = mac.write(payload, seq)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        wire2 = mac.write(payload, seq)
        fr = mac.read_soft(diag)
        mac.write(payload, 5)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(wire, wire2) and fr.valid.shape == (256,)


def test_apply_channel_on_card_equals_cpu(dev):
    """Explicit phi0 and noise: the card's output equals the CPU's within
    1e-6 of max|x| (complex64; no int16 round trip, whose rounding at a
    tie could turn a last-ulp difference into one LSB)."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy((rng.standard_normal((4, 3000))
                          + 1j * rng.standard_normal((4, 3000))).astype(
                              np.complex64))
    params = ChannelParams(snr_db=15.0, cfo=-2e-4, timing_offset=400,
                           capture_len=3900, multipath=(0.15 + 0.1j,),
                           amplitude=80.0, sco_ppm=20.0)
    phi0 = torch.from_numpy(rng.uniform(0, 2 * np.pi, 4).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((4, 3900, 2)).astype(
        np.float32))
    cpu = apply_channel(params, x, phi0=phi0, noise=noise)
    card = apply_channel(params, x.to(dev), phi0=phi0.to(dev),
                         noise=noise.to(dev))
    assert card.device.type == "cuda" and card.shape == cpu.shape
    err = float((card.cpu() - cpu).abs().max())
    assert err <= 1e-6 * float(cpu.abs().max()), err
    g1 = torch.Generator(device=dev).manual_seed(1)
    g2 = torch.Generator(device=dev).manual_seed(1)
    a = apply_channel(params, x.to(dev), generator=g1)
    assert torch.equal(a, apply_channel(params, x.to(dev), generator=g2))


# the channel sets of tests/test_mac_channel.py's link loop, 64 frames each
LINK_SETS = (
    dict(snr_db=25.0, cfo=0.0, timing_offset=0),
    dict(snr_db=20.0, cfo=3e-4, timing_offset=1234),
    dict(snr_db=15.0, cfo=-2e-4, timing_offset=4096, quantize_mult=CFG.mult,
         amplitude=80.0),
    dict(snr_db=25.0, cfo=1e-4, timing_offset=500, multipath=(0.15 + 0.1j,),
         amplitude=50.0),
)


def test_mac_link_batch_on_card(dev):
    """256 MAC frames (seq 0-255) -> transmit -> apply_channel in the four
    LINK_SETS (noise from a generator on the card) -> FlagshipStep.receive
    -> read_soft: every frame at its set's timing offset, payload and seq
    exact, CRC valid, K1 once; read_llr(soft_llrs) the same.  The second
    set again with phi0 and noise drawn on the CPU: the sync fields and
    every MacFrame field equal to the CPU run."""
    from c_ofdm_tpu_torch.models import tx
    from c_ofdm_tpu_torch.ops import modulation
    step = FlagshipStep(make_frame_spec(CFG, torch.complex64, device=dev))
    spec = step.bound_spec()
    mac = tmac.Mac(frame_bytes=CFG.frame_bytes, spread=CFG.mod_type)
    per = 64
    B = per * len(LINK_SETS)
    payload = torch.from_numpy(np.random.default_rng(21).integers(
        0, 256, (B, mac.payload), dtype=np.uint8)).to(dev)
    params = [ChannelParams(capture_len=CFG.frame_len + 6144, **kw)
              for kw in LINK_SETS]
    g = torch.Generator(device=dev).manual_seed(21)
    frames = tx.transmit(spec, mac.write(payload, torch.arange(B,
                                                               device=dev)))
    caps = torch.cat([apply_channel(p, frames[i * per:(i + 1) * per],
                                    generator=g)
                      for i, p in enumerate(params)])
    k1 = extract.extract_windows.launches
    res, s = step.receive(caps)
    fr = mac.read_soft(res.constellation.real + res.constellation.imag)
    torch.cuda.synchronize()
    assert extract.extract_windows.launches == k1 + 1
    assert bool(s.found.all())
    np.testing.assert_array_equal(
        s.frame_start.cpu().numpy(),
        np.repeat([p.timing_offset for p in params], per))
    assert bool(fr.valid.all()) and torch.equal(fr.payload, payload)
    assert fr.seq.cpu().tolist() == list(range(B))
    fl = mac.read_llr(modulation.soft_llrs(res.constellation, CFG.mod_type))
    assert bool(fl.valid.all()) and torch.equal(fl.payload, payload)
    assert torch.equal(fl.seq, fr.seq)

    p, rows = params[1], slice(per, 2 * per)
    gc = torch.Generator().manual_seed(22)
    phi0 = torch.rand(per, generator=gc) * (2 * np.pi)
    noise = torch.randn(per, caps.shape[-1], 2, generator=gc)
    res_d, s_d = step.receive(apply_channel(p, frames[rows], phi0=phi0.to(dev),
                                            noise=noise.to(dev)))
    fr_d = mac.read_soft(res_d.constellation.real + res_d.constellation.imag)
    cpu = FlagshipStep(make_frame_spec(CFG, torch.complex64, device="cpu"))
    wire_c = mac.write(payload.cpu()[rows], torch.arange(per, 2 * per))
    res_c, s_c = cpu.receive(apply_channel(
        p, tx.transmit(cpu.bound_spec(), wire_c), phi0=phi0, noise=noise))
    fr_c = mac.read_soft(res_c.constellation.real + res_c.constellation.imag)
    for name in ("frame_start", "t2_begin", "pr_begin", "found"):
        assert torch.equal(getattr(s_d, name).cpu(), getattr(s_c, name)), name
    for name, a, b in zip(fr_c._fields, fr_c, fr_d):
        assert torch.equal(a, b.cpu()), name
    assert bool(fr_c.valid.all())
    assert torch.equal(fr_c.payload, payload.cpu()[rows])


@pytest.mark.parametrize("ppm", [20.0, -20.0])
def test_mac_stream_under_sample_clock_offset_on_card(dev, ppm):
    """12 MAC frames back to back after 900 silent samples, through
    apply_channel on the card at a +-20 ppm sample clock (24 dB, CFO
    1.5e-4, amplitude 60), fed to a StreamingReceiver a buffer at a time:
    all 12 frames CRC-clean, in order, payloads exact; K2 twice a
    buffer."""
    from c_ofdm_tpu_torch.models import tx
    spec = make_frame_spec(CFG, torch.complex64, device=dev)
    mac = tmac.Mac(frame_bytes=CFG.frame_bytes, spread=CFG.mod_type)
    n_frames, buf = 12, CFG.rx_buf_size * CFG.frame_len
    payload = torch.from_numpy(np.random.default_rng(int(ppm) + 100).integers(
        0, 256, (n_frames, mac.payload), dtype=np.uint8)).to(dev)
    frames = tx.transmit(spec, mac.write(payload,
                                         torch.arange(n_frames, device=dev)))
    stream = torch.cat([torch.zeros(900, dtype=frames.dtype, device=dev),
                        frames.reshape(-1)])
    total = -(-stream.shape[0] // buf) * buf
    cap = apply_channel(
        ChannelParams(snr_db=24.0, cfo=1.5e-4, sco_ppm=ppm,
                      capture_len=total, amplitude=60.0),
        stream, generator=torch.Generator(device=dev).manual_seed(3))
    rxr = streaming.StreamingReceiver(spec, max_frames=16)
    k2 = extract.extract_windows_single.launches
    outs = [rxr.feed(cap[i:i + buf]) for i in range(0, total, buf)]
    torch.cuda.synchronize()
    assert extract.extract_windows_single.launches == k2 + 2 * len(outs)
    got = []
    for out in outs:
        fr = mac.read_soft(out.diag)
        got += [(int(fr.seq[k]), bool(fr.valid[k]), fr.payload[k])
                for k in torch.nonzero(out.valid).flatten().tolist()]
    assert [g[:2] for g in got] == [(i, True) for i in range(n_frames)]
    for i, (_, _, p) in enumerate(got):
        assert torch.equal(p, payload[i])


# ---- the apps on the card (python -m c_ofdm_tpu_torch tx / rx / loopback)

def _app(mod, argv):
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue()


@pytest.fixture
def six_buffer_stream(dev, tmp_path):
    """150 MAC frames with 3000-sample gaps written by the tx app on the
    card: 1 352 400 samples, six stock buffers."""
    from c_ofdm_tpu_torch.apps import txstream
    payload = np.random.default_rng(11).integers(0, 256, 150 * 248,
                                                 dtype=np.uint8).tobytes()
    (tmp_path / "p.bin").write_bytes(payload)
    assert txstream.main(["--in", str(tmp_path / "p.bin"), "--out",
                          str(tmp_path / "s.bin"), "--gap", "3000",
                          "--device", str(dev)]) == 0
    return tmp_path, payload


def _rx(d, tag, device, extra=()):
    import json
    from c_ofdm_tpu_torch.apps import rxstream
    assert rxstream.main(["--in", str(d / "s.bin"), "--out",
                          str(d / f"{tag}.bin"), "--metrics",
                          str(d / f"{tag}.jsonl"), "--summary-json",
                          str(d / f"{tag}.json"), "--device", str(device),
                          *extra]) == 0
    rows = [json.loads(ln) for ln in (d / f"{tag}.jsonl").read_text()
            .splitlines()]
    return ((d / f"{tag}.bin").read_bytes(), rows,
            json.loads((d / f"{tag}.json").read_text()))


def test_tx_rx_apps_on_card_equal_cpu(dev, six_buffer_stream):
    """The card's rx of the card's tx file decodes every frame and equals
    the CPU run: bytes, positions, seqs and CRC flags exact, cfo within
    1e-5; K2 launched twice per buffer."""
    d, payload = six_buffer_stream
    before = extract.extract_windows_single.launches
    card = _rx(d, "card", dev)
    torch.cuda.synchronize()
    k2 = extract.extract_windows_single.launches - before
    cpu = _rx(d, "cpu", "cpu")
    assert card[2]["buffers"] == 6 and k2 == 2 * 6
    assert card[0] == cpu[0] and card[0][:len(payload)] == payload
    assert len(card[1]) == len(cpu[1]) == 150
    for g, w in zip(card[1], cpu[1]):
        assert {k: g[k] for k in ("buf", "slot", "pos", "seq", "crc_ok")} \
            == {k: w[k] for k in ("buf", "slot", "pos", "seq", "crc_ok")}
        assert abs(g["cfo"] - w["cfo"]) <= 1e-5
    assert [r["seq"] for r in card[1]] == list(range(150))


def test_pinned_staging_equals_synchronous_copies(dev, six_buffer_stream):
    """The rx app's pinned two-slot ring (side copy stream, each slot
    reused three times) decodes the six buffers exactly as synchronous
    copies into the same receiver do."""
    from c_ofdm_tpu_torch.mac.mac import Mac
    d, _ = six_buffer_stream
    got, rows, _ = _rx(d, "pinned", dev)
    spec = make_frame_spec(CFG, torch.complex64, device=dev)
    mac = Mac(frame_bytes=CFG.frame_bytes, spread=CFG.mod_type)
    rxr = streaming.StreamingReceiver(spec)
    raw = np.fromfile(d / "s.bin", dtype=np.int16).reshape(-1, 2)
    n = CFG.rx_buf_size * CFG.frame_len
    want, want_rows = b"", []
    for i in range(0, raw.shape[0], n):
        block = np.zeros((n, 2), dtype=np.int16)
        block[:len(raw[i:i + n])] = raw[i:i + n]
        out = rxr.feed(torch.from_numpy(block).to(dev))
        fr = mac.read_soft(out.diag)
        for k in torch.nonzero(out.valid).flatten().tolist():
            want += fr.payload[k].cpu().numpy().tobytes()
            want_rows.append((int(out.positions[k]), int(fr.seq[k]),
                              float(out.cfo[k])))
    assert got == want
    assert [(r["pos"], r["seq"]) for r in rows] == [w[:2] for w in want_rows]
    assert max(abs(r["cfo"] - w[2]) for r, w in zip(rows, want_rows)) <= 1e-7


@pytest.mark.parametrize("chunk", [2, 4])
def test_rx_chunked_tallies_equal_chunk_1(dev, six_buffer_stream, chunk):
    """--drain metadata: --chunk 2 (three full groups) and --chunk 4 (a
    zero-padded tail group) tally what --chunk 1 does."""
    d, payload = six_buffer_stream
    one = _rx(d, "c1", dev, ["--drain", "metadata", "--chunk", "1"])[2]
    many = _rx(d, f"c{chunk}", dev, ["--drain", "metadata", "--chunk",
                                     str(chunk)])[2]
    keys = ("buffers", "frames", "crc_failures", "max_seq",
            "payload_checksum_u32")
    assert {k: one[k] for k in keys} == {k: many[k] for k in keys}
    assert one["frames"] == 150 and one["max_seq"] == 149
    assert one["payload_checksum_u32"] == sum(payload) & 0xFFFFFFFF


@pytest.mark.parametrize("f64", [False, True])
def test_loopback_app_on_card_launches_k1_once(dev, tmp_path, f64):
    from c_ofdm_tpu_torch.apps import loopback
    before = extract.extract_windows.launches
    rc, out = _app(loopback, ["--snr-db", "28", "--dump", str(tmp_path),
                              "--device", str(dev)]
                   + (["--f64"] if f64 else []))
    torch.cuda.synchronize()
    assert rc == 0 and "ACCURACY: 1.0" in out, out
    assert extract.extract_windows.launches == before + 1


def test_rx_native_ingest_equals_the_replayed_file(dev, six_buffer_stream):
    """rx --native-ingest on the card: the replay ring loops the file, so
    its bytes and metrics rows equal rx of a file holding what the replay
    yields (the file looped to whole buffers), the payload among them."""
    d, payload = six_buffer_stream
    n = CFG.rx_buf_size * CFG.frame_len
    raw = np.fromfile(d / "s.bin", dtype=np.int16)
    (d / "replay").mkdir()
    np.resize(raw, (raw.size // (n * 2) + 1) * n * 2).tofile(
        d / "replay" / "s.bin")
    nat = _rx(d, "native", dev, ["--native-ingest"])
    rep = _rx(d / "replay", "replay", dev)
    assert nat[0] == rep[0] and payload in nat[0]
    assert len(nat[1]) == len(rep[1]) >= 150
    for g, w in zip(nat[1], rep[1]):
        assert {k: g[k] for k in ("buf", "slot", "pos", "seq", "crc_ok")} \
            == {k: w[k] for k in ("buf", "slot", "pos", "seq", "crc_ok")}
        assert abs(g["cfo"] - w["cfo"]) <= 1e-5


def test_ber_sweep_app_on_card(dev, tmp_path):
    """ber-sweep of QAM16 at 12, 20 and 28 dB, 4 frames each: BER 0 at
    28 dB and the EVM falling as the SNR rises."""
    from c_ofdm_tpu_torch.apps import ber_sweep
    rc, _ = _app(ber_sweep, ["--mods", "4", "--snrs", "12:29:8", "--frames",
                             "4", "--out", str(tmp_path / "ber.jsonl"),
                             "--device", str(dev)])
    rows = [json.loads(ln) for ln in
            (tmp_path / "ber.jsonl").read_text().splitlines()]
    evms = [r["evm_rms"] for r in rows]
    assert rc == 0 and [r["snr_db"] for r in rows] == [12.0, 20.0, 28.0]
    assert rows[-1]["ber"] == 0.0 and evms == sorted(evms, reverse=True)


def test_ingest_bench_to_device_runs_on_card(dev):
    """ingest-bench --to-device pops 50 buffers into pinned memory and
    copies each to the card, and prints its one JSON line."""
    from c_ofdm_tpu_torch.apps import ingest_bench
    rc, out = _app(ingest_bench, ["--buffers", "50", "--to-device"])
    line = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and line["metric"] == "ingest_samples_per_s_to_device"
    assert line["value"] > 0


@pytest.mark.parametrize("group", [None, "nccl"])
def test_world_of_one_sharded_receiver_on_card_equals_cpu(dev, group):
    """The sharded receiver in a world of one on the card, with no process
    group or in an NCCL group of one (the outputs gathered through it): K3
    twice per call (regions, then frames), K1 and K2 never, and every
    field equal to the CPU run; frames straddling nothing, at both ends of
    the capture, decode."""
    import contextlib
    import torch.distributed as dist
    from c_ofdm_tpu_torch.models import tx
    from c_ofdm_tpu_torch.parallel import ingest, launch, mesh, sharded

    @contextlib.contextmanager
    def world(where):
        if where == "cpu" or group is None:
            yield
            return
        dist.init_process_group(
            group, init_method=f"tcp://localhost:{launch._free_port()}",
            world_size=1, rank=0, device_id=dev)
        try:
            yield
        finally:
            dist.destroy_process_group()

    tx_spec = make_frame_spec(CFG, torch.complex64, device="cpu")
    rng = np.random.default_rng(8)
    payload = rng.integers(0, 256, (4, CFG.frame_bytes), dtype=np.uint8)
    frames = tx.transmit(tx_spec, torch.from_numpy(payload)).numpy()
    n = 8 * CFG.frame_len
    caps = 0.05 * (rng.standard_normal((2, n))
                   + 1j * rng.standard_normal((2, n)))
    for i, (c, s) in enumerate([(0, 0), (0, 20_000), (1, 333),
                                (1, n - CFG.frame_len)]):
        caps[c, s:s + CFG.frame_len] += 60.0 * frames[i]
    caps = caps.astype(np.complex64)
    outs = {}
    for where in ("cpu", dev):
        spec = make_frame_spec(CFG, torch.complex64, device=where)
        with world(where):
            m = mesh.make_modem_mesh(1, 1, device=where)
            assert (m.group is not None) == (where == dev and bool(group))
            assert not m.staged
            recv = sharded.make_sharded_receiver(spec, m, 4)
            block = ingest.make_global_capture(m, caps)
            counts = [f.launches for f in (extract.extract_windows,
                                           extract.extract_windows_single,
                                           extract.extract_windows_multi)]
            out = sharded.gather_outputs(m, recv(block))
            torch.cuda.synchronize()
        if where == dev:
            assert [f.launches - c for f, c in zip(
                (extract.extract_windows, extract.extract_windows_single,
                 extract.extract_windows_multi), counts)] == [0, 0, 2]
        outs[str(where)] = out
    cpu, card = outs["cpu"], outs[str(dev)]
    for name in ("positions", "valid", "num_found"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name)), name
    valid = cpu.valid
    assert cpu.num_found.tolist() == [[2], [2]]
    assert torch.equal(card.mac_bytes.cpu()[valid], cpu.mac_bytes[valid])
    np.testing.assert_array_equal(cpu.mac_bytes[valid].numpy(), payload)
    torch.testing.assert_close(card.diag.cpu()[valid], cpu.diag[valid],
                               rtol=0, atol=1e-4)


# ---- the compiled entry points: CUDA-graph replays (utils/graphs.py)

def _stream_blocks(C, S=3, seed=9):
    """S consecutive stock buffers, [S, n] (C = 0) or [S, C, n] complex64
    on the CPU, with frames planted at random starts (some straddle a
    buffer boundary) in AWGN."""
    from c_ofdm_tpu_torch.models import tx
    tx_spec = make_frame_spec(CFG, torch.complex64, device="cpu")
    rng = np.random.default_rng(seed)
    n = CFG.rx_buf_size * CFG.frame_len
    rows = max(C, 1)
    total = S * n
    sig = 0.05 * (rng.standard_normal((rows, total))
                  + 1j * rng.standard_normal((rows, total)))
    nf = 24
    payload = rng.integers(0, 256, (rows, nf, CFG.frame_bytes),
                           dtype=np.uint8)
    frames = tx.transmit(tx_spec, torch.from_numpy(payload)).numpy()
    for c in range(rows):
        starts = np.sort(rng.choice(total // CFG.frame_len - 1, nf,
                                    replace=False)) * CFG.frame_len
        starts += rng.integers(0, CFG.frame_len // 2, nf)
        for i, s in enumerate(starts):
            sig[c, s:s + CFG.frame_len] += 60.0 * frames[c, i]
    blocks = sig.astype(np.complex64).reshape(rows, S, n).transpose(1, 0, 2)
    return torch.from_numpy(np.ascontiguousarray(
        blocks[:, 0] if C == 0 else blocks))


def _planted_rings(C, seed, dev, S=4, cfg=CFG):
    """S consecutive buffers of ``cfg`` a channel, [S, n] (C = 0) or [S, C,
    n] complex64 on ``dev``, made as the benchmark's stream traffic makes
    them: int(0.8 S n / frame_len) MAC frames a channel (random payloads
    written with seq 0, 1, ...) at multinomial random gaps, CFO 1e-4
    cycles a sample, amplitude 60, AWGN at 26 dB SNR.  Returns (blocks,
    per channel the planted starts of the frames that end inside the S
    buffers, in order, the payloads [channels, frames, mac.payload])."""
    from c_ofdm_tpu_torch.models import tx
    spec = make_frame_spec(cfg, torch.complex64, device=dev)
    mac = tmac.Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    fl, rows = cfg.frame_len, max(C, 1)
    total = S * cfg.rx_buf_size * fl
    rng = np.random.default_rng(seed)
    nf = int(0.8 * total / fl)
    payload = rng.integers(0, 256, (rows, nf, mac.payload), dtype=np.uint8)
    gaps = np.stack([rng.multinomial(total - nf * fl,
                                     np.ones(nf + 1) / (nf + 1))
                     for _ in range(rows)])
    starts = np.cumsum(gaps[:, :nf], axis=1) + fl * np.arange(nf)
    wire = mac.write(torch.from_numpy(payload).to(dev),
                     torch.arange(nf, device=dev))
    frames = tx.transmit(spec, wire)
    flat = torch.from_numpy(starts + total * np.arange(rows)[:, None]).to(dev)
    idx = flat[..., None] + torch.arange(fl, device=dev)
    sig = torch.zeros(rows * total, dtype=torch.complex64, device=dev)
    sig[idx.reshape(-1)] = frames.reshape(-1)
    k = torch.arange(total, dtype=torch.float64, device=dev)
    rot = torch.polar(torch.full_like(k, 60.0), 2 * np.pi * 1e-4 * k)
    std = torch.sqrt((frames.abs() ** 2).mean() * 3600
                     * 10 ** (-26.0 / 10) / 2)
    g = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn((2, rows, total), generator=g, device=dev)
    sig = (sig.view(rows, total) * rot.to(torch.complex64)
           + torch.complex(noise[0], noise[1]) * std)
    blocks = sig.view(rows, S, -1).transpose(0, 1).contiguous()
    truth = [[int(x) for x in st if x + fl < total] for st in starts]
    return (blocks[:, 0].contiguous() if C == 0 else blocks), truth, payload


def _assert_planted(outs, truth, payload, C, cfg=CFG):
    """Every planted frame of ``_planted_rings`` decoded exactly once, in
    order, at its planted start, and nothing else; read_soft of its slot
    gives its seq and payload with the CRC valid."""
    mac = tmac.Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    n, rows = cfg.rx_buf_size * cfg.frame_len, max(C, 1)
    got = [[] for _ in range(rows)]
    for b, out in enumerate(outs):
        fr = mac.read_soft(out.diag)
        pos = out.positions.cpu().reshape(rows, -1)
        valid = out.valid.cpu().reshape(rows, -1)
        seq = fr.seq.cpu().reshape(rows, -1)
        ok = fr.valid.cpu().reshape(rows, -1)
        pl = fr.payload.cpu().reshape(rows, valid.shape[1], -1)
        for c in range(rows):
            for k in torch.nonzero(valid[c]).flatten().tolist():
                got[c].append((b * n - cfg.frame_len + int(pos[c, k])
                               - cfg.t2sin_size, int(seq[c, k]),
                               bool(ok[c, k]), pl[c, k].numpy()))
    for c in range(rows):
        assert [g[:3] for g in got[c]] == [
            (s, i, True) for i, s in enumerate(truth[c])], c
        for _, i, _, p in got[c]:
            np.testing.assert_array_equal(p, payload[c, i])


def _same(a, b):
    """Two outputs equal field for field (NaN where both are NaN)."""
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("backend", ["matmul", "pallas", "xla",
                                     "matmul_bf16", "ct", "ct_bf16"])
def test_flagship_graph_equals_eager(dev, backend):
    """FlagshipStep replays one graph per call under each FFT backend:
    every output field equal to the eager step on the same inputs, the
    payloads exact, K1 (and under pallas K4 twice; under the others never)
    per replay as per eager call, the outputs of call i unchanged by call
    i+1, transmit_jit -> receive_batch_jit equal to the step's graph, and a
    new batch size captures a second graph."""
    from c_ofdm_tpu_torch.models import rx, tx
    from c_ofdm_tpu_torch.utils import graphs
    step = FlagshipStep(make_frame_spec(CFG, torch.complex64, device=dev,
                                        fft_backend=backend))
    spec = step.bound_spec()
    rng = np.random.default_rng(10)
    payloads = [torch.from_numpy(rng.integers(
        0, 256, (16, CFG.frame_bytes), dtype=np.uint8)).to(dev)
        for _ in range(3)]

    def eager(p):
        return rx.receive_batch(spec, tx.transmit(spec, p))

    before = graphs.launch_counts()
    want = [eager(p) for p in payloads]
    per_eager = {k: v - before.get(k, 0)
                 for k, v in graphs.launch_counts().items()}
    got = [step(p) for p in payloads]          # first call captures
    assert len(step.graphs.graphs) == 1
    mid = graphs.launch_counts()
    again = step(payloads[0])
    per_replay = {k: v - mid.get(k, 0)
                  for k, v in graphs.launch_counts().items()}
    torch.cuda.synchronize()
    assert {k: 3 * v for k, v in per_replay.items() if v} == \
        {k: v for k, v in per_eager.items() if v}
    assert extract.extract_windows.launches - mid[
        (extract.extract_windows, "launches", None)] == 1
    assert dft.dft.launches - mid[(dft.dft, "launches", None)] == (
        2 if backend == "pallas" else 0)
    for w, g in zip(want, got):
        _same(w[0], g[0])
        _same(w[1], g[1])
    _same(got[0][0], again[0])
    for p, (res, _) in zip(payloads, got):        # call i kept its outputs
        assert torch.equal(res.mac_bytes, p)
    jit = rx.receive_batch_jit(spec, tx.transmit_jit(spec, payloads[0]))
    _same(got[0][0], jit[0])
    _same(got[0][1], jit[1])
    step(payloads[1][:8])
    assert len(step.graphs.graphs) == 2
    step.to(dev)
    assert not step.graphs.graphs


@pytest.mark.parametrize("C,backend,geometry", [
    (0, "matmul", "stock"), (8, "matmul", "stock"), (8, "pallas", "stock"),
    (0, "pallas", "1536")])
def test_streaming_graph_equals_eager(dev, C, backend, geometry):
    """StreamingReceiver.feed replays one graph per buffer, the state
    carried in the module's buffers: every output and state field equal to
    eager process_buffer over the same buffers, the outputs of buffer i
    unchanged after buffer i+1, K2 (C = 0) or K3 (C = 8) twice per replay
    and K4 once under pallas (on the geometry's route: radix at the stock
    layout, mixed at 1536 points), never otherwise.  The buffers are
    MAC-framed rings (``_planted_rings``): every planted frame decodes
    exactly once, in order, at its start, CRC-clean."""
    cfg, _, routes = PALLAS_GEOMETRIES[geometry][:3]
    route = next(iter(routes))
    spec = make_frame_spec(cfg, torch.complex64, device=dev,
                           fft_backend=backend)
    blocks, truth, payload = _planted_rings(C, 30 + C, dev, cfg=cfg)
    state = streaming.init_state(spec, channels=C)
    want = []
    for b in blocks:
        state, out = streaming.process_buffer(spec, state, b)
        want.append(out)
    rxr = streaming.StreamingReceiver(spec, channels=C)
    fn = extract.extract_windows_multi if C else extract.extract_windows_single
    got, per = [], []
    for b in blocks:
        n0 = (fn.launches, _route_counts())
        got.append(rxr.feed(b))
        per.append((fn.launches - n0[0],
                    dft.dft.launches - n0[1]["launches"],
                    _route_counts()[route] - n0[1][route]))
    torch.cuda.synchronize()
    k4 = int(backend == "pallas")
    assert per == [(2, k4, k4)] * len(blocks)
    assert len(rxr.graphs.graphs) == 1
    for w, g in zip(want, got):
        _same(w, g)
    _same(state, rxr.state)
    _assert_planted(got, truth, payload, C, cfg)
    assert rxr.graphs.graphs[next(iter(rxr.graphs.graphs))].delta


@pytest.mark.parametrize("how", ["setter", "load_state"])
def test_streaming_state_after_capture(dev, how):
    """After capture, setting the state (or loading a checkpoint into it)
    copies into the captured buffers: the receiver carries on as an
    uninterrupted run; a state of another shape rebinds and recaptures."""
    import io
    spec = make_frame_spec(CFG, torch.complex64, device=dev)
    blocks = _stream_blocks(8).to(dev)
    full = streaming.StreamingReceiver(spec, channels=8)
    outs = [full.feed(b) for b in blocks]
    rxr = streaming.StreamingReceiver(spec, channels=8)
    rxr.feed(blocks[0])
    rxr.feed(blocks[2])                       # a wrong buffer: state diverges
    first = streaming.StreamingReceiver(spec, channels=8)
    first.feed(blocks[0])
    if how == "setter":
        rxr.state = first.state
    else:
        f = io.BytesIO()
        streaming.save_state(f, first.state)
        f.seek(0)
        rxr.state = streaming.load_state(f, device=dev)
    graph = rxr.graphs.graphs
    assert len(graph) == 1
    _same(rxr.feed(blocks[1]), outs[1])
    _same(rxr.feed(blocks[2]), outs[2])
    rxr.state = streaming.init_state(spec, channels=4)
    assert not rxr.graphs.graphs
    rxr.feed(blocks[0][:4])
    assert len(rxr.graphs.graphs) == 1


def test_capture_refuses_a_host_sync_and_runs_nothing_eager(dev):
    """A step that reads a value back (``.item()``) raises at capture with
    the key in the message; no graph is kept and no result returned."""
    from c_ofdm_tpu_torch.utils import graphs
    call = graphs.CapturedCall("item-step")
    x = torch.ones(16, device=dev)

    def step(t):
        return t * (t.sum().item() + 1.0)

    with pytest.raises(RuntimeError, match="capture failed.*item-key"):
        call(step, (x,), static="item-key")
    assert not call.graphs
    torch.cuda.synchronize()
    y = graphs.jit(lambda t: t * 2, static_argnums=())(x)   # the card works
    assert torch.equal(y, x * 2)


def test_replay_survives_evicted_constants(dev):
    """A graph holds the cached constants its capture read (K4's twiddles,
    the DFT and CRC tables): after every cache is cleared and the freed
    memory is overwritten, a replay still equals the eager step."""
    from c_ofdm_tpu_torch.models import rx, tx
    from c_ofdm_tpu_torch.ops import modulation
    step = FlagshipStep(make_frame_spec(CFG, torch.complex64, device=dev,
                                        fft_backend="pallas"))
    payload = torch.from_numpy(np.random.default_rng(11).integers(
        0, 256, (8, CFG.frame_bytes), dtype=np.uint8)).to(dev)
    spec = step.bound_spec()
    want = rx.receive_batch(spec, tx.transmit(spec, payload))
    step(payload)
    (g,) = step.graphs.graphs.values()
    assert any(isinstance(t, torch.Tensor) and t.dtype == torch.complex64
               and t.shape == (CFG.fft_size,) for t in g.held)   # twiddles
    for cache in (dft.fft_twiddles, dft.dft_planes, fft._full_basis,
                  fft._ct_constants, modulation._bpsk_table,
                  modulation._llr_tables, tmac._crc16_affine):
        cache.cache_clear()
    torch.cuda.synchronize()
    junk = [torch.full((1 << k,), float("nan"), device=dev)
            for k in range(8, 22, 2) for _ in range(32)]
    got = step(payload)
    torch.cuda.synchronize()
    del junk
    _same(want[0], got[0])
    _same(want[1], got[1])
    assert torch.equal(got[0].mac_bytes, payload)


def test_launch_counters_advance_on_replay(dev):
    """Each replay adds what one call launches; warm-up and capture add
    nothing."""
    from c_ofdm_tpu_torch.models import rx, tx
    spec = make_frame_spec(CFG, torch.complex64, device=dev,
                           fft_backend="pallas")
    payload = torch.zeros((4, CFG.frame_bytes), dtype=torch.uint8, device=dev)
    k1, k4 = extract.extract_windows.launches, dft.dft.radix_launches
    frames = tx.transmit_jit(spec, payload)          # capture + 1 replay
    assert (extract.extract_windows.launches, dft.dft.radix_launches) == (
        k1, k4 + 1)
    for i in range(3):
        res, s = rx.receive_batch_jit(spec, frames)
    torch.cuda.synchronize()
    assert (extract.extract_windows.launches, dft.dft.radix_launches) == (
        k1 + 3, k4 + 4)
    assert torch.equal(res.mac_bytes, payload) and bool(s.found.all())
    assert len(rx.receive_batch_jit.graphs.graphs) >= 1


@pytest.mark.parametrize("mode", ["gated", "dense"])
def test_streaming_graph_per_block_layout(dev, mode):
    """Complex, interleaved float32 and int16 blocks each capture their own
    graph (gated and dense sync; dense walks hits in a loop of device ops
    with no host sync), every output equal to the eager run."""
    spec = make_frame_spec(CFG, torch.complex64, device=dev)
    z = _stream_blocks(0, S=2).numpy()
    planes = np.stack([z.real, z.imag], -1) * 200.0
    layouts = [torch.from_numpy(z).to(dev),
               torch.from_numpy(planes.astype(np.float32)).to(dev),
               torch.from_numpy(planes.astype(np.int16)).to(dev)]
    rxr = streaming.StreamingReceiver(spec, sync_mode=mode)
    for blocks in layouts:
        rxr.state = streaming.init_state(spec)
        state = streaming.init_state(spec)
        for b in blocks:
            state, want = streaming.process_buffer(spec, state, b,
                                                   sync_mode=mode)
            _same(want, rxr.feed(b))
        _same(state, rxr.state)
    assert len(rxr.graphs.graphs) == 3


# ---- the sharded steps captured (parallel/sharded.py)

@contextlib.contextmanager
def _no_sync():
    """Any host synchronisation inside the block raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _sharded_inputs(dev, seed=12):
    """A block [2, 8 frame lengths] and its right neighbour's head [2,
    frame_len] on the card, with frames at the block start, inside, one
    straddling into the halo and one starting on the halo's first sample
    (the neighbour's); and the planted payloads of the block's frames."""
    from c_ofdm_tpu_torch.models import tx
    tx_spec = make_frame_spec(CFG, torch.complex64, device="cpu")
    rng = np.random.default_rng(seed)
    n = 8 * CFG.frame_len
    payload = rng.integers(0, 256, (6, CFG.frame_bytes), dtype=np.uint8)
    frames = tx.transmit(tx_spec, torch.from_numpy(payload)).numpy()
    caps = 0.05 * (rng.standard_normal((2, n + CFG.frame_len))
                   + 1j * rng.standard_normal((2, n + CFG.frame_len)))
    for i, (c, s) in enumerate([(0, 0), (0, 20_000),
                                (0, n - CFG.frame_len // 3), (1, 333),
                                (1, n - CFG.frame_len - 5), (1, n)]):
        end = min(s + CFG.frame_len, caps.shape[1])
        caps[c, s:end] += 60.0 * frames[i, :end - s]
    caps = torch.from_numpy(caps.astype(np.complex64)).to(dev)
    return caps[:, :n].contiguous(), caps[:, n:].contiguous(), payload


@pytest.mark.parametrize("sync_mode,backend", [
    ("gated", "matmul"), ("dense", "matmul"), ("gated", "pallas")])
def test_sharded_receiver_graph_equals_eager(dev, sync_mode, backend):
    """The world-of-one receiver replays one graph per call (halo_valid
    False: no right neighbour), every field equal to the eager body; the
    halo_valid True graph, driven through ``replay_local`` with a real
    halo, equals its eager body too and decodes the straddling frame.  One
    graph per key; later calls capture nothing and make no host sync; K3
    launches per replay as per eager call (gated: regions and frames;
    dense: frames), and K4 once under pallas (the radix route: the demod
    of every window), never otherwise."""
    from c_ofdm_tpu_torch.parallel import mesh, sharded
    spec = make_frame_spec(CFG, torch.complex64, device=dev,
                           fft_backend=backend)
    block, halo, payload = _sharded_inputs(dev)
    K = 6
    recv = sharded.make_sharded_receiver(
        spec, mesh.make_modem_mesh(1, 1, device=dev), K, sync_mode)
    k3 = extract.extract_windows_multi
    k4 = int(backend == "pallas")

    def launches():
        return (k3.launches, dft.dft.launches, dft.dft.radix_launches)

    def since(n0):
        return tuple(a - b for a, b in zip(launches(), n0))

    want = {}
    for valid in (False, True):
        n0 = launches()
        want[valid] = sharded._shard_body(
            spec, valid, K, sync_mode, block,
            halo if valid else torch.zeros_like(halo))
        per_eager = since(n0)
    assert per_eager == (2 if sync_mode == "gated" else 1, k4, k4)
    n0 = launches()
    got = recv(block)                           # warm-up, capture, replay
    torch.cuda.synchronize()
    assert since(n0) == per_eager
    got_true = sharded.replay_local(recv.graphs, spec, block, halo, True, K,
                                    sync_mode)
    keys = {key[0][1] for key in recv.graphs.graphs}
    assert keys == {False, True} and len(recv.graphs.graphs) == 2
    held = dict(recv.graphs.graphs)
    n0 = launches()
    with _no_sync():
        again = recv(block)
        again_true = sharded.replay_local(recv.graphs, spec, block, halo,
                                          True, K, sync_mode)
    torch.cuda.synchronize()
    assert since(n0) == tuple(2 * n for n in per_eager)
    assert recv.graphs.graphs == held            # nothing captured again
    for out in (got, again):
        _same(want[False], out)
    for out in (got_true, again_true):
        _same(want[True], out)
    assert want[True].num_found[:, 0].tolist() == [3, 2]
    assert want[False].num_found[:, 0].tolist() == [2, 2]
    v = got_true.valid[:, 0].cpu()
    np.testing.assert_array_equal(
        got_true.mac_bytes[:, 0].cpu()[v].numpy(), payload[[0, 1, 2, 3, 4]])


def test_sharded_stream_graph_equals_streaming_receiver(dev):
    """The channel-sharded step in a world of one replays one graph per
    buffer over S = 4 buffers at C = 8: every output and the final state
    equal to StreamingReceiver(channels=8).feed, K3 twice per replay, no
    host sync after capture, and the state a buffer returned unchanged by
    the next buffer (fresh tensors, as jax.jit returns)."""
    from c_ofdm_tpu_torch.parallel import mesh, sharded
    spec = make_frame_spec(CFG, torch.complex64, device=dev)
    blocks = _stream_blocks(8, S=4).to(dev)
    rxr = streaming.StreamingReceiver(spec, channels=8)
    want = [rxr.feed(b) for b in blocks]
    step = sharded.make_sharded_streaming(
        spec, mesh.make_modem_mesh(1, 1, device=dev), 0)
    state = streaming.init_state(spec, channels=8)
    k3 = extract.extract_windows_multi
    got, per, states = [], [], []
    for i, b in enumerate(blocks):
        n0 = k3.launches
        with _no_sync() if i else contextlib.nullcontext():
            state, out = step(state, b)
        got.append(out)
        per.append(k3.launches - n0)
        states.append((state, [t.clone() for t in state]))
    torch.cuda.synchronize()
    assert per == [2] * len(blocks) and len(step.graphs.graphs) == 1
    for w, g in zip(want, got):
        _same(w, g)
    _same(rxr.state, state)
    for st, snap in states:
        _same(snap, st)
    assert int(sum(o.num_found.sum() for o in got)) > 0


def test_gloo_world_on_one_card_equals_process_buffer(dev):
    """4 gloo ranks all on the one card (``launch.receive_rank``), mesh
    {channel: 2, time: 2}, the halo staged through host memory: every
    rank's gathered view equal; every frame at its planted start with its
    bytes (one a channel straddles the time boundary, one ends at the
    capture end), as process_buffer over the whole capture on the card
    finds them; K3 twice and the hop track once a rank and no other
    kernel; one graph a rank, halo_valid on the left blocks only."""
    from c_ofdm_tpu_torch.models import tx
    from c_ofdm_tpu_torch.parallel import launch
    nc, nt, C, K = 2, 2, 4, 6
    fl = CFG.frame_len
    block = 8 * fl
    total = nt * block
    starts = [500, block - fl // 3, block + 9000, total - fl]
    rng = np.random.default_rng(24)
    payload = rng.integers(0, 256, (C, len(starts), CFG.frame_bytes),
                           dtype=np.uint8)
    frames = tx.transmit(make_frame_spec(CFG, torch.complex64, device="cpu"),
                         torch.from_numpy(payload)).numpy()
    caps = 0.05 * (rng.standard_normal((C, total))
                   + 1j * rng.standard_normal((C, total)))
    for c in range(C):
        for i, s in enumerate(starts):
            caps[c, s:s + fl] += 60.0 * frames[c, i]
    caps = caps.astype(np.complex64)
    ranks = launch.run_world(
        nc * nt, "c_ofdm_tpu_torch.parallel.launch:receive_rank",
        backend="gloo", device=str(dev),
        args=(CFG, torch.complex64, "matmul", caps, nc, nt, K), timeout=300)
    for r, res in enumerate(ranks):
        assert res["coords"] == divmod(r, nt)
        assert res["launches"] == dict(NO_LAUNCHES, extract_windows_multi=2,
                                       t2_ratio_track_hop=1)
        assert [g["static"] for g in res["graphs"]] == [
            [res["coords"][1] < nt - 1, K, "gated"]]
        for k, v in res["out"].items():
            np.testing.assert_array_equal(v, ranks[0]["out"][k], err_msg=k)
    out = ranks[0]["out"]
    spec = make_frame_spec(CFG, torch.complex64, device=dev)
    _, ref = streaming.process_buffer(
        spec, streaming.init_state(spec, channels=C),
        torch.from_numpy(caps).to(dev), len(starts) + 2)
    for c in range(C):
        gpos = out["positions"][c] + (np.arange(nt) * block)[:, None]
        v = out["valid"][c]
        got = sorted((int(p) - CFG.t2sin_size, bytes(b))
                     for p, b in zip(gpos[v], out["mac_bytes"][c][v]))
        assert got == [(s, payload[c, i].tobytes())
                       for i, s in enumerate(starts)], c
        rv = ref.valid[c].cpu().numpy()
        single = sorted((int(p) - fl - CFG.t2sin_size, bytes(b)) for p, b in
                        zip(ref.positions[c].cpu().numpy()[rv],
                            ref.mac_bytes[c].cpu().numpy()[rv]))
        assert single == got, c


def test_channel_sharded_stream_world_on_one_card(dev):
    """The channel-sharded stream in a world of 2 gloo ranks on the one
    card (``launch.stream_rank``), mesh {channel: 2, time: 1}, a graph
    replay a buffer, on 8 channels of MAC-framed rings: every buffer's
    gathered output equal to StreamingReceiver(channels=8) on the card
    (diag and cfo within 1e-4: each rank's products are 4 channels wide),
    the final state exactly; every planted frame decoded; K3 twice and the
    hop track once a buffer a rank, no other kernel; one graph a rank."""
    from c_ofdm_tpu_torch.parallel import launch
    blocks, truth, payload = _planted_rings(8, 38, dev)
    spec = make_frame_spec(CFG, torch.complex64, device=dev)
    rxr = streaming.StreamingReceiver(spec, channels=8)
    want = [rxr.feed(b) for b in blocks]
    ranks = launch.run_world(
        2, "c_ofdm_tpu_torch.parallel.launch:stream_rank", backend="gloo",
        device=str(dev), args=(CFG, torch.complex64, "matmul",
                               blocks.cpu().numpy(), 2, 1, 0), timeout=300)
    for res in ranks:
        assert res["launches"] == dict(
            NO_LAUNCHES, extract_windows_multi=2 * len(blocks),
            t2_ratio_track_hop=len(blocks))
        assert len(res["graphs"]) == 1
        outs = [streaming.StreamOut(**{k: torch.from_numpy(v)
                                       for k, v in o.items()})
                for o in res["outs"]]
        for w, g in zip(want, outs):
            w = streaming.StreamOut(*(t.cpu() for t in w))
            for name in ("positions", "valid", "num_found"):
                assert torch.equal(getattr(w, name), getattr(g, name)), name
            v = w.valid
            assert torch.equal(w.mac_bytes[v], g.mac_bytes[v])
            for name in ("diag", "cfo"):
                torch.testing.assert_close(getattr(g, name)[v],
                                           getattr(w, name)[v],
                                           rtol=0, atol=1e-4)
        for k, v in res["state"].items():
            np.testing.assert_array_equal(
                v, getattr(rxr.state, k).cpu().numpy(), err_msg=k)
    _assert_planted(outs, truth, payload, 8)


def test_scaling_bench_app_on_card(dev):
    """scaling-bench --devices 1 --channels 8 --frames-per-block 40: an
    NCCL world of one rank on the card finds all 8 planted frames and
    prints its JSON line; --devices one more than the cards raises the
    mesh's ValueError."""
    import io
    from c_ofdm_tpu_torch.apps import scaling_bench
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, text = _app(scaling_bench, ["--devices", "1", "--channels", "8",
                                        "--frames-per-block", "40"])
    line = json.loads(text.strip().splitlines()[-1])
    assert rc == 0 and line["devices"] == [1]
    assert "(8 frames)" in err.getvalue(), err.getvalue()
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"need {n} devices, have {n - 1}"):
        _app(scaling_bench, ["--devices", str(n), "--channels", "8"])


# ---- the trace recorder (io/trace.py) on the card

STAGE_SPANS = ["sync", "extract", "recover", "dft", "equalize"]


@pytest.fixture
def recorder_off():
    from c_ofdm_tpu_torch.io import trace
    trace.disable()
    trace.drain()
    yield trace
    trace.disable()
    trace.drain()


# cuGraphNodeGetType's CUgraphNodeType values
NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait event", 7: "record event",
              10: "mem alloc", 11: "mem free"}


def _captured(fn):
    """fn(0) captured into a CUDA graph kept whole (``keep_graph=True``)
    on a side stream, after a first call there (a library's lazy set-up,
    such as a cuBLAS workspace, is never captured).  A call that
    synchronises with the host or copies from it raises."""
    from c_ofdm_tpu_torch.utils import graphs
    s = graphs._side_stream(torch.device("cuda",
                                         torch.cuda.current_device()))
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn(0)
    s.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=s):
        fn(0)
    return g


def _kernel_nodes(fn):
    """{node kind: count} of one call of fn(0), exact: the call captured
    whole (``_captured``) and its nodes counted by type through libcuda's
    graph calls (cuGraphGetNodes, cuGraphNodeGetType).  A graph holds every launch
    of the call, where torch.profiler now and then drops a record.  A call
    that cannot be captured, or a failed query, raises."""
    import collections
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_void_p),
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    g = _captured(fn)
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    rc = cu.cuGraphGetNodes(graph, None, ctypes.byref(count))
    nodes = (ctypes.c_void_p * count.value)()
    if rc == 0:
        rc = cu.cuGraphGetNodes(graph, nodes, ctypes.byref(count))
    assert rc == 0, f"cuGraphGetNodes failed ({rc})"
    kinds = collections.Counter()
    for node in nodes:
        kind = ctypes.c_int(-1)
        rc = cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        assert rc == 0, f"cuGraphNodeGetType failed ({rc})"
        kinds[NODE_KINDS.get(kind.value, str(kind.value))] += 1
    del g
    return dict(kinds)


def test_untraced_capture_holds_no_recorder_node(dev, recorder_off,
                                                 monkeypatch):
    """A stream buffer and a batch step captured with the recorder off have
    the same nodes before the recorder was ever on, after it was on, and
    with every recorder method made to raise (so no site ran one)."""
    trace = recorder_off
    spec = make_frame_spec(CFG, torch.complex64, device=dev)
    block = _stream_blocks(8)[0].to(dev)
    rxr = streaming.StreamingReceiver(spec, channels=8)
    step = FlagshipStep(spec)
    payload = torch.zeros((16, CFG.frame_bytes), dtype=torch.uint8,
                          device=dev)

    def nodes():
        return (_kernel_nodes(lambda i: rxr._step(block)),
                _kernel_nodes(lambda i: step._forward(payload)))

    first = nodes()
    trace.enable()
    rxr.feed(block)
    step(payload)
    trace.disable()
    trace.drain()
    again = nodes()

    def boom(*args, **kwargs):
        raise AssertionError("the recorder ran while off")
    for name in ("begin", "mark", "count_hits", "entry", "span",
                 "hit_counter"):
        monkeypatch.setattr(trace.Recorder, name, boom)
    patched = nodes()
    assert first == again == patched
    assert first[0]["kernel"] > 50 and first[1]["kernel"] > 50


def test_traced_capture_adds_the_marks_and_the_hit_counter(dev,
                                                           recorder_off):
    """With the recorder on, a captured stream buffer holds six more kernel
    nodes (the marks) and the hit counter's (its sum and add captured
    alone); a batch step the six marks; no other node changes."""
    trace = recorder_off
    spec = make_frame_spec(CFG, torch.complex64, device=dev)
    block = _stream_blocks(8)[0].to(dev)
    rxr = streaming.StreamingReceiver(spec, channels=8)
    step = FlagshipStep(spec)
    payload = torch.zeros((16, CFG.frame_bytes), dtype=torch.uint8,
                          device=dev)

    def stream(i):
        rxr._step(block)
        trace.mark("end", block)

    def batch(i):
        step._forward(payload)
        trace.mark("end", payload)

    off = (_kernel_nodes(stream), _kernel_nodes(batch))
    trace.enable()
    on = (_kernel_nodes(stream), _kernel_nodes(batch))
    valid = torch.ones((8, rxr.max_frames), dtype=torch.bool, device=dev)
    hits = _kernel_nodes(lambda i: trace.count_hits(valid))
    assert set(hits) == {"kernel"} and 1 <= hits["kernel"] <= 3
    for a, b, more in zip(off, on, (6 + hits["kernel"], 6)):
        assert b == dict(a, kernel=a["kernel"] + more), (a, b)


def test_traced_replay_equals_untraced_and_records(dev, recorder_off,
                                                  tmp_path):
    """Four buffers of 8 channels fed traced and untraced from the same
    state: equal outputs and state; the traced graph is its own key; each
    traced call is an entry span holding copy_in, launch and clone (the
    first also capture, labelled with the key); the work counts replay
    exactly (K x C, max_frames x C and 1926 hop windows x C a buffer) and
    the hit count equals
    the valid slots; the profiler's device trace shows each replay's six
    marks in order, split by stage_split with none dropped."""
    from torch.profiler import ProfilerActivity, profile
    trace = recorder_off
    spec = make_frame_spec(CFG, torch.complex64, device=dev)
    blocks = _stream_blocks(8, S=4).to(dev)
    plain = streaming.StreamingReceiver(spec, channels=8)
    want = [plain.feed(b) for b in blocks]
    rxr = streaming.StreamingReceiver(spec, channels=8)
    trace.enable()
    got = [rxr.feed(blocks[0])]                # the capture
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got += [rxr.feed(b) for b in blocks[1:]]
        torch.cuda.synchronize()
    recorded = trace.drain()
    trace.disable()
    for w, g in zip(want, got):
        _same(w, g)
    _same(plain.state, rxr.state)
    (static, _), = rxr.graphs.graphs
    assert static[0] == "traced"
    spans = recorded["spans"]
    entries = [i for i, s in enumerate(spans) if s["name"] == "entry"]
    assert [spans[i]["call"] for i in entries] == [0, 1, 2, 3]
    for n, i in enumerate(entries):
        kids = [s["name"] for s in spans if s["parent"] == i]
        assert kids == (["capture"] if n == 0 else []) + [
            "copy_in", "launch", "clone"]
    cap = next(s for s in spans if s["name"] == "capture")
    assert cap["label"].startswith("StreamingReceiver.feed [(8, 240640)]")
    K = rxr.max_frames + CFG.t2_gate_slack
    assert recorded["counts"] == {
        "regions_scored": 4 * 8 * K,
        "slots_demodulated": 4 * 8 * rxr.max_frames, "mf_chunks": 0,
        "cfo_windows": 4 * 8 * rxr.max_frames * CFG.num_pilot_subc,
        "cfo_bins": 4 * 8 * rxr.max_frames * 328,
        "hop_windows": 4 * 8 * 1926, "fourstep_rows": 0,
        "hits_accepted": int(sum(int(o.valid.sum()) for o in got))}
    assert recorded["counts"]["hits_accepted"] > 0
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    split = trace.stage_split(
        json.loads((tmp_path / "t.json").read_text())["traceEvents"])
    assert split["replays"] == 3 and split["dropped"] == 0, split
    assert set(split["busy_us"]) == set(STAGE_SPANS)
    assert all(v > 0 for v in split["busy_us"].values())


def test_block_stager_spans(dev, recorder_off):
    """Each staged block is a slot_wait, a fill and an h2d span, in order;
    the staged blocks equal the host blocks."""
    from c_ofdm_tpu_torch.apps.rxstream import BlockStager
    trace = recorder_off
    stage = BlockStager(dev)
    rng = np.random.default_rng(3)
    host = [rng.integers(-2000, 2000, (4096, 2), dtype=np.int16)
            for _ in range(3)]
    trace.enable()
    got = [stage(h).cpu().numpy() for h in host]
    spans = trace.drain()["spans"]
    assert [s["name"] for s in spans] == ["slot_wait", "fill", "h2d"] * 3
    assert all(s["parent"] is None and s["start_ns"] <= s["end_ns"]
               for s in spans)
    for g, h in zip(got, host):
        np.testing.assert_array_equal(g, h)


if __name__ == "__main__":
    # python tests/test_torch_cuda.py profile-broadcast DIR: the profile of
    # test_broadcast_receive_replays_one_chunk_a_row, as one JSON line
    if sys.argv[1:2] == ["profile-broadcast"]:
        print(json.dumps(_profile_broadcast_receive(
            torch.device("cuda", 0), Path(sys.argv[2]) / "t.json")))
    # python tests/test_torch_cuda.py profile-broadcast-stages DIR: the
    # profile of test_broadcast_receive_recovers_in_one_search
    if sys.argv[1:2] == ["profile-broadcast-stages"]:
        print(json.dumps(_profile_broadcast_stages(
            torch.device("cuda", 0), Path(sys.argv[2]) / "t.json")))
