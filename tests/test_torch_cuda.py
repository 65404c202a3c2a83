"""The port on the card: K1, K2, K3 and K4 against their plain versions,
the flagship step (matmul and pallas backends), one gated streaming buffer,
and the MAC codec and channel simulator against their CPU runs.

Every test here needs CUDA and skips without it.  This file imports no jax,
so it also runs where jax is not installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
from c_ofdm_tpu_torch.channel.sim import ChannelParams, apply_channel
from c_ofdm_tpu_torch.mac import mac as tmac
from c_ofdm_tpu_torch.models import streaming
from c_ofdm_tpu_torch.models.modem import FlagshipStep
from c_ofdm_tpu_torch.ops import dft, extract, fft

pytestmark = pytest.mark.cuda

CFG = ModemConfig()
WIN = CFG.preamble_len + CFG.message_len


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
    spec = make_frame_spec(CFG, torch.complex64, device=dev)
    payload = np.random.default_rng(1).integers(
        0, 256, (8, CFG.frame_bytes), dtype=np.uint8)
    before = extract.extract_windows.launches
    res, s = FlagshipStep(spec)(torch.from_numpy(payload).to(dev))
    torch.cuda.synchronize()
    assert extract.extract_windows.launches == before + 1
    assert bool(s.found.all()) and not bool(s.frame_start.any())
    np.testing.assert_array_equal(res.mac_bytes.cpu().numpy(), payload)


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


def test_empty_launch_runs_and_rejects_bad_grids(dev):
    for grid in ((1, 1), (49, 4), (41, 23)):
        extract.empty_launch(grid, 256, dev)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError):
        extract.empty_launch((1, 1), 2048, dev)


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


def _dft64(x, sign, scale):
    x64 = x.to(torch.complex128)
    y = torch.fft.fft(x64) if sign < 0 else torch.fft.ifft(x64) * x.shape[-1]
    return y * scale


@pytest.mark.parametrize("case", ["rx_view", "tx", "ragged", "n500_scaled"])
def test_dft_kernel_matches_plain_version(dev, case):
    """K4 at the flagship step's shapes (the RX input is the strided
    CP-stripped view, row stride 640), a ragged row count and a size that is
    no power of two (the dense route; the others take the radix route),
    against dft_ref and the float64 DFT: within 1e-5·max|Y| and within 4x
    the plain version's own error."""
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
    before = (dft.dft.launches, dft.dft.radix_launches,
              dft.dft.dense_launches)
    got = dft.dft(x, sign, scale)
    plain = dft.dft_ref(x, sign, scale)
    torch.cuda.synchronize()
    radix = case != "n500_scaled"
    assert (dft.dft.launches, dft.dft.radix_launches,
            dft.dft.dense_launches) == (before[0] + 1, before[1] + radix,
                                        before[2] + (not radix))
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


def test_dft_kernel_rejects_what_it_does_not_take(dev):
    with pytest.raises(TypeError):
        dft.dft(torch.zeros((4, 64), dtype=torch.complex128, device=dev))
    with pytest.raises(TypeError):
        dft.dft(torch.zeros((4, 64), dtype=torch.float32, device=dev))


def test_pallas_flagship_step_on_card(dev):
    """B = 8 under fft_backend="pallas": K4 launched twice (TX and RX, both
    on the radix route), K1 once, payloads exact and equal to the CPU
    run."""
    payload = np.random.default_rng(5).integers(
        0, 256, (8, CFG.frame_bytes), dtype=np.uint8)
    spec = make_frame_spec(CFG, torch.complex64, device=dev,
                           fft_backend="pallas")
    before = (dft.dft.launches, extract.extract_windows.launches,
              dft.dft.radix_launches, dft.dft.dense_launches)
    res, s = FlagshipStep(spec)(torch.from_numpy(payload).to(dev))
    torch.cuda.synchronize()
    assert (dft.dft.launches, extract.extract_windows.launches) == (
        before[0] + 2, before[1] + 1)
    assert (dft.dft.radix_launches, dft.dft.dense_launches) == (
        before[2] + 2, before[3])
    assert bool(s.found.all()) and not bool(s.frame_start.any())
    np.testing.assert_array_equal(res.mac_bytes.cpu().numpy(), payload)
    cpu = FlagshipStep(make_frame_spec(CFG, torch.complex64, device="cpu",
                                       fft_backend="pallas"))
    res_c, _ = cpu(torch.from_numpy(payload))
    assert torch.equal(res.mac_bytes.cpu(), res_c.mac_bytes)


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


def test_world_of_one_sharded_receiver_on_card_equals_cpu(dev):
    """The sharded receiver in a world of one (no process group) on the
    card: K3 twice per call (regions, then frames), K1 and K2 never, and
    every field equal to the CPU run; frames straddling nothing, at both
    ends of the capture, decode."""
    from c_ofdm_tpu_torch.models import tx
    from c_ofdm_tpu_torch.parallel import ingest, mesh, sharded
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
        m = mesh.make_modem_mesh(1, 1, device=where)
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


def _same(a, b):
    """Two outputs equal field for field (NaN where both are NaN)."""
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("backend", ["matmul", "pallas"])
def test_flagship_graph_equals_eager(dev, backend):
    """FlagshipStep replays one graph per call: every output field equal to
    the eager step on the same inputs, K1 (and under pallas K4 twice) per
    replay as per eager call, the outputs of call i unchanged by call i+1,
    and a new batch size captures a second graph."""
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
    step(payloads[1][:8])
    assert len(step.graphs.graphs) == 2
    step.to(dev)
    assert not step.graphs.graphs


@pytest.mark.parametrize("C", [0, 8])
def test_streaming_graph_equals_eager(dev, C):
    """StreamingReceiver.feed replays one graph per buffer, the state
    carried in the module's buffers: every output and state field equal to
    eager process_buffer over the same buffers, the outputs of buffer i
    unchanged after buffer i+1, K2 (C = 0) or K3 (C = 8) twice per replay."""
    from c_ofdm_tpu_torch.utils import graphs
    spec = make_frame_spec(CFG, torch.complex64, device=dev)
    blocks = _stream_blocks(C).to(dev)
    state = streaming.init_state(spec, channels=C)
    want = []
    for b in blocks:
        state, out = streaming.process_buffer(spec, state, b)
        want.append(out)
    rxr = streaming.StreamingReceiver(spec, channels=C)
    fn = extract.extract_windows_multi if C else extract.extract_windows_single
    got, per = [], []
    for b in blocks:
        n0 = fn.launches
        got.append(rxr.feed(b))
        per.append(fn.launches - n0)
    torch.cuda.synchronize()
    assert per == [2] * len(blocks) and len(rxr.graphs.graphs) == 1
    for w, g in zip(want, got):
        _same(w, g)
    _same(state, rxr.state)
    assert int(sum(o.num_found.sum() for o in got)) > 0
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
