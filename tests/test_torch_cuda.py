"""The port on the card: K1, K2, K3 and K4 against their plain versions,
the flagship step (matmul and pallas backends) and one gated streaming
buffer.

Every test here needs CUDA and skips without it.  This file imports no jax,
so it also runs where jax is not installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
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
        extract.extract_windows(caps, st.to(torch.int64), 8)
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
        single(ring, st.to(torch.int64), 8)
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
