"""CPU parity of the PyTorch port's ops against the JAX package.

The same numpy-seeded inputs go through the JAX function and its
counterpart in ``c_ofdm_tpu_torch``.  Tolerances: exact for integers, bytes,
positions and the numpy constants; complex128 arithmetic within atol 1e-9
(the two frameworks sum and multiply in different orders, which moves
float64 results by ~1e-13 at these magnitudes).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_ofdm_tpu import config as jconfig
from c_ofdm_tpu.models import frame as jframe
from c_ofdm_tpu.ops import bits as jbits
from c_ofdm_tpu.ops import cfo as jcfo
from c_ofdm_tpu.ops import chanest as jchanest
from c_ofdm_tpu.ops import fft as jfft
from c_ofdm_tpu.ops import modulation as jmod
from c_ofdm_tpu.ops import sync as jsync
from c_ofdm_tpu.oracle import reference as joracle
from c_ofdm_tpu.utils import mt19937 as jmt

from c_ofdm_tpu_torch import config as tconfig
from c_ofdm_tpu_torch.models import frame as tframe
from c_ofdm_tpu_torch.ops import bits as tbits
from c_ofdm_tpu_torch.ops import cfo as tcfo
from c_ofdm_tpu_torch.ops import chanest as tchanest
from c_ofdm_tpu_torch.ops import fft as tfft
from c_ofdm_tpu_torch.ops import modulation as tmod
from c_ofdm_tpu_torch.ops import sync as tsync
from c_ofdm_tpu_torch.oracle import reference as toracle
from c_ofdm_tpu_torch.utils import mt19937 as tmt

torch.set_num_threads(1)

ATOL128 = 1e-9
CPU = torch.device("cpu")

# stock, a QAM64 geometry with raised thresholds (peak_refine auto-on), a
# wider FFT, and a two-symbol-preamble BPSK config
CONFIG_KWARGS = [
    {},
    dict(mod_type=6, pr_level=0.6, t2_sin_level=0.7, cfo_outlier_bins=0),
    dict(fft_size=1024, num_data_subc=512, num_pilot_subc=16, cp_size=256,
         num_symb=4, mod_type=8),
    dict(mod_type=1, num_pr_symb=2, num_symb=4, sync_peak_refine=True),
]

DERIVED = ("peak_refine", "segment_step", "segment_size", "ofdm_len",
           "preamble_len", "message_len", "frame_len", "frame_bytes",
           "preamble_bytes", "ring_len", "sync_window", "num_t2_blocks_ring",
           "gated_search_lags")


def _specs(dtype_name, **kw):
    """(JAX spec, port spec) of the same config, matmul backend."""
    jdt = {"c64": jnp.complex64, "c128": jnp.complex128}[dtype_name]
    tdt = {"c64": torch.complex64, "c128": torch.complex128}[dtype_name]
    js = jframe.make_frame_spec(jconfig.ModemConfig(**kw), dtype=jdt,
                                fft_backend="matmul")
    ts = tframe.make_frame_spec(tconfig.ModemConfig(**kw), tdt, device=CPU)
    return js, ts


def _t(a):
    return torch.from_numpy(np.array(a))    # a writable copy


def _n(x):
    return np.asarray(x)


def _crandn(rng, shape, dtype=np.complex128):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


# ---------------------------------------------------------------- config


@pytest.mark.parametrize("kw", CONFIG_KWARGS)
def test_config_fields_and_geometry_match(kw):
    jc, tc = jconfig.ModemConfig(**kw), tconfig.ModemConfig(**kw)
    assert ([f.name for f in dataclasses.fields(jc)]
            == [f.name for f in dataclasses.fields(tc)])
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    for name in DERIVED:
        assert getattr(jc, name) == getattr(tc, name), name
    assert jc.to_dict() == tc.to_dict()


@pytest.mark.parametrize("bad", [dict(num_data_subc=255), dict(mod_type=3),
                                 dict(num_pilot_subc=7),
                                 dict(t2_gate_level=0.9)])
def test_config_validation_matches(bad):
    with pytest.raises(ValueError):
        jconfig.ModemConfig(**bad)
    with pytest.raises(ValueError):
        tconfig.ModemConfig(**bad)


def test_config_file_parsing_matches(tmp_path):
    text = ("fft_size = 1024\nnum_data_subc = 512 # comment\n"
            "num_pilot_subc = 16\ncp_size = 256\nmodType = 6\n"
            "pr_level = 600\nT2_gate_level = -1\nsync_peak_refine = -1\n"
            "unknown_key = 3\n")
    path = tmp_path / "config.txt"
    path.write_text(text)
    assert jconfig.parse_config_text(text) == tconfig.parse_config_text(text)
    assert (dataclasses.asdict(jconfig.load_config(str(path)))
            == dataclasses.asdict(tconfig.load_config(str(path))))


# ------------------------------------------------- mt19937 and the oracle


@pytest.mark.parametrize("seed", [0, 42, 5489, 2**32 - 1])
def test_mt19937_matches(seed):
    np.testing.assert_array_equal(jmt.mt19937_uint32(seed, 700),
                                  tmt.mt19937_uint32(seed, 700))
    np.testing.assert_array_equal(jmt.uniform_bytes(seed, 300),
                                  tmt.uniform_bytes(seed, 300))


@pytest.mark.parametrize("kw", CONFIG_KWARGS)
def test_oracle_constants_match(kw):
    jc, tc = jconfig.ModemConfig(**kw), tconfig.ModemConfig(**kw)
    for a, b in zip(joracle.subcarrier_maps(jc), toracle.subcarrier_maps(tc)):
        np.testing.assert_array_equal(a, b)
    for name in ("preamble_bytes", "preamble_points", "preamble_time",
                 "matched_filter", "t2sin_burst", "t2_detect_mask"):
        a, b = getattr(joracle, name)(jc), getattr(toracle, name)(tc)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for mod_type in (1, 2, 4, 6, 8):
        np.testing.assert_array_equal(joracle.constellation(mod_type),
                                      toracle.constellation(mod_type))
    data = np.random.default_rng(1).integers(0, 256, 48, dtype=np.uint8)
    np.testing.assert_array_equal(joracle.modulate(data, jc.mod_type),
                                  toracle.modulate(data, tc.mod_type))
    sym = np.random.default_rng(2).integers(0, 256, jc.num_data_subc // 2,
                                            dtype=np.uint8)
    pts = joracle.modulate(sym, 4)
    np.testing.assert_array_equal(joracle.ofdm_modulate(jc, pts, 1),
                                  toracle.ofdm_modulate(tc, pts, 1))


# ------------------------------------------------------------ frame spec


@pytest.mark.parametrize("dtype_name", ["c64", "c128"])
@pytest.mark.parametrize("kw", CONFIG_KWARGS[:2])
def test_frame_spec_from_jax_arrays_matches_own(kw, dtype_name):
    """The "weights carried across": a spec built from a JAX FrameSpec's
    numpy fields equals the port's own make_frame_spec exactly, in every
    numpy constant and every derived device tensor."""
    js, own = _specs(dtype_name, **kw)
    arrays = {k: getattr(js, k) for k in tframe.ARRAY_FIELDS}
    carried = tframe.frame_spec_from_arrays(
        dataclasses.asdict(js.cfg), arrays, device=CPU, dtype=own.dtype)
    assert dataclasses.asdict(carried.cfg) == dataclasses.asdict(own.cfg)
    for k in tframe.ARRAY_FIELDS:
        a, b = getattr(carried, k), getattr(own, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert carried.tensors.keys() == own.tensors.keys()
    for k, t in own.tensors.items():
        assert t.dtype == carried.tensors[k].dtype, k
        assert torch.equal(carried.tensors[k], t), k
    assert carried.cfo_segments == jcfo._cfo_window_segments(js)


# ---------------------------------------------------- bits and modulation


def _check_bits(data, bps):
    sj = _n(jbits.bytes_to_symbols(jnp.asarray(data), bps))
    st = tbits.bytes_to_symbols(_t(data), bps)
    assert st.dtype == torch.int32
    np.testing.assert_array_equal(sj, st.numpy())
    if sj.shape[-1] * bps % 8 == 0:
        np.testing.assert_array_equal(
            _n(jbits.symbols_to_bytes(jnp.asarray(sj), bps)),
            tbits.symbols_to_bytes(st, bps).numpy())
        np.testing.assert_array_equal(tbits.symbols_to_bytes(st, bps).numpy(),
                                      data)
    bits = _n(jbits.unpack_bits(jnp.asarray(data)))
    np.testing.assert_array_equal(bits, tbits.unpack_bits(_t(data)).numpy())
    np.testing.assert_array_equal(_n(jbits.pack_bits(jnp.asarray(bits))),
                                  tbits.pack_bits(_t(bits)).numpy())


@pytest.mark.parametrize("bps", [3, 5, 7])
def test_bits_generic_widths_match(bps):
    """Symbol widths outside the fast paths (bit expansion + packing)."""
    data = np.random.default_rng(bps).integers(0, 256, (2, 8 * bps),
                                               dtype=np.uint8)
    _check_bits(data, bps)
    _check_bits(data[:, :-1], bps)          # leftover bits are dropped


@pytest.mark.parametrize("mod_type", [1, 2, 4, 6, 8])
def test_bits_and_modulation_match(mod_type):
    rng = np.random.default_rng(mod_type)
    _check_bits(rng.integers(0, 256, (3, 97), dtype=np.uint8), mod_type)
    data = rng.integers(0, 256, (3, 96), dtype=np.uint8)
    _check_bits(data, mod_type)
    np.testing.assert_array_equal(jmod.constellation(mod_type),
                                  tmod.constellation(mod_type))
    for jdt, tdt in ((jnp.complex64, torch.complex64),
                     (jnp.complex128, torch.complex128)):
        pj = _n(jmod.map_bytes(jnp.asarray(data), mod_type, jdt))
        pt = tmod.map_bytes(_t(data), mod_type, tdt)
        assert pt.dtype == tdt
        np.testing.assert_array_equal(pj, pt.numpy())
        # the clean points decode exactly
        np.testing.assert_array_equal(
            tmod.demap_bytes(pt, mod_type).numpy(), data)
    # noisy float64 points around the grid, plus far outliers that clamp
    pts = pj + 0.2 * _crandn(rng, pj.shape)
    pts[0, :4] *= 10
    np.testing.assert_array_equal(
        _n(jmod.hard_demap(jnp.asarray(pts), mod_type)),
        tmod.hard_demap(_t(pts), mod_type).numpy())
    np.testing.assert_array_equal(
        _n(jmod.demap_bytes(jnp.asarray(pts), mod_type)),
        tmod.demap_bytes(_t(pts), mod_type).numpy())


# ------------------------------------------------------------------- fft


def test_complex_matmul_and_partial_dft_match():
    rng = np.random.default_rng(2)
    x = _crandn(rng, (4, 3, 256))
    w = _crandn(rng, (256, 40))
    np.testing.assert_allclose(
        _n(jfft.complex_matmul(jnp.asarray(x), w)),
        tfft.complex_matmul(_t(x), tfft.basis_pair(w, CPU, torch.float64)).numpy(),
        rtol=0, atol=ATOL128)
    rows = rng.choice(256, 22, replace=False)
    np.testing.assert_allclose(
        _n(jfft.partial_dft(jnp.asarray(x), rows)),
        tfft.partial_dft(_t(x), rows).numpy(), rtol=0, atol=ATOL128)
    np.testing.assert_allclose(
        _n(jfft.fft_fwd(jnp.asarray(x), "matmul")),
        tfft.fft_fwd(_t(x), "matmul").numpy(), rtol=0, atol=ATOL128)
    np.testing.assert_allclose(
        _n(jfft.ifft_unnorm(jnp.asarray(x), "matmul")),
        tfft.ifft_unnorm(_t(x), "matmul").numpy(), rtol=0, atol=ATOL128)
    np.testing.assert_allclose(tfft.fft_fwd(_t(x), "matmul").numpy(),
                               np.fft.fft(x), rtol=0, atol=ATOL128)


# --------------------------------------------------------------- chanest


@pytest.mark.parametrize("kw", CONFIG_KWARGS)
def test_chanest_matches(kw):
    js, ts = _specs("c128", **kw)
    cfg = js.cfg
    rng = np.random.default_rng(3)
    B = 3
    payload = rng.integers(0, 256, (B, cfg.frame_bytes), dtype=np.uint8)
    points = _n(jmod.map_bytes(jnp.asarray(payload), cfg.mod_type,
                               jnp.complex128))
    tj = _n(jchanest.ofdm_modulate(js, jnp.asarray(points), cfg.num_symb))
    tt = tchanest.ofdm_modulate(ts, _t(points), cfg.num_symb).numpy()
    np.testing.assert_allclose(tj, tt, rtol=0, atol=ATOL128)

    syms = tj[..., cfg.cp_size:] * np.exp(0.3j) + 0.01 * _crandn(
        rng, tj[..., cfg.cp_size:].shape)
    pj, dj = jchanest.bins_transform(js, jnp.asarray(syms))
    pt, dt = tchanest.bins_transform(ts, _t(syms))
    np.testing.assert_allclose(_n(pj), pt.numpy(), rtol=0, atol=ATOL128)
    np.testing.assert_allclose(_n(dj), dt.numpy(), rtol=0, atol=ATOL128)
    np.testing.assert_allclose(
        _n(jchanest.pilot_equalize(js, pj, dj)),
        tchanest.pilot_equalize(ts, pt, dt).numpy(), rtol=0, atol=ATOL128)

    # preamble with a timing-offset phase slope and noise
    pre = np.tile(js.preamble_time, (B, 1))
    pre = np.roll(pre, 1, axis=-1) * np.exp(0.7j) + 0.02 * _crandn(rng, pre.shape)
    cj = _n(jchanest.chan_est_lq(js, jnp.asarray(pre)))
    ct = tchanest.chan_est_lq(ts, _t(pre)).numpy()
    np.testing.assert_allclose(cj, ct, rtol=0, atol=ATOL128)
    pre_pts = _n(jchanest.preamble_demod(js, jnp.asarray(pre)))
    np.testing.assert_allclose(
        ct, tchanest.chan_est_lq(ts, pre_points=_t(pre_pts)).numpy(),
        rtol=0, atol=ATOL128)
    np.testing.assert_allclose(
        _n(jchanest.chan_est_full(js, jnp.asarray(pre))),
        tchanest.chan_est_full(ts, _t(pre)).numpy(), rtol=0, atol=ATOL128)
    np.testing.assert_allclose(
        _n(jchanest.equalize(js, jnp.asarray(points), jnp.asarray(cj))),
        tchanest.equalize(ts, _t(points), _t(cj)).numpy(),
        rtol=0, atol=ATOL128)
    phase = np.cumsum(rng.uniform(-2.5, 2.5, (B, 128)), axis=-1)
    np.testing.assert_allclose(
        _n(jchanest.unwrap_fast(jnp.asarray(np.angle(np.exp(1j * phase))))),
        tchanest.unwrap_fast(_t(np.angle(np.exp(1j * phase)))).numpy(),
        rtol=0, atol=ATOL128)


# ------------------------------------------------------------------ sync


def _frames_np(js, payload):
    from c_ofdm_tpu.models import tx as jtx
    return _n(jtx.transmit(js, jnp.asarray(payload)))


def _noisy_captures(js, rng, B, n):
    """B captures [n]: frames at random offsets, amplitude 40, CFO 1e-4,
    AWGN at 30 dB SNR, and one all-zero row last."""
    cfg = js.cfg
    payload = rng.integers(0, 256, (B, cfg.frame_bytes), dtype=np.uint8)
    frames = _frames_np(js, payload).astype(np.complex128)
    offs = rng.integers(0, n - cfg.frame_len + 1, B)
    caps = np.zeros((B + 1, n), np.complex128)
    for b in range(B):
        caps[b, offs[b]:offs[b] + cfg.frame_len] = frames[b] * 40.0
    caps[:B] *= np.exp(2j * np.pi * 1e-4 * np.arange(n))
    std = np.sqrt(float((np.abs(frames) ** 2).mean()) * 1600 * 1e-3 / 2)
    caps[:B] += std * _crandn(rng, (B, n))
    return caps, offs


@pytest.mark.parametrize("kw", CONFIG_KWARGS[:2])
def test_sync_matches(kw):
    js, ts = _specs("c128", **kw)
    cfg = js.cfg
    rng = np.random.default_rng(4)
    caps, offs = _noisy_captures(js, rng, 4, cfg.frame_len + 700)
    jc, tc = jnp.asarray(caps), _t(caps)

    np.testing.assert_allclose(_n(jsync.t2_ratio_track(js, jc)),
                               tsync.t2_ratio_track(ts, tc).numpy(),
                               rtol=0, atol=ATOL128)
    t2j, fj = jax.vmap(lambda c: jsync.find_t2sin(js, c))(jc)
    t2t, ft = tsync.find_t2sin(ts, tc)
    np.testing.assert_array_equal(_n(t2j), t2t.numpy())
    np.testing.assert_array_equal(_n(fj), ft.numpy())
    assert ft.numpy().tolist() == [True] * 4 + [False]

    start = torch.clamp(t2t, min=0)
    region = tsync.window_rows(tc, start, cfg.sync_window + cfg.pr_sin_len)
    np.testing.assert_allclose(
        _n(jsync.matched_filter_scores(js, jnp.asarray(region.numpy()))),
        tsync.matched_filter_scores(ts, region).numpy(), rtol=0, atol=ATOL128)
    trj = jax.vmap(lambda c, s: jsync.preamble_corr_track(js, c, s))(
        jc, jnp.asarray(start.numpy()))
    np.testing.assert_allclose(_n(trj),
                               tsync.preamble_corr_track(ts, tc, start).numpy(),
                               rtol=0, atol=ATOL128)
    for jfind, tfind in ((jsync.find_preamble, tsync.find_preamble),
                         (jsync.find_preamble_peak, tsync.find_preamble_peak)):
        pj, okj = jax.vmap(lambda c, s: jfind(js, c, s))(
            jc, jnp.asarray(start.numpy()))
        pt, okt = tfind(ts, tc, start)
        np.testing.assert_array_equal(_n(pj), pt.numpy())
        np.testing.assert_array_equal(_n(okj), okt.numpy())


@pytest.mark.parametrize("dtype_name", ["c64", "c128"])
@pytest.mark.parametrize("kw", [{}, dict(t2sin_size=512)])
def test_hop_track_matches(kw, dtype_name):
    """The 50%-overlap detector track of the streaming receiver, on frames
    at every alignment class to the half blocks (plus all-zero halves):
    within 1e-9 in complex128, 1e-5 in complex64."""
    js, ts = _specs(dtype_name, **kw)
    rng = np.random.default_rng(14)
    caps, _ = _noisy_captures(js, rng, 3, 3 * js.cfg.frame_len)
    caps[1, :js.cfg.t2sin_size] = 0.0
    caps = caps.astype({"c64": np.complex64, "c128": np.complex128}[dtype_name])
    want = _n(jsync.t2_ratio_track_hop(js, jnp.asarray(caps)))
    got = tsync.t2_ratio_track_hop(ts, _t(caps)).numpy()
    assert got.shape == want.shape == (4, 3 * js.cfg.frame_len
                                       // (js.cfg.t2sin_size // 2) - 1)
    np.testing.assert_allclose(want, got, rtol=0,
                               atol=ATOL128 if dtype_name == "c128" else 1e-5)


@pytest.mark.parametrize("dtype_name", ["c64", "c128"])
@pytest.mark.parametrize("lead", [(), (3,), (0,)])
def test_hop_track_on_cpu_is_the_plain_version(lead, dtype_name):
    """On CPU tensors t2_ratio_track_hop is t2_ratio_track_hop_ref bit for
    bit (a single ring, rows, zero rows; a length that is not a multiple of
    hop), launches nothing and counts rows x windows, as the kernel
    branch does."""
    from c_ofdm_tpu_torch.io import trace
    _, ts = _specs(dtype_name)
    rng = np.random.default_rng(16)
    n = 3 * ts.cfg.frame_len + 37
    caps = _t(_crandn(rng, (*lead, n)).astype(
        {"c64": np.complex64, "c128": np.complex128}[dtype_name]))
    before = tsync.t2_ratio_track_hop.launches
    trace.enable()
    try:
        got = tsync.t2_ratio_track_hop(ts, caps)
        counts = trace.drain()["counts"]
    finally:
        trace.disable()
    want = tsync.t2_ratio_track_hop_ref(ts, caps)
    assert got.shape == (*lead, n // (ts.cfg.t2sin_size // 2) - 1)
    assert torch.equal(got, want)
    assert tsync.t2_ratio_track_hop.launches == before
    assert counts["hop_windows"] == math.prod(lead) * got.shape[-1]


@pytest.mark.parametrize("n", [896, 3000, 30080])
def test_matched_filter_branches_match(n):
    """All three branches of matched_filter_scores in complex128: the
    Toeplitz product (n <= 2048), one FFT pair (next_pow2(n + L) <= 8192)
    and 4096-point overlap-save beyond; torch.fft against jnp.fft."""
    js, ts = _specs("c128")
    rng = np.random.default_rng(15)
    caps, _ = _noisy_captures(js, rng, 2, max(n, js.cfg.frame_len))
    x = caps[:, :n]
    np.testing.assert_allclose(
        _n(jsync.matched_filter_scores(js, jnp.asarray(x))),
        tsync.matched_filter_scores(ts, _t(x)).numpy(), rtol=0, atol=ATOL128)


@pytest.mark.parametrize("L,C,sizes", [(128, 4096, (4096, 8192)),
                                        (1024, 4096, (4096, 8192)),
                                        (2048, 8192, (8192,)),
                                        (4096, 16384, (8192, 16384))])
def test_overlap_save_chunk_from_the_filter_length(L, C, sizes):
    """The overlap-save chunk is 4096 up to a 1024-tap filter and
    next_pow2(4L) beyond; the spec holds one spectrum for each FFT size
    the matched filter takes, one entry where the single-FFT size and the
    chunk meet (8192 at L = 2048)."""
    assert tsync.overlap_save_len(L) == C
    assert tsync.mf_spectrum_sizes(L) == sizes
    assert C - L + 1 > 3 * L
    cfg = tconfig.ModemConfig(pr_sin_len=L, fft_size=max(512, 4 * L))
    ts = tframe.make_frame_spec(cfg, torch.complex128, device=CPU,
                                fft_backend="xla")
    assert {k for k in ts.tensors if k.startswith("mf_fft")} == {
        tsync.mf_spectrum_key(m) for m in sizes}


@pytest.mark.parametrize("L", [1024, 2048])
def test_matched_filter_long_filters_match_jax(L):
    """The overlap-save branch with 1024 and 2048 taps on 20000 lags, in
    complex128: the port's chunk (4096 and 8192 points: 5 and 3 chunks a
    row) against the JAX package's 4096-point chunks (6 and 10), torch.fft
    against jnp.fft."""
    kw = dict(pr_sin_len=L, fft_size=4 * L)
    js = jframe.make_frame_spec(jconfig.ModemConfig(**kw),
                                dtype=jnp.complex128, fft_backend="xla")
    ts = tframe.make_frame_spec(tconfig.ModemConfig(**kw), torch.complex128,
                                device=CPU, fft_backend="xla")
    rng = np.random.default_rng(L)
    x = 4 * _crandn(rng, (2, 20000))
    x[:, 9000:9000 + L] += 100 * np.conj(js.matched_filter)
    want = _n(jsync.matched_filter_scores(js, jnp.asarray(x)))
    np.testing.assert_allclose(
        want, tsync.matched_filter_scores(ts, _t(x)).numpy(), rtol=0,
        atol=ATOL128)
    assert want[:, 9000].min() > 0.2


def test_sliding_max_and_local_suppression_match():
    rng = np.random.default_rng(16)
    track = rng.uniform(0, 1, (3, 500))
    track[1, 100:140] = 0.0
    for radius in (0, 1, 2, 5, 64, 600):
        np.testing.assert_array_equal(
            _n(jsync.sliding_max(jnp.asarray(track), radius)),
            tsync.sliding_max(_t(track), radius).numpy())
        np.testing.assert_array_equal(
            _n(jsync.suppress_sidelobes_local(jnp.asarray(track), radius)),
            tsync.suppress_sidelobes_local(_t(track), radius).numpy())


def test_first_above_and_peak_refine_match():
    rng = np.random.default_rng(5)
    track = rng.uniform(0, 1, (6, 40))
    track[2] = 0.0                                   # no crossing
    track[3, 38:] = 0.99                             # crossing at the edge
    for level in (0.5, 0.9, 0.98):
        ij, fj = jsync.first_above(jnp.asarray(track), level)
        it, ft = tsync.first_above(_t(track), level)
        np.testing.assert_array_equal(_n(ij), it.numpy())
        np.testing.assert_array_equal(_n(fj), ft.numpy())
        for radius in (2, 5):
            pj, _ = jsync.first_above_peak(jnp.asarray(track), level, radius)
            pt, _ = tsync.first_above_peak(_t(track), level, radius)
            np.testing.assert_array_equal(_n(pj), pt.numpy())
    np.testing.assert_array_equal(
        _n(jsync.suppress_sidelobes(jnp.asarray(track))),
        tsync.suppress_sidelobes(_t(track)).numpy())
    for kw in CONFIG_KWARGS:
        assert (jsync.peak_radius(jconfig.ModemConfig(**kw))
                == tsync.peak_radius(tconfig.ModemConfig(**kw)))


# ------------------------------------------------------------------- cfo


@pytest.mark.parametrize("kw", CONFIG_KWARGS[:2])
def test_cfo_recovery_matches(kw):
    """recover_fused against JAX's, and against the port's own sequential
    pilot_freq_shift -> apply_freq_shift -> cp_freq_correct ->
    common_phase_correct chain (algebraically identical)."""
    js, ts = _specs("c128", **kw)
    cfg = js.cfg
    rng = np.random.default_rng(6)
    B = 4
    payload = rng.integers(0, 256, (B, cfg.frame_bytes), dtype=np.uint8)
    sig = _frames_np(js, payload)[:, cfg.t2sin_size:].astype(np.complex128)
    n = np.arange(sig.shape[-1])
    cfos = np.array([0.0, 3e-4, -2e-3, 1e-3])[:, None]
    sig = sig * np.exp(2j * np.pi * cfos * n + 1.1j) + 0.03 * _crandn(rng, sig.shape)
    jsig, tsig = jnp.asarray(sig), _t(sig)

    shj = _n(jcfo.pilot_freq_shift(js, jsig))
    sht = tcfo.pilot_freq_shift(ts, tsig)
    np.testing.assert_allclose(shj, sht.numpy(), rtol=0, atol=ATOL128)
    outj, sj = jcfo.recover_fused(js, jsig)
    outt, st = tcfo.recover_fused(ts, tsig)
    np.testing.assert_allclose(_n(outj), outt.numpy(), rtol=0, atol=ATOL128)
    np.testing.assert_allclose(_n(sj), st.numpy(), rtol=0, atol=ATOL128)

    seq_t = tcfo.common_phase_correct(ts, tcfo.cp_freq_correct(
        ts, tcfo.apply_freq_shift(tsig, sht)))
    np.testing.assert_allclose(outt.numpy(), seq_t.numpy(), rtol=0, atol=ATOL128)
    seq_j = jcfo.common_phase_correct(js, jcfo.cp_freq_correct(
        js, jcfo.apply_freq_shift(jsig, jnp.asarray(shj))))
    np.testing.assert_allclose(_n(seq_j), seq_t.numpy(), rtol=0, atol=ATOL128)
    ramp_args = (np.array([1e-3, -2e-4]), rng.uniform(-1e-3, 1e-3, (2, 9)),
                 rng.uniform(-3, 3, (2, 9)))
    np.testing.assert_allclose(
        _n(jcfo.phase_ramp(*map(jnp.asarray, ramp_args), 9, cfg.ofdm_len,
                           jnp.complex128)),
        tcfo.phase_ramp(*map(_t, ramp_args), 9, cfg.ofdm_len,
                        torch.complex128).numpy(), rtol=0, atol=ATOL128)


def test_cfo_outlier_rejection_matches():
    """A frame whose pilot windows are corrupted by strong off-bin tones:
    the median rejection must pick the same windows in both packages."""
    js, ts = _specs("c128")
    cfg = js.cfg
    rng = np.random.default_rng(7)
    payload = rng.integers(0, 256, (3, cfg.frame_bytes), dtype=np.uint8)
    sig = _frames_np(js, payload)[:, cfg.t2sin_size:].astype(np.complex128)
    n = np.arange(cfg.preamble_len)
    for b, f in enumerate((0.31, -0.27, 0.12)):
        sig[b, :cfg.preamble_len] += 3.0 * np.exp(2j * np.pi * f * n)
    np.testing.assert_allclose(_n(jcfo.pilot_freq_shift(js, jnp.asarray(sig))),
                               tcfo.pilot_freq_shift(ts, _t(sig)).numpy(),
                               rtol=0, atol=ATOL128)


# the coarse CFO's window geometries: the stock (PlutoSDR) config, LTE 5G
# broadcast's 0.37 kHz numerology (600 windows of 90 bins, FFT branch only:
# its 92160-point preamble is past the partial product's limit), and the
# stock config with hand-made borders of unequal widths (26-60 bins)
CFO_GEOMETRIES = {
    "pluto": {},
    "broadcast": dict(fft_size=82944, num_data_subc=48000, num_pilot_subc=600,
                      cp_size=9216, num_symb=2, pr_sin_len=4096, mod_type=6),
    "uneven": {},
}
UNEVEN_BORDERS = np.array([134, 160, 216, 250, 300, 320, 380, 420, 470, 503])
# (geometry, backend): xla takes the FFT branch, matmul the partial product
CFO_CASES = [("pluto", "xla"), ("pluto", "matmul"), ("broadcast", "xla"),
             ("uneven", "xla"), ("uneven", "matmul")]


def _cfo_specs(geometry, backend, dtype_name):
    """(JAX spec, port spec) of a CFO geometry under ``backend``."""
    jdt = {"c64": jnp.complex64, "c128": jnp.complex128}[dtype_name]
    tdt = {"c64": torch.complex64, "c128": torch.complex128}[dtype_name]
    kw = CFO_GEOMETRIES[geometry]
    js = jframe.make_frame_spec(jconfig.ModemConfig(**kw), dtype=jdt,
                                fft_backend=backend)
    if geometry == "uneven":
        js = dataclasses.replace(js, cfo_borders=UNEVEN_BORDERS)
    ts = tframe.frame_spec_from_arrays(
        dataclasses.asdict(js.cfg),
        {k: getattr(js, k) for k in tframe.ARRAY_FIELDS}, device=CPU,
        dtype=tdt, fft_backend=backend)
    return js, ts


def _planted_spectrum(ts, rng):
    """[5, preamble_len] complex128 in fftshifted order, with exact
    magnitudes (k, -k, ik or -ik for an integer k) planting ties: a flat
    zero row; small integer levels (ties in most windows); every window
    flat at 1 with equal peaks 5 at its first and last bin; equal peaks 7
    at its middle and last bin (both rows 9 outside the windows, so a bin
    searched outside its window wins); and integer levels 0-40."""
    size = ts.cfg.preamble_len
    unit = rng.choice(np.array([1, -1, 1j, -1j]), (5, size))
    spec = np.zeros((5, size), np.complex128)
    spec[1] = rng.integers(0, 3, size)
    spec[2] = spec[3] = 9.0
    for lo, hi in ts.cfo_segments:
        spec[2:4, lo:hi] = 1.0
        spec[2, [lo, hi - 1]] = 5.0
        spec[3, [(lo + hi) // 2, hi - 1]] = 7.0
    spec[4] = rng.integers(0, 41, size)
    return spec * unit


@pytest.mark.parametrize("inputs", ["noisy", "planted"])
@pytest.mark.parametrize("geometry,backend", CFO_CASES)
def test_pilot_freq_shift_one_search_equals_jax(geometry, backend, inputs,
                                                monkeypatch):
    """The coarse CFO's one gather and one argmax over every window give
    exactly the JAX package's per-window loop, on the FFT branch (xla) and
    the partial product (matmul), at the stock, broadcast and uneven window
    geometries, complex128 and complex64.  ``noisy``: preambles with CFO
    and noise, and a zero row (every window flat).  ``planted``: spectra
    with exact ties (``_planted_spectrum``) handed to both packages in place
    of their transforms, so each first-maximum rule meets the same ties."""
    for dtype_name in ("c128", "c64"):
        js, ts = _cfo_specs(geometry, backend, dtype_name)
        cfg = ts.cfg
        assert ("cfo_basis" in ts.tensors) == (backend == "matmul")
        rng = np.random.default_rng(21)
        cdt = np.complex128 if dtype_name == "c128" else np.complex64
        if inputs == "noisy":
            k = np.arange(cfg.preamble_len)
            sig = (np.tile(js.preamble_time, (4, 1))
                   * np.exp(2j * np.pi * np.array([[0.0], [3e-4], [-2e-3],
                                                   [0.0]]) * k)
                   + 0.05 * _crandn(rng, (4, cfg.preamble_len)))
            sig[3] = 0.0
        else:
            planted = _planted_spectrum(ts, rng).astype(cdt)
            cols = np.concatenate([np.arange(lo, hi)
                                   for lo, hi in ts.cfo_segments])
            unshifted = np.fft.ifftshift(planted, axes=-1)
            monkeypatch.setattr(jcfo.fftops, "fft_fwd",
                                lambda x: jnp.asarray(unshifted))
            monkeypatch.setattr(jcfo.fftops, "partial_dft",
                                lambda x, rows: jnp.asarray(planted[:, cols]))
            monkeypatch.setattr(tcfo.fftops, "fft_fwd",
                                lambda x: torch.from_numpy(unshifted))
            monkeypatch.setattr(
                tcfo.fftops, "complex_matmul",
                lambda x, w: torch.from_numpy(planted[:, cols].copy()))
            sig = np.zeros((5, cfg.preamble_len))
        sig = sig.astype(cdt)
        want = _n(jcfo.pilot_freq_shift(js, jnp.asarray(sig)))
        got = tcfo.pilot_freq_shift(ts, _t(sig)).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        monkeypatch.undo()


@pytest.mark.parametrize("backend,preamble_len,bins,partial", [
    ("matmul", 640, 328, True), ("pallas", 640, 328, True),
    ("matmul_bf16", 640, 349, True), ("pallas", 18432, 15552, False),
    ("matmul", 18432, 15552, False), ("pallas", 1644, 832, False),
    ("pallas", 36864, 16, False), ("matmul", 92160, 16, False),
    ("xla", 640, 328, False), ("ct", 640, 328, False),
    ("ct_bf16", 640, 328, False)])
def test_partial_spectrum_rule(backend, preamble_len, bins, partial):
    """The coarse CFO projects onto its inspected bins only while the
    product's 8·n·m FLOPs a row stay under ``FFT_SLOWDOWN`` times the FFT's
    5·n·log2(n): Pluto's 328 bins of 640 (and the tests' uneven 349) under
    matmul* and pallas; not DVB-T2 16K's 15552 of 18432, nor LTE 1536's 832
    of 1644; never past ``MAX_DEVICE_BASIS_N`` (36864, 92160) nor under xla
    or ct*.  The switch sits where the two costs meet: at 1024 points, 8·m
    against FFT_SLOWDOWN·50."""
    assert tcfo.uses_partial_spectrum(backend, preamble_len, bins) == partial
    edge = tcfo.FFT_SLOWDOWN * 5 * 10 / 8
    assert tcfo.uses_partial_spectrum(backend, 1024, math.ceil(edge) - 1) \
        == (backend not in ("xla", "ct", "ct_bf16"))
    assert not tcfo.uses_partial_spectrum(backend, 1024, math.ceil(edge))


@pytest.mark.parametrize("geometry,backend", CFO_CASES)
def test_cfo_window_index_holds_each_window(geometry, backend):
    """``cfo_win_idx`` [n_windows, w_max] holds each used window's bins in
    order, then repeats its first bin: as unshifted FFT bins under xla, as
    columns of the partial product under matmul.  The two benchmark
    geometries' windows are those measured: 8 of 41 bins over 134-503
    (window 4 skipped), 600 of 90 over 19035-73125 (window 300 skipped)."""
    _, ts = _cfo_specs(geometry, backend, "c64")
    size = ts.cfg.preamble_len
    segs = ts.cfo_segments
    idx = ts.tensors["cfo_win_idx"]
    widths = [hi - lo for lo, hi in segs]
    assert idx.dtype == torch.int64 and idx.device == CPU
    assert tuple(idx.shape) == (len(segs), max(widths))
    idx = idx.numpy()
    if backend == "xla":
        idx = (idx + size // 2) % size          # back to fftshifted bins
    off = 0
    for row, (lo, hi) in zip(idx, segs):
        first = lo if backend == "xla" else off
        np.testing.assert_array_equal(row[:hi - lo],
                                      np.arange(first, first + hi - lo))
        assert (row[hi - lo:] == first).all()
        off += hi - lo
    skipped = np.flatnonzero(~ts.cfo_window_mask)
    if geometry == "pluto":
        assert (len(segs), set(widths), segs[0][0], segs[-1][1],
                list(skipped)) == (8, {41}, 134, 503, [4])
    elif geometry == "broadcast":
        assert (len(segs), set(widths), segs[0][0], segs[-1][1],
                list(skipped)) == (600, {90}, 19035, 73125, [300])
    else:
        assert len(set(widths)) > 1 and max(widths) == 60
