"""K1, K2, K3 (window extraction): the port's plain versions against the JAX
package's Pallas kernels, run in interpret mode on the CPU as
``tests/test_streaming.py::test_pallas_extract_paths_match_xla`` runs them,
and against ``lax.dynamic_slice`` for out-of-range starts.  All comparisons
are bit-exact: extraction copies values.  The kernels themselves run only on
the card (``tests/test_torch_cuda.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_ofdm_tpu import ModemConfig as JModemConfig
from c_ofdm_tpu.models import frame as jframe
from c_ofdm_tpu.models import rx as jrx
from c_ofdm_tpu.ops import pallas_extract

from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
from c_ofdm_tpu_torch.models import rx as trx
from c_ofdm_tpu_torch.ops import _kernels, extract

torch.set_num_threads(1)

CFG = ModemConfig()
WIN = CFG.preamble_len + CFG.message_len          # 5760


def EDGE_STARTS(n, win):
    """Starts past both ends and on both edges of [0, n - win]."""
    return [-n - 5, -7, -1, 0, n - win, n - win + 1, 10**6]


def _captures(rng, B, n, dtype=np.complex64):
    return (rng.standard_normal((B, n))
            + 1j * rng.standard_normal((B, n))).astype(dtype)


def test_extract_ref_matches_pallas_interpret():
    """Main-path window length, ragged rows (mirroring the JAX package's
    own kernel test), starts at both edges of the valid range."""
    rng = np.random.default_rng(4)
    n = 3 * CFG.frame_len
    caps = _captures(rng, 5, n)
    starts = np.array([0, 100, CFG.frame_len, 2 * CFG.frame_len, n - WIN],
                      dtype=np.int32)
    want = np.asarray(pallas_extract.extract_windows(
        jnp.asarray(caps), jnp.asarray(starts), WIN))
    got = extract.extract_windows_ref(torch.from_numpy(caps),
                                      torch.from_numpy(starts), WIN)
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(want, got.numpy())


def test_extract_ref_matches_pallas_flagship_shape():
    """The flagship batch geometry (n = frame_len, starts in [0, n - win])
    at a small batch."""
    rng = np.random.default_rng(5)
    n = CFG.frame_len
    caps = _captures(rng, 8, n)
    starts = rng.integers(0, n - WIN + 1, 8).astype(np.int32)
    starts[:2] = [0, n - WIN]
    want = np.asarray(pallas_extract.extract_windows(
        jnp.asarray(caps), jnp.asarray(starts), WIN))
    got = extract.extract_windows_ref(torch.from_numpy(caps),
                                      torch.from_numpy(starts), WIN)
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("np_dtype", [np.complex64, np.complex128])
def test_extract_ref_clamps_like_dynamic_slice(np_dtype):
    """Out-of-range starts follow lax.dynamic_slice: a negative start counts
    from the end once (s + n), then the start is clamped to [0, n - win]."""
    rng = np.random.default_rng(6)
    n, win = 700, 300
    starts = np.array(EDGE_STARTS(n, win), dtype=np.int32)
    caps = _captures(rng, starts.size, n, np_dtype)
    want = np.asarray(jax.vmap(lambda c, s: jax.lax.dynamic_slice_in_dim(
        c, s, win))(jnp.asarray(caps), jnp.asarray(starts)))
    got = extract.extract_windows_ref(torch.from_numpy(caps),
                                      torch.from_numpy(starts), win)
    assert got.dtype == torch.from_numpy(caps).dtype
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("np_dtype", [np.complex64, np.complex128])
def test_ring_refs_slice_like_dynamic_slice(np_dtype):
    """K2's and K3's plain versions at the same edge starts."""
    rng = np.random.default_rng(9)
    n, win = 700, 300
    starts = np.array(EDGE_STARTS(n, win), dtype=np.int32)
    rings = _captures(rng, 2, n, np_dtype)

    def ds(ring, st):
        return np.asarray(jax.vmap(lambda s: jax.lax.dynamic_slice_in_dim(
            jnp.asarray(ring), s, win))(jnp.asarray(st)))

    got = extract.extract_windows_single_ref(torch.from_numpy(rings[0]),
                                             torch.from_numpy(starts), win)
    np.testing.assert_array_equal(ds(rings[0], starts), got.numpy())
    st2 = np.stack([starts, starts[::-1]])
    got2 = extract.extract_windows_multi_ref(torch.from_numpy(rings),
                                             torch.from_numpy(st2), win)
    assert got2.shape == (2, starts.size, win)
    for c in range(2):
        np.testing.assert_array_equal(ds(rings[c], st2[c]), got2[c].numpy())


@pytest.mark.parametrize("K,win", [(49, 896), (41, WIN)])
def test_ring_refs_match_pallas_interpret(K, win):
    """K2/K3 plain versions against the JAX Pallas kernels (interpret mode)
    at the streaming path's (K, win) pairs on a 6-frame ring, starts in
    [0, n - win] as the receiver passes them."""
    rng = np.random.default_rng(10)
    n = 6 * CFG.frame_len
    rings = _captures(rng, 3, n)
    starts = rng.integers(0, n - win + 1, (3, K)).astype(np.int32)
    starts[:, :2] = [0, n - win]
    want = np.asarray(pallas_extract.extract_windows_single(
        jnp.asarray(rings[0]), jnp.asarray(starts[0]), win))
    got = extract.extract_windows_single_ref(torch.from_numpy(rings[0]),
                                             torch.from_numpy(starts[0]), win)
    np.testing.assert_array_equal(want, got.numpy())
    want = np.asarray(pallas_extract.extract_windows_multi(
        jnp.asarray(rings), jnp.asarray(starts), win))
    got = extract.extract_windows_multi_ref(torch.from_numpy(rings),
                                            torch.from_numpy(starts), win)
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_extract_sigs_ring_matches_jax(backend):
    """rx.extract_sigs_single / extract_sigs_ring (burst offset, clamp to
    [0, n - sig], K2/K3) against the JAX receiver's ring gathers, frame
    starts inside the ring as process_buffer clips them."""
    rng = np.random.default_rng(12)
    n = 3 * CFG.frame_len
    rings = _captures(rng, 2, n)
    fs = np.array([[0, 100, CFG.frame_len, 2 * CFG.frame_len,
                    n - CFG.frame_len]] * 2, dtype=np.int32)
    fs[1] = fs[1][::-1]
    jspec = jframe.make_frame_spec(JModemConfig(), dtype=jnp.complex64,
                                   extract_backend=backend)
    tspec = make_frame_spec(CFG, torch.complex64, device="cpu")
    want = np.asarray(jrx.extract_sigs_single(jspec, jnp.asarray(rings[0]),
                                              jnp.asarray(fs[0])))
    got = trx.extract_sigs_single(tspec, torch.from_numpy(rings[0]),
                                  torch.from_numpy(fs[0]).to(torch.int64))
    np.testing.assert_array_equal(want, got.numpy())
    want = np.asarray(jrx.extract_sigs_ring(jspec, jnp.asarray(rings),
                                            jnp.asarray(fs)))
    got = trx.extract_sigs_ring(tspec, torch.from_numpy(rings),
                                torch.from_numpy(fs).to(torch.int64))
    np.testing.assert_array_equal(want, got.numpy())


def test_extract_sigs_rows_matches_jax_pallas_backend():
    """rx.extract_sigs_rows (frame start + burst offset, clamp, K1) against
    the JAX receiver's Pallas-backend gather, frame starts past both ends."""
    rng = np.random.default_rng(7)
    n = CFG.frame_len + 1024
    caps = _captures(rng, 6, n)
    frame_starts = np.array([0, 1, 512, 1024, 1100, -300], dtype=np.int32)
    jspec = jframe.make_frame_spec(JModemConfig(), dtype=jnp.complex64,
                                   extract_backend="pallas")
    want = np.asarray(jrx.extract_sigs_rows(jspec, jnp.asarray(caps),
                                            jnp.asarray(frame_starts)))
    tspec = make_frame_spec(CFG, torch.complex64, device="cpu")
    got = trx.extract_sigs_rows(tspec, torch.from_numpy(caps),
                                torch.from_numpy(frame_starts).to(torch.int64))
    np.testing.assert_array_equal(want, got.numpy())


def test_extract_windows_on_cpu_runs_plain_version_uncounted():
    rng = np.random.default_rng(8)
    caps = torch.from_numpy(_captures(rng, 3, 900))
    starts = torch.tensor([0, 5, 600], dtype=torch.int32)
    fns = (extract.extract_windows, extract.extract_windows_single,
           extract.extract_windows_multi)
    before = [f.launches for f in fns]
    got = extract.extract_windows(caps, starts, 300)
    assert torch.equal(got, extract.extract_windows_ref(caps, starts, 300))
    got = extract.extract_windows_single(caps[0], starts, 300)
    assert torch.equal(got, extract.extract_windows_single_ref(
        caps[0], starts, 300))
    st2 = torch.stack([starts, starts.flip(0), starts])
    got = extract.extract_windows_multi(caps, st2, 300)
    assert torch.equal(got, extract.extract_windows_multi_ref(caps, st2, 300))
    assert [f.launches for f in fns] == before


def test_extract_windows_refuses_devices_without_kernel():
    caps = torch.zeros((2, 16), dtype=torch.complex64, device="meta")
    starts = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        extract.extract_windows(caps, starts, 8)
    with pytest.raises(ValueError, match="no kernel"):
        extract.extract_windows_single(caps[0], starts, 8)
    with pytest.raises(ValueError, match="no kernel"):
        extract.extract_windows_multi(caps, starts[:, None], 8)


def test_find_nvcc_raises_when_missing(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build("extract_windows")


def test_find_nvcc_uses_cuda_home(monkeypatch, tmp_path):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\n")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _kernels.find_nvcc() == str(nvcc)


def test_library_path_follows_source_hash(monkeypatch, tmp_path):
    """An edited kernel source gets a new library name, so it is rebuilt."""
    src = (_kernels.CSRC / "extract_windows.cu").read_text()
    monkeypatch.setattr(_kernels, "CSRC", tmp_path)
    (tmp_path / "extract_windows.cu").write_text(src)
    first = _kernels.library_path("extract_windows")
    (tmp_path / "extract_windows.cu").write_text(src + "\n// edit\n")
    second = _kernels.library_path("extract_windows")
    assert first != second
    assert first.parent == second.parent == _kernels.BUILD


# ---- the wide body's planning arithmetic (mirrored in csrc/extract_windows.cu)

@pytest.mark.parametrize("elem_bytes", [8, 16])
@pytest.mark.parametrize("win", [1, 2, 3, 4, 7, 8, 299, 300, 895, 896, 5760])
@pytest.mark.parametrize("dst_off", [0, 8])
@pytest.mark.parametrize("src_off", [0, 8])
def test_plan_window_covers_the_window_with_aligned_pairs(src_off, dst_off,
                                                          win, elem_bytes):
    """Head + 2·pairs + tail is the whole window for every combination of
    source and destination address parity, odd and even win, 8- and 16-byte
    elements; every paired store is 16-byte aligned; ``aligned`` says
    exactly when every paired load is."""
    halves = win * elem_bytes // 8
    src, dst = 4096 + src_off, 8192 + dst_off
    p = extract.plan_window(src, dst, halves)
    assert p.head in (0, 1) and p.tail in (0, 1) and p.pairs >= 0
    assert p.head + 2 * p.pairs + p.tail == halves
    assert p.head == (1 if dst_off else 0)
    for q in {0, p.pairs // 2, max(p.pairs - 1, 0)}:
        assert (dst + 8 * p.head + 16 * q) % 16 == 0
        assert ((src + 8 * p.head + 16 * q) % 16 == 0) == p.aligned
    assert p.aligned == (src_off == dst_off)


PATH_SHAPES = [                      # (windows, win, elem bytes, class)
    (49, 896, 8, "scalar"),          # K2 candidate regions
    (41, WIN, 8, "wide"),            # K2 frame windows
    (8 * 49, 896, 8, "wide"), (8 * 41, WIN, 8, "wide"),        # K3, C = 8
    (64 * 49, 896, 8, "wide"), (64 * 41, WIN, 8, "wide"),      # K3, C = 64
    (256, WIN, 8, "wide"),           # K1, flagship
    (128, 27904 - 256, 8, "wide"),   # K1, wideband 8k
    (7, 300, 16, "scalar"), (400, 300, 16, "wide"),
    (10**6, 3, 8, "scalar"), (10**6, 3, 16, "scalar"), (10**6, 4, 16, "wide"),
]


@pytest.mark.parametrize("windows,win,elem_bytes,name", PATH_SHAPES)
def test_launch_plan_class_and_grid(windows, win, elem_bytes, name):
    """The class follows from the shape alone; its grid covers every pair
    (or element) of a window with no tile more than one warp short."""
    plan = extract.launch_plan(windows, win, elem_bytes)
    assert plan.name == name == extract.launch_class(windows, win, elem_bytes)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
    assert plan.units == (extract.WIDE_UNITS if name == "wide" else 0)
    per_thread = max(1, plan.units)
    items = win if name == "scalar" else win * elem_bytes // 16
    cover = plan.tiles * plan.threads * per_thread
    assert cover >= items
    assert cover - items < plan.tiles * 32 * per_thread
    assert (plan.tiles - 1) * extract.MAX_THREADS * per_thread < items


def test_launch_plan_forced_body_and_bad_name():
    for name in extract.CLASSES:
        assert extract.launch_plan(41, WIN, 8, body=name).name == name
    assert extract.launch_plan(49, 896, 8) == ("scalar", 0, 224, 4)
    assert extract.launch_plan(49, 896, 8, body="wide") == (
        "wide", 4, 128, 1)
    assert extract.launch_plan(41, WIN, 8) == ("wide", 4, 256, 3)
    assert extract.launch_plan(41, WIN, 8, body="scalar") == (
        "scalar", 0, 256, 23)
    with pytest.raises(ValueError, match="body must be one of"):
        extract.launch_plan(41, WIN, 8, body="wide2")


def _wide_body(x, x_off, starts, per_row, win, out_off, body):
    """The wide kernel's copy, thread for thread, on 8-byte halves in numpy:
    x [rows, n·hpe] uint64 whose first half lies at byte address ``x_off``,
    output at ``out_off``; grid and cut from ``launch_plan`` and
    ``plan_window``.  Asserts that every paired store and every load taken as
    16 bytes is aligned, and that no half is written twice."""
    rows, n = x.shape
    hpe = 1                                    # halves per element: x is c64
    windows = rows * per_row
    plan = extract.launch_plan(windows, win, 8 * hpe, body)
    flat = x.reshape(-1)
    out = np.zeros(windows * win * hpe, np.uint64)
    written = np.zeros(out.size, np.int64)
    for w in range(windows):
        s = int(starts.reshape(-1)[w])
        s = s + n if s < 0 else s
        s = min(max(s, 0), n - win)
        src = (w // per_row * n + s) * hpe
        dst = w * win * hpe
        halves = win * hpe
        p = extract.plan_window(x_off + 8 * src, out_off + 8 * dst, halves)
        for tile in range(plan.tiles):
            t = np.arange(plan.threads)
            for k in range(plan.units):
                q = tile * plan.threads * plan.units + t + k * plan.threads
                q = q[q < p.pairs]
                assert not ((out_off + 8 * (dst + p.head + 2 * q)) % 16).any()
                if p.aligned:
                    assert not ((x_off + 8 * (src + p.head + 2 * q)) % 16).any()
                for h in (0, 1):
                    out[dst + p.head + 2 * q + h] = flat[src + p.head + 2 * q + h]
                    written[dst + p.head + 2 * q + h] += 1
        if p.head:
            out[dst] = flat[src]
            written[dst] += 1
        if p.tail:
            out[dst + halves - 1] = flat[src + halves - 1]
            written[dst + halves - 1] += 1
    assert (written == 1).all()
    return out.reshape(rows, per_row, win)


@pytest.mark.parametrize("body", ["wide"])
@pytest.mark.parametrize("win", [300, 299, 1, 7, 1030, 2500])
@pytest.mark.parametrize("x_off,out_off", [(0, 0), (8, 0), (0, 8), (8, 8)])
def test_wide_body_arithmetic_copies_every_window(x_off, out_off, win, body):
    """The kernel's index arithmetic rehearsed on the CPU: for 16- and
    8-byte-aligned bases, odd and even win (odd win gives odd windows an
    8-byte-aligned output), odd and even and out-of-range starts, each class
    writes every half of every window exactly once and equals the plain
    version."""
    rng = np.random.default_rng(21)
    rows, per_row, n = 2, 5, 2600
    x = rng.integers(0, 2**63, (rows, n), dtype=np.uint64)
    starts = rng.integers(0, n - win + 1, (rows, per_row))
    starts[0, :4] = [-n - 5, -1, n - win + 1, 10**6]
    starts[1, :2] = [0, 1]
    got = _wide_body(x, x_off, starts, per_row, win, out_off, body)
    want = extract.extract_windows_multi_ref(
        torch.from_numpy(x.view(np.complex64)),
        torch.from_numpy(starts), win).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)


# ---- int64 starts, and the library expressions the kernels are timed against

@pytest.mark.parametrize("np_dtype", [np.complex64, np.complex128])
def test_int64_starts_equal_int32_and_dynamic_slice(np_dtype):
    """extract_windows* take int32 or int64 starts: the same windows, equal
    to lax.dynamic_slice_in_dim at starts past both ends and on both edges;
    an int64 start beyond int32 clamps to the last window."""
    rng = np.random.default_rng(13)
    n, win = 700, 300
    edge = EDGE_STARTS(n, win)
    rings = _captures(rng, len(edge), n, np_dtype)
    want = np.asarray(jax.vmap(lambda c, s: jax.lax.dynamic_slice_in_dim(
        c, s, win))(jnp.asarray(rings), jnp.asarray(edge, dtype=jnp.int32)))
    x = torch.from_numpy(rings)
    for dt in (torch.int32, torch.int64):
        st = torch.tensor(edge, dtype=dt)
        np.testing.assert_array_equal(
            want, extract.extract_windows(x, st, win).numpy())
        got = extract.extract_windows_single(x[0], st, win)
        got3 = extract.extract_windows_multi(x[:2], torch.stack([st, st]),
                                             win)
        for k, s in enumerate(edge):
            one = np.asarray(jax.lax.dynamic_slice_in_dim(
                jnp.asarray(rings[0]), s, win))
            np.testing.assert_array_equal(one, got[k].numpy())
            np.testing.assert_array_equal(one, got3[0, k].numpy())
    far = torch.tensor([2**40, -2**40], dtype=torch.int64)
    got = extract.extract_windows_single(x[0], far, win)
    np.testing.assert_array_equal(got[0].numpy(), rings[0, n - win:])
    np.testing.assert_array_equal(got[1].numpy(), rings[0, :win])


@pytest.mark.parametrize("K,win", [(49, 896), (41, WIN)])
def test_unfold_index_library_calls_equal_plain_versions(K, win):
    """The single PyTorch call each kernel is timed against on the card (an
    index into the unfolded view) equals the plain version for starts in
    [0, n - win], which is all the receiver passes."""
    rng = np.random.default_rng(14)
    n = 4 * CFG.frame_len
    rings = torch.from_numpy(_captures(rng, 3, n))
    st = torch.from_numpy(rng.integers(0, n - win + 1, (3, K)))
    st[:, :2] = torch.tensor([0, n - win])
    assert torch.equal(rings[0].unfold(-1, win, 1)[st[0]],
                       extract.extract_windows_single_ref(rings[0], st[0],
                                                          win))
    assert torch.equal(
        rings.unfold(-1, win, 1)[torch.arange(3)[:, None], st],
        extract.extract_windows_multi_ref(rings, st, win))
    assert torch.equal(
        rings.unfold(-1, win, 1)[torch.arange(3), st[:, 0]],
        extract.extract_windows_ref(rings, st[:, 0], win))


@pytest.mark.parametrize("dt", [torch.int32, torch.int64])
def test_sig_starts_keep_the_callers_index_type(dt):
    """rx._sig_starts clamps in the caller's index type (no conversion is
    launched before the gather) and the gathers take either type."""
    tspec = make_frame_spec(CFG, torch.complex64, device="cpu")
    n = 2 * CFG.frame_len
    fs = torch.tensor([0, 100, CFG.frame_len, 10**6, -300], dtype=dt)
    starts, ln = trx._sig_starts(tspec, n, fs)
    assert starts.dtype == dt and ln == WIN
    assert starts.tolist() == [256, 356, CFG.frame_len + 256, n - WIN, 0]
    ring = torch.from_numpy(_captures(np.random.default_rng(15), 1, n))[0]
    got = trx.extract_sigs_single(tspec, ring, fs)
    assert torch.equal(got, extract.extract_windows_single_ref(
        ring, starts.to(torch.int64), WIN))


@pytest.mark.parametrize("channels", [0, 2])
def test_streaming_gathers_get_starts_without_conversion(monkeypatch,
                                                         channels):
    """process_buffer hands the gathers the index tensors it computed (int64
    candidate starts from the top-K, int32 frame starts from the positions):
    no dtype conversion runs before either launch."""
    from c_ofdm_tpu_torch.models import streaming
    spec = make_frame_spec(CFG, torch.complex64, device="cpu")
    name = "extract_windows_multi" if channels else "extract_windows_single"
    real = getattr(extract, name)
    seen = []

    def spy(x, starts, win, **kw):
        seen.append((starts.dtype, win))
        return real(x, starts, win, **kw)

    monkeypatch.setattr(extract, name, spy)
    lead = (channels,) if channels else ()
    block = torch.zeros((*lead, CFG.rx_buf_size * CFG.frame_len),
                        dtype=torch.complex64)
    streaming.process_buffer(
        spec, streaming.init_state(spec, channels=channels), block)
    assert seen == [(torch.int64, CFG.gated_search_lags + CFG.pr_sin_len),
                    (torch.int32, WIN)]
