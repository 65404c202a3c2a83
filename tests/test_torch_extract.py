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
