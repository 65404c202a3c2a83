"""The port's ``io`` package against the JAX package's on the CPU: binio
writes the same bytes and reads the same arrays, StageTrace writes the same
files and summaries on the same calls and clock, link_metrics agrees to
1e-12, and the native ingest library, built from ``native/ingest.cpp`` into
``c_ofdm_tpu_torch/_build/``, pops the same buffers as the JAX binding."""

import itertools
import os
import time

import numpy as np
import pytest
import torch

from c_ofdm_tpu.io import binio as jbinio
from c_ofdm_tpu.io import ingest as jingest
from c_ofdm_tpu.io import trace as jtrace

from c_ofdm_tpu_torch.io import binio, ingest, trace

torch.set_num_threads(1)


def _cplx(rng, n, scale=1.0):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * scale


@pytest.mark.parametrize("writer", ["write_complex64f", "write_complex_int16",
                                    "write_doubles"])
def test_binio_writes_the_same_bytes(tmp_path, writer):
    rng = np.random.default_rng(0)
    if writer == "write_doubles":
        arr = rng.standard_normal(77)
    elif writer == "write_complex_int16":
        arr = _cplx(rng, 301, 300.0)      # truncation toward zero, both signs
    else:
        arr = _cplx(rng, 129).astype(np.complex64)
    a, b = tmp_path / "jax.bin", tmp_path / "port.bin"
    getattr(jbinio, writer)(str(a), arr)
    getattr(binio, writer)(str(b), arr)
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("reader,writer", [
    ("read_complex64f", "write_complex64f"),
    ("read_complex_int16", "write_complex_int16"),
    ("read_doubles", "write_doubles")])
def test_binio_reads_the_same_arrays(tmp_path, reader, writer):
    rng = np.random.default_rng(1)
    arr = (rng.standard_normal(64) if writer == "write_doubles"
           else _cplx(rng, 64, 1000.0))
    path = str(tmp_path / "x.bin")
    getattr(jbinio, writer)(path, arr)
    got, want = getattr(binio, reader)(path), getattr(jbinio, reader)(path)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_dump_rx_artifacts_writes_the_same_files(tmp_path):
    rng = np.random.default_rng(2)
    kw = dict(capture=_cplx(rng, 500), t2_corr=rng.random(40),
              chan_est=_cplx(rng, 16), constellation=_cplx(rng, 64),
              tx_int16=_cplx(rng, 100, 5000.0))
    jbinio.dump_rx_artifacts(str(tmp_path / "j"), **kw)
    binio.dump_rx_artifacts(str(tmp_path / "t"), **kw)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 5
    for name in names:
        assert ((tmp_path / "j" / name).read_bytes()
                == (tmp_path / "t" / name).read_bytes()), name


def _drive_trace(mod):
    tr = mod.StageTrace()
    for i in range(4):
        tr.iter_start(ITER=i)
        tr.point("RX_STEP")
        tr.value("FR_IN_BUF", i % 3)
        tr.point("MAC_per_buf")
        tr.value("DET", 2 * i)
    return tr


def test_stage_trace_matches_jax(tmp_path, monkeypatch):
    """The same calls on the same clock give the same LOG.txt, jsonl and
    summaries (with and without ``amortize_over``)."""
    outs = {}
    for name, mod in (("jax", jtrace), ("port", trace)):
        clock = itertools.count(0.0, 0.125)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        tr = _drive_trace(mod)
        tr.to_log_txt(str(tmp_path / f"{name}.txt"))
        tr.to_jsonl(str(tmp_path / f"{name}.jsonl"))
        outs[name] = (tr.summary(), tr.summary(amortize_over="FR_IN_BUF"),
                      (tmp_path / f"{name}.txt").read_text(),
                      (tmp_path / f"{name}.jsonl").read_text())
    assert outs["port"] == outs["jax"]
    assert "ITER:3 RX_STEP:0.125" in outs["port"][2]


@pytest.mark.parametrize("mod_type", [2, 4, 6])
@pytest.mark.parametrize("with_bytes", [False, True])
def test_link_metrics_matches_jax(mod_type, with_bytes):
    """Within 1e-12 on a noisy constellation; the port takes a tensor (and
    tensor bytes, 2-D so FER is reported) where the JAX function takes
    numpy."""
    from c_ofdm_tpu_torch.ops.modulation import constellation
    rng = np.random.default_rng(mod_type)
    table = constellation(mod_type)
    pts = table[rng.integers(0, table.size, 2048)] * 0.7
    pts = pts + 0.03 * _cplx(rng, pts.size)
    kw, tkw = {}, {}
    if with_bytes:
        ref = rng.integers(0, 256, (4, 64), dtype=np.uint8)
        dec = ref.copy()
        dec[1, 3] ^= 0x11
        dec[3, 60] ^= 0x80
        kw = dict(ref_bytes=ref, decoded_bytes=dec)
        tkw = dict(ref_bytes=torch.from_numpy(ref),
                   decoded_bytes=torch.from_numpy(dec))
    want = jtrace.link_metrics(pts, mod_type, **kw)
    got = trace.link_metrics(torch.from_numpy(pts), mod_type, **tkw)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])
    if with_bytes:
        assert got["fer"] == 0.5


def _source(tmp_path, n=6016):
    data = np.random.default_rng(9).integers(-32768, 32768, 2 * n,
                                             dtype=np.int16)
    path = tmp_path / "src.bin"
    data.tofile(path)
    return str(path), data


def test_native_ingest_replay_matches_jax(tmp_path):
    """Buffers popped from a file replay, across the loop back to the start
    of the file (buffer size not a divisor of the file), equal JAX's."""
    path, data = _source(tmp_path)
    per = 2500
    with jingest.NativeIngest(jingest.SRC_FILE_REPLAY, path, per, 4) as ji, \
            ingest.NativeIngest(ingest.SRC_FILE_REPLAY, path, per, 4) as ti:
        for k in range(6):
            if k % 3 == 2:
                a, b = ji.pop_i16(), ti.pop_i16()
            else:
                a, b = ji.pop_complex64(), ti.pop_complex64()
            assert a.dtype == b.dtype and np.array_equal(a, b), k
        assert ti.stats().buffers_consumed == ji.stats().buffers_consumed == 6
    # the first three buffers walk the file, the third wraps to its start
    want = np.concatenate([data, data])[: 2 * 3 * per].astype(np.float32)
    with ingest.NativeIngest(ingest.SRC_FILE_REPLAY, path, per, 2) as ti:
        got = np.concatenate([ti.pop_f32() for _ in range(3)])
    assert np.array_equal(got, want)


def test_native_ingest_fd_stream_eof_matches_jax(tmp_path):
    data = np.arange(-150, 150, dtype=np.int16)
    p = tmp_path / "s.bin"
    data.tofile(p)
    outs = []
    for mod in (jingest, ingest):
        fd = os.open(p, os.O_RDONLY)
        try:
            with mod.NativeIngest(mod.SRC_FD_STREAM, str(fd), 50, 2) as ing:
                pops = [ing.pop_f32(timeout_ms=2000) for _ in range(4)]
        finally:
            os.close(fd)
        assert pops[3] is None                  # EOF after 300 int16
        outs.append(pops[:3])
    for a, b in zip(*outs):
        assert np.array_equal(a, b)
    assert np.array_equal(np.concatenate(outs[1]), data.astype(np.float32))


def test_native_ingest_pops_into_a_given_buffer(tmp_path):
    path, data = _source(tmp_path, 1000)
    out = torch.empty(2000, dtype=torch.float32).numpy()
    with ingest.NativeIngest(ingest.SRC_FILE_REPLAY, path, 1000, 2) as ti:
        assert ti.pop_f32(out=out) is out
        with pytest.raises(ValueError):
            ti.pop_f32(out=np.empty(1999, dtype=np.float32))
    assert np.array_equal(out, data.astype(np.float32))


@pytest.mark.parametrize("n", [1, 15, 16, 10001])
def test_convert_i16_to_f32_matches_jax(n):
    x = np.random.default_rng(n).integers(-32768, 32768, n, dtype=np.int16)
    got = ingest.convert_i16_to_f32(x)
    assert np.array_equal(got, jingest.convert_i16_to_f32(x))
    assert np.array_equal(got, x.astype(np.float32))


def test_library_is_built_under_build_not_loaded_from_native():
    lib = ingest.load_library()
    path = ingest.library_path()
    assert lib._name == str(path) and path.exists()
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "c_ofdm_tpu_torch"
    assert "native" not in path.parts
    assert path.name.startswith("libingest-") and path.name != "libingest.so"
    assert ingest.SOURCE.name == "ingest.cpp" and ingest.SOURCE.exists()
    assert "-march=native" in ingest.CXX_FLAGS


def test_library_name_follows_source_and_flags(monkeypatch):
    base = ingest.library_path()
    monkeypatch.setattr(ingest, "CXX_FLAGS", ingest.CXX_FLAGS + ("-g",))
    assert ingest.library_path() != base
    assert ingest.library_path().parent == base.parent
