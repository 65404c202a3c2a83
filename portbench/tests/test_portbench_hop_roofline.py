"""The hop-track reader, ``portbench/metrics/hop_roofline.py``: its bound
gives PERF.md's fixed point at the 64-channel gateway, and a record whose
trace holds no hop-track kernel reads nothing."""

import pytest

from portbench import harness, peaks
from portbench.reference.config import ModemConfig


def _cfg(name):
    return ModemConfig(**harness.Bench.load().config(name)["modem"])


def test_hop_roofline_bound_at_the_gateway():
    """PERF.md: the hop track over 64 rings of 246656 complex64 samples
    (hop 128, 22 masked bins) reads 126.8 MB and does 2.778 GFLOP, and
    the float32 rate binds (41.5 us)."""
    bench = harness.Bench.load()
    work = bench.reader("hop_roofline").__globals__["work"]
    nbytes, flops = work(_cfg("pluto_c_ofdm"), 64)
    assert nbytes == 64 * 246656 * 8 + 64 * 1926 * 4 == 126_780_928
    assert flops == 8 * 64 * 1927 * 128 * 22 == 2_778_333_184
    t, which = peaks.bound_seconds(nbytes, flops)
    assert which == "flops" and round(t * 1e6, 1) == 41.5


def test_hop_roofline_without_the_kernel_reads_nothing():
    """A traced record whose kernels hold no hop-track kernel (the parent's
    cuBLAS path) reads None; one that holds it reads its share."""
    bench = harness.Bench.load()
    read = bench.reader("hop_roofline")
    mix = harness.load_json(harness.PORTBENCH / "mixes"
                            / "stream_c64_device.json")
    rec = {"cfg": _cfg("pluto_c_ofdm"), "mix": mix,
           "config": bench.config("pluto_c_ofdm"),
           "trace": {"steps": 2, "kernels": {
               "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x32x8": 3e-4,
               "void at::native::reduce_kernel<512, 1>": 1e-4}}}
    assert read(rec) is None
    rec["trace"]["kernels"][
        "void (anonymous namespace)::t2_hop_track_kernel<float>("
        "(anonymous namespace)::Args)"] = 2 * 83e-6
    assert read(rec) == pytest.approx(100 * 41.467e-6 / 83e-6, rel=1e-3)
