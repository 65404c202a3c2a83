"""Tiny cells for the benchmark's CPU tests: throwaway mixes and limits
written to a temporary folder, found by name beside the benchmark's own
files, on the benchmark's own configurations.  Run with

    python -m pytest portbench/tests -q
"""

import json
import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness   # noqa: E402

TINY = {
    "tiny_stream": {"entry": "stream", "inputs": "device", "channels": 2,
                    "buffers": 2, "fill": 0.8, "cfo": 1e-4, "amplitude": 60.0,
                    "snr_db": 26.0, "wire": "int16", "soft_calls": 2,
                    "soft_frames": 64, "profile_calls": 2},
    "tiny_stream_host": {"entry": "stream", "inputs": "host", "channels": 0,
                         "buffers": 3, "fill": 0.8, "cfo": 1e-4,
                         "amplitude": 60.0, "snr_db": 26.0, "wire": "int16",
                         "soft_calls": 2, "soft_frames": 64,
                         "profile_calls": 2},
    "tiny_batch": {"entry": "batch", "inputs": "device", "frames": 8,
                   "zero_rows": 2, "extra": 1024, "cfo": 1e-4,
                   "amplitude": 40.0, "snr_db": 30.0, "batches": 2,
                   "wire": "complex64", "soft_calls": 2, "soft_frames": 16,
                   "profile_calls": 2},
    "tiny_bcast": {"entry": "batch", "inputs": "device", "frames": 1,
                   "zero_rows": 1, "extra": 4096, "cfo": 2e-6,
                   "amplitude": 10.0, "snr_db": 30.0, "batches": 1,
                   "wire": "complex64", "soft_calls": 1, "soft_frames": 1,
                   "profile_calls": 1},
}
# each tiny cell's configuration and the real cell whose limit it is held to
CELLS = {"tiny_stream": ("pluto_c_ofdm", "pluto_stream_c64"),
         "tiny_stream_host": ("pluto_c_ofdm", "pluto_stream_c1_host"),
         "tiny_batch": ("pluto_c_ofdm", "pluto_batch_b256"),
         "tiny_bcast": ("lte_bcast_0p37khz", "lte_bcast_batch_b16")}


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    """A Bench whose BENCHMARK.json also names the tiny cells, their mixes
    and limits (the real cells' limits) in a temporary folder."""
    d = tmp_path_factory.mktemp("tiny")
    (d / "mixes").mkdir()
    (d / "limits").mkdir()
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for name, mix in TINY.items():
        config, real = CELLS[name]
        (d / "mixes" / f"{name}.json").write_text(json.dumps(mix))
        limits = harness.load_json(harness.PORTBENCH / "limits"
                                   / f"{real}.json")
        (d / "limits" / f"{name}.json").write_text(json.dumps(limits))
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": name, "chips": 1, "why": "test"})
        for m in spec["end_to_end"]:
            if m["name"] in ("samples_per_s", "latency_ms_p95"):
                m["workloads"].append(name)
    return harness.Bench(spec, search=(d, harness.PORTBENCH))


def run_cpu(bench, cell, seed=2**31 + 11, seconds=1.0, trace=False):
    """One run of ``cell`` on the CPU: the harness without its look for a
    card."""
    return harness.run(bench, cell, seed, seconds, trace, "cpu",
                       time.perf_counter())
