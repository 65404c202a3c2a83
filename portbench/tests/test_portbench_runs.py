"""The harness drives the port on the CPU at tiny sizes of each entry kind
(the look for a card skipped): every planted frame decodes; the control
(the reference in TF32) fails the soft-value limit the program meets; and
each fault a cell can have, planted under the timed path, makes the run
come out not correct."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests.conftest import CELLS, run_cpu


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_port_decodes_every_planted_frame(tiny_bench, cell):
    result, lines = run_cpu(tiny_bench, cell)
    assert result["correct"], lines
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"samples_per_s", "latency_ms_p95",
                                      "setup_s"}
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", ["tiny_stream", "tiny_stream_host",
                                  "tiny_batch", "tiny_bcast"])
def test_control_fails_the_limit_the_program_meets(tiny_bench, cell):
    """Three seeds: the program's widest soft gap under the cell's limit,
    the control's over it, on the same frames."""
    from portbench.calibrate import calibrate
    limit = tiny_bench.limits(cell)["soft_gap"]
    s = calibrate(tiny_bench, cell, [3, 4, 5], 0.3, "cpu")
    assert s["failed"] == 0
    assert s["program_gap_max"] < limit < s["control_gap_min"]


def _stream_state_unchanged(monkeypatch):
    from c_ofdm_tpu_torch.models import streaming
    from c_ofdm_tpu_torch.models.streaming import StreamingReceiver

    def step(self, block):
        _, out = streaming.process_buffer(self.bound_spec(),
                                          self._state_buffers(), block,
                                          self.max_frames, self.sync_mode)
        return out
    monkeypatch.setattr(StreamingReceiver, "_step", step)


def _batch_half_left_out(monkeypatch):
    from c_ofdm_tpu_torch.models.modem import FlagshipStep
    receive = FlagshipStep.receive

    def half(self, captures):
        x = captures.clone()
        x[x.shape[0] // 2:] = 0
        return receive(self, x)
    monkeypatch.setattr(FlagshipStep, "receive", half)


def _byte_altered(monkeypatch):
    from c_ofdm_tpu_torch.models.modem import FlagshipStep
    receive = FlagshipStep.receive

    def flip(self, captures):
        res, sync = receive(self, captures)
        mac = res.mac_bytes.clone()
        mac[0, 0] ^= 1
        return res._replace(mac_bytes=mac), sync
    monkeypatch.setattr(FlagshipStep, "receive", flip)


def _soft_altered(monkeypatch):
    from c_ofdm_tpu_torch.models.streaming import StreamingReceiver
    feed = StreamingReceiver.feed

    def nudge(self, block):
        out = feed(self, block)
        return out._replace(diag=out.diag + 1e-3)
    monkeypatch.setattr(StreamingReceiver, "feed", nudge)


@pytest.mark.parametrize("cell,fault", [
    ("tiny_stream", _stream_state_unchanged),
    ("tiny_batch", _batch_half_left_out),
    ("tiny_batch", _byte_altered),
    ("tiny_stream", _soft_altered)])
def test_fault_makes_the_run_not_correct(tiny_bench, monkeypatch, cell, fault):
    fault(monkeypatch)
    result, lines = run_cpu(tiny_bench, cell, seconds=0.5)
    assert not result["correct"], lines


def test_traced_run_reads_its_trace(tiny_bench, tmp_path, monkeypatch):
    """A traced run on the CPU writes its chrome trace and reads it between
    the host bounds of its profiled calls; with no device activity it
    reports no device fields."""
    import time
    seen = {}
    read = harness.read_trace

    def spy(path, profiled):
        seen["trace"] = out = read(path, profiled)
        return out
    monkeypatch.setattr(harness, "read_trace", spy)
    result, _ = harness.run(tiny_bench, "tiny_batch", 9, 0.5, True, "cpu",
                            time.perf_counter(), trace_dir=tmp_path)
    assert (tmp_path / "tiny_batch.trace.json").is_file()
    trace = seen["trace"]
    assert trace["steps"] == 2 and trace["busy_s"] == 0.0
    assert 0 < trace["window_s"] < 0.5
    assert set(trace["gaps"]) <= {"call", "readback", "wait", "check", "host"}
    assert result["correct"] and "busy_s" not in result["device"]


def test_no_card_no_result():
    """Without a CUDA card run.py exits non-zero and prints nothing on
    standard output."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, str(harness.PORTBENCH / "run.py"), "--workload",
         "pluto_batch_b256", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_forbidden_module_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "c_ofdm_tpu_torch_x", sys)
    assert "c_ofdm_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "c_ofdm_tpu.config", sys)
    assert "c_ofdm_tpu.config" in harness.forbidden_modules()


def test_frame_the_reference_sync_cannot_see_is_undetected(tiny_bench):
    """LTE broadcast at offset 234 (seed 147: a burst 22 samples short of
    one two-tone block, its preamble's first samples in the next):
    the block-aligned detect misses the burst in the reference's float64
    sync as in the program, so the frame counts as undetected, not failed;
    a frame the reference finds and the program misses fails (the
    half-batch fault above)."""
    result, lines = run_cpu(tiny_bench, "tiny_bcast", seed=147, seconds=0.1)
    assert result["attempted"] == result["undetected"] > 0, lines
    assert result["failed"] == 0 and not result["correct"]


def test_sync_capture_is_the_oracle():
    from c_ofdm_tpu_torch import ModemConfig as ProgramConfig
    from c_ofdm_tpu_torch.oracle import reference as program_oracle
    from portbench.reference import oracle
    from portbench.reference.config import ModemConfig
    rng = np.random.default_rng(3)
    cfg = ModemConfig()
    frame = oracle.tx_frame(cfg, rng.integers(0, 256, cfg.frame_bytes))
    for off in (0, 100, 233, 700):
        cap = np.zeros(cfg.frame_len + 1024, complex)
        cap[off:off + cfg.frame_len] = 40 * frame
        cap += 0.5 * rng.standard_normal(cap.size)
        got = program_oracle.rx_capture(ProgramConfig(), cap)
        want = -1 if got is None else got[4] - cfg.t2sin_size
        assert oracle.sync_capture(cfg, cap) == want == off
