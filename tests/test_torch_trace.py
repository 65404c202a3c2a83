"""The port's trace recorder (``io/trace.py``) on the CPU: off, it records
nothing and the steps run the same operations; on, its spans nest under
their entry call on ``time.time_ns``, the gated sync's work counts are exact
and its hit count equals the frames the outputs mark valid, the
overlap-save matched filter counts its chunks, the coarse CFO its
windows and K4's four-step route its rows, which a graph's replay adds as
the eager call does; the stage reader splits a chrome trace's replays
between their marks; and the spans land in a profiler trace on its own
clock.  The
graph-side spans, the marks in a captured graph and the counts a real
graph's replays add need the card (``tests/test_torch_cuda.py``)."""

import json
import math
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
from c_ofdm_tpu_torch.io import trace
from c_ofdm_tpu_torch.models import streaming
from c_ofdm_tpu_torch.models.modem import FlagshipStep
from c_ofdm_tpu_torch.ops import sync
from c_ofdm_tpu_torch.utils import graphs

CFG = ModemConfig()
STAGE_SPANS = ["sync", "extract", "recover", "dft", "equalize"]


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def _stream_blocks(C, S=2, seed=4):
    """S consecutive stock buffers [S, C, n] complex64 with frames planted
    at random starts in AWGN."""
    from c_ofdm_tpu_torch.models import tx
    spec = make_frame_spec(CFG, torch.complex64, device="cpu")
    rng = np.random.default_rng(seed)
    n = CFG.rx_buf_size * CFG.frame_len
    total, nf = S * n, 12
    sig = 0.05 * (rng.standard_normal((C, total))
                  + 1j * rng.standard_normal((C, total)))
    payload = rng.integers(0, 256, (C, nf, CFG.frame_bytes), dtype=np.uint8)
    frames = tx.transmit(spec, torch.from_numpy(payload)).numpy()
    for c in range(C):
        starts = np.sort(rng.choice(total // CFG.frame_len - 1, nf,
                                    replace=False)) * CFG.frame_len
        starts += rng.integers(0, CFG.frame_len // 2, nf)
        for i, s in enumerate(starts):
            sig[c, s:s + CFG.frame_len] += 60.0 * frames[c, i]
    blocks = sig.astype(np.complex64).reshape(C, S, n).transpose(1, 0, 2)
    return torch.from_numpy(np.ascontiguousarray(blocks))


def _captures(B=3, seed=5):
    from c_ofdm_tpu_torch.models import tx
    spec = make_frame_spec(CFG, torch.complex64, device="cpu")
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, (B, CFG.frame_bytes), dtype=np.uint8)
    frames = tx.transmit(spec, torch.from_numpy(payload))
    caps = torch.zeros((B, CFG.frame_len + 300), dtype=torch.complex64)
    for b in range(B):
        caps[b, 37 * b:37 * b + CFG.frame_len] = frames[b]
    return caps


@pytest.fixture(scope="module")
def blocks():
    return _stream_blocks(2)


def _ops(fn):
    with _CountOps() as mode:
        fn()
    return mode.ops


def test_off_records_nothing_and_runs_the_same_ops(blocks, monkeypatch):
    """With the recorder off no recorder method runs (each raises here), the
    drain is empty, and the batch step and a stream buffer dispatch the
    same operations before and after the recorder was on; on, the batch
    step dispatches the same operations, and the stream buffer those plus
    the hit counter's sum and add."""
    step = FlagshipStep(make_frame_spec(CFG, torch.complex64, device="cpu"))
    caps = _captures()
    spec = make_frame_spec(CFG, torch.complex64, device="cpu")

    def feed():
        rxr = streaming.StreamingReceiver(spec, channels=2)
        rxr.feed(blocks[0])

    before = (_ops(lambda: step.receive(caps)), _ops(feed))
    trace.enable()
    feed()                  # makes the CPU's hit counter
    traced = (_ops(lambda: step.receive(caps)), _ops(feed))
    trace.disable()
    trace.drain()

    def boom(*args, **kwargs):
        raise AssertionError("the recorder ran while off")
    for name in ("begin", "mark", "count_hits", "entry", "span"):
        monkeypatch.setattr(trace.Recorder, name, boom)
    after = (_ops(lambda: step.receive(caps)), _ops(feed))
    assert after == before
    assert traced[0] == before[0]
    extra = list(traced[1])
    for op in before[1]:
        extra.remove(op)
    assert sorted(map(str, extra)) == ["aten.add_.Tensor", "aten.sum.default"]
    monkeypatch.undo()
    assert trace.drain() == {"spans": [], "counts": {
        "regions_scored": 0, "slots_demodulated": 0, "mf_chunks": 0,
        "cfo_windows": 0, "cfo_bins": 0, "hop_windows": 0,
        "fourstep_rows": 0, "hits_accepted": 0}}


def test_spans_nest_under_their_entry_call():
    """Two batch calls: each an ``entry`` span (its own call id, labelled
    with the captured call's name) holding the five stage spans in order,
    each inside its parent on ``time.time_ns``'s clock."""
    step = FlagshipStep(make_frame_spec(CFG, torch.complex64, device="cpu"))
    caps = _captures()
    trace.enable()
    t0 = time.time_ns()
    step.receive(caps)
    step.receive(caps)
    t1 = time.time_ns()
    spans = trace.drain()["spans"]
    entries = [i for i, s in enumerate(spans) if s["name"] == "entry"]
    assert [spans[i]["call"] for i in entries] == [0, 1]
    for i in entries:
        e = spans[i]
        assert e["parent"] is None and e["label"] == "FlagshipStep"
        kids = [s for s in spans if s["parent"] == i]
        assert [s["name"] for s in kids] == STAGE_SPANS
        assert all(s["call"] == e["call"] and s["label"] == "stage"
                   for s in kids)
        assert t0 <= e["start_ns"] <= kids[0]["start_ns"]
        assert kids[-1]["end_ns"] <= e["end_ns"] <= t1
        for a, b in zip(kids, kids[1:]):
            assert a["start_ns"] <= a["end_ns"] <= b["start_ns"]
    assert len(spans) == 2 * (1 + len(STAGE_SPANS))


def test_work_counts_and_hits_on_the_cpu(blocks):
    """Two buffers of two channels: regions scored K x C, slots
    demodulated max_frames x C and hop windows 1926 x C a buffer, exactly;
    hits accepted equal the
    valid slots of the outputs.  The work counts are launch counts, so a
    graph's delta carries them."""
    spec = make_frame_spec(CFG, torch.complex64, device="cpu")
    rxr = streaming.StreamingReceiver(spec, channels=2)
    trace.enable()
    outs = [rxr.feed(b) for b in blocks]
    counts = trace.drain()["counts"]
    K = rxr.max_frames + CFG.t2_gate_slack
    assert counts["regions_scored"] == len(blocks) * 2 * K
    assert counts["slots_demodulated"] == len(blocks) * 2 * rxr.max_frames
    assert counts["cfo_windows"] == (len(blocks) * 2 * rxr.max_frames
                                     * CFG.num_pilot_subc)
    assert counts["cfo_bins"] == (len(blocks) * 2 * rxr.max_frames
                                  * spec.tensors["cfo_basis"].shape[-1])
    assert counts["hop_windows"] == len(blocks) * 2 * (
        CFG.frame_len * (CFG.rx_buf_size + 1) // (CFG.t2sin_size // 2) - 1)
    valid = sum(int(o.valid.sum()) for o in outs)
    assert counts["hits_accepted"] == valid > 0
    keys = graphs.launch_counts()
    for name in trace.WORK_COUNTS:
        assert keys[(trace.count, "work_counts", name)] == 0


@pytest.mark.parametrize("L,rows,n,chunks", [(4096, 20, 8704, 1),
                                             (128, 2, 30080, 8)])
def test_matched_filter_counts_its_chunks(L, rows, n, chunks):
    """With the recorder on, one overlap-save matched filter counts rows x
    chunks a row: one 16384-point chunk a row at the broadcast sync's
    [20, 8704] and 4096 taps (12289 lags a chunk), ceil(30080 / 3969) = 8
    at the stock 128 taps; nothing with the recorder off."""
    cfg = ModemConfig(pr_sin_len=L, fft_size=max(512, 4 * L))
    spec = make_frame_spec(cfg, torch.complex64, device="cpu",
                           fft_backend="xla")
    x = torch.randn((rows, n), dtype=torch.complex64)
    assert chunks == -(-n // (sync.overlap_save_len(L) - L + 1))
    sync.matched_filter_scores(spec, x)
    assert trace.drain()["counts"]["mf_chunks"] == 0
    trace.enable()
    sync.matched_filter_scores(spec, x)
    assert trace.drain()["counts"]["mf_chunks"] == rows * chunks


BROADCAST = ModemConfig(fft_size=82944, num_data_subc=48000,
                        num_pilot_subc=600, cp_size=9216, num_symb=2,
                        pr_sin_len=4096, mod_type=6)


# DVB-T2 16K at its published occupancy (the benchmark's dvbt2_16k)
DVBT2_16K = ModemConfig(fft_size=16384, num_data_subc=13248,
                        num_pilot_subc=576, cp_size=2048, num_symb=2,
                        pr_sin_len=2048, mod_type=6, sync_peak_refine=True)


@pytest.mark.parametrize("cfg,backend,rows,windows,bins", [
    (CFG, "matmul", 3, 8, 328), (CFG, "xla", 3, 8, 640),
    (BROADCAST, "xla", 20, 600, 92160), (DVBT2_16K, "pallas", 2, 576, 18432)],
    ids=["stock-matmul", "stock-xla", "broadcast-xla", "dvbt2-pallas"])
def test_coarse_cfo_counts_its_windows(cfg, backend, rows, windows, bins):
    """With the recorder on, one coarse-CFO search counts rows x windows:
    20 x 600 = 12000 at the broadcast cell's rows, rows x 8 at the stock
    geometry on either branch, rows x 576 at DVB-T2 16K; and ``cfo_bins``
    rows x the bins its spectrum is made over: the partial product's basis
    columns (328 at the stock geometry under matmul: [2, 640, 328]), else
    the preamble's length (the FFT: 640 stock, 92160 broadcast, 18432 at
    DVB-T2 16K under pallas, where a product onto its 15552 inspected bins
    would do ~1750x the FFT's work); nothing with the recorder off.
    Both are launch counts, so a graph's replay adds them as the eager call
    does.  A batch receive counts its rows' windows and bins once a call."""
    from c_ofdm_tpu_torch.ops import cfo
    spec = make_frame_spec(cfg, torch.complex64, device="cpu",
                           fft_backend=backend)
    assert spec.tensors["cfo_win_idx"].shape[0] == windows
    if bins < cfg.preamble_len:
        assert spec.tensors["cfo_basis"].shape == (2, cfg.preamble_len, bins)
    else:
        assert "cfo_basis" not in spec.tensors and bins == cfg.preamble_len
    x = torch.randn((rows, cfg.preamble_len), dtype=torch.complex64)
    cfo.pilot_freq_shift(spec, x)
    counts = trace.drain()["counts"]
    assert counts["cfo_windows"] == counts["cfo_bins"] == 0
    trace.enable()
    cfo.pilot_freq_shift(spec, x)
    counts = trace.drain()["counts"]
    assert counts["cfo_windows"] == rows * windows
    assert counts["cfo_bins"] == rows * bins
    assert graphs.launch_counts()[(trace.count, "work_counts",
                                   "cfo_bins")] == 0
    if cfg is CFG:
        step = FlagshipStep(spec)
        caps = _captures()
        step.receive(caps)
        step.receive(caps)
        counts = trace.drain()["counts"]
        assert counts["cfo_windows"] == 2 * 3 * windows
        assert counts["cfo_bins"] == 2 * 3 * bins


@pytest.mark.parametrize("t2sin,lead,n", [(256, (2,), 246656),
                                           (128, (), 5000),
                                           (512, (3,), 6016 + 37),
                                           (256, (0,), 4096)])
def test_hop_track_counts_its_windows(t2sin, lead, n):
    """With the recorder on, one hop track counts rows x (n // hop - 1)
    windows (2 x 1926 at the stock ring); nothing with the recorder off."""
    spec = make_frame_spec(ModemConfig(t2sin_size=t2sin), torch.complex64,
                           device="cpu")
    x = torch.randn((*lead, n), dtype=torch.complex64)
    sync.t2_ratio_track_hop(spec, x)
    assert trace.drain()["counts"]["hop_windows"] == 0
    trace.enable()
    got = sync.t2_ratio_track_hop(spec, x)
    nwin = n // (t2sin // 2) - 1
    assert got.shape == (*lead, nwin)
    assert trace.drain()["counts"]["hop_windows"] == math.prod(lead) * nwin


class _NoGraph:
    """Stands in for a captured CUDA graph: replaying it runs nothing."""

    def replay(self):
        pass


@pytest.mark.parametrize("n,route", [
    (12, "dense"), (512, "radix"), (1536, "mixed"), (510, "bluestein"),
    (16384, "cluster"), (82944, "cluster"), (4099, "chirp"),
    (117649, "fourstep"), (165888, "fourstep")])
def test_fourstep_rows_counts_the_four_step_route(n, route):
    """With the recorder on, K4's ``dft`` on a CPU tensor [2, 3, n] counts
    ``fourstep_rows`` 6 (rows x symbols) a transform on the four-step route
    (165888 = 64 x 2592, the benchmark's 61.44 Msps broadcast geometry;
    117649 = 49 x 2401) and 0 on every other route (the other cells'
    82944 and 16384 on the cluster route among them); nothing with the
    recorder off.  It is a launch count, so a graph whose delta was taken
    around the call, as a capture takes it, adds it on every replay."""
    from c_ofdm_tpu_torch.ops import dft
    assert dft._route(n) == route
    x = torch.randn((2, 3, n), dtype=torch.complex64)
    dft.dft(x)
    assert trace.drain()["counts"]["fourstep_rows"] == 0
    trace.enable()
    before = graphs.launch_counts()
    dft.dft(x)
    dft.dft(x, +1, 1.0 / n)
    delta = {k: v - before[k] for k, v in graphs.launch_counts().items()
             if v != before[k]}
    rows = 2 * 3 if route == "fourstep" else 0
    assert trace.drain()["counts"]["fourstep_rows"] == 2 * rows
    key = (trace.count, "work_counts", "fourstep_rows")
    assert delta.get(key, 0) == 2 * rows
    replayed = graphs.Graph(_NoGraph(), (), (), delta, 0, 0.0, 0, [])
    for _ in range(3):
        replayed.replay(())
    assert trace.drain()["counts"]["fourstep_rows"] == 3 * 2 * rows


def _event(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _mark(k, ts):
    return _event(f"void (anonymous namespace)::stage_mark_kernel<{k}>()",
                  ts, 1.0)


def test_stage_split_reads_each_replay_between_its_marks():
    """Kernels between marks go to the mark's stage (overlapping intervals
    counted once, a copy and a set too); a replay missing a mark is left
    out and counted as dropped; a graph with only an end mark is neither;
    host events and anything outside the marks count nowhere."""
    ev = [_event("copy_in", 0, 5, "gpu_memcpy")]
    t = 10.0
    for k in range(5):
        ev.append(_mark(k, t))
        ev += [_event("a", t + 2, 4), _event("b", t + 4, 4)]   # overlap
        ev.append(_event("c", t + 9, 1, "gpu_memset"))
        t += 20
    ev.append(_mark(5, t))
    ev.append(_event("clone", t + 2, 3, "gpu_memcpy"))
    ev.append(_event("host op", 15, 100, "cpu_op"))
    # a second replay whose recover mark was lost
    t = 200.0
    for k in (0, 1, 3, 4, 5):
        ev.append(_mark(k, t))
        ev.append(_event("d", t + 2, 3))
        t += 10
    ev.append(_mark(5, 400))             # an end-only graph (a tally)
    got = trace.stage_split(ev)
    assert got["replays"] == 1 and got["dropped"] == 1
    assert got["marks_us"] == 6.0
    assert got["busy_us"] == {s: 7.0 for s in STAGE_SPANS}
    assert got["span_us"] == {s: 19.0 for s in STAGE_SPANS}


def test_spans_merge_into_a_profiler_trace_on_its_clock(tmp_path):
    """A CPU profile of a traced batch call: the merged spans sit on the
    trace's clock, around the operations the profiler saw in them."""
    from torch.profiler import ProfilerActivity, profile
    step = FlagshipStep(make_frame_spec(CFG, torch.complex64, device="cpu"))
    caps = _captures()
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step.receive(caps)
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    recorded = trace.drain()
    trace.merge_chrome_trace(path, recorded)
    events = json.loads(path.read_text())["traceEvents"]
    mine = [e for e in events if e.get("cat") == "c_ofdm_tpu_torch"]
    assert [e["name"] for e in mine if e["ph"] == "X"] == [
        s["name"] for s in recorded["spans"]]
    entry = next(e for e in mine if e["name"] == "entry")
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "cpu_op" and e["name"] == "aten::matmul"]
    assert ops and all(entry["ts"] <= e["ts"] <= entry["ts"] + entry["dur"]
                       for e in ops)
    assert mine[-1]["name"] == "counts" and mine[-1]["args"] == \
        recorded["counts"]
