"""One run of one cell: set-up, the measured window, the trace, the
correctness check and the result line.

Everything that belongs to one configuration, traffic mix, cell limit or
metric is a file found by its name (``README.md``): ``BENCHMARK.json``'s
entries name them, and this module holds no per-cell code.

The window is a closed loop with two calls in flight, the double buffer of
the reference's RX loop (`rx.cpp:55-66`) and of the port's ``rx`` app: the
loop hands call k+1 to the program, then waits for call k's outputs on the
host and checks them against the traffic.  Host spans (``stage``, ``call``,
``readback``, ``wait``, ``check``) label what the host was doing in a traced
run.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import gc
import importlib
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import peaks
from .reference import receiver
from .reference.config import ModemConfig
from .traffic import generate

PORTBENCH = Path(__file__).resolve().parent
ROOT = PORTBENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "c_ofdm_tpu")
WARMUP_PROFILE_STEPS = 5     # profiler steps that record nothing, first
IN_FLIGHT = 2


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden package."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` and the files its names point to.  ``search``
    lists the folders tried in turn for ``mixes/``, ``limits/`` and
    ``metrics/``."""

    def __init__(self, spec: dict, search=(PORTBENCH,)):
        self.spec = spec
        self.search = tuple(Path(p) for p in search)

    @classmethod
    def load(cls):
        return cls(load_json(ROOT / "BENCHMARK.json"))

    def _find(self, kind: str, name: str, suffix: str) -> Path:
        for base in self.search:
            path = base / kind / f"{name}{suffix}"
            if path.is_file():
                return path
        raise FileNotFoundError(f"no {kind}/{name}{suffix} under "
                                f"{[str(b) for b in self.search]}")

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                path = Path(c["file"])
                return load_json(path if path.is_absolute() else ROOT / path)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> dict:
        return load_json(self._find("mixes", name, ".json"))

    def limits(self, cell: str) -> dict:
        return load_json(self._find("limits", cell, ".json"))

    def metrics(self, cell: str, trace: bool) -> list:
        """The metric entries this cell reports in a run of this kind."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, name: str):
        return peaks.load_read(self._find("metrics", name, ".py"))


def entry_class(kind: str):
    return importlib.import_module(f"portbench.entries.{kind}").Entry


class Reservoir:
    """A uniform sample of ``size`` items from a stream (algorithm R),
    drawn from the run's seed."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.items, self.seen = size, rng, [], 0

    def offer(self, make):
        """Keep the item ``make()`` builds if the draw takes it."""
        k = self.seen
        self.seen += 1
        if k < self.size:
            self.items.append(make())
        else:
            j = int(self.rng.integers(0, k + 1))
            if j < self.size:
                self.items[j] = make()


def _pinned_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype,
                       pin_memory=t.device.type == "cuda")


class Spans:
    """Host spans of the profiled calls: (name, start, end) in
    ``time.time_ns()``, the clock the profiler's trace is written in
    (``baseTimeNanoseconds`` + its microseconds).  Recording is off outside
    the profiled calls; a span costs two clock reads."""

    def __init__(self):
        self.on = False
        self.items = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))


def run_window(entry, traffic, seconds: float, seed: int, trace_path,
               profile_calls: int, soft_calls: int, cuda: bool) -> dict:
    """The measured window.  Returns the window's record: calls, frames
    due and failed, latencies, the soft samples and, with ``trace_path``,
    per-call device times (CUDA events), the host spans and bounds of the
    profiled calls, and the profiler's chrome trace of them.

    The profiler records device activity only (host operator events would
    slow the host and read as device idle time): it starts after
    ``WARMUP_PROFILE_STEPS`` calls and records ``profile_calls`` calls."""
    rng = np.random.default_rng(generate._seed(seed) ^ 0x5EED)
    sample = Reservoir(soft_calls, rng)
    host_bufs = [None] * IN_FLIGHT
    pending = collections.deque()
    lat, dev_s = [], []
    due = failed = 0
    spans = entry.spans = Spans()
    bounds = [None, None]

    prof = None
    if trace_path is not None:
        from torch.profiler import ProfilerActivity, profile, schedule
        prof = profile(
            activities=[ProfilerActivity.CUDA if cuda else
                        ProfilerActivity.CPU],
            schedule=schedule(wait=0, warmup=WARMUP_PROFILE_STEPS,
                              active=profile_calls, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(str(trace_path)))
        prof.start()

    def collect():
        nonlocal due, failed
        i, t0, done, host, ev = pending.popleft()
        with spans("wait"):
            if done is not None:
                done.synchronize()
        lat.append(time.perf_counter() - t0)
        if ev is not None:
            dev_s.append(ev[0].elapsed_time(ev[1]) / 1e3)
        with spans("check"):
            d, f = entry.check(i, host)
        due += d
        failed += f

    t_start = time.perf_counter()
    k = 0
    while time.perf_counter() - t_start < seconds:
        if prof is not None and k == WARMUP_PROFILE_STEPS:
            spans.on = True
            bounds[0] = time.time_ns()
        i = k % traffic.calls
        ev = None
        if prof is not None and cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        with spans("call"):
            out = entry.call(i, before=ev[0].record if ev else None)
            if ev:
                ev[1].record()
        with spans("readback"):
            dev = entry.readback(out)
            slot = k % IN_FLIGHT
            if host_bufs[slot] is None:
                host_bufs[slot] = {n: _pinned_like(t) for n, t in dev.items()}
            host = host_bufs[slot]
            for n, t in dev.items():
                host[n].copy_(t, non_blocking=cuda)
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record()
        sample.offer(lambda: (i, out))
        pending.append((i, t0, done, {n: h.numpy() for n, h in host.items()},
                        ev))
        k += 1
        if len(pending) == IN_FLIGHT:
            collect()
        if prof is not None:
            if k == WARMUP_PROFILE_STEPS + profile_calls:
                # the step that ends the profiled calls writes the trace
                bounds[1] = time.time_ns()
                spans.on = False
            prof.step()
    while pending:
        collect()
    window_s = time.perf_counter() - t_start
    if spans.on:
        bounds[1] = time.time_ns()
        spans.on = False
    if prof is not None:
        prof.stop()
    steps = min(max(k - WARMUP_PROFILE_STEPS, 0), profile_calls)
    return {"calls": k, "window_s": window_s, "latencies_s": lat,
            "call_device_s": dev_s, "due": due, "failed": failed,
            "sample": sample.items,
            "profiled": {"steps": steps, "bounds": bounds,
                         "spans": spans.items}}


def read_trace(path: Path, profiled: dict) -> dict:
    """Device busy time, kernel times and idle gaps of the profiled calls,
    from the chrome trace, between the host clock's bounds of those calls;
    each idle gap is labelled by the innermost host span open at its
    middle ("host" where none is: the loop between spans)."""
    with open(path) as f:
        trace = json.load(f)
    if not profiled["steps"] or None in profiled["bounds"]:
        return None
    base = trace.get("baseTimeNanoseconds", 0)

    def us(t_ns):
        return (t_ns - base) / 1e3

    w0, w1 = (us(t) for t in profiled["bounds"])
    device, kernels = [], collections.Counter()
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                    "gpu_memset"):
            a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
            if b > a:
                device.append((a, b))
                kernels[e["name"]] += (b - a) * 1e-6
    device.sort()
    merged = []
    for a, b in device:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    spans = sorted((us(t0), us(t1), name)
                   for name, t0, t1 in profiled["spans"])
    starts = [s[0] for s in spans]
    gaps, t = collections.Counter(), w0
    for a, b in merged + [[w1, w1]]:
        if a > t:
            mid = (a + t) / 2
            j = bisect.bisect_right(starts, mid)
            open_ = [s for s in spans[max(0, j - 4):j] if s[1] > mid]
            label = min(open_, key=lambda s: s[1] - s[0])[2] if open_ \
                else "host"
            gaps[label] += (a - t) * 1e-6
        t = max(t, b)
    return {"steps": profiled["steps"], "window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in merged) * 1e-6,
            "kernels": dict(kernels), "gaps": dict(gaps)}


def soft_rows(entry, sample, seed: int, soft_frames: int) -> list:
    """Up to ``soft_frames`` planted frames of the sampled calls, drawn
    from the seed: (pool index, the program's soft values on the CPU, the
    frame's index in the traffic)."""
    rng = np.random.default_rng(generate._seed(seed) ^ 0xC0DE)
    rows = []
    for i, out in sample:
        values, index = entry.soft(i, out)
        rows += [(i, values[r], index[r]) for r in range(len(index))]
    if not rows:
        return []
    pick = rng.choice(len(rows), min(soft_frames, len(rows)), replace=False)
    return [rows[r] for r in sorted(pick)]


def soft_gap(entry_cls, traffic, rows: list, control: bool = False) -> float:
    """The widest gap between the program's soft values and the float64
    reference's over ``rows``; with ``control``, the gap of the control
    (the reference in TF32, in the program's place) instead."""
    if not rows:
        return math.inf
    gap = 0.0
    by_call = collections.defaultdict(list)
    for row in rows:
        by_call[row[0]].append(row)
    for i, group in by_call.items():
        frames = traffic.frame_windows(i, np.stack([g[2] for g in group]))
        const, _ = receiver.demodulate(traffic.cfg, frames)
        ref = entry_cls.reference_values(const)
        if control:
            low, _ = receiver.demodulate(traffic.cfg, frames, tf32=True)
            got = entry_cls.reference_values(low).to(torch.complex128)
        else:
            got = torch.stack([g[1] for g in group]).to(torch.complex128)
        gap = max(gap, float((got - ref.to(torch.complex128)).abs().max()))
    return gap


def device_info(chips: int, cuda: bool) -> dict:
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(chips))}
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        info["power_limit_w"] = None
    return info


def run(bench: Bench, cell: str, seed: int, seconds: float, trace: bool,
        device: str, t_process: float, trace_dir: Path = None):
    """One run of ``cell``: (the result, the line's keys with "checks"
    last; the lines naming each number checked beside its limit)."""
    work = bench.workload(cell)
    conf = bench.config(work["config"])
    mix = bench.mix(work["traffic"])
    limits = bench.limits(cell)
    cuda = torch.device(device).type == "cuda"
    cfg = ModemConfig(**conf["modem"])

    traffic = generate.make(cfg, mix, seed, device)
    entry = entry_class(mix["entry"])(conf, mix, traffic, device)
    for i in range(traffic.calls):          # every input once: the capture
        entry.call(i)                       # and the shapes the window uses
    entry.stage_s.clear()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_process

    trace_path = None
    if trace:
        trace_dir = Path(trace_dir or ROOT / "portbench_out")
        trace_dir.mkdir(parents=True, exist_ok=True)
        trace_path = trace_dir / f"{cell}.trace.json"
    # the loop's thread keeps one core and no collector pauses in the window
    gc.collect()
    gc.disable()
    cores = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {max(cores)})
    try:
        rec = run_window(entry, traffic, seconds, seed, trace_path,
                         mix["profile_calls"], mix["soft_calls"], cuda)
    finally:
        os.sched_setaffinity(0, cores)
        gc.enable()
    if cuda:
        torch.cuda.synchronize()
    dev_info = device_info(work["chips"], cuda)
    stage_s = list(entry.stage_s)
    rows = soft_rows(entry, rec.pop("sample"), seed, mix["soft_frames"])
    more_failed, undetected = entry.resolve()
    rec["failed"] += more_failed
    entry.close()
    del entry
    if cuda:
        torch.cuda.empty_cache()
    gap = soft_gap(entry_class(mix["entry"]), traffic, rows)
    n_soft = len(rows)

    record = {"cell": cell, "config": conf, "mix": mix, "cfg": cfg,
              "setup_s": setup_s, "stage_s": stage_s,
              "samples_per_call": traffic.samples_per_call(), **rec}
    record["trace"] = (read_trace(trace_path, rec["profiled"])
                       if trace_path is not None and trace_path.is_file()
                       else None)

    metrics = {}
    for m in bench.metrics(cell, trace):
        value = bench.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    checks = {
        "frames_failed": {"value": rec["failed"], "limit": 0},
        "soft_gap": {"value": gap, "limit": limits["soft_gap"],
                     "frames": n_soft},
    }
    correct = (rec["failed"] <= 0 and n_soft > 0
               and gap <= limits["soft_gap"] and rec["calls"] > 0)
    result = {"correct": bool(correct), "attempted": rec["due"],
              "failed": rec["failed"], "metrics": metrics,
              "device": dev_info, "undetected": undetected}
    traced = record["trace"]
    if cuda and traced is not None:
        steps = traced["steps"]
        result["device"]["busy_s"] = traced["busy_s"]
        result["device"]["window_s"] = traced["window_s"]
        ops = sorted(traced["kernels"].items(), key=lambda kv: -kv[1])
        gaps = sorted(traced["gaps"].items(), key=lambda kv: -kv[1])
        result["breakdown"] = {
            "device_ops": [[n[:120], s / steps] for n, s in ops[:10]],
            "idle_gaps": [[n, s / steps] for n, s in gaps[:10]]}
    result["checks"] = checks
    lines = [f"check frames_failed {rec['failed']} limit 0 "
             f"(of {rec['due']} frames due in {rec['calls']} calls)",
             f"check soft_gap {gap!r} limit {limits['soft_gap']!r} "
             f"({n_soft} frames against the reference)"]
    return result, lines
