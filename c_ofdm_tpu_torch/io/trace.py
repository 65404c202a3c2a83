"""Structured per-stage tracing and link metrics (counterpart of
``c_ofdm_tpu/io/trace.py``; ``StageTrace`` is a copy).

Reference counterpart: the compile-time macro trace in `rx.cpp:25-43` —
KEY:value tokens buffered in memory and flushed once to LOG.txt, analyzed by
`python_code/timetrace.py`.  ``StageTrace`` is that buffer, written out as
the reference's LOG.txt (``rx --log``).

CUDA work is asynchronous: a kernel launch returns before the card has run
it, and on the card an entry call is one CUDA-graph replay
(``utils/graphs.py``), in which no Python runs.  ``Recorder`` therefore
records two kinds of events, off unless ``enable()`` is called:

- host spans (name, start and end in ``time.time_ns()``, parent span, the
  entry call they belong to, a label): ``entry`` around every captured
  call (``CapturedCall``: ``FlagshipStep.forward`` / ``.receive``,
  ``StreamingReceiver.feed``, the ``_jit`` functions), and inside it
  ``capture`` (warm-up and capture, labelled with the graph's key),
  ``copy_in`` (the static-input copies), ``launch`` (``graph.replay()``)
  and ``clone`` (the output clones and the replayed counts);
  ``apps/rxstream.py::BlockStager``'s ``slot_wait``, ``fill`` and ``h2d``.
  ``time.time_ns()`` is the clock torch.profiler's chrome trace is written
  in (``baseTimeNanoseconds`` + its microseconds), so the spans line up with
  the device trace (``merge_chrome_trace``).
- stage marks (``STAGES``), at each stage boundary of the receive chain:
  a host span from one mark to the next, and on the card a kernel that does
  nothing (``stage_mark_kernel<index>``, ``csrc/extract_windows.cu``)
  launched on the current stream, so that a graph captured with tracing on
  carries the marks and the profiler's device trace splits each replay by
  stage (``stage_split``).  The tracing state is part of a graph's key: an
  untraced capture holds no mark.

and eight counts of the receiver's work: ``regions_scored`` (the gated
sync's candidate regions matched-filtered), ``slots_demodulated`` (frame
slots demodulated), ``mf_chunks`` (the overlap-save matched filter's
chunks, rows x chunks a row), ``cfo_windows`` (the coarse CFO's pilot
windows searched, rows x windows), ``cfo_bins`` (the bins of the coarse
CFO's spectrum, rows x the partial product's columns or rows x
preamble_len on the FFT), ``hop_windows`` (the stream's hop-track
windows, rows x windows) and ``fourstep_rows`` (the rows K4's four-step
route transformed, summed over its transforms), host counts that graphs
replay as they replay the kernels' launch counts (``count.work_counts``,
read by ``utils/graphs.py::launch_counts``),
and ``hits_accepted`` (frames the gated sync accepted), device data summed
into a device int64 counter a device and read once by ``drain()``.

When the recorder is off, each site costs one flag test: no allocation, no
clock read, no device work.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import re
import time
from typing import Dict, List

import torch

STAGES = ("sync", "extract", "recover", "dft", "equalize", "end")
WORK_COUNTS = ("regions_scored", "slots_demodulated", "mf_chunks",
               "cfo_windows", "cfo_bins", "hop_windows", "fourstep_rows")


class StageTrace:
    """In-memory per-iteration KEY:value trace, flushed once (rx.cpp pattern)."""

    def __init__(self):
        self._rows: List[Dict] = []
        self._cur: Dict = {}
        self._t_last = None

    def iter_start(self, **vals):
        if self._cur:
            self._rows.append(self._cur)
        self._cur = dict(vals)
        self._t_last = time.perf_counter()

    def point(self, key: str):
        """Record seconds since the previous point (or iter_start)."""
        now = time.perf_counter()
        self._cur[key] = now - self._t_last
        self._t_last = now

    def value(self, key: str, val):
        self._cur[key] = val

    def finish(self):
        if self._cur:
            self._rows.append(self._cur)
            self._cur = {}

    @property
    def rows(self) -> List[Dict]:
        self.finish()
        return self._rows

    def to_log_txt(self, path: str):
        """Reference LOG.txt format: space-separated KEY:value per line."""
        with open(path, "w") as f:
            for r in self.rows:
                f.write(" ".join(f"{k}:{v}" for k, v in r.items()) + "\n")


class Recorder:
    """The program's spans, stage marks and device hit counters (see the
    module's docstring).  ``on`` is the flag every site tests."""

    def __init__(self):
        self.on = False
        self._hits: Dict[torch.device, torch.Tensor] = {}
        self._spans: list = []     # [name, start, end, parent, call, label]
        self._open: list = []      # indices of the open spans, innermost last
        self._stage = None         # index of the open stage span
        self._call = None          # id of the running entry call
        self._calls = 0

    def enable(self) -> None:
        """Start recording (what was recorded before is dropped)."""
        self.drain()
        self.on = True

    def disable(self) -> None:
        self.on = False

    def drain(self) -> dict:
        """Hand out and forget what was recorded: {"spans": [{name,
        start_ns, end_ns, parent (an index into the list or None), call,
        label}], "counts": {regions_scored, slots_demodulated, mf_chunks,
        cfo_windows, cfo_bins, hop_windows, fourstep_rows,
        hits_accepted}}.  Spans still open end now; call ids start again
        from 0.  Reads the device hit counters (one synchronisation a
        device)."""
        now = time.time_ns()
        for i in self._open:
            self._spans[i][2] = now
        spans = [dict(name=n, start_ns=a, end_ns=b, parent=p, call=c,
                      label=lab) for n, a, b, p, c, lab in self._spans]
        counts = dict(count.work_counts)
        counts["hits_accepted"] = sum(int(h) for h in self._hits.values())
        for h in self._hits.values():
            h.zero_()
        count.work_counts.update(dict.fromkeys(WORK_COUNTS, 0))
        self._spans, self._open, self._stage = [], [], None
        self._call, self._calls = None, 0
        return {"spans": spans, "counts": counts}

    def begin(self, name: str, label=None) -> int:
        """Open a span inside the innermost open one; returns its index."""
        i = len(self._spans)
        parent = self._open[-1] if self._open else None
        self._spans.append([name, time.time_ns(), None, parent, self._call,
                            label])
        self._open.append(i)
        return i

    def end(self, i: int) -> None:
        """Close span ``i`` and every span opened inside it."""
        if i not in self._open:
            return
        now = time.time_ns()
        while self._open and self._open[-1] >= i:
            j = self._open.pop()
            self._spans[j][2] = now
            if j == self._stage:
                self._stage = None

    @contextlib.contextmanager
    def span(self, name: str, label=None):
        i = self.begin(name, label)
        try:
            yield
        finally:
            self.end(i)

    @contextlib.contextmanager
    def entry(self, name: str):
        """An ``entry`` span labelled ``name``; the outermost one starts a
        new call id, which the spans inside it carry."""
        outer = self._call is None
        if outer:
            self._call, self._calls = self._calls, self._calls + 1
        try:
            with self.span("entry", name):
                yield
        finally:
            if outer:
                self._call = None

    def mark(self, stage: str, like: torch.Tensor | None) -> None:
        """End the open stage span and open ``stage``'s (``"end"`` opens
        none); on a CUDA ``like``, also launch the stage's mark kernel on the
        current stream of its device (captured into the graph when a
        capture is running)."""
        index = STAGES.index(stage)
        if self._stage is not None:
            self.end(self._stage)
        if stage != "end":
            self._stage = self.begin(stage, "stage")
        if like is not None and like.is_cuda:
            from ..ops import extract
            extract.stage_mark(index, like.device)

    def hit_counter(self, device: torch.device) -> torch.Tensor:
        """The device's int64 hit counter, made on first use (outside a
        capture: a traced capture asks for it before it starts)."""
        h = self._hits.get(device)
        if h is None:
            h = self._hits[device] = torch.zeros((), dtype=torch.int64,
                                                 device=device)
        return h

    def count_hits(self, valid: torch.Tensor) -> None:
        self.hit_counter(valid.device).add_(valid.sum())


recorder = Recorder()


def enable() -> None:
    """Turn the program's recorder on (spans, marks and counts)."""
    recorder.enable()


def disable() -> None:
    recorder.disable()


def drain() -> dict:
    """What the recorder holds (``Recorder.drain``), handed out once."""
    return recorder.drain()


def mark(stage: str, like: torch.Tensor) -> None:
    """The boundary of ``stage`` (``STAGES``) on ``like``'s device, when the
    recorder is on."""
    if recorder.on:
        recorder.mark(stage, like)


def count(name: str, n: int) -> None:
    """Add ``n`` to the work count ``name`` (``WORK_COUNTS``), when the
    recorder is on.  The counts are ``count.work_counts``, which graphs
    replay as they replay the kernel wrappers' launch counts."""
    if recorder.on:
        count.work_counts[name] += n


count.work_counts = dict.fromkeys(WORK_COUNTS, 0)


def count_hits(valid: torch.Tensor) -> None:
    """Add ``valid.sum()`` to the device's hit counter, when the recorder is
    on."""
    if recorder.on:
        recorder.count_hits(valid)


def merge_chrome_trace(path, drained: dict) -> None:
    """Write ``drained``'s spans into torch.profiler's chrome trace at
    ``path`` on the trace's own clock (``baseTimeNanoseconds``), as one
    track of complete events (their call, parent and label in ``args``),
    and the counts as one instant event, so that a trace viewer shows them
    beside the device's kernels."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    pid, tid = "c_ofdm_tpu_torch", "spans"
    events = trace.setdefault("traceEvents", [])
    for s in drained["spans"]:
        events.append({"ph": "X", "cat": "c_ofdm_tpu_torch", "name": s["name"],
                       "pid": pid, "tid": tid,
                       "ts": (s["start_ns"] - base) / 1e3,
                       "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                       "args": {"call": s["call"], "parent": s["parent"],
                                "label": s["label"]}})
    last = max((s["end_ns"] for s in drained["spans"]), default=base)
    events.append({"ph": "i", "s": "p", "cat": "c_ofdm_tpu_torch",
                   "name": "counts", "pid": pid, "tid": tid,
                   "ts": (last - base) / 1e3, "args": drained["counts"]})
    with open(path, "w") as f:
        json.dump(trace, f)


_MARK = re.compile(r"stage_mark_kernel<(\d+)>")
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


def stage_split(events) -> dict:
    """Each staged replay's device time by stage, from a chrome trace's
    events.  A staged replay is a run of marks sync, extract, recover, dft,
    equalize, end in that order; a stage's device time lies between its
    mark and the next.  Returns {"replays": staged replays read,
    "dropped": runs of marks out of that order (a record the profiler lost,
    or a graph marked otherwise), "marks_us": the marks' own time,
    "busy_us": {stage: union of the kernel, copy and set intervals between
    its mark and the next}, "span_us": {stage: the next mark's start less
    this mark's end}}, totals in microseconds over the replays read."""
    device, marks = [], []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in _DEVICE:
            continue
        m = _MARK.search(e.get("name", ""))
        if m:
            marks.append((e["ts"], e["ts"] + e["dur"], int(m.group(1))))
        else:
            device.append((e["ts"], e["ts"] + e["dur"]))
    marks.sort()
    busy = _merged(device)
    starts = [a for a, _ in busy]
    out = {"replays": 0, "dropped": 0, "marks_us": 0.0,
           "busy_us": collections.Counter(), "span_us": collections.Counter()}
    end, run = len(STAGES) - 1, []
    for m in marks:
        run.append(m)
        if m[2] != end:
            continue
        if [k for _, _, k in run] != list(range(len(STAGES))):
            out["dropped"] += bool(len(run) > 1)
            run = []
            continue
        out["replays"] += 1
        out["marks_us"] += sum(b - a for a, b, _ in run)
        for (_, a, k), (b, _, _) in zip(run, run[1:]):
            out["span_us"][STAGES[k]] += b - a
            out["busy_us"][STAGES[k]] += _covered(busy, starts, a, b)
        run = []
    out["dropped"] += bool(run)
    out["busy_us"], out["span_us"] = dict(out["busy_us"]), dict(out["span_us"])
    return out


def _merged(intervals) -> list:
    """The union of ``intervals`` as sorted disjoint [start, end] pairs."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _covered(merged, starts, a, b) -> float:
    """How much of [a, b] the disjoint sorted ``merged`` intervals cover."""
    total = 0.0
    for s, e in merged[max(0, bisect.bisect_right(starts, a) - 1):]:
        if s >= b:
            break
        total += max(0.0, min(e, b) - max(s, a))
    return total


def link_metrics(constellation, mod_type: int, ref_bytes=None,
                 decoded_bytes=None) -> Dict[str, float]:
    """EVM / BER / FER per processed batch (reference only prints byte/bit
    accuracy, `main.cpp:86-104`).  ``constellation`` and the byte arrays are
    numpy arrays or tensors on any device."""
    import numpy as np
    import torch
    from ..ops.modulation import constellation as ctable

    def host(x):
        # tensors on any device come to the host once
        return x.detach().cpu().resolve_conj().numpy() \
            if isinstance(x, torch.Tensor) else np.asarray(x)

    c = host(constellation)
    table = ctable(mod_type)
    # gain fit: scale received points to the table's rms power (the capture's
    # equalizer normalizes pilots, not data power), then refine with one
    # nearest-point LS pass; finally EVM vs nearest ideal point
    rms_t = np.sqrt((np.abs(table) ** 2).mean())
    scale = rms_t / max(np.sqrt((np.abs(c) ** 2).mean()), 1e-12)
    for _ in range(2):
        cs = c * scale
        nearest = table[np.abs(cs[..., None] - table).argmin(axis=-1)]
        num = (np.conj(c) * nearest).real.sum()
        den = (np.abs(c) ** 2).sum()
        scale = float(num / max(den, 1e-12))
    d = np.abs(c * scale - nearest)
    evm = float(np.sqrt((d ** 2).mean()) / rms_t)
    out = {"evm_rms": evm, "evm_db": float(20 * np.log10(max(evm, 1e-12)))}
    if ref_bytes is not None and decoded_bytes is not None:
        ref_b = host(ref_bytes).astype(np.uint8, copy=False)
        dec_b = host(decoded_bytes).astype(np.uint8, copy=False)
        diff = np.unpackbits(ref_b ^ dec_b, axis=-1)
        out["ber"] = float(diff.mean())
        out["byte_acc"] = float((ref_b == dec_b).mean())
        if ref_b.ndim > 1:
            out["fer"] = float((ref_b != dec_b).any(axis=-1).mean())
    return out
