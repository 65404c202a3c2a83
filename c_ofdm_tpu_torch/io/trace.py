"""Structured per-stage tracing and link metrics (counterpart of
``c_ofdm_tpu/io/trace.py``; ``StageTrace`` is a copy).

Reference counterpart: the compile-time macro trace in `rx.cpp:25-43` —
KEY:value tokens buffered in memory and flushed once to LOG.txt, analyzed by
`python_code/timetrace.py`.  Here: a zero-I/O-in-loop event buffer with both
jsonl and reference-style ``KEY:value`` text output, plus the amortize-buffer-
cost-over-frames reporting idea (`timetrace.py:43-71`) built in.

CUDA work is asynchronous: a kernel launch returns before the card has run
it.  Stage timings taken with the host clock are therefore measured around
explicit fences by the caller (``torch.cuda.synchronize``, or a CUDA event's
``synchronize`` for one stream's work), or on the card itself with CUDA
events (``torch.cuda.Event(enable_timing=True)``); ``torch.profiler`` gives
the intra-step breakdown.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List


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

    def to_jsonl(self, path: str):
        with open(path, "w") as f:
            for r in self.rows:
                f.write(json.dumps(r) + "\n")

    def to_log_txt(self, path: str):
        """Reference LOG.txt format: space-separated KEY:value per line."""
        with open(path, "w") as f:
            for r in self.rows:
                f.write(" ".join(f"{k}:{v}" for k, v in r.items()) + "\n")

    def summary(self, amortize_over: str = "") -> Dict[str, float]:
        """Mean of numeric keys; if ``amortize_over`` names a count column,
        per-buffer costs are divided by the mean of that column
        (timetrace.py:43-71 semantics)."""
        rows = self.rows
        keys = {k for r in rows for k in r if isinstance(r[k], (int, float))}
        out = {}
        denom = 1.0
        if amortize_over:
            vals = [r[amortize_over] for r in rows if amortize_over in r]
            denom = max(sum(vals) / len(vals), 1e-12) if vals else 1.0
        for k in sorted(keys):
            vals = [r[k] for r in rows if k in r]
            out[k] = sum(vals) / len(vals)
            if amortize_over and k.endswith("_per_buf"):
                out[k] /= denom
        return out


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
