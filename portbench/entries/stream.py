"""The ``stream`` entry: ``StreamingReceiver.feed`` over a pool of ingest
buffers, one buffer (all channels) a call.

With ``inputs: device`` the pool's buffers already sit on the card and are
handed to ``feed`` as they are.  With ``inputs: host`` each buffer is a
numpy int16 array that the port's ``apps/rxstream.py::BlockStager`` (two
pinned slots, a side copy stream) stages to the card first, as the ``rx``
app does; that staging is part of the call.

Every call's positions, valid flags, bytes and coarse CFO are read back and
held against the frames the traffic planted for that buffer; the soft
values (``StreamOut.diag``, re + im of the equalised points) of the calls
the run samples are compared with the reference.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


class Entry:
    def __init__(self, conf: dict, mix: dict, traffic, device):
        from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
        from c_ofdm_tpu_torch.models.streaming import StreamingReceiver
        self.traffic = traffic
        self.channels = mix["channels"]
        spec = make_frame_spec(ModemConfig(**conf["modem"]), torch.complex64,
                               device=device, fft_backend=conf["fft_backend"])
        self.receiver = StreamingReceiver(spec, channels=self.channels)
        self.stager = None
        if mix["inputs"] == "host":
            from c_ofdm_tpu_torch.apps.rxstream import BlockStager
            self.stager = BlockStager(torch.device(device))
        self.stage_s = []
        self.spans = contextlib.nullcontext

    def reset(self, traffic) -> None:
        """Serve ``traffic`` next, from a fresh stream state."""
        from c_ofdm_tpu_torch.models.streaming import init_state
        self.traffic = traffic
        self.receiver.state = init_state(self.receiver.bound_spec(),
                                         channels=self.channels)

    def call(self, i: int, before=None):
        """Hand pool buffer ``i`` to the program; returns its StreamOut."""
        x = self.traffic.input(i)
        if self.stager is not None:
            with self.spans("stage"):
                t0 = time.perf_counter()
                x = self.stager(x)
                self.stage_s.append(time.perf_counter() - t0)
        if before is not None:
            before()
        return self.receiver.feed(x)

    @staticmethod
    def readback(out) -> dict:
        """The outputs read back on every call."""
        return {"positions": out.positions, "valid": out.valid,
                "mac_bytes": out.mac_bytes, "cfo": out.cfo}

    def _lead(self, host: dict):
        C = max(self.channels, 1)
        pos = np.asarray(host["positions"]).reshape(C, -1)
        val = np.asarray(host["valid"]).reshape(C, -1)
        mac = np.asarray(host["mac_bytes"]).reshape(C, pos.shape[1], -1)
        return pos, val, mac

    def check(self, i: int, host: dict):
        """(frames due, frames failed) of the call on buffer ``i``: each
        planted frame not decoded exactly once at its position with exact
        bytes fails, and so does each frame found where none was planted."""
        pos, val, mac = self._lead(host)
        want = self.traffic.exp_pos[i]
        due = want >= 0
        n_due = int(due.sum())
        if (np.array_equal(val, due) and np.array_equal(np.where(val, pos, -1),
                                                        want)
                and np.array_equal(mac[due], self.traffic.exp_bytes[i][due])):
            return n_due, 0
        failed = 0
        for c in range(pos.shape[0]):
            got = {int(p): k for k, p in enumerate(pos[c]) if val[c, k]}
            for k in np.flatnonzero(due[c]):
                g = got.pop(int(want[c, k]), None)
                if g is None or not np.array_equal(
                        mac[c, g], self.traffic.exp_bytes[i][c, k]):
                    failed += 1
            failed += len(got)
        return n_due, failed

    @staticmethod
    def resolve():
        """Nothing is held for after the window: (0 failed, 0 undetected)."""
        return 0, 0

    def soft(self, i: int, out):
        """(program soft values [F, V] on the CPU, the (channel, slot)
        index of each planted frame in the traffic) for the planted frames
        of buffer ``i`` that the call found at their positions."""
        host = {k: v.cpu().numpy() for k, v in self.readback(out).items()}
        pos, val, _ = self._lead(host)
        C = pos.shape[0]
        diag = out.diag.cpu().reshape(C, pos.shape[1], -1)
        want = self.traffic.exp_pos[i]
        index, rows = [], []
        for c in range(C):
            got = {int(p): k for k, p in enumerate(pos[c]) if val[c, k]}
            for k in np.flatnonzero(want[c] >= 0):
                g = got.get(int(want[c, k]))
                if g is not None:
                    index.append((c, k))
                    rows.append(diag[c, g])
        if not rows:
            return torch.zeros((0, 0)), np.zeros((0, 2), np.int64)
        return torch.stack(rows), np.asarray(index, np.int64)

    @staticmethod
    def reference_values(const: torch.Tensor) -> torch.Tensor:
        """The reference's points in the form ``soft`` returns: re + im."""
        return const.real + const.imag

    def close(self):
        self.receiver.graphs.clear()
        self.receiver = self.stager = None
