"""The ``batch`` entry: ``FlagshipStep.receive`` on one capture batch
[rows, n] a call (single-frame sync, K1's window gather, recovery, channel
estimate and demap of every row).

Every call's frame starts, found flags, bytes and coarse CFO are read back
and held against the frames the traffic planted; the soft values
(``RxResult.constellation``) of the calls the run samples are compared with
the reference.
"""

from __future__ import annotations

import numpy as np
import torch


class Entry:
    def __init__(self, conf: dict, mix: dict, traffic, device):
        from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
        from c_ofdm_tpu_torch.models.modem import FlagshipStep
        self.traffic = traffic
        self.frames = mix["frames"]
        spec = make_frame_spec(ModemConfig(**conf["modem"]), torch.complex64,
                               device=device, fft_backend=conf["fft_backend"])
        self.step = FlagshipStep(spec)
        self.stage_s = []
        self.missed = {}

    def reset(self, traffic) -> None:
        """Serve ``traffic`` next."""
        self.traffic = traffic
        self.missed = {}

    def call(self, i: int, before=None):
        """Hand pool batch ``i`` to the program; returns (RxResult,
        SyncResult)."""
        x = self.traffic.input(i)
        if before is not None:
            before()
        return self.step.receive(x)

    @staticmethod
    def readback(out) -> dict:
        """The outputs read back on every call."""
        res, sync = out
        return {"frame_start": sync.frame_start, "found": sync.found,
                "mac_bytes": res.mac_bytes, "cfo": res.cfo}

    def check(self, i: int, host: dict):
        """(frames due, frames failed) of the call on batch ``i``: a planted
        frame fails if found anywhere but at its offset or with wrong bytes,
        and a zero row in which a frame is found fails.  A planted frame the
        call did not find is held for ``resolve``."""
        nb = self.frames
        found = np.asarray(host["found"])
        at = np.asarray(host["frame_start"])[:nb] == self.traffic.exp_pos[i]
        exact = (np.asarray(host["mac_bytes"])[:nb]
                 == self.traffic.exp_bytes[i]).all(-1)
        for r in np.flatnonzero(~found[:nb]):
            self.missed[(i, int(r))] = self.missed.get((i, int(r)), 0) + 1
        wrong = found[:nb] & ~(at & exact)
        return nb, int(wrong.sum() + found[nb:].sum())

    def resolve(self):
        """(frames failed, frames undetected) among the planted frames the
        window's calls did not find: the plain reference's single-frame
        sync (``oracle.sync_capture``) runs on each such capture row once.
        Where it finds the frame, the program should have (failed); where
        it finds none either, the configuration's sync cannot see that
        frame (undetected: the block-aligned two-tone detect misses a burst
        that straddles two blocks at some alignments), and the program
        agrees with the reference."""
        from ..reference import oracle
        failed = undetected = 0
        for (i, r), count in self.missed.items():
            if oracle.sync_capture(self.traffic.cfg, self.traffic.row(i, r)) < 0:
                undetected += count
            else:
                failed += count
        return failed, undetected

    def soft(self, i: int, out):
        """(program constellation [F, V] on the CPU, planted rows) of the
        planted frames the call found at their offsets."""
        res, sync = out
        nb = self.frames
        found = sync.found[:nb].cpu().numpy() & (
            sync.frame_start[:nb].cpu().numpy() == self.traffic.exp_pos[i])
        rows = np.flatnonzero(found)
        return res.constellation[:nb].cpu()[rows], rows

    @staticmethod
    def reference_values(const: torch.Tensor) -> torch.Tensor:
        return const

    def close(self):
        self.step.graphs.clear()
        self.step = None
