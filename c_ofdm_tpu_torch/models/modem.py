"""The flagship step as an nn.Module: payload -> transmit -> receive_batch.

Counterpart of the JAX package's flagship step (``bench.py::build_runner``,
``__graft_entry__.entry``): B payloads go through ``models.tx.transmit`` and
the resulting frames through ``models.rx.receive_batch``.  The spec's device
constants are registered as buffers, so ``.to(device)`` moves them.

On the card each call is one CUDA-graph replay (``utils/graphs.py``), as the
JAX step is one compiled program: ``forward`` and ``receive`` capture a
graph on their first call for each input shape and dtype, against this
module's buffers; ``.to()`` and the other ``_apply`` conversions drop the
graphs.  On CPU tensors both run eagerly.
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils import graphs
from . import rx, tx
from .frame import FrameSpec


class FlagshipStep(nn.Module):
    def __init__(self, spec: FrameSpec):
        super().__init__()
        self.spec = spec
        for name, t in spec.tensors.items():
            self.register_buffer(name, t)
        self.graphs = graphs.CapturedCall("FlagshipStep")

    def _apply(self, fn, recurse=True):
        self.graphs.clear()
        return super()._apply(fn, recurse)

    def bound_spec(self) -> FrameSpec:
        """The spec reading its constants from this module's buffers."""
        return self.spec.with_tensors(dict(self.named_buffers()))

    def _step(self, body, x: torch.Tensor):
        return self.graphs(body, (x,), static=body.__name__)

    def _forward(self, payload: torch.Tensor):
        spec = self.bound_spec()
        return rx.receive_batch(spec, tx.transmit(spec, payload))

    def _receive(self, captures: torch.Tensor):
        return rx.receive_batch(self.bound_spec(), captures)

    def forward(self, payload: torch.Tensor):
        """payload uint8 [B, frame_bytes] -> (RxResult, SyncResult)."""
        return self._step(self._forward, payload)

    def receive(self, captures: torch.Tensor):
        """The RX half alone: captures [B, n] -> (RxResult, SyncResult)."""
        return self._step(self._receive, captures)
