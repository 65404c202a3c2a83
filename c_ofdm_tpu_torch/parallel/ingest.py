"""Per-rank ingest: this rank's part of a capture sharded over the mesh
(counterpart of ``c_ofdm_tpu/parallel/ingest.py``).

In a deployment each rank ingests its own slice of the capture (its own
radio heads and time span); no rank ever holds the global capture.  The JAX
package assembles a global array from per-process data; here every rank
keeps its block and these functions check and place it.  In a world of one
the whole capture is the block, as the JAX ``device_put`` branch has it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import streaming
from .mesh import CHANNEL_AXIS, TIME_AXIS, ModemMesh


class Sharding(NamedTuple):
    """Which leading dims are split over which mesh axis, in how many equal
    parts, and this rank's coordinate on each."""
    axes: tuple       # mesh axis name of dim 0, 1, ...
    parts: tuple      # parts per dim
    coords: tuple     # this rank's part per dim

    def shard_shape(self, global_shape) -> tuple:
        """The shape of one rank's block of an array of ``global_shape``."""
        shape = list(global_shape)
        for d, p in enumerate(self.parts):
            if shape[d] % p:
                raise ValueError(f"dim {d} ({shape[d]}) does not split into "
                                 f"{p} equal parts over the {self.axes[d]} "
                                 f"axis")
            shape[d] //= p
        return tuple(shape)

    def index(self, global_shape) -> tuple:
        """This rank's block of an array of ``global_shape``, as slices."""
        shard = self.shard_shape(global_shape)
        return tuple(slice(k * n, (k + 1) * n)
                     for k, n in zip(self.coords, shard))


def capture_sharding(mesh: ModemMesh) -> Sharding:
    """A [n_channels, total_len] capture batch: rows over the channel axis,
    contiguous time blocks over the time axis."""
    return Sharding((CHANNEL_AXIS, TIME_AXIS), (mesh.n_channel, mesh.n_time),
                    (mesh.c, mesh.t))


def channel_sharding(mesh: ModemMesh) -> Sharding:
    """[C, ...] arrays split over the channel axis only (replicated over
    time): the continuous sharded-streaming path's blocks and carry state."""
    return Sharding((CHANNEL_AXIS,), (mesh.n_channel,), (mesh.c,))


def _place(mesh: ModemMesh, sharding: Sharding, local, global_shape):
    local = torch.as_tensor(local)
    if mesh.size > 1:
        want = sharding.shard_shape(global_shape)
        if tuple(local.shape) != want:
            raise ValueError(f"rank ({mesh.c}, {mesh.t}): local block "
                             f"{tuple(local.shape)}, the {tuple(global_shape)}"
                             f" array's shard is {want}")
    return local.to(mesh.device)


def make_global_capture(mesh: ModemMesh, local_capture, global_shape=None):
    """This rank's block of the mesh-wide capture, on the mesh's device.
    In a world of one ``local_capture`` is the whole [n_channels, total_len]
    capture.  In a larger world it is this rank's [ch_local, block_len]
    block and ``global_shape`` (the full [n_channels, total_len]) is
    required; the block's shape is checked against it."""
    if mesh.size > 1 and global_shape is None:
        raise ValueError("global_shape is required with multiple processes")
    return _place(mesh, capture_sharding(mesh), local_capture, global_shape)


def make_global_channel_array(mesh: ModemMesh, local,
                              global_channels: int = 0):
    """This rank's [C_local, ...] block of a channel-sharded array (the
    per-buffer ingest of the sharded continuous streaming path), on the
    mesh's device.  ``global_channels`` is the mesh-wide channel count
    (required in a larger world than one)."""
    if mesh.size > 1 and not global_channels:
        raise ValueError("global_channels is required with multiple processes")
    local = torch.as_tensor(local)
    return _place(mesh, channel_sharding(mesh), local,
                  (global_channels, *local.shape[1:]))


def make_global_stream_state(mesh: ModemMesh, local_state,
                             global_channels: int = 0):
    """A rank-local ``StreamState`` slice (every field with a leading
    [C_local] axis, from ``streaming.init_state(spec, channels=C_local)``)
    placed as the channel-sharded state ``make_sharded_streaming`` threads;
    after the first step it stays on the rank's device."""
    return streaming.StreamState(*(
        make_global_channel_array(mesh, x, global_channels)
        for x in local_state))
