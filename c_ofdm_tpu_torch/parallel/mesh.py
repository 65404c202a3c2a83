"""The modem's two parallel axes over a torch.distributed world
(counterpart of ``c_ofdm_tpu/parallel/mesh.py``).

* ``channel`` — independent OFDM streams (pure data parallelism, no comms);
* ``time``   — long captures split into contiguous blocks, one per rank,
  with a one-frame overlap-save halo passed left (the distributed form of
  the reference's carry-over memcpy, `rx.cpp:147-156`).

The JAX package lays its devices out as ``reshape(n_channel, n_time)``; here
one process is one rank and rank r sits at ``(c, t) = (r // n_time,
r % n_time)``, so rank r plays JAX device r.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

CHANNEL_AXIS = "channel"
TIME_AXIS = "time"


def mesh_grid(n_channel: int, n_time: int, world: int) -> np.ndarray:
    """The ranks of a {channel, time} mesh laid out as the JAX mesh lays out
    its devices: ``arange(need).reshape(n_channel, n_time)``.  ``n_time`` 0
    fills the world.  Raises the JAX mesh's ValueErrors, with the world size
    in place of the device count."""
    if n_time == 0:
        if world % n_channel:
            raise ValueError(
                f"{world} devices not divisible by n_channel={n_channel}")
        n_time = world // n_channel
    need = n_channel * n_time
    if need > world:
        raise ValueError(f"need {need} devices, have {world}")
    return np.arange(need).reshape(n_channel, n_time)


@dataclasses.dataclass(frozen=True)
class ModemMesh:
    """This rank's place on a {channel, time} mesh.  ``group`` is None in a
    world of one without a process group; ``staged`` is True where the
    group's collectives take host tensors but the data lies on the card
    (gloo with a CUDA device), so every transfer goes through host memory."""
    n_channel: int
    n_time: int
    c: int
    t: int
    device: torch.device
    group: object = None
    staged: bool = False

    @property
    def size(self) -> int:
        return self.n_channel * self.n_time

    def global_rank(self, c: int, t: int) -> int:
        """The global rank of the mesh position (c, t)."""
        r = c * self.n_time + t
        return r if self.group is None else dist.get_global_rank(self.group, r)


def make_modem_mesh(n_channel: int = 1, n_time: int = 0, *, group=None,
                    device) -> ModemMesh:
    """Build this rank's {channel, time} mesh over ``group`` (default: the
    initialised default group; without one, a world of one).  ``n_time`` 0
    fills the world.  ``device`` is required: it is where this rank's blocks
    and outputs lie, never derived from the rank.  The mesh takes the whole
    group: a group larger than the mesh raises (pass a group of exactly
    ``n_channel * n_time`` ranks)."""
    if dist.is_available() and dist.is_initialized():
        group = group if group is not None else dist.group.WORLD
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    elif group is not None:
        raise ValueError("make_modem_mesh: group given but torch.distributed "
                         "is not initialised")
    else:
        world, rank = 1, 0
    grid = mesh_grid(n_channel, n_time, world)
    if grid.size != world:
        raise ValueError(f"a {grid.shape[0]}x{grid.shape[1]} mesh takes "
                         f"{grid.size} ranks, the group has {world}: pass a "
                         f"group of {grid.size} ranks")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"make_modem_mesh: device {device} but no CUDA "
                           f"device is available")
    staged =(group is not None and device.type == "cuda"
              and dist.get_backend(group) == "gloo")
    return ModemMesh(n_channel=grid.shape[0], n_time=grid.shape[1],
                     c=rank // grid.shape[1], t=rank % grid.shape[1],
                     device=device, group=group, staged=staged)
