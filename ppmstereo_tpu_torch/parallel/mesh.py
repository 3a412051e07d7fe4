"""The (data, seq, space) process mesh over torch.distributed.

Counterpart of ppmstereo_tpu/parallel/mesh.py. The JAX package lays its
devices out as a (data, seq, space) array and lets XLA place collectives.
Here each process is one position of that array, and each axis is a
subgroup of the default process group: the processes that share the other
two coordinates. Ranks are laid out row-major over (data, seq, space), as
the JAX mesh reshapes its device list, so the `space` neighbours of a rank
are consecutive ranks.

  data   batches of windows or clips (not used by this slice)
  seq    the frame axis of a window (not used by this slice)
  space  the rows of a window: the ring play attention shards each play
         step's query rows and picked memory over it

Any axis may be 1.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import timedelta

import numpy as np
import torch.distributed as dist

AXES = ("data", "seq", "space")


@dataclass(frozen=True)
class MeshSpec:
    data: int = 1
    seq: int = 1
    space: int = 1

    @property
    def size(self) -> int:
        return self.data * self.seq * self.space


@dataclass
class Mesh:
    """This process's place in the mesh: the axis sizes (`shape`), its
    coordinate on each axis (`coords`) and each axis's subgroup (`groups`;
    None for an axis of size 1)."""

    spec: MeshSpec
    coords: dict
    groups: dict = field(repr=False)

    @property
    def shape(self) -> dict:
        return {axis: getattr(self.spec, axis) for axis in AXES}


def make_mesh(spec: MeshSpec, timeout: timedelta | None = None) -> Mesh:
    """Build the mesh over the initialised default process group, whose world
    size must be `spec.size`. Every rank must call it (subgroup creation is
    collective), with the same spec. `timeout` bounds every collective of
    the subgroups (torch.distributed's default when None)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed default group")
    world = dist.get_world_size()
    if world != spec.size:
        raise ValueError(f"mesh {spec} needs {spec.size} processes, the group has {world}")
    sizes = [getattr(spec, axis) for axis in AXES]
    rank = dist.get_rank()
    ranks = np.arange(world).reshape(sizes)
    coords = {axis: int(c) for axis, c in zip(AXES, np.unravel_index(rank, sizes))}
    groups = {}
    for a, axis in enumerate(AXES):
        groups[axis] = None
        if sizes[a] == 1:
            continue
        # the rows of this array are the axis's groups; creating a group is
        # collective, so every rank creates every group
        for members in np.moveaxis(ranks, a, -1).reshape(-1, sizes[a]).tolist():
            group = dist.new_group(members, timeout=timeout)
            if rank in members:
                groups[axis] = group
    return Mesh(spec, coords, groups)
