"""The (data, seq, space) process mesh over torch.distributed.

Counterpart of ppmstereo_tpu/parallel/mesh.py. The JAX package lays its
devices out as a (data, seq, space) array and lets XLA place collectives.
Here each process is one position of that array, and each axis is a
subgroup of the default process group: the processes that share the other
two coordinates. Ranks are laid out row-major over (data, seq, space), as
the JAX mesh reshapes its device list, so the `space` neighbours of a rank
are consecutive ranks.

  data   batches of clips or windows: each rank holds its contiguous
         block of the global batch (`parallel/sharding.py`); PPMStereo's
         batch mean of the picked frames' scores is taken over it
         (`batch_group`)
  seq    the frames of a window or a training clip: each rank holds its
         block of frames [s T/S, (s+1) T/S) (`parallel/sharding.py::
         FrameShard`, its offset and count); PPMStereo exchanges time halos
         and gathers what mixes frames over it; in inference a window whose
         T is not divisible by S runs whole on every rank of the axis
  space  the rows of a window (inference): the ring play attention shards
         each play step's query rows and picked memory over it

Any axis may be 1. The ranks that share a `space` coordinate, data x seq of
them, hold between them the whole global batch: training sums its
gradients, its loss's denominators and its metrics over them
(`replica_group`).

One process per card is the PyTorch idiom. `join_group` joins the group
that `torchrun --nproc_per_node N` describes in the environment; the
tests and chip_smoke.py start theirs with `parallel/launch.py::run_group`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ppmstereo_tpu_torch.utils.device import resolve_device

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
    None for an axis of size 1).

    batch_group: a second subgroup over the ranks of `groups["data"]`,
    for PPMStereo's batch mean only. A checkpointed train-mode iteration
    issues that mean again in the backward pass, so on a group of its own
    it cannot interleave with the other collectives of the data axis.

    replica_group: the ranks that share this rank's `space` coordinate
    (data x seq of them), over which training sums the gradients, the
    loss's denominators and the metrics; None when data x seq is 1."""

    spec: MeshSpec
    coords: dict
    groups: dict = field(repr=False)
    batch_group: object = field(default=None, repr=False)
    replica_group: object = field(default=None, repr=False)

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
    batch_group = None
    for a, axis in enumerate(AXES):
        groups[axis] = None
        if sizes[a] == 1:
            continue
        # the rows of this array are the axis's groups; creating a group is
        # collective, so every rank creates every group
        for members in np.moveaxis(ranks, a, -1).reshape(-1, sizes[a]).tolist():
            group = dist.new_group(members, timeout=timeout)
            second = dist.new_group(members, timeout=timeout) if axis == "data" else None
            if rank in members:
                groups[axis] = group
                batch_group = second if axis == "data" else batch_group
    replica_group = None
    if spec.data * spec.seq > 1:
        for members in np.moveaxis(ranks, 2, 0).reshape(spec.space, -1).tolist():
            group = dist.new_group(members, timeout=timeout)
            if rank in members:
                replica_group = group
    return Mesh(spec, coords, groups, batch_group, replica_group)


def backend_for(device: torch.device, ranks_on_host: int) -> str:
    """The process group's backend: NCCL when every rank of this host has a
    card of its own, gloo when ranks share a card (NCCL refuses two ranks
    on one GPU) or run on the CPU."""
    if device.type == "cuda" and ranks_on_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def join_group(device: str | torch.device | None = None,
               timeout: timedelta | None = None) -> tuple[torch.device, bool]:
    """Join the process group of a `torchrun --nproc_per_node N` launch and
    return (this rank's device, whether this call started the group).

    Reads RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE and MASTER_ADDR /
    MASTER_PORT. On a card the rank's device is cuda:(LOCAL_RANK % the
    host's card count) and becomes the current device; `device` names the
    type (`cuda` unless another is named: no CPU fallback). The backend
    follows `backend_for`, and rank 0 prints the choice; an NCCL group that
    fails to start raises. Without WORLD_SIZE > 1, or in a process whose
    default group is already up (`parallel/launch.py::run_group`), nothing
    is started and the device is `device`'s."""
    dev = resolve_device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_initialized() or world == 1:
        return dev, False
    rank, local_rank = int(os.environ["RANK"]), int(os.environ.get("LOCAL_RANK", "0"))
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    on_host = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    backend = backend_for(dev, on_host)
    if rank == 0:
        print(f"process group: {world} ranks, {on_host} on this host, device {dev.type}"
              + (f" ({torch.cuda.device_count()} cards)" if dev.type == "cuda" else "")
              + f": backend {backend}", flush=True)
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=timeout)
    return dev, True
