"""How a global batch maps onto the `data` axis, and a clip's frames onto
the `seq` axis (counterpart of ppmstereo_tpu/parallel/sharding.py and of
the window sharding of ppmstereo_tpu/parallel/streaming.py).

The JAX package lays a training batch out as P("data", "seq", "space"):
clips over `data`, frames over `seq`, in device order. Here each rank
holds its contiguous block of clips of the global batch, in rank order:
rank r of n holds clips [r B/n, (r+1) B/n) (`local_batch`); over a seq
axis of S ranks, rank s holds frames [s T/S, (s+1) T/S) of its block's
clips (`local_frames`). A batch that the data axis does not divide, or a
clip that the seq axis does not divide, raises, as the JAX sharding does.
The port shards nothing over `space` in training.

In inference a window's T frames spread over the `seq` axis likewise
(`FrameShard`); a window whose T is not divisible by S runs replicated on
every rank of the axis, the JAX predictor's rule for tail windows
(`frame_shard`). In training a rank holds its block of every clip
(`block_shard`).
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass

import torch.distributed as dist

from ppmstereo_tpu_torch.parallel import collectives

# bytes this process received over the seq axis since the counts were last
# set to 0: the play's memory bank ("bank": its keys once a stage, its
# values every iteration), the convolutions' time halos ("halo") and every
# other frame gather ("frames": pooled descriptors, frame confidences, the
# 1/16 time attention's input and, in inference, the outputs). Each message
# counts when it is sent: a train-mode iteration is checkpointed, so the
# backward pass recomputes it and its gathers and halos count again under
# the same three keys. The "_grad" keys count the backward's own messages:
# the cotangents that the gathers and halos send back to the frames' owners.
RECEIVED = {"bank": 0, "halo": 0, "frames": 0, "bank_grad": 0, "halo_grad": 0,
            "frames_grad": 0}


def _counter(kind: str):
    """on_message of `collectives.gather_frames` / `time_halo`: the bytes
    go to RECEIVED[kind], or to RECEIVED[kind + "_grad"] in the backward."""
    def count(nbytes: int, backward: bool) -> None:
        RECEIVED[kind + "_grad" * backward] += nbytes
    return count


def local_slice(batch_size: int, rank: int, size: int) -> slice:
    """The clips of rank `rank` of `size` in a global batch of `batch_size`."""
    if batch_size % size:
        raise ValueError(f"a batch of {batch_size} does not divide over a data axis of {size}")
    n = batch_size // size
    return slice(rank * n, (rank + 1) * n)


def local_batch(batch: Mapping, rank: int, size: int) -> dict:
    """This rank's block of every entry of a global batch (numpy arrays or
    tensors, clips on the first axis)."""
    lengths = {len(v) for v in batch.values()}
    if len(lengths) != 1:
        raise ValueError(f"batch entries of {sorted(lengths)} clips")
    mine = local_slice(lengths.pop(), rank, size)
    return {k: v[mine] for k, v in batch.items()}


def local_frames(batch: Mapping, index: int, size: int) -> dict:
    """Rank `index`'s frames of every clip of a batch over a seq axis of
    `size` ranks: frames [index T/size, (index+1) T/size) of every entry
    (numpy arrays or tensors, (B, T, ...)). A clip whose T the axis does
    not divide raises."""
    frames = {v.shape[1] for v in batch.values()}
    if len(frames) != 1:
        raise ValueError(f"batch entries of {sorted(frames)} frames")
    t = frames.pop()
    if t % size:
        raise ValueError(f"a clip of {t} frames does not divide over a seq axis of {size}")
    n = t // size
    return {k: v[:, index * n: (index + 1) * n] for k, v in batch.items()}


@dataclass(frozen=True)
class FrameShard:
    """This rank's block of a window of `total` frames over the seq axis
    (`group`, `size` ranks; this rank's position `index`), and the messages
    that join the blocks. Tensors are (B, T, ...): frames on dim 1. The
    messages have a backward (`parallel/collectives.py`), so a train-mode
    forward through them is differentiable."""

    group: object
    index: int
    size: int
    total: int

    @property
    def count(self) -> int:
        """The frames of each rank's block."""
        return self.total // self.size

    @property
    def offset(self) -> int:
        """The window's index of this rank's first frame."""
        return self.index * self.count

    def local(self, x):
        """This rank's frames of a whole window's x."""
        return x[:, self.offset: self.offset + self.count]

    def gather(self, x, kind: str = "frames"):
        """Every rank's block of x joined in frame order (the whole window)."""
        return collectives.gather_frames(x, self.group, _counter(kind))

    def gather_bank(self, x):
        """The play's memory bank (keys or values) of the whole window."""
        return self.gather(x, "bank")

    def halo(self, x, h: int):
        """x extended by h frames on each side from the neighbouring ranks'
        blocks (zero frames past the clip's ends): (B, count + 2h, ...)."""
        return collectives.time_halo(x, h, self.group, _counter("halo"))


def frame_shard(t: int, group) -> FrameShard | None:
    """This rank's share of a window of t frames over the seq `group`; None
    (the window runs whole on every rank) without a group or when t is not
    divisible by the axis's size."""
    if group is None:
        return None
    size = dist.get_world_size(group)
    if t % size:
        return None
    return FrameShard(group, dist.get_rank(group), size, t)


def block_shard(n: int, group) -> FrameShard | None:
    """This rank's share of a training clip of which it holds the block of
    n frames (`local_frames`) over the seq `group`: a clip of n S frames.
    None without a group."""
    if group is None:
        return None
    size = dist.get_world_size(group)
    return FrameShard(group, dist.get_rank(group), size, n * size)
