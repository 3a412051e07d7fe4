"""How a global batch maps onto the `data` axis (counterpart of
ppmstereo_tpu/parallel/sharding.py).

The JAX package lays a training batch out as P("data", "seq", "space"):
clips over `data`, in device order. Here each rank holds its contiguous
block of clips of the global batch, in rank order: rank r of n holds clips
[r B/n, (r+1) B/n). The port shards nothing over `seq` or `space` in
training. A batch that the axis does not divide raises, as the JAX
sharding does.
"""

from __future__ import annotations

from collections.abc import Mapping


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
