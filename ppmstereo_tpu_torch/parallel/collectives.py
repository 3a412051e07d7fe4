"""Collectives over a process group, for tensors on a card or the CPU.

A gloo group moves host tensors only, so when the group's backend is gloo
and the tensors are on a card, every message is staged through pinned host
buffers (`host_staged`): the work around it stays on the card. An NCCL
group moves the device buffers directly.

`all_reduce_sum` has a backward: the cotangent summed over the group, the
adjoint of a sum over ranks whose losses are added up (the data axis's
batch mean in `models/ppm_stereo.py`).

The `seq` axis's two messages (`parallel/sharding.py::FrameShard`):
`gather_frames`, the blocks of a window's frames of every rank joined along
dim 1, and `time_halo`, a block extended by its neighbours' edge frames.
Both move the tensors' bytes as they are, so any dtype (bf16 included)
passes through gloo. Both have a backward, for training over the axis:

  * the gather's is the adjoint of an all-gather along dim 1: each rank
    sends every other rank that rank's block of its cotangent and sums
    what it receives with its own block, in rank order and in f32 at least
    (a reduce-scatter by point-to-point messages);
  * the halo's sends the cotangents of the two halos back to the
    neighbours that own those frames, and each rank adds what it receives
    to its edge frames; the cotangents of the zero frames past the clip's
    ends are dropped. A block thinner than the halo goes through the
    gather, and so through the gather's backward.

Either takes `on_message(nbytes, backward)`, called with the bytes this
rank received at each message of the forward (backward False) and of the
backward pass (True).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def host_staged(group, device: torch.device) -> bool:
    """Whether messages of `group` on `device` pass through host memory: a
    gloo group moves host tensors only."""
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


def _to_host(x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True) if out is None else out
    host.copy_(x)  # waits for the device: the message must be complete
    return host


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The blocks `x` of every rank of `group`, concatenated along `dim` in
    rank order (host-staged under gloo on a card)."""
    device = x.device
    staged = host_staged(group, device)
    src = _to_host(x) if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(device)


def broadcast_from_first(x: torch.Tensor, group) -> torch.Tensor:
    """`x` as rank 0 of `group` holds it, on every rank of the group."""
    staged = host_staged(group, x.device)
    buf = _to_host(x) if staged else x.contiguous().clone()
    dist.broadcast(buf, src=dist.get_global_rank(group, 0), group=group)
    return buf.to(x.device)


def all_reduce_(x: torch.Tensor, group, host: torch.Tensor | None = None) -> torch.Tensor:
    """Sum the contiguous `x` over `group` in place and return it. Under
    gloo on a card the sum goes through `host` (a pinned buffer of x's
    shape and dtype, made here when None)."""
    if host_staged(group, x.device):
        host = _to_host(x, host)
        dist.all_reduce(host, group=group)
        x.copy_(host)
    else:
        dist.all_reduce(x, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.detach().clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(memory_format=torch.contiguous_format), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, differentiable: the
    gradient that reaches `x` is the sum over the ranks of the gradient of
    the result."""
    return _AllReduceSum.apply(x, group)


def broadcast_tensors_(tensors, group) -> None:
    """Overwrite `tensors` on every rank of `group` with rank 0's, one
    message per dtype (the tensors flattened into it)."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in same])
        flat = broadcast_from_first(flat, group)
        start = 0
        with torch.no_grad():
            for t in same:
                t.copy_(flat[start: start + t.numel()].view_as(t))
                start += t.numel()


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """x's bytes, flat (uint8): a message that gloo moves for any dtype."""
    return x.contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(raw: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`_bytes`' inverse: raw as a tensor of like's shape and dtype."""
    return raw.view(like.dtype).reshape(like.shape)


def _exchange(sends: dict, group, device: torch.device) -> dict:
    """Point-to-point messages over `group` in one batch: `sends` maps a
    peer (its rank in the group) to the bytes (uint8) sent to it, and each
    such peer sends as many bytes back (host-staged under gloo on a card).
    Returns the received bytes by peer, on `device`."""
    staged = host_staged(group, device)
    ops, recv = [], {}
    for peer, raw in sorted(sends.items()):
        peer_rank = dist.get_global_rank(group, peer)
        raw = _to_host(raw) if staged else raw
        recv[peer] = torch.empty(raw.shape, dtype=raw.dtype, device=raw.device,
                                 pin_memory=staged)
        ops += [dist.P2POp(dist.isend, raw, peer_rank, group),
                dist.P2POp(dist.irecv, recv[peer], peer_rank, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return {peer: raw.to(device) for peer, raw in recv.items()}


def _all_gather_frames(x: torch.Tensor, group) -> torch.Tensor:
    device = x.device
    src = _bytes(x)
    if host_staged(group, device):
        src = _to_host(src)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat([_from_bytes(p.to(device), x) for p in parts], dim=1)


class _GatherFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, on_message):
        ctx.group, ctx.on_message = group, on_message
        size = dist.get_world_size(group)
        if on_message is not None:
            on_message(x.numel() * x.element_size() * (size - 1), False)
        return _all_gather_frames(x, group)

    @staticmethod
    def backward(ctx, grad):
        group = ctx.group
        me, size = dist.get_rank(group), dist.get_world_size(group)
        blocks = grad.chunk(size, dim=1)
        mine = blocks[me].contiguous()
        peers = [p for p in range(size) if p != me]
        got = _exchange({p: _bytes(blocks[p]) for p in peers}, group, grad.device)
        acc = torch.promote_types(grad.dtype, torch.float32)
        total = None
        for p in range(size):  # in rank order
            part = (mine if p == me else _from_bytes(got[p], mine)).to(acc)
            total = part if total is None else total + part
        if ctx.on_message is not None:
            ctx.on_message(mine.numel() * mine.element_size() * (size - 1), True)
        return total.to(grad.dtype), None, None


def gather_frames(x: torch.Tensor, group, on_message=None) -> torch.Tensor:
    """The frame blocks x (B, n, ...) of every rank of `group`, joined along
    the frame axis (dim 1) in rank order: (B, S n, ...) on every rank.
    Differentiable: the gradient that reaches x is the sum over the ranks of
    the gradient of their results' frames of this rank's block."""
    return _GatherFrames.apply(x, group, on_message)


class _TimeHalo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h, group, on_message):
        ctx.h, ctx.group, ctx.on_message = h, group, on_message
        n = x.shape[1]
        me, size = dist.get_rank(group), dist.get_world_size(group)
        edges = {me - 1: x[:, :h], me + 1: x[:, n - h:]}
        peers = [p for p in edges if 0 <= p < size]
        got = _exchange({p: _bytes(edges[p]) for p in peers}, group, x.device)
        if on_message is not None:
            on_message(sum(raw.numel() for raw in got.values()), False)
        before, after = (_from_bytes(got[p], edges[p]) if p in got
                         else torch.zeros_like(edges[p]) for p in (me - 1, me + 1))
        return torch.cat([before, x, after], dim=1)

    @staticmethod
    def backward(ctx, grad):
        h, group = ctx.h, ctx.group
        n = grad.shape[1] - 2 * h
        me, size = dist.get_rank(group), dist.get_world_size(group)
        # the halos' cotangents go back to the frames' owners: the previous
        # rank's last h frames, the next rank's first h
        halos = {me - 1: grad[:, :h], me + 1: grad[:, n + h:]}
        peers = [p for p in halos if 0 <= p < size]
        got = _exchange({p: _bytes(halos[p]) for p in peers}, group, grad.device)
        dx = grad[:, h: n + h].clone(memory_format=torch.contiguous_format)
        acc = torch.promote_types(grad.dtype, torch.float32)
        for p, frames in ((me - 1, slice(0, h)), (me + 1, slice(n - h, n))):
            if p in got:
                dx[:, frames] = (dx[:, frames].to(acc)
                                 + _from_bytes(got[p], halos[p]).to(acc)).to(dx.dtype)
        if ctx.on_message is not None:
            ctx.on_message(sum(raw.numel() for raw in got.values()), True)
        return dx, None, None, None


def time_halo(x: torch.Tensor, h: int, group, on_message=None) -> torch.Tensor:
    """This rank's frame block x (B, n, ...) extended by h frames on each
    side: the previous rank's last h and the next rank's first h frames
    (rank order of `group`), zero frames past the clip's ends (the zero
    padding of a convolution over time): (B, n + 2h, ...). Differentiable
    (see the module's docstring).

    One message to each neighbour (`batch_isend_irecv`). A block thinner
    than the halo (n < h) takes its halo from the gathered window instead."""
    n = x.shape[1]
    if n < h:
        me = dist.get_rank(group)
        whole = gather_frames(x, group, on_message)
        pad = x.new_zeros(x.shape[0], h, *x.shape[2:])
        whole = torch.cat([pad, whole, pad], dim=1)
        return whole[:, me * n: me * n + n + 2 * h]
    return _TimeHalo.apply(x, h, group, on_message)
