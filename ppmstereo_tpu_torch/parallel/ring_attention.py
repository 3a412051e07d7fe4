"""Ring play attention over the `space` process group.

Counterpart of ppmstereo_tpu/parallel/ring_attention.py. Under a window
whose rows are sharded over n processes, process p holds the query rows
[p H/n, (p+1) H/n) of every target frame and the same rows of the picked
memory bank. The play step must attend every query row over the whole bank,
so each query block rings around the group carrying its online-softmax
state (o, m, l): at each of n hops a process merges the visiting block's
attention over its local keys into the visiting state (kernel 5,
`play_attention_carry`, on a card; its plain version on the CPU), then
passes (q, o, m, l) to process p + 1. After n hops every block is home and
has seen every key; o / l is the attention. The result equals the unsharded
play attention up to the f32 reassociation of the merge and the bf16
rounding of the unnormalised probabilities.

Transport: `torch.distributed.batch_isend_irecv` of one packed buffer per
hop, staged through pinned host buffers under gloo on a card
(`parallel/collectives.py::host_staged`): the kernels still run on the
card. An NCCL group moves the device buffers directly.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ppmstereo_tpu_torch.kernels.play_attention import play_attention_carry
from ppmstereo_tpu_torch.parallel.collectives import _to_host, host_staged

NEG_INF = -1e30  # the empty state's row max, as the JAX ring starts from


def _pack(tensors) -> torch.Tensor:
    """One byte buffer of `tensors`, each starting 16-byte aligned (the
    kernels take 16-byte aligned pointers)."""
    parts = []
    for t in tensors:
        raw = t.contiguous().view(torch.uint8).reshape(-1)
        parts += [raw, raw.new_zeros(-raw.numel() % 16)]
    return torch.cat(parts)


def _unpack(buf: torch.Tensor, like) -> list:
    out, start = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf[start: start + n].view(t.dtype).reshape(t.shape))
        start += n + (-n % 16)
    return out


def shift(tensors, group) -> list:
    """Send `tensors` to the next rank of `group` and return those of the
    previous rank (the same shapes and dtypes), packed into one message.
    `shift.messages` and `shift.bytes` count what this process sent."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    device = tensors[0].device
    send = _pack(tensors)
    staged = host_staged(group, device)
    if staged:
        send = _to_host(send)
    recv = torch.empty(send.shape, dtype=send.dtype, device=send.device, pin_memory=staged)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, (me + 1) % n), group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (me - 1) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    shift.messages += 1
    shift.bytes += send.numel()
    if staged:
        recv = recv.to(device)
    return _unpack(recv, tensors)


shift.messages = 0
shift.bytes = 0


def _ring_local(q, k, v, scale: float, group):
    """q (B, Lq, D) and k/v (B, Lk, D): this rank's token blocks. Rings the
    (q, o, m, l) bundle n times over `group`, one carry hop per rank, from
    the empty state (0, NEG_INF, 0); returns o / l (B, Lq, D) in q's dtype."""
    n = dist.get_world_size(group)
    b, lq, d = q.shape
    o = torch.zeros(b, lq, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, lq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(b, lq, dtype=torch.float32, device=q.device)
    for _ in range(n):
        o, m, l = play_attention_carry(q, k, v, o, m, l, scale)
        if n > 1:  # n shifts of one rank: every block ends at home
            q, o, m, l = shift((q, o, m, l), group)
    return (o / l[..., None]).to(q.dtype)


def ring_play_attention(query, sel_key, sel_val, scale: float, group):
    """The play attention with the rows sharded over `group`.

    query (B, R, H/n, W, C) and sel_key/sel_val (B, R, K, H/n, W, C) hold
    the rows of this rank's position in `group` (n ranks). Each of the B R
    target frames attends over all K H W picked tokens. Returns
    (B, R, H/n, W, C) in query's dtype."""
    b, r, lh, w, c = query.shape
    kf = sel_key.shape[2]
    q_tok = query.reshape(b * r, lh * w, c).contiguous()
    k_tok = sel_key.reshape(b * r, kf * lh * w, c).contiguous()
    v_tok = sel_val.reshape(b * r, kf * lh * w, c).contiguous()
    return _ring_local(q_tok, k_tok, v_tok, scale, group).reshape(b, r, lh, w, c)
