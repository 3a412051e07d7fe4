"""The PPM "play" attention: q over the picked-memory key/value bank.

Counterpart of ppmstereo_tpu/kernels/play_attention.py. Single head,
non-causal, custom softmax scale, bf16 inputs, f32 softmax:

    O = softmax(scale * Q K^T) V,   q (B, Lq, D), k/v (B, Lk, D) -> (B, Lq, D)

and its gradients. Each kernel has a plain PyTorch version beside it, which
the wrappers use for CPU tensors only and `chip_smoke.py` holds the kernel
against on the card:

  kernel (csrc/)                            replaces (Pallas)               plain version
  play_attention_fwd.cu, forward            `_flash_kernel`                 `play_attention_plain`
  play_attention_fwd.cu, forward + residual `_flash_kernel(save_residuals)` `play_attention_fwd_res_plain`
  play_attention_bwd.cu, dq                 `_flash_bwd_dq_kernel`          `play_attention_bwd_plain`
  play_attention_bwd.cu, dk and dv          `_flash_bwd_dkv_kernel`         `play_attention_bwd_plain`
  play_attention_fwd.cu, carry (ring hop)   `_flash_carry_kernel`           `play_attention_carry_plain`

The plain versions are chunked over query rows with f32 logits, as the JAX
package's `_play_attention_xla` and `_attention_bwd_xla` are. The kernels
are built by `kernels/_build.py` and bound with ctypes.

`play_attention` is the entry point. Without autograd (inference) it runs
the plain forward on the CPU or launches the forward kernel. The kernels
take D = 128 and any other head dim raises on a card (`PPMStereoConfig`
refuses a context_dim other than 128 when it is built). When an input
requires a gradient it goes through `PlayAttention`, a
`torch.autograd.Function`: on a card the forward-with-residual kernel and
the two backward kernels, on the CPU the plain forward and
`play_attention_bwd_plain`. On a card every wrapper launches its kernel or
raises; none falls back to a plain version.

`play_attention_carry` is one hop of the ring play attention
(`parallel/ring_attention.py`): it merges the attention of q over a block
of keys into an incoming unnormalised online-softmax state (o, m, l). It is
forward only, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ppmstereo_tpu_torch.kernels import _build

HEAD_DIM = 128
LOG2E = 1.4426950408889634


def play_attention_plain(q, k, v, scale: float, q_chunk: int = 1024):
    """Reference version: (B, Lq, D) x (B, Lk, D) -> (B, Lq, D) in q's dtype.

    Chunked over rows and query rows, so it never holds more than
    q_chunk x Lk f32 logits at once.
    """
    b, lq, _ = q.shape
    out = torch.empty_like(q)
    for bi in range(b):
        kf = k[bi].float()
        vf = v[bi].float()
        for s in range(0, lq, q_chunk):
            e = min(s + q_chunk, lq)
            logits = torch.matmul(q[bi, s:e].float(), kf.t()) * scale
            probs = torch.softmax(logits, dim=-1).to(v.dtype).float()
            out[bi, s:e] = torch.matmul(probs, vf).to(q.dtype)
    return out


def play_attention_fwd_res_plain(q, k, v, scale: float, q_chunk: int = 1024):
    """Reference version of the forward with residual: (o, lse), o as
    `play_attention_plain` gives it and lse (B, Lq) f32 each row's base-2
    log-sum-exp of scale * log2(e) * q.k."""
    b, lq, _ = q.shape
    lse = torch.empty(b, lq, dtype=torch.float32, device=q.device)
    for bi in range(b):
        kf = k[bi].float()
        for s in range(0, lq, q_chunk):
            e = min(s + q_chunk, lq)
            logits = torch.matmul(q[bi, s:e].float(), kf.t()) * (scale * LOG2E)
            lse[bi, s:e] = torch.logsumexp(logits * math.log(2.0), dim=-1) * LOG2E
    return play_attention_plain(q, k, v, scale, q_chunk), lse


def play_attention_bwd_plain(q, k, v, do, scale: float, q_chunk: int = 1024):
    """Reference backward, the counterpart of the JAX package's
    `_attention_bwd_xla`: recompute P = softmax(scale q k^T) in f32, chunked
    over query rows (never more than q_chunk x Lk logits at once), then

        dV = P^T dO,  dP = dO V^T,  dS = P o (dP - rowsum(dP o P)),
        dQ = scale dS K,  dK = scale dS^T Q

    in f32. Returns (dq, dk, dv) in the dtypes of q, k and v."""
    b, lq, _ = q.shape
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    for bi in range(b):
        kf, vf = k[bi].float(), v[bi].float()
        dk_acc = torch.zeros_like(kf)
        dv_acc = torch.zeros_like(vf)
        for s in range(0, lq, q_chunk):
            e = min(s + q_chunk, lq)
            qf, gf = q[bi, s:e].float(), do[bi, s:e].float()
            p = torch.softmax(torch.matmul(qf, kf.t()) * scale, dim=-1)
            dv_acc += torch.matmul(p.t(), gf)
            dp = torch.matmul(gf, vf.t())
            ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
            dq[bi, s:e] = (scale * torch.matmul(ds, kf)).to(q.dtype)
            dk_acc += scale * torch.matmul(ds.t(), qf)
        dk[bi] = dk_acc.to(k.dtype)
        dv[bi] = dv_acc.to(v.dtype)
    return dq, dk, dv


def play_attention_carry_plain(q, k, v, o, m, l, scale: float, q_chunk: int = 1024):
    """Reference version of one ring hop, the counterpart of the JAX
    package's `_flash_carry_kernel`: q (B, Lq, D), k/v (B, Lk, D), and the
    incoming state o (B, Lq, D) f32 unnormalised, m (B, Lq) f32 the base-2
    row max and l (B, Lq) f32 the row sum. With s = scale log2(e) q k^T in
    f32 (chunked over query rows):

        m' = max(m, rowmax s),  p = exp2(s - m'),  alpha = exp2(m - m'),
        l' = alpha l + rowsum p,  o' = alpha o + p V,

    p rounded to v's dtype before P V as the kernel does. Returns new
    (o', m', l'); the inputs are not changed."""
    b, lq, _ = q.shape
    o_new, m_new, l_new = torch.empty_like(o), torch.empty_like(m), torch.empty_like(l)
    for bi in range(b):
        kf, vf = k[bi].float(), v[bi].float()
        for s0 in range(0, lq, q_chunk):
            s1 = min(s0 + q_chunk, lq)
            logits = torch.matmul(q[bi, s0:s1].float(), kf.t()) * (scale * LOG2E)
            m_blk = torch.maximum(m[bi, s0:s1], logits.max(dim=-1).values)
            p = torch.exp2(logits - m_blk[:, None])
            alpha = torch.exp2(m[bi, s0:s1] - m_blk)
            l_new[bi, s0:s1] = alpha * l[bi, s0:s1] + p.sum(dim=-1)
            o_new[bi, s0:s1] = alpha[:, None] * o[bi, s0:s1] + torch.matmul(
                p.to(v.dtype).float(), vf)
            m_new[bi, s0:s1] = m_blk
    return o_new, m_new, l_new


_ARGTYPES = {
    # q, k, v, o, B, Lq, Lk, scale_log2, stream
    "play_attention_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.c_void_p],
    # q, k, v, o, lse, B, Lq, Lk, scale_log2, stream
    "play_attention_fwd_res": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.c_void_p],
    # q, k, v, o, m, l, B, Lq, Lk, scale_log2, stream
    "play_attention_carry": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.c_void_p],
    # q, k, v, dout, lse, di, dq, B, Lq, Lk, scale_log2, scale, stream
    "play_attention_bwd_dq": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
    + [ctypes.c_float] * 2 + [ctypes.c_void_p],
    # q, k, v, dout, lse, di, dk, dv, B, Lq, Lk, scale_log2, scale, stream
    "play_attention_bwd_dkv": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
    + [ctypes.c_float] * 2 + [ctypes.c_void_p],
}


def _kernel(library: str, name: str):
    fn = getattr(_build.build(library).lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _launch(library: str, name: str, device: torch.device, *args) -> None:
    """Launch `name` of `csrc/<library>.cu` on the current stream of
    `device`; raise if the launch was refused."""
    fn = _kernel(library, name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _check_cuda_tensor(name: str, x: torch.Tensor, device: torch.device,
                       dtype: torch.dtype, shape: tuple) -> None:
    if x.device != device:
        raise ValueError(f"play_attention: {name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"play_attention: {name} is {x.dtype}, the kernel takes {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"play_attention: {name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"play_attention: {name} must be contiguous and 16-byte aligned")


def _check_cuda_inputs(q, k, v):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(
                f"play_attention: {name} is on {x.device}; q, k and v must be "
                "on one CUDA device (or all on the CPU)"
            )
        if x.dtype != torch.bfloat16:
            raise ValueError(f"play_attention: {name} is {x.dtype}, the kernel takes bfloat16")
        if x.dim() != 3 or x.shape[-1] != HEAD_DIM:
            raise ValueError(
                f"play_attention: {name} has shape {tuple(x.shape)}, the kernel "
                f"takes (B, L, {HEAD_DIM})"
            )
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"play_attention: {name} must be contiguous and 16-byte aligned")
    if k.shape != v.shape or k.shape[0] != q.shape[0]:
        raise ValueError(
            f"play_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not match"
        )
    b, lq, _ = q.shape
    lk = k.shape[1]
    if not (0 < b <= 65535 and 0 < lq < 2**31 and 0 < lk < 2**31):
        raise ValueError(f"play_attention: unsupported sizes B={b} Lq={lq} Lk={lk}")


def _on_cpu(*xs) -> bool:
    return all(x.device.type == "cpu" for x in xs)


def play_attention_fwd_res(q, k, v, scale: float):
    """Kernel 2: the forward kernel with its residual, on CUDA tensors.
    Returns (o, lse), lse (B, Lq) f32."""
    _check_cuda_inputs(q, k, v)
    b, lq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, lq, dtype=torch.float32, device=q.device)
    _launch("play_attention_fwd", "play_attention_fwd_res", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, lq, k.shape[1], scale * LOG2E)
    play_attention_fwd_res.launches += 1
    return out, lse


def _check_bwd_inputs(q, k, v, do, lse, di):
    _check_cuda_inputs(q, k, v)
    _check_cuda_tensor("dout", do, q.device, torch.bfloat16, tuple(q.shape))
    for name, x in (("lse", lse), ("di", di)):
        _check_cuda_tensor(name, x, q.device, torch.float32, tuple(q.shape[:2]))


def play_attention_bwd_dq(q, k, v, do, lse, di, scale: float):
    """Kernel 3: dq on CUDA tensors, from the forward's lse and
    di = rowsum(dO o O), both (B, Lq) f32."""
    _check_bwd_inputs(q, k, v, do, lse, di)
    b, lq, _ = q.shape
    dq = torch.empty_like(q)
    _launch("play_attention_bwd", "play_attention_bwd_dq", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
            b, lq, k.shape[1], scale * LOG2E, scale)
    play_attention_bwd_dq.launches += 1
    return dq


def play_attention_bwd_dkv(q, k, v, do, lse, di, scale: float):
    """Kernel 4: (dk, dv) on CUDA tensors; arguments as for dq."""
    _check_bwd_inputs(q, k, v, do, lse, di)
    b, lq, _ = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("play_attention_bwd", "play_attention_bwd_dkv", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, lq, k.shape[1], scale * LOG2E, scale)
    play_attention_bwd_dkv.launches += 1
    return dk, dv


def play_attention_di(o, do):
    """di = rowsum(dO o O) in f32, (B, Lq): a torch op, as the JAX package
    computes it in XLA. One f32 copy of o is made and multiplied by dO in
    place (bf16 times bf16 is exact in f32), so the only temporary is one
    (B, Lq, D) f32 tensor."""
    return o.float().mul_(do).sum(dim=-1)


def play_attention_bwd(q, k, v, o, lse, do, scale: float):
    """(dq, dk, dv) on CUDA tensors: di (`play_attention_di`, under the
    profiler label "play_attention_di"), then kernels 3 and 4."""
    with torch.profiler.record_function("play_attention_di"):
        di = play_attention_di(o, do)
    dq = play_attention_bwd_dq(q, k, v, do, lse, di, scale)
    dk, dv = play_attention_bwd_dkv(q, k, v, do, lse, di, scale)
    return dq, dk, dv


for _wrapper in (play_attention_fwd_res, play_attention_bwd_dq, play_attention_bwd_dkv):
    _wrapper.launches = 0  # launches of the wrapper's kernel in this process


class PlayAttention(torch.autograd.Function):
    """The play attention with its gradient: on a card the forward-with-
    residual kernel and the dq and dk/dv kernels, on the CPU the plain
    forward and `play_attention_bwd_plain` (which recomputes P)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        ctx.scale = scale
        if _on_cpu(q, k, v):
            ctx.save_for_backward(q, k, v)
            return play_attention_plain(q, k, v, scale)
        out, lse = play_attention_fwd_res(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        do = do.contiguous()
        saved = ctx.saved_tensors  # unpacked once: checkpointing allows no more
        if len(saved) == 3:
            dq, dk, dv = play_attention_bwd_plain(*saved, do, ctx.scale)
        else:
            q, k, v, out, lse = saved
            dq, dk, dv = play_attention_bwd(q, k, v, out, lse, do, ctx.scale)
        return dq, dk, dv, None


def play_attention(q, k, v, scale: float):
    """softmax(scale * q k^T) v. When an input requires a gradient (and
    autograd is on) the call goes through `PlayAttention`. Otherwise CPU
    tensors take the plain version and CUDA tensors launch the forward
    kernel, kernel 1 (bf16, D = 128), or raise; `play_attention.launches`
    counts kernel 1."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return PlayAttention.apply(q, k, v, scale)
    if _on_cpu(q, k, v):
        return play_attention_plain(q, k, v, scale)
    _check_cuda_inputs(q, k, v)
    b, lq, _ = q.shape
    out = torch.empty_like(q)
    _launch("play_attention_fwd", "play_attention_fwd", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, lq, k.shape[1], scale * LOG2E)
    play_attention.launches += 1
    return out


play_attention.launches = 0


def play_attention_carry(q, k, v, o, m, l, scale: float):
    """One ring hop: merge softmax(scale q k^T) over this block of keys into
    the state (o, m, l) (see `play_attention_carry_plain`). CPU tensors take
    the plain version and get new state tensors. CUDA tensors launch kernel
    5 (bf16 q/k/v, D = 128, f32 state), which updates o, m and l in place
    and returns them, or raise; `play_attention_carry.launches` counts
    kernel 5."""
    if _on_cpu(q, k, v, o, m, l):
        return play_attention_carry_plain(q, k, v, o, m, l, scale)
    _check_cuda_inputs(q, k, v)
    b, lq, _ = q.shape
    _check_cuda_tensor("o", o, q.device, torch.float32, tuple(q.shape))
    for name, x in (("m", m), ("l", l)):
        _check_cuda_tensor(name, x, q.device, torch.float32, (b, lq))
    _launch("play_attention_fwd", "play_attention_carry", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(),
            l.data_ptr(), b, lq, k.shape[1], scale * LOG2E)
    play_attention_carry.launches += 1
    return o, m, l


play_attention_carry.launches = 0


def play_attention_carry_cost(b: int, lq: int, lk: int, d: int = HEAD_DIM) -> tuple[float, float]:
    """(FLOP, bytes) one hop needs: the forward's two products, bf16 q, k, v
    read once, and the f32 state (o, m, l) read once and written once."""
    flops = 4.0 * b * lq * lk * d
    nbytes = 2.0 * b * d * (lq + 2 * lk) + 2 * 4.0 * b * lq * (d + 2)
    return flops, nbytes


def play_attention_cost(b: int, lq: int, lk: int, d: int = HEAD_DIM) -> tuple[float, float]:
    """(FLOP, bytes) one forward needs: two products of 2*Lq*Lk*D each per
    row, and bf16 q, k, v read once and o written once."""
    flops = 4.0 * b * lq * lk * d
    nbytes = 2.0 * b * d * (2 * lq + 2 * lk)
    return flops, nbytes


def play_attention_bwd_cost(b: int, lq: int, lk: int, d: int = HEAD_DIM) -> tuple[float, float]:
    """(FLOP, bytes) the backward needs: five products of 2*Lq*Lk*D each
    (S, dP, dV, dQ, dK) per row; bf16 q, dO, dq and k, v, dk, dv and f32 lse
    and Di each moved once."""
    flops = 10.0 * b * lq * lk * d
    nbytes = 2.0 * b * d * (3 * lq + 4 * lk) + 8.0 * b * lq
    return flops, nbytes


def play_attention_bwd_dq_cost(b: int, lq: int, lk: int,
                               d: int = HEAD_DIM) -> tuple[float, float]:
    """(FLOP, bytes) kernel 3 needs: three products of 2*Lq*Lk*D each (S, dP,
    dS K) per row; bf16 q, dO, k, v read once and dq written once, and f32
    lse and Di read once."""
    flops = 6.0 * b * lq * lk * d
    nbytes = 2.0 * b * d * (3 * lq + 2 * lk) + 8.0 * b * lq
    return flops, nbytes


def play_attention_bwd_dkv_cost(b: int, lq: int, lk: int,
                                d: int = HEAD_DIM) -> tuple[float, float]:
    """(FLOP, bytes) kernel 4 needs: four products (S^T, dP^T, P^T dO,
    dS^T Q) per row; bf16 q, dO, k, v read once and dk, dv written once, and
    f32 lse and Di read once."""
    flops = 8.0 * b * lq * lk * d
    nbytes = 2.0 * b * d * (2 * lq + 4 * lk) + 8.0 * b * lq
    return flops, nbytes


def play_scale(c: int) -> float:
    """The model's softmax scale, c^-0.5 * log_12000(2c) (ppm_stereo.py)."""
    return c**-0.5 * math.log(2 * c, 12000)
