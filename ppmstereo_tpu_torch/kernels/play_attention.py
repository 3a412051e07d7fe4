"""The PPM "play" attention: q over the picked-memory key/value bank.

Counterpart of ppmstereo_tpu/kernels/play_attention.py. Single head,
non-causal, custom softmax scale, bf16 inputs, f32 softmax:

    O = softmax(scale * Q K^T) V,   q (B, Lq, D), k/v (B, Lk, D) -> (B, Lq, D)

Two versions of the same function:
  * `play_attention_plain`: plain PyTorch, chunked over query rows, f32
    logits and softmax, probabilities rounded to the value dtype before the
    f32-accumulated product (as the JAX package's `_play_attention_xla`
    and its Pallas kernel do). The wrapper uses it for CPU tensors only;
    `chip_smoke.py` holds the CUDA kernel against it on the card.
  * the CUDA kernel `csrc/play_attention.cu` (replaces the Pallas
    `_flash_kernel`), built by `kernels/_build.py` and bound with ctypes.

`play_attention` launches the kernel for CUDA tensors or raises; it never
falls back to the plain version on a card.
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


def _kernel():
    built = _build.build("play_attention")
    fn = built.lib.play_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


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


def play_attention(q, k, v, scale: float):
    """softmax(scale * q k^T) v. CPU tensors take the plain version; CUDA
    tensors launch the hand-written kernel (bf16, D = 128) or raise."""
    if q.device.type == k.device.type == v.device.type == "cpu":
        return play_attention_plain(q, k, v, scale)
    _check_cuda_inputs(q, k, v)
    b, lq, _ = q.shape
    lk = k.shape[1]
    fn = _kernel()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, lq, lk, scale * LOG2E, stream,
        )
    if err != 0:
        raise RuntimeError(f"play_attention kernel launch failed: CUDA error {err}")
    play_attention.launches += 1
    return out


play_attention.launches = 0


def play_attention_cost(b: int, lq: int, lk: int, d: int = HEAD_DIM) -> tuple[float, float]:
    """(FLOP, bytes) one call needs: two products of 2*Lq*Lk*D each per row,
    and bf16 q, k, v read once and o written once."""
    flops = 4.0 * b * lq * lk * d
    nbytes = 2.0 * b * d * (2 * lq + 2 * lk)
    return flops, nbytes


def play_scale(c: int) -> float:
    """The model's softmax scale, c^-0.5 * log_12000(2c) (ppm_stereo.py)."""
    return c**-0.5 * math.log(2 * c, 12000)
