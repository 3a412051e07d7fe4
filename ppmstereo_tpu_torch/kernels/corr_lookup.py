"""The correlation-pyramid lookup as one CUDA kernel (kernel 6).

Counterpart of ppmstereo_tpu/kernels/corr_lookup.py::corr_lookup_pallas:

    corr_lookup_kernel(pyramid, coords_x, radius=4) -> (N, H, W1, L (2r+1)) f32

with pyramid level l (N, H, W1, W2 / 2^l) f32 and coords_x (N, H, W1) f32:
for each pixel, level and tap t in [-r, r], the row of level l linearly
interpolated at coords_x / 2^l + t, zeros outside the row, level-major. The
kernel (`csrc/corr_lookup.cu`) does all levels and taps in one launch. Its
plain version is the port's lookup, `ops/corr.py::corr_lookup`, which the
model runs (as the JAX model runs XLA's lookup and not the Pallas kernel);
the kernel is on no path of the model yet. CPU tensors take the plain
version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from ppmstereo_tpu_torch.kernels import _build
from ppmstereo_tpu_torch.ops.corr import corr_lookup

MAX_LEVELS = 4
_ARGTYPES = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]


def _check(pyramid, coords_x) -> None:
    if not 1 <= len(pyramid) <= MAX_LEVELS:
        raise ValueError(f"corr_lookup_kernel: {len(pyramid)} levels, the kernel takes 1 to "
                         f"{MAX_LEVELS}")
    dev = coords_x.device
    for name, x, ndim in [("coords_x", coords_x, 3)] + [
            (f"level {i}", c, 4) for i, c in enumerate(pyramid)]:
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"corr_lookup_kernel: {name} is on {x.device}; the pyramid and "
                             "the coordinates must be on one CUDA device (or all on the CPU)")
        if x.dtype != torch.float32:
            raise ValueError(f"corr_lookup_kernel: {name} is {x.dtype}, the kernel takes float32")
        if x.dim() != ndim or tuple(x.shape[:3]) != tuple(coords_x.shape):
            raise ValueError(f"corr_lookup_kernel: {name} has shape {tuple(x.shape)}, expected "
                             f"{tuple(coords_x.shape)}" + (" + (W,)" if ndim == 4 else ""))
        if not x.is_contiguous():
            raise ValueError(f"corr_lookup_kernel: {name} must be contiguous")


def corr_lookup_kernel(pyramid: list[torch.Tensor], coords_x: torch.Tensor,
                       radius: int = 4) -> torch.Tensor:
    """The pyramid lookup; `corr_lookup_kernel.launches` counts kernel 6."""
    if all(x.device.type == "cpu" for x in [coords_x, *pyramid]):
        return corr_lookup(pyramid, coords_x, radius)
    _check(pyramid, coords_x)
    n, h, w1 = coords_x.shape
    levels = len(pyramid)
    out = torch.empty(n, h, w1, levels * (2 * radius + 1), dtype=torch.float32,
                      device=coords_x.device)
    fn = _build.build("corr_lookup").lib.corr_lookup
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    ptrs = (ctypes.c_void_p * levels)(*[c.data_ptr() for c in pyramid])
    widths = (ctypes.c_int * levels)(*[c.shape[-1] for c in pyramid])
    with torch.cuda.device(coords_x.device):
        stream = torch.cuda.current_stream(coords_x.device).cuda_stream
        err = fn(ptrs, widths, levels, radius, coords_x.data_ptr(), out.data_ptr(),
                 n * h * w1, stream)
    if err != 0:
        raise RuntimeError(f"corr_lookup kernel launch failed: CUDA error {err}")
    corr_lookup_kernel.launches += 1
    return out


corr_lookup_kernel.launches = 0


def corr_lookup_bytes(pyramid: list[torch.Tensor], coords_x: torch.Tensor,
                      radius: int = 4) -> float:
    """The bytes a lookup must move on these inputs: the pyramid elements it
    reads (per pixel and level, the indices floor(x / 2^l) - r .. + r + 1
    that lie in the row), the coordinates and the output, each once."""
    n_read = 0
    for lvl, corr in enumerate(pyramid):
        lo = torch.floor(coords_x.double() / 2**lvl) - radius
        hi = lo + 2 * radius + 1  # inclusive
        w = corr.shape[-1]
        n_read += int((hi.clamp(max=w - 1) - lo.clamp(min=0) + 1).clamp(min=0).sum().item())
    pixels = coords_x.numel()
    return 4.0 * (n_read + pixels + pixels * len(pyramid) * (2 * radius + 1))
