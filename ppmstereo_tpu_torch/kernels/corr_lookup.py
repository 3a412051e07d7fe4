"""The correlation-pyramid lookup as one CUDA kernel (kernel 6).

Counterpart of ppmstereo_tpu/kernels/corr_lookup.py::corr_lookup_pallas:

    corr_lookup_kernel(pyramid, coords_x, radius=4, out_dtype=torch.float32)
        -> (N, H, W1, L (2r+1)) in out_dtype

with L = 1..MAX_LEVELS pyramid levels, level l (N, H, W1, W2 / 2^l) in f32
or bf16 (all levels one dtype), radius 1..MAX_RADIUS (the model's
`corr_levels` and `corr_radius`; `PPMStereoConfig` refuses others) and
coords_x (N, H, W1) f32: for each pixel, level and tap t in
[-r, r], the row of level l linearly interpolated at coords_x / 2^l + t,
zeros outside the row, level-major, the pyramid's values widened to f32 and
the blend in f32. The kernel (`csrc/corr_lookup.cu`) does all levels and
taps in one launch and writes f32 or bf16; the bf16 output is the f32
result rounded to nearest. Its plain version is the port's lookup,
`ops/corr.py::corr_lookup`, cast to `out_dtype`.

The model's test mode runs this lookup (`PPMUpdateLoop._iteration`); train
mode runs the plain lookup, which autograd differentiates: the kernel has no
backward, as the JAX package's has none. CPU tensors take the plain version;
CUDA tensors launch the kernel or raise, also when one of them requires a
gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ppmstereo_tpu_torch.kernels import _build
from ppmstereo_tpu_torch.ops.corr import corr_lookup

MAX_LEVELS = 6  # level counts and radii the kernel is built for
MAX_RADIUS = 6
RADIUS = 4  # the shipped model's radius
DTYPES = (torch.float32, torch.bfloat16)  # of the pyramid and of the output
# level0..5, width0..5, num_levels, radius, coords, out, pixels, pyramid_bf16,
# out_bf16, stream
_ARGTYPES = ([ctypes.c_void_p] * MAX_LEVELS + [ctypes.c_int] * (MAX_LEVELS + 2)
             + [ctypes.c_void_p] * 2 + [ctypes.c_int64] + [ctypes.c_int] * 2
             + [ctypes.c_void_p])


def _accepted(pyramid, coords_x, radius: int, out_dtype) -> bool:
    """Whether the kernel takes these arguments: the cheap test run on every
    call (`_check` says what is wrong)."""
    dev, shape, dtype = coords_x.get_device(), coords_x.shape, pyramid[0].dtype
    if (not 1 <= radius <= MAX_RADIUS or not 1 <= len(pyramid) <= MAX_LEVELS
            or out_dtype not in DTYPES or dtype not in DTYPES or dev < 0
            or coords_x.dtype != torch.float32 or coords_x.dim() != 3 or not coords_x.is_contiguous()):
        return False
    grad = torch.is_grad_enabled() and coords_x.requires_grad
    for c in pyramid:
        if (c.get_device() != dev or c.dtype != dtype or c.dim() != 4 or c.shape[:3] != shape
                or not c.is_contiguous() or c.data_ptr() % 16):
            return False
        grad = grad or (c.requires_grad and torch.is_grad_enabled())
    return not grad


def _check(pyramid, coords_x, radius: int, out_dtype) -> None:
    """Raise the reason the kernel does not take these arguments."""
    if not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"corr_lookup_kernel: radius {radius}, the kernel takes 1 to "
                         f"{MAX_RADIUS}")
    if not 1 <= len(pyramid) <= MAX_LEVELS:
        raise ValueError(f"corr_lookup_kernel: {len(pyramid)} levels, the kernel takes 1 to "
                         f"{MAX_LEVELS}")
    if out_dtype not in DTYPES:
        raise ValueError(f"corr_lookup_kernel: out_dtype {out_dtype}, the kernel writes float32 "
                         "or bfloat16")
    dev, pyr_dtype = coords_x.device, pyramid[0].dtype
    if pyr_dtype not in DTYPES:
        raise ValueError(f"corr_lookup_kernel: the pyramid is {pyr_dtype}, the kernel takes "
                         "float32 or bfloat16")
    for name, x, ndim, dtype in [("coords_x", coords_x, 3, torch.float32)] + [
            (f"level {i}", c, 4, pyr_dtype) for i, c in enumerate(pyramid)]:
        if x.device != dev or dev.type != "cuda":
            raise ValueError(f"corr_lookup_kernel: {name} is on {x.device}; the pyramid and "
                             "the coordinates must be on one CUDA device (or all on the CPU)")
        if x.dtype != dtype:
            raise ValueError(f"corr_lookup_kernel: {name} is {x.dtype}, expected {dtype} "
                             "(coordinates float32; every level of one dtype)")
        if x.dim() != ndim or x.shape[:3] != coords_x.shape:
            raise ValueError(f"corr_lookup_kernel: {name} has shape {tuple(x.shape)}, expected "
                             f"{tuple(coords_x.shape)}" + (" + (W,)" if ndim == 4 else ""))
        if not x.is_contiguous() or (ndim == 4 and x.data_ptr() % 16):
            raise ValueError(f"corr_lookup_kernel: {name} must be contiguous and 16-byte aligned")
        if x.requires_grad and torch.is_grad_enabled():
            raise ValueError(f"corr_lookup_kernel: {name} requires a gradient; the kernel has "
                             "no backward (train mode runs ops/corr.py::corr_lookup)")


@functools.cache
def _kernel():
    """The library's entry point, bound once."""
    fn = _build.build("corr_lookup").lib.corr_lookup
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def corr_lookup_kernel(pyramid: list[torch.Tensor], coords_x: torch.Tensor,
                       radius: int = RADIUS, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The pyramid lookup; `corr_lookup_kernel.launches` counts kernel 6."""
    if all(x.device.type == "cpu" for x in [coords_x, *pyramid]):
        return corr_lookup(pyramid, coords_x, radius).to(out_dtype)
    if not _accepted(pyramid, coords_x, radius, out_dtype):
        _check(pyramid, coords_x, radius, out_dtype)
        raise ValueError("corr_lookup_kernel: arguments the kernel does not take")
    n, h, w1 = coords_x.shape
    levels = len(pyramid)
    dev = coords_x.device
    out = torch.empty(n, h, w1, levels * (2 * radius + 1), dtype=out_dtype, device=dev)
    ptrs = [c.data_ptr() for c in pyramid] + [None] * (MAX_LEVELS - levels)
    widths = [c.shape[-1] for c in pyramid] + [0] * (MAX_LEVELS - levels)
    args = (*ptrs, *widths, levels, radius, coords_x.data_ptr(), out.data_ptr(), n * h * w1,
            int(pyramid[0].dtype == torch.bfloat16), int(out_dtype == torch.bfloat16))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index == torch.cuda.current_device():
        err = _kernel()(*args, stream)
    else:  # the library launches on the current device
        with torch.cuda.device(dev):
            err = _kernel()(*args, stream)
    if err != 0:
        raise RuntimeError(f"corr_lookup kernel launch failed: CUDA error {err}")
    corr_lookup_kernel.launches += 1
    return out


corr_lookup_kernel.launches = 0


def corr_lookup_bytes(pyramid: list[torch.Tensor], coords_x: torch.Tensor,
                      radius: int = RADIUS, out_dtype: torch.dtype = torch.float32) -> float:
    """The bytes a lookup must move on these inputs, at the pyramid's and the
    output's element sizes: the pyramid elements it reads (per pixel and
    level, the indices floor(x / 2^l) - r .. + r + 1 that lie in the row),
    the f32 coordinates and the output, each once."""
    n_read = 0
    for lvl, corr in enumerate(pyramid):
        lo = torch.floor(coords_x.double() / 2**lvl) - radius
        hi = lo + 2 * radius + 1  # inclusive
        w = corr.shape[-1]
        n_read += int((hi.clamp(max=w - 1) - lo.clamp(min=0) + 1).clamp(min=0).sum().item())
    pixels = coords_x.numel()
    out_size = torch.empty((), dtype=out_dtype).element_size()
    return (pyramid[0].element_size() * n_read + 4.0 * pixels
            + out_size * pixels * len(pyramid) * (2 * radius + 1))
