"""ctypes binding of the port's native data readers, `csrc/stereoio.cpp`
(counterpart of ppmstereo_tpu/data/native.py).

The library is compiled with g++ the first time a function here is called
(`kernels/_build.py`: into `build/ppmstereo_tpu_torch/`, named after a hash
of the source, the flags and the host's instruction set). A failed build or
load raises with the compiler's or the loader's message: nothing falls back
to numpy. The numpy readers of `data/frame_utils.py` stay as the plain
versions.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ppmstereo_tpu_torch.kernels import _build

_INT_P = ctypes.POINTER(ctypes.c_int)
_FLOAT_P = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "read_pfm": ([ctypes.c_char_p, _FLOAT_P, _INT_P, _INT_P, _INT_P], ctypes.c_int),
    "read_flo": ([ctypes.c_char_p, _FLOAT_P, _INT_P, _INT_P], ctypes.c_int),
    "photometric_fused": ([ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64] + [ctypes.c_float] * 6
                          + [ctypes.POINTER(ctypes.c_int32)], None),
}


def _load() -> ctypes.CDLL:
    lib = _build.build("stereoio").lib
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def available() -> bool:
    """True once the library is built and loaded; a failed build raises."""
    return _load() is not None


def read_pfm(path: str) -> np.ndarray:
    """PFM -> (H, W) or (H, W, 3) float32, top-down."""
    lib = _load()
    h, w, ch = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.read_pfm(path.encode(), None, ctypes.byref(h), ctypes.byref(w), ctypes.byref(ch))
    if rc != 0:
        raise IOError(f"read_pfm({path}) failed: {rc}")
    out = np.empty((h.value, w.value) if ch.value == 1 else (h.value, w.value, 3), np.float32)
    rc = lib.read_pfm(path.encode(), out.ctypes.data_as(_FLOAT_P),
                      ctypes.byref(h), ctypes.byref(w), ctypes.byref(ch))
    if rc != 0:
        raise IOError(f"read_pfm({path}) failed: {rc}")
    return out


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo -> (H, W, 2) float32."""
    lib = _load()
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.read_flo(path.encode(), None, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"read_flo({path}) failed: {rc}")
    out = np.empty((h.value, w.value, 2), np.float32)
    rc = lib.read_flo(path.encode(), out.ctypes.data_as(_FLOAT_P),
                      ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"read_flo({path}) failed: {rc}")
    return out


def photometric_fused(
    img: np.ndarray, brightness: float, contrast: float, saturation: float,
    gamma: float, gain: float, order: np.ndarray,
) -> np.ndarray:
    """Fused jitter on (..., 3) uint8, in place when `img` is contiguous.
    order: 3 ints from {0: brightness, 1: contrast, 2: saturation}, applied
    in that order, then the gamma LUT (hue is the caller's)."""
    lib = _load()
    flat = np.ascontiguousarray(img.reshape(-1, 3))
    gray_mean = float((flat @ np.array([0.299, 0.587, 0.114], np.float32)).mean())
    order_arr = np.ascontiguousarray(order, np.int32)
    lib.photometric_fused(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), flat.shape[0],
        brightness, contrast, saturation, gamma, gain, gray_mean,
        order_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return flat.reshape(img.shape)
