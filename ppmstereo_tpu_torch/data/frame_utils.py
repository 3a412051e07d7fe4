"""File formats of the stereo datasets (counterpart of
ppmstereo_tpu/data/frame_utils.py): Middlebury .flo, PFM (read and write),
Sintel packed-PNG disparity, Middlebury ground truth, 16-bit float PNG depth
(Dynamic Replica), KITTI and VKITTI2 depth PNGs, numpy-first and
channels-last.

PNGs go through the port's own codec (`data/png.py`), so no image library
is needed. JPEG frames raise: of the datasets only VKITTI2, a training set,
stores them. `read_gen` reads PFM and FLO through the native readers.
"""

from __future__ import annotations

import os.path as osp
import re

import numpy as np

from ppmstereo_tpu_torch.data import native
from ppmstereo_tpu_torch.data.png import read_png

FLO_MAGIC = 202021.25


def read_flow(path: str) -> np.ndarray:
    """Middlebury .flo -> (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if len(magic) == 0 or magic[0] != np.float32(FLO_MAGIC):
            raise ValueError(f"invalid .flo magic in {path}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def read_pfm(path: str) -> np.ndarray:
    """PFM -> (H, W) or (H, W, 3) float, flipped from bottom-up to top-down."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"not a PFM file: {path}")
        m = re.match(rb"^(\d+)\s(\d+)\s*$", f.readline())
        if not m:
            raise ValueError(f"malformed PFM header in {path}")
        width, height = map(int, m.groups())
        scale = float(f.readline().rstrip())
        data = np.fromfile(f, ("<" if scale < 0 else ">") + "f")
    shape = (height, width, 3) if header == b"PF" else (height, width)
    return np.flipud(data.reshape(shape))


def write_pfm(path: str, data: np.ndarray, scale: float = 1.0) -> None:
    data = np.asarray(data, np.float32)
    color = data.ndim == 3 and data.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        endian = data.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        np.flipud(data).tofile(f)


def _read_png_of(path: str, what: str) -> np.ndarray:
    if osp.splitext(path)[-1].lower() != ".png":
        raise ValueError(f"{path}: {what} must be a PNG file (the port reads no JPEG)")
    return read_png(path)


def read_image(path: str) -> np.ndarray:
    """RGB uint8 (H, W, 3) from an 8-bit gray, RGB or RGBA PNG."""
    img = _read_png_of(path, "an image")
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: a 16-bit PNG is not an image frame")
    if img.ndim == 2:
        img = np.tile(img[..., None], (1, 1, 3))
    return img[..., :3]


def read_disp_sintel(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Sintel packed-PNG disparity and its validity from the occlusion map
    beside it (disparities/ -> occlusions/)."""
    rgb = _read_png_of(path, "a Sintel disparity").astype(np.float64)
    disp = rgb[..., 0] * 4 + rgb[..., 1] / 2**6 + rgb[..., 2] / 2**14
    mask = read_png(path.replace("disparities", "occlusions"))
    return disp, (mask == 0) & (disp > 0)


def read_disp_middlebury(path: str) -> tuple[np.ndarray, np.ndarray]:
    if osp.basename(path) != "disp0GT.pfm":
        raise ValueError(f"{path}: Middlebury ground truth is named disp0GT.pfm")
    disp = read_pfm(path).astype(np.float32)
    nocc = read_png(path.replace("disp0GT.pfm", "mask0nocc.png")) == 255
    return disp, nocc


def read_16bit_float_depth(path: str) -> np.ndarray:
    """A 16-bit gray PNG whose values are float16 bits (Dynamic Replica)."""
    raw = _read_png_of(path, "a float16 depth map")
    if raw.dtype != np.uint16 or raw.ndim != 2:
        raise ValueError(f"{path}: a float16 depth map must be a 16-bit gray PNG")
    return raw.view(np.float16).astype(np.float32)


def read_kitti_depth(path: str) -> np.ndarray:
    """KITTI depth: 16-bit PNG in 1/256 m, 0 (no measurement) -> -1."""
    raw = _read_png_of(path, "a KITTI depth map").astype(np.int64)
    if raw.max() <= 255:
        raise ValueError(f"{path}: expected 16-bit KITTI depth")
    depth = raw.astype(np.float32) / 256.0
    depth[raw == 0] = -1.0
    return depth


def read_vkitti2_depth(path: str) -> np.ndarray:
    """VKITTI2 depth: 16-bit PNG in cm, 0 -> -1."""
    raw = _read_png_of(path, "a VKITTI2 depth map")
    depth = raw.astype(np.float32) / 100.0
    depth[raw == 0] = -1.0
    return depth


def read_gen(path: str):
    """Read a frame, flow or disparity file by its extension. PFM and FLO go
    through the native readers (`data/native.py`), as the JAX package's
    `read_gen` does; `read_pfm` and `read_flow` are their plain versions."""
    ext = osp.splitext(path)[-1].lower()
    if ext == ".png":
        return read_image(path)
    if ext in (".jpg", ".jpeg", ".ppm"):
        raise ValueError(f"{path}: the port reads PNG frames only")
    if ext in (".bin", ".raw"):
        return np.load(path)
    if ext == ".flo":
        return native.read_flo(path)
    if ext == ".pfm":
        data = native.read_pfm(path)
        return data if data.ndim == 2 else data[..., :-1]
    raise ValueError(f"unsupported extension: {path}")


def read_depth_any(path: str) -> np.ndarray:
    """Depth by extension and dataset: .npy, KITTI or VKITTI2 PNG, or a
    float16 PNG."""
    if path.endswith("npy"):
        return np.load(path)
    if path.endswith("png"):
        if "kitti_depth" in path:
            return read_kitti_depth(path)
        if "vkitti2" in path:
            return read_vkitti2_depth(path)
        return read_16bit_float_depth(path)
    raise ValueError(f"unsupported depth format: {path}")
