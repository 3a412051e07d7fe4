"""Visual inspection: disparity colour maps and point-cloud renders
(counterpart of ppmstereo_tpu/evaluation/visualization.py), in numpy:
disparity -> depth -> 3-D points -> a z-buffered splat from a camera turned
about the vertical axis. Flicker between frames shows as shimmering splats
and as red pixels in the variance-masked mean view.
"""

from __future__ import annotations

import math
import os

import numpy as np


def colorize_disparity(disp: np.ndarray, vmin=None, vmax=None) -> np.ndarray:
    """(H, W) -> (H, W, 3) uint8 magma-like colormap (no cv2 needed)."""
    vmin = np.percentile(disp, 2) if vmin is None else vmin
    vmax = np.percentile(disp, 98) if vmax is None else vmax
    x = np.clip((disp - vmin) / max(vmax - vmin, 1e-6), 0, 1)
    # compact magma approximation
    r = np.clip(2.1 * x - 0.1, 0, 1)
    g = np.clip(1.6 * x - 0.4, 0, 1) ** 1.4
    b = np.clip(1.0 - np.abs(x - 0.35) * 2.2, 0, 1) * 0.8 + 0.2 * x
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def disparity_to_depth(disp: np.ndarray, focal_px: float, baseline: float) -> np.ndarray:
    return focal_px * baseline / np.maximum(np.abs(disp), 1e-3)


def depth_to_pcd(
    depth: np.ndarray, image: np.ndarray, focal_px: float,
    cx: float | None = None, cy: float | None = None,
):
    """(H, W) depth + (H, W, 3) image -> (N, 3) points, (N, 3) colors."""
    h, w = depth.shape
    cx = w / 2 if cx is None else cx
    cy = h / 2 if cy is None else cy
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    z = depth
    x = (xs - cx) * z / focal_px
    y = (ys - cy) * z / focal_px
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    cols = image.reshape(-1, 3)
    keep = np.isfinite(z).reshape(-1) & (z.reshape(-1) > 0)
    return pts[keep], cols[keep]


def render_pcd(
    pts: np.ndarray, cols: np.ndarray, hw: tuple[int, int], focal_px: float,
    yaw_deg: float = 15.0, splat: int = 1,
) -> np.ndarray:
    """Z-buffered splat render from a viewpoint turned by yaw_deg about
    the vertical axis through the scene's centroid."""
    h, w = hw
    center = pts.mean(axis=0)
    yaw = np.deg2rad(yaw_deg)
    rot = np.array(
        [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]],
        np.float32,
    )
    p = (pts - center) @ rot.T + center

    z = p[:, 2]
    valid = z > 1e-3
    u = (p[:, 0] / z) * focal_px + w / 2
    v = (p[:, 1] / z) * focal_px + h / 2
    ui, vi = np.round(u).astype(np.int64), np.round(v).astype(np.int64)
    valid &= (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)

    order = np.argsort(-z[valid])  # far -> near, near wins
    ui, vi, cols_v = ui[valid][order], vi[valid][order], cols[valid][order]

    img = np.zeros((h, w, 3), np.uint8)
    for dy in range(-splat, splat + 1):
        for dx in range(-splat, splat + 1):
            uu = np.clip(ui + dx, 0, w - 1)
            vv = np.clip(vi + dy, 0, h - 1)
            img[vv, uu] = cols_v
    return img


def render_prediction_views(
    disparity: np.ndarray, image: np.ndarray, focal_px: float = 500.0,
    baseline: float = 0.1, angles=(-15.0, 15.0),
) -> list[np.ndarray]:
    depth = disparity_to_depth(disparity, focal_px, baseline)
    pts, cols = depth_to_pcd(depth, image, focal_px)
    return [render_pcd(pts, cols, disparity.shape, focal_px, a) for a in angles]


def variance_masked_mean(
    frames: np.ndarray, threshold: float = 40.0
) -> np.ndarray:
    """Temporal mean of rendered views with the pixels whose variance
    (times 255) exceeds `threshold` painted red: flicker shows as red.

    frames: (T, H, W, 3) uint8 or float in [0, 1]/[0, 255].
    """
    x = np.asarray(frames, np.float32)
    if x.max() > 1.5:  # uint8-scaled input -> [0, 1]
        x = x / 255.0
    mean = x.mean(axis=0)
    var = x.var(axis=0)
    # per channel: mean * ~mask + red * mask, red = (1, 0, 0)
    var_mask = (var * 255.0) > threshold
    red = np.array([1.0, 0.0, 0.0], np.float32)
    out = mean * ~var_mask + red * var_mask
    return (out * 255.0).astype(np.uint8)


def save_reconstruction_views(
    disparity: np.ndarray, images: np.ndarray, out_dir: str,
    sequence_name: str = "seq", focal_px: float = 500.0,
    baseline: float = 0.1,
) -> dict:
    """Render a sequence in three modes (angle_15, angle_-15 and
    changing_angle, a cosine sweep of +-15 degrees) and write, per mode, the
    rendered frames (T, H, W, 3) uint8 as `.npy` and the variance-masked
    mean view as `_varmask.npy` (the JAX package's files without OpenCV;
    the port writes no video).

    disparity: (T, H, W); images: (T, H, W, 3) uint8. Returns
    {mode: path of the frames}."""
    os.makedirs(out_dir, exist_ok=True)
    t_len = len(disparity)
    modes = {
        "angle_15": [15.0] * t_len,
        "angle_-15": [-15.0] * t_len,
        "changing_angle": [math.cos(math.pi * (t / 15)) * 15 for t in range(t_len)],
    }
    written = {}
    for mode, angles in modes.items():
        frames = []
        for t in range(t_len):
            depth = disparity_to_depth(disparity[t], focal_px, baseline)
            pts, cols = depth_to_pcd(depth, images[t], focal_px)
            frames.append(render_pcd(pts, cols, disparity[t].shape, focal_px, angles[t]))
        frames = np.stack(frames)
        base = os.path.join(out_dir, f"{sequence_name}_reconstruction_mode_{mode}")
        np.save(base + ".npy", frames)
        np.save(base + "_varmask.npy", variance_masked_mean(frames))
        written[mode] = base + ".npy"
    return written
