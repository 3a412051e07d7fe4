"""Sequence-consistent augmentation for stereo video clips (counterpart of
ppmstereo_tpu/data/augmentor.py: `ColorJitter`, `SequenceDispFlowAugmentor`
and `SequenceDispSparseFlowAugmentor`).

The JAX package uses OpenCV for two functions; the port has no OpenCV and
writes them in numpy:

  * `resize_linear`: cv2.resize(src, None, fx, fy, INTER_LINEAR). The output
    size is round(w fx) x round(h fy); output pixel x samples the source at
    (x + 0.5) / fx - 0.5, with both taps clamped to the border, first along
    the width, then along the height. For uint8 images the tap weights are
    quantised to 1/2048 and the two passes shifted and rounded as OpenCV's
    fixed-point (vectorised) path does; about 0.2 % of the pixels still
    differ by one level. Float maps are interpolated in float32.
  * `rgb_to_hsv` / `hsv_to_rgb`: cv2.cvtColor with COLOR_RGB2HSV /
    COLOR_HSV2RGB on uint8 (hue in [0, 180)). RGB -> HSV repeats OpenCV's
    integer arithmetic exactly. HSV -> RGB takes OpenCV's float formula and
    truncates to a level, which matches its vectorised path (the one an
    image takes) on about 98.6 % of the values; the rest differ by one.

(F.interpolate maps by the ratio of the output and input sizes and floors
the size, so it is not the same function.)

The augmentor draws from its own numpy generator in the same order as the
JAX package's, so one seed gives one augmentation in both.

Data layout: images (T, 2, H, W, 3) uint8 (left/right); disp (T, C, H, W,
2) float32 (x, y disparity as flow).
"""

from __future__ import annotations

import numpy as np

_COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS


def _taps(in_size: int, out_size: int, scale: float):
    """Source indices (i0, i1) and weights (w0, w1) of each output position
    along one axis, as OpenCV computes them for a scale factor `scale`."""
    inv = 1.0 / scale
    pos = ((np.arange(out_size, dtype=np.float64) + 0.5) * inv - 0.5).astype(np.float32)
    i0 = np.floor(pos).astype(np.int64)
    frac = pos - i0
    frac = np.where(i0 < 0, 0.0, frac)
    i0 = np.clip(i0, 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    return i0, i1, (1.0 - frac).astype(np.float32), frac.astype(np.float32)


def resize_linear(src: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """cv2.resize(src, None, fx=fx, fy=fy, interpolation=INTER_LINEAR) for
    (H, W) or (H, W, C) uint8 or float32 arrays."""
    h, w = src.shape[:2]
    out_h, out_w = int(round(h * fy)), int(round(w * fx))
    xi0, xi1, xw0, xw1 = _taps(w, out_w, fx)
    yi0, yi1, yw0, yw1 = _taps(h, out_h, fy)
    chan = (None,) * (src.ndim - 2)
    if src.dtype == np.uint8:
        # fixed point: weights in 1/2048; the horizontal pass keeps the
        # 2048-scaled sum, the vertical one takes (row >> 4) * w >> 16 per
        # tap and rounds the sum of the two by (+2) >> 2
        qx0, qx1, qy0, qy1 = (np.rint(wt * _COEF_SCALE).astype(np.int64)
                              for wt in (xw0, xw1, yw0, yw1))
        s = src.astype(np.int64)
        rows = s[:, xi0] * qx0[(None, slice(None)) + chan] + s[:, xi1] * qx1[(None, slice(None)) + chan]
        top = ((rows[yi0] >> 4) * qy0[(slice(None), None) + chan]) >> 16
        bottom = ((rows[yi1] >> 4) * qy1[(slice(None), None) + chan]) >> 16
        return np.clip((top + bottom + 2) >> 2, 0, 255).astype(np.uint8)
    s = src.astype(np.float32)
    rows = s[:, xi0] * xw0[(None, slice(None)) + chan] + s[:, xi1] * xw1[(None, slice(None)) + chan]
    return rows[yi0] * yw0[(slice(None), None) + chan] + rows[yi1] * yw1[(slice(None), None) + chan]


_HSV_SHIFT = 12


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_RGB2HSV) for uint8 RGB: OpenCV's integer
    formula (hue in [0, 180), saturation and value in [0, 255])."""
    rgb = img.astype(np.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = v - vmin
    idx = np.arange(256)
    with np.errstate(divide="ignore"):
        sdiv = np.where(idx > 0, np.rint((255 << _HSV_SHIFT) / np.maximum(idx, 1)), 0).astype(np.int64)
        hdiv = np.where(idx > 0, np.rint((180 << _HSV_SHIFT) / (6.0 * np.maximum(idx, 1))), 0).astype(np.int64)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> _HSV_SHIFT
    hue = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    hue = (hue * hdiv[diff] + half) >> _HSV_SHIFT
    hue = np.where(hue < 0, hue + 180, hue)
    return np.stack([hue, s, v], axis=-1).astype(np.uint8)


_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, COLOR_HSV2RGB) for uint8 (hue in [0, 180)): OpenCV's
    float formula, truncated to a level."""
    h = hsv[..., 0].astype(np.float32) * np.float32(6.0 / 180.0)
    s = hsv[..., 1].astype(np.float32) * np.float32(1.0 / 255.0)
    v = hsv[..., 2].astype(np.float32) * np.float32(1.0 / 255.0)
    h = np.mod(h, np.float32(6.0))
    sector = np.floor(h).astype(np.int64)
    frac = h - sector
    bad = (sector < 0) | (sector >= 6)
    sector = np.where(bad, 0, sector)
    frac = np.where(bad, np.float32(0.0), frac)
    tab = np.stack([v, v * (1 - s), v * (1 - s * frac), v * (1 - s * (1 - frac))], axis=-1)
    order = _SECTORS[sector]  # (..., 3): indices of b, g, r in tab
    bgr = np.take_along_axis(tab, order, axis=-1)
    gray = s == 0
    bgr = np.where(gray[..., None], v[..., None], bgr)
    rgb = bgr[..., ::-1] * np.float32(255.0)
    return np.clip(np.floor(rgb), 0, 255).astype(np.uint8)


def _adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(img.astype(np.float32) * factor, 0, 255)


def _adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    gray = img @ np.array([0.299, 0.587, 0.114], np.float32)
    mean = gray.mean()
    return np.clip((img.astype(np.float32) - mean) * factor + mean, 0, 255)


def _adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    gray = (img @ np.array([0.299, 0.587, 0.114], np.float32))[..., None]
    return np.clip(gray + (img.astype(np.float32) - gray) * factor, 0, 255)


def _adjust_hue(img: np.ndarray, shift: float) -> np.ndarray:
    """shift in [-0.5, 0.5] revolutions."""
    hsv = rgb_to_hsv(img.astype(np.uint8))
    h = hsv[..., 0].astype(np.int32)
    hsv[..., 0] = ((h + int(round(shift * 180))) % 180).astype(np.uint8)
    return hsv_to_rgb(hsv).astype(np.float32)


def _adjust_gamma(img: np.ndarray, gamma: float, gain: float = 1.0) -> np.ndarray:
    return np.clip(255.0 * gain * (img.astype(np.float32) / 255.0) ** gamma, 0, 255)


class ColorJitter:
    """torchvision-style jitter: random-order brightness, contrast,
    saturation and hue with uniformly sampled factors."""

    def __init__(self, brightness=0.4, contrast=0.4, saturation=(0.6, 1.4), hue=0.5 / 3.14):
        self.brightness = (max(0, 1 - brightness), 1 + brightness)
        self.contrast = (max(0, 1 - contrast), 1 + contrast)
        self.saturation = tuple(saturation)
        self.hue = (-hue, hue)

    def sample_params(self, rng: np.random.Generator) -> dict:
        return {
            "order": rng.permutation(4),
            "brightness": rng.uniform(*self.brightness),
            "contrast": rng.uniform(*self.contrast),
            "saturation": rng.uniform(*self.saturation),
            "hue": rng.uniform(*self.hue),
        }

    @staticmethod
    def apply(img: np.ndarray, p: dict) -> np.ndarray:
        out = img.astype(np.float32)
        ops = (lambda x: _adjust_brightness(x, p["brightness"]),
               lambda x: _adjust_contrast(x, p["contrast"]),
               lambda x: _adjust_saturation(x, p["saturation"]),
               lambda x: _adjust_hue(x, p["hue"]))
        for op in p["order"]:
            out = ops[op](out)
        return out


class SequenceDispFlowAugmentor:
    """Dense-ground-truth augmentor, as the training mixture configures the
    JAX package's (`yjitter=True`, gamma range (1, 1, 1, 1)): photometric
    jitter (shared by the clip, or per image with probability 0.2), eraser
    occlusions, random scale and stretch, and a crop with a per-frame
    vertical jitter of the right view."""

    GAMMA = (1, 1, 1, 1)  # gamma and gain ranges: drawn, and 1 either way

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5,
                 saturation_range=(0.6, 1.4), seed: int | None = None):
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 1.0
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.jitter = ColorJitter(saturation=saturation_range)
        self.asymmetric_color_aug_prob = 0.2
        self.eraser_aug_prob = 0.5
        self.rng = np.random.default_rng(seed)

    def _jitter_once(self, img, rng):
        p = self.jitter.sample_params(rng)
        out = ColorJitter.apply(img, p)
        g = self.GAMMA
        out = _adjust_gamma(out, rng.uniform(g[0], g[1]), rng.uniform(g[2], g[3]))
        return out.astype(np.uint8)

    def color_transform(self, images: np.ndarray, rng) -> np.ndarray:
        t = images.shape[0]
        if rng.random() < self.asymmetric_color_aug_prob:
            return np.stack([np.stack([self._jitter_once(images[i, c], rng) for c in (0, 1)])
                             for i in range(t)])
        # one jitter for the whole clip and both cameras
        stack = images.reshape(t * 2, *images.shape[2:])
        p = self.jitter.sample_params(rng)
        gamma = rng.uniform(self.GAMMA[0], self.GAMMA[1])
        gain = rng.uniform(self.GAMMA[2], self.GAMMA[3])
        out = [_adjust_gamma(ColorJitter.apply(im, p), gamma, gain).astype(np.uint8)
               for im in stack]
        return np.stack(out).reshape(images.shape)

    def eraser_transform(self, images: np.ndarray, rng, bounds=(50, 100)) -> np.ndarray:
        t, _, ht, wd, _ = images.shape
        mean_color = images[0, 0].reshape(-1, 3).mean(axis=0)
        images = images.copy()
        for i in range(t):
            for cam in (0, 1):
                if rng.random() < self.eraser_aug_prob:
                    for _ in range(rng.integers(1, 3)):
                        x0 = rng.integers(0, wd)
                        y0 = rng.integers(0, ht)
                        dx = rng.integers(bounds[0], bounds[1])
                        dy = rng.integers(bounds[0], bounds[1])
                        images[i, cam, y0: y0 + dy, x0: x0 + dx] = mean_color
        return images

    def _sample_scales(self, ht, wd, rng):
        min_scale = max((self.crop_size[0] + 8) / float(ht), (self.crop_size[1] + 8) / float(wd))
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        sx = sy = scale
        if rng.random() < self.stretch_prob:
            sx *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
            sy *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
        return max(sx, min_scale), max(sy, min_scale)

    def spatial_transform(self, images, disp, rng):
        t, _, ht, wd, _ = images.shape
        sx, sy = self._sample_scales(ht, wd, rng)
        if rng.random() < self.spatial_aug_prob:
            images = np.stack([np.stack([resize_linear(images[i, c], sx, sy) for c in (0, 1)])
                               for i in range(t)])
            if disp is not None:
                disp = np.stack([
                    np.stack([resize_linear(disp[i, c], sx, sy) * np.array([sx, sy], np.float32)
                              for c in range(disp.shape[1])])
                    for i in range(t)])

        # the crop, the right view shifted by -2..2 rows per frame
        ch, cw = self.crop_size
        hh, ww = images.shape[2], images.shape[3]
        y0 = int(rng.integers(2, hh - ch - 2))
        x0 = int(rng.integers(2, ww - cw - 2))
        imgs_out, disp_out = [], []
        for i in range(t):
            y1 = y0 + int(rng.integers(-2, 3))
            left = images[i, 0, y0: y0 + ch, x0: x0 + cw]
            right = images[i, 1, y1: y1 + ch, x0: x0 + cw]
            imgs_out.append(np.stack([left, right]))
            if disp is not None:
                d = [disp[i, 0, y0: y0 + ch, x0: x0 + cw]]
                if disp.shape[1] > 1:
                    d.append(disp[i, 1, y1: y1 + ch, x0: x0 + cw])
                disp_out.append(np.stack(d))
        return np.stack(imgs_out), np.stack(disp_out) if disp is not None else None

    def __call__(self, images, disp, rng: np.random.Generator | None = None):
        """Augment one clip with `rng`. The draws come in one fixed order,
        so one generator state gives one augmentation. The training loader
        always passes a generator of the sample's own (`data/loader.py`).
        With none, the augmentor's own generator (seeded by `seed`) is
        drawn from, call after call: that is the JAX package's augmentor,
        and the path the parity tests hold against it."""
        rng = self.rng if rng is None else rng
        images = self.color_transform(images, rng)
        images = self.eraser_transform(images, rng)
        images, disp = self.spatial_transform(images, disp, rng)
        return np.ascontiguousarray(images), (
            np.ascontiguousarray(disp) if disp is not None else None)


class SequenceDispSparseFlowAugmentor(SequenceDispFlowAugmentor):
    """Sparse-ground-truth variant: one photometric jitter for the whole clip
    always, and the valid disparity samples moved to their nearest pixel of
    the resized grid instead of a bilinear resize; a crop without the right
    view's jitter."""

    def color_transform(self, images: np.ndarray, rng) -> np.ndarray:
        t = images.shape[0]
        stack = images.reshape(t * 2, *images.shape[2:])
        p = self.jitter.sample_params(rng)
        gamma = rng.uniform(self.GAMMA[0], self.GAMMA[1])
        gain = rng.uniform(self.GAMMA[2], self.GAMMA[3])
        out = [_adjust_gamma(ColorJitter.apply(im, p), gamma, gain).astype(np.uint8)
               for im in stack]
        return np.stack(out).reshape(images.shape)

    @staticmethod
    def resize_sparse_flow_map(flow, valid, fx=1.0, fy=1.0):
        """(H, W, 2) flow and (H, W) validity -> the resized grid's
        (round(H fy), round(W fx), 2) flow and int32 validity: each valid
        sample, scaled by (fx, fy), lands on the nearest pixel of its scaled
        position; samples on the first row or column or outside are
        dropped."""
        ht, wd = flow.shape[:2]
        xx, yy = np.meshgrid(np.arange(wd), np.arange(ht))
        coords = np.stack([xx, yy], axis=-1).reshape(-1, 2).astype(np.float32)
        flow_flat = flow.reshape(-1, 2).astype(np.float32)
        valid_flat = valid.reshape(-1) >= 1
        coords0, flow0 = coords[valid_flat], flow_flat[valid_flat]
        ht1, wd1 = int(round(ht * fy)), int(round(wd * fx))
        coords1 = coords0 * [fx, fy]
        flow1 = flow0 * [fx, fy]
        xi = np.round(coords1[:, 0]).astype(np.int32)
        yi = np.round(coords1[:, 1]).astype(np.int32)
        keep = (xi > 0) & (xi < wd1) & (yi > 0) & (yi < ht1)
        flow_img = np.zeros([ht1, wd1, 2], np.float32)
        valid_img = np.zeros([ht1, wd1], np.int32)
        flow_img[yi[keep], xi[keep]] = flow1[keep]
        valid_img[yi[keep], xi[keep]] = 1
        return flow_img, valid_img

    def spatial_transform(self, images, disp, valid, rng):
        t, _, ht, wd, _ = images.shape
        sx, sy = self._sample_scales(ht, wd, rng)
        if rng.random() < self.spatial_aug_prob:
            images = np.stack([np.stack([resize_linear(images[i, c], sx, sy) for c in (0, 1)])
                               for i in range(t)])
            if disp is not None:
                resized = [[self.resize_sparse_flow_map(disp[i, c], valid[i, c], sx, sy)
                            for c in range(disp.shape[1])] for i in range(t)]
                disp = np.stack([np.stack([d for d, _ in cams]) for cams in resized])
                valid = np.stack([np.stack([v for _, v in cams]) for cams in resized])
        ch, cw = self.crop_size
        hh, ww = images.shape[2], images.shape[3]
        y0 = int(rng.integers(0, hh - ch))
        x0 = int(rng.integers(0, ww - cw))
        images = images[:, :, y0: y0 + ch, x0: x0 + cw]
        if disp is not None:
            disp = disp[:, :, y0: y0 + ch, x0: x0 + cw]
            valid = valid[:, :, y0: y0 + ch, x0: x0 + cw]
        return images, disp, valid

    def __call__(self, images, disp, valid, rng: np.random.Generator | None = None):
        """Augment one clip and its validity (T, C, H, W) with `rng` (the
        augmentor's own generator when None, as for the dense one)."""
        rng = self.rng if rng is None else rng
        images = self.color_transform(images, rng)
        images = self.eraser_transform(images, rng)
        images, disp, valid = self.spatial_transform(images, disp, valid, rng)
        return (np.ascontiguousarray(images),
                None if disp is None else np.ascontiguousarray(disp),
                None if valid is None else np.ascontiguousarray(valid))
