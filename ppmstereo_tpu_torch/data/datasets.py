"""The training data of the one-card PPMStereo run (counterpart of
ppmstereo_tpu/data/datasets.py: the `StereoSequenceDataset` base,
`SyntheticStereoDataset` and `fetch_dataloader`).

Ground-truth conventions are the JAX package's: disparity is stored as
negative-x flow (np.stack([-disp, 0])), and after augmentation
valid = |disp| < 512 and disp != 0.

Samples are channels-last numpy dicts:
  img   (T, 2, H, W, 3) float32 in [0, 255]
  disp  (T, 1, H, W, 1) float32 (negative-x disparity of the left camera)
  valid (T, 1, H, W)    float32

The readers of SceneFlow and Dynamic Replica are not ported yet; where
their data is on disk, `fetch_dataloader` raises instead of training on
something else.
"""

from __future__ import annotations

import copy
import logging
import os.path as osp

import numpy as np

from ppmstereo_tpu_torch.data.augmentor import SequenceDispFlowAugmentor


def _gaussian_taps_fixed(sigma: float = 3.0, size: int = 19, bits: int = 8) -> np.ndarray:
    """OpenCV's fixed-point Gaussian taps for uint8 images: the normalised
    Gaussian in units of 2^-bits, rounded with the error carried from tap to
    tap towards the centre, whose tap makes the sum exactly 2^bits."""
    x = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-x * x / (2 * sigma * sigma))
    g /= g.sum()
    taps = np.zeros(size, np.int64)
    err = 0.0
    for i in range(size // 2):
        adj = g[i] * (1 << bits) + err
        taps[i] = taps[size - 1 - i] = int(np.rint(adj))
        err = adj - taps[i]
    taps[size // 2] = (1 << bits) - 2 * taps[: size // 2].sum()
    return taps


def gaussian_blur_sigma3(img: np.ndarray) -> np.ndarray:
    """cv2.GaussianBlur(img, (0, 0), 3) for (H, W, C) uint8, bit-exact:
    19 taps of 2^-8, mirrored edges (BORDER_REFLECT_101), a horizontal then
    a vertical pass in integers and one rounding at the end."""
    taps = _gaussian_taps_fixed()
    r = len(taps) // 2
    h, w = img.shape[:2]
    x = np.pad(img.astype(np.int64), ((0, 0), (r, r), (0, 0)), mode="reflect")
    rows = sum(c * x[:, i: i + w] for i, c in enumerate(taps))
    x = np.pad(rows, ((r, r), (0, 0), (0, 0)), mode="reflect")
    out = sum(c * x[i: i + h] for i, c in enumerate(taps))
    return np.clip((out + (1 << 15)) >> 16, 0, 255).astype(np.uint8)


class StereoSequenceDataset:
    """Base: a sample list, the augmentor and the ground-truth conventions.
    Subclasses implement `_load_sample(sample) -> {"img", "disp", "valid"}`
    with img (T, 2, H, W, 3) uint8 and disp (T, 1, H, W, 2) float32."""

    def __init__(self, aug_params=None):
        self.augmentor = None
        if aug_params is not None and "crop_size" in aug_params:
            self.augmentor = SequenceDispFlowAugmentor(**aug_params)
        self.sample_list: list = []

    def _load_sample(self, sample) -> dict:
        raise NotImplementedError

    def __getitem__(self, index, rng: np.random.Generator | None = None) -> dict:
        """Sample `index`, augmented with `rng`. The loader passes one
        generator per sample, seeded from (seed, epoch, index); with None
        the augmentor draws from its own generator, as the JAX package's
        dataset does (the reference path of the parity tests)."""
        out = self._load_sample(self.sample_list[index % len(self.sample_list)])
        imgs, disp = out["img"], out["disp"]
        if self.augmentor is not None:
            imgs, disp = self.augmentor(imgs, disp, rng)
        disp = np.asarray(disp, np.float32)
        valid = ((np.abs(disp[..., 0]) < 512) & (disp[..., 0] != 0)).astype(np.float32)
        return {"img": imgs.astype(np.float32), "disp": disp[..., :1], "valid": valid}

    def __mul__(self, v: int):
        """The dataset repeated v times (the training mixture's x50)."""
        clone = copy.copy(self)
        clone.sample_list = v * self.sample_list
        return clone

    def __len__(self):
        return len(self.sample_list)


class SyntheticStereoDataset(StereoSequenceDataset):
    """Procedural stereo clips with exact disparity: three textured
    fronto-parallel layers (two discs in front of a background) drifting
    over time; the right view is the left view shifted by each layer's
    disparity. The textures are blurred as cv2.GaussianBlur(tex, (0, 0), 3)
    blurs them in the JAX package, bit for bit (`gaussian_blur_sigma3`)."""

    def __init__(self, aug_params=None, num_seqs=4, sample_len=5, height=256,
                 width=384, seed=0):
        super().__init__(aug_params)
        self.sample_len = sample_len
        self.height, self.width = height, width
        self._seed = seed
        self.sample_list = list(range(num_seqs))

    def _load_sample(self, sample):
        rng = np.random.default_rng(self._seed + int(sample))
        t, h, w = self.sample_len, self.height, self.width
        n_layers = 3
        disps = np.sort(rng.uniform(4, 48, n_layers))[::-1]  # near -> far
        textures = [gaussian_blur_sigma3(rng.integers(0, 255, (h, w + 128, 3)).astype(np.uint8))
                    for _ in range(n_layers)]
        masks = []
        yy, xx = np.mgrid[0:h, 0:w]
        for _ in range(n_layers - 1):
            cx, cy = rng.uniform(0.2, 0.8) * w, rng.uniform(0.2, 0.8) * h
            r = rng.uniform(0.15, 0.3) * min(h, w)
            masks.append(((xx - cx) ** 2 + (yy - cy) ** 2) < r * r)
        drift = rng.integers(1, 4, n_layers)

        imgs, dmaps = [], []
        for ti in range(t):
            left = np.empty((h, w, 3), np.uint8)
            right = np.empty((h, w, 3), np.uint8)
            dmap = np.empty((h, w), np.float32)
            for li in range(n_layers - 1, -1, -1):  # far to near
                tex = np.roll(textures[li], int(ti * drift[li]), axis=1)
                d = int(round(disps[li]))
                # the right camera sees the scene shifted left by d
                region = masks[li] if li < n_layers - 1 else np.ones((h, w), bool)
                left[region] = tex[:, 64: 64 + w][region]
                right[region] = tex[:, 64 + d: 64 + d + w][region]
                dmap[region] = disps[li]
            imgs.append(np.stack([left, right]))
            dmaps.append(np.stack([-dmap, np.zeros_like(dmap)], axis=-1))
        return {"img": np.stack(imgs), "disp": np.stack(dmaps)[:, None],
                "valid": np.ones((t, 1, h, w), np.float32)}


def fetch_dataloader(crop_size=(320, 512), sample_len=5, batch_size=2, num_workers=4,
                     sceneflow_root="datasets/SceneFlow",
                     dynamic_replica_root="datasets/dynamic_replica_data", seed=0):
    """The training loader: the JAX package's mixture is SceneFlow (final
    pass) + Dynamic Replica (train), x50, shuffled, with its fallback to the
    synthetic dataset when neither is on disk. The port trains on the
    synthetic fallback only: where either dataset's root exists it raises
    (their readers come with the evaluation slice of the port)."""
    from ppmstereo_tpu_torch.data.loader import PrefetchLoader

    for root in (sceneflow_root, osp.join(dynamic_replica_root, "train")):
        if osp.isdir(root):
            raise NotImplementedError(
                f"{root} exists, but the port has no reader for it yet: the SceneFlow "
                "and Dynamic Replica readers come with the port's evaluation slice "
                "(ROADMAP). Move the directory or pass other roots to train on the "
                "synthetic dataset.")
    aug_params = {
        "crop_size": crop_size,
        "min_scale": -0.2,
        "max_scale": 0.4,
        "saturation_range": (0.0, 1.4),
    }
    logging.warning("no datasets on disk; using SyntheticStereoDataset")
    dataset = SyntheticStereoDataset(aug_params, num_seqs=64, sample_len=sample_len,
                                     height=crop_size[0] + 32, width=crop_size[1] + 64)
    return PrefetchLoader(dataset * 50, batch_size=batch_size, num_workers=num_workers,
                          seed=seed)
