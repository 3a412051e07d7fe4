"""Stereo video datasets (counterpart of ppmstereo_tpu/data/datasets.py):
the `StereoSequenceDataset` base and `ConcatStereoDataset` (`a + b`), the
readers (SceneFlow, Sintel's evaluation and training clips, Dynamic
Replica, Infinigen, KITTI depth, South Kensington's real captures),
`SyntheticStereoDataset` and the training loader `fetch_dataloader` with the
reference's mixture.

Ground-truth conventions are the JAX package's: disparity is stored as
negative-x flow (np.stack([-disp, 0])); depth ground truth becomes
disparity as depth2disp_scale / depth (focal length in pixels times the
baseline); a dense dataset's valid = |disp| < 512 and disp != 0, a sparse
one keeps its reader's validity.

Samples are channels-last numpy dicts:
  img   (T, 2, H, W, 3) float32 in [0, 255]
  disp  (T, 1, H, W, 1) float32 (negative-x disparity of the left camera)
  valid (T, 1, H, W)    float32

VKITTI2 is not ported yet (ROADMAP §1 item 4).
"""

from __future__ import annotations

import copy
import gzip
import json
import logging
import os.path as osp
from collections import defaultdict
from glob import glob

import numpy as np

from ppmstereo_tpu_torch.data import frame_utils
from ppmstereo_tpu_torch.data.augmentor import (
    SequenceDispFlowAugmentor,
    SequenceDispSparseFlowAugmentor,
)


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
    """Base: a sample list, the readers, the augmentor and the ground-truth
    conventions. A sample is a mapping with "image" {"left", "right"}: lists
    of frame paths, and either "disparity" {"left"}: paths read by `reader`
    (default `frame_utils.read_gen`; a reader may return (disparity,
    valid)), or "depth" {"left"} with "depth2disp_scale". Subclasses with
    other samples override `_load_sample(sample) -> {"img", "disp",
    "valid"}` with img (T, 2, H, W, 3) uint8 and disp (T, 1, H, W, 2)
    float32.

    sparse: the ground truth is sparse, its validity is the reader's, not
    recomputed from the disparity, and it is augmented by the sparse
    augmentor."""

    def __init__(self, aug_params=None, sparse: bool = False, reader=None):
        self.augmentor = None
        self.sparse = sparse
        if aug_params is not None and "crop_size" in aug_params:
            cls = SequenceDispSparseFlowAugmentor if sparse else SequenceDispFlowAugmentor
            self.augmentor = cls(**aug_params)
        self.disparity_reader = reader or frame_utils.read_gen
        self.depth_reader = frame_utils.read_depth_any
        self.sample_list: list = []
        self.extra_info: list = []
        self.depth_eps = 1e-5
        self.rng = np.random.default_rng(0)  # train-split clip strides

    def _load_sample(self, sample) -> dict:
        t = len(sample["image"]["left"])
        imgs = np.stack([np.stack([frame_utils.read_image(sample["image"][cam][i])
                                   for cam in ("left", "right")]) for i in range(t)])
        disp = valid = None
        if "disparity" in sample and "left" in sample["disparity"]:
            ds, vs = [], []
            for i in range(t):
                d = self.disparity_reader(sample["disparity"]["left"][i])
                d, v = d if isinstance(d, tuple) else (d, d < 512)
                d = np.asarray(d, np.float32)
                ds.append(np.stack([-d, np.zeros_like(d)], axis=-1))
                vs.append(np.asarray(v, np.float32))
            disp, valid = np.stack(ds)[:, None], np.stack(vs)[:, None]
        elif "depth" in sample and "left" in sample["depth"]:
            scale = sample["depth2disp_scale"]
            ds, vs = [], []
            for i in range(t):
                depth = self.depth_reader(sample["depth"]["left"][i])
                bad = depth < self.depth_eps
                d = np.where(bad, 0.0, scale / np.where(bad, self.depth_eps, depth))
                ds.append(np.stack([-d, np.zeros_like(d)], axis=-1).astype(np.float32))
                vs.append(((d < 512) & ~bad).astype(np.float32))
            disp, valid = np.stack(ds)[:, None], np.stack(vs)[:, None]
        return {"img": imgs, "disp": disp, "valid": valid}

    def __getitem__(self, index, rng: np.random.Generator | None = None) -> dict:
        """Sample `index`, augmented with `rng`. The loader passes one
        generator per sample, seeded from (seed, epoch, index); with None
        the augmentor draws from its own generator, as the JAX package's
        dataset does (the reference path of the parity tests). A sample
        without ground truth has "img" only."""
        out = self._load_sample(self.sample_list[index % len(self.sample_list)])
        imgs, disp, valid = out["img"], out["disp"], out["valid"]
        if self.augmentor is not None and self.sparse:
            imgs, disp, valid = self.augmentor(imgs, disp, valid, rng)
        elif self.augmentor is not None:
            imgs, disp = self.augmentor(imgs, disp, rng)
        res = {"img": imgs.astype(np.float32)}
        if disp is not None:
            disp = np.asarray(disp, np.float32)
            if not self.sparse:
                valid = (np.abs(disp[..., 0]) < 512) & (disp[..., 0] != 0)
            res["disp"] = disp[..., :1]
            res["valid"] = np.asarray(valid, np.float32)
        return res

    def __mul__(self, v: int):
        """The dataset repeated v times (the training mixture's x50)."""
        clone = copy.copy(self)
        clone.sample_list = v * self.sample_list
        clone.extra_info = v * self.extra_info
        return clone

    def __add__(self, other):
        return ConcatStereoDataset([self, other])

    def __len__(self):
        return len(self.sample_list)


class ConcatStereoDataset:
    """Datasets one after another (`a + b`; nested sums flatten); `* v`
    repeats each part v times, in place."""

    def __init__(self, datasets):
        self.datasets = []
        for d in datasets:
            self.datasets.extend(d.datasets if isinstance(d, ConcatStereoDataset) else [d])
        self._lengths = [len(d) for d in self.datasets]

    def __len__(self):
        return sum(self._lengths)

    def __getitem__(self, index, rng: np.random.Generator | None = None) -> dict:
        for d, n in zip(self.datasets, self._lengths):
            if index < n:
                return d.__getitem__(index, rng)
            index -= n
        raise IndexError(index)

    def __add__(self, other):
        return ConcatStereoDataset([self, other])

    def __mul__(self, v: int):
        return ConcatStereoDataset([d * v for d in self.datasets])


def _clip() -> defaultdict:
    """An empty sample: {"image"|"disparity"|"depth": {camera: [paths]}}."""
    return defaultdict(lambda: defaultdict(list))


class SequenceSceneFlowDataset(StereoSequenceDataset):
    """FlyingThings3D, Monkaa and Driving: PNG frames and PFM disparity,
    each clip of `sample_len` frames also added time-reversed.
    things_test=True reads the 40 FlyingThings3D TEST sequences that a
    fixed permutation (seed 1000) picks."""

    def __init__(self, aug_params=None, root="datasets/SceneFlow",
                 dstype="frames_finalpass", sample_len=1, things_test=False,
                 add_things=True, add_monkaa=True, add_driving=True):
        super().__init__(aug_params)
        self.root, self.dstype, self.sample_len = root, dstype, sample_len
        if things_test:
            self._add_things("TEST")
        else:
            if add_things:
                self._add_things("TRAIN")
            if add_monkaa:
                self._add_sequences(osp.join(root, "Monkaa", dstype, "*/{cam}/"))
            if add_driving:
                self._add_sequences(osp.join(root, "Driving", dstype, "*/*/*/{cam}/"))

    def _scan(self, pattern):
        image_paths = {cam: sorted(glob(pattern.format(cam=cam))) for cam in ("left", "right")}
        disparity_paths = {cam: [p.replace(self.dstype, "disparity") for p in paths]
                           for cam, paths in image_paths.items()}
        return image_paths, disparity_paths

    def _collect(self, image_paths, disparity_paths, seq_idx):
        images = {cam: sorted(glob(osp.join(image_paths[cam][seq_idx], "*.png")))
                  for cam in ("left", "right")}
        disparities = {cam: sorted(glob(osp.join(disparity_paths[cam][seq_idx], "*.pfm")))
                       for cam in ("left", "right")}
        self._append_sample(images, disparities)

    def _add_things(self, split="TRAIN"):
        image_paths, disparity_paths = self._scan(
            osp.join(self.root, "FlyingThings3D", self.dstype, split, "*/*/{cam}/"))
        val_idxs = set(np.random.RandomState(1000).permutation(len(image_paths["left"]))[:40])
        for seq_idx in range(len(image_paths["left"])):
            if (seq_idx in val_idxs) == (split == "TEST"):
                self._collect(image_paths, disparity_paths, seq_idx)
        logging.info(f"SceneFlow/Things[{split}]: {len(self.sample_list)} samples")

    def _add_sequences(self, pattern):
        image_paths, disparity_paths = self._scan(pattern)
        for seq_idx in range(len(image_paths["left"])):
            self._collect(image_paths, disparity_paths, seq_idx)

    def _append_sample(self, images, disparities):
        seq_len = len(images["left"])
        for ref_idx in range(0, seq_len - self.sample_len):
            fwd, bwd = _clip(), _clip()
            for cam in ("left", "right"):
                for idx in range(ref_idx, ref_idx + self.sample_len):
                    fwd["image"][cam].append(images[cam][idx])
                    fwd["disparity"][cam].append(disparities[cam][idx])
                    bwd["image"][cam].append(images[cam][seq_len - idx - 1])
                    bwd["disparity"][cam].append(disparities[cam][seq_len - idx - 1])
            self.sample_list += [fwd, bwd]


class SequenceSintelStereo(StereoSequenceDataset):
    """Sintel stereo training sequences, one sample a sequence: packed-PNG
    disparity, valid where not occluded (sparse)."""

    def __init__(self, dstype="clean", aug_params=None, root="datasets/sintel_stereo"):
        super().__init__(aug_params, sparse=True, reader=frame_utils.read_disp_sintel)
        self.dstype = dstype
        image_root = osp.join(root, "training")
        for seq_path in sorted(glob(osp.join(image_root, f"{dstype}_left/*"))):
            seq = osp.basename(seq_path)
            sample = _clip()
            for img_l in sorted(glob(osp.join(seq_path, "*.png"))):
                frame = osp.basename(img_l)
                sample["image"]["left"].append(img_l)
                sample["image"]["right"].append(osp.join(image_root, f"{dstype}_right", seq, frame))
                sample["disparity"]["left"].append(osp.join(image_root, "disparities", seq, frame))
            if sample["image"]["left"]:
                self.sample_list.append(sample)
                self.extra_info.append(seq)


class SequenceSintelStereoTrain(StereoSequenceDataset):
    """Sintel as a training source: dense clips of `sample_len` frames
    sliding by one frame, each also added time-reversed, the packed-PNG
    disparity read as dense (valid recomputed from it)."""

    def __init__(self, aug_params=None, dstype="final", root="datasets/sintel_stereo",
                 sample_len=1):
        super().__init__(aug_params, reader=frame_utils.read_disp_sintel)
        self.dstype, self.sample_len = dstype, sample_len
        image_root = osp.join(root, "training")
        for seq_path in sorted(glob(osp.join(image_root, f"{dstype}_left/*"))):
            seq = osp.basename(seq_path)
            lefts = sorted(glob(osp.join(seq_path, "*.png")))
            images = {"left": lefts,
                      "right": [osp.join(image_root, f"{dstype}_right", seq, osp.basename(p))
                                for p in lefts]}
            disps = [osp.join(image_root, "disparities", seq, osp.basename(p)) for p in lefts]
            seq_len = len(lefts)
            for ref in range(0, seq_len - sample_len):
                fwd, rev = _clip(), _clip()
                for idx in range(ref, ref + sample_len):
                    for cam in ("left", "right"):
                        fwd["image"][cam].append(images[cam][idx])
                        rev["image"][cam].append(images[cam][seq_len - idx - 1])
                    fwd["disparity"]["left"].append(disps[idx])
                    rev["disparity"]["left"].append(disps[seq_len - idx - 1])
                self.sample_list += [fwd, rev]


class DynamicReplicaDataset(StereoSequenceDataset):
    """Dynamic Replica: `<root>/<split>/frame_annotations_<split>.jgz`, a
    gzip JSON list of frame annotations (sequence, camera, image and depth
    paths, viewpoint), float16 PNG depth. The train split takes a clip every
    3 frames with a random temporal stride in [1, 5]; other splits take
    contiguous chunks of sample_len frames, at most only_first_n_samples a
    sequence."""

    def __init__(self, aug_params=None, root="datasets/dynamic_replica_data", split="train",
                 sample_len=-1, only_first_n_samples=-1):
        super().__init__(aug_params)
        self.root, self.sample_len, self.split = root, sample_len, split
        path = osp.join(root, split, f"frame_annotations_{split}.jgz")
        with gzip.open(path, "rt", encoding="utf8") as f:
            frame_annots = json.load(f)
        seq_annot = defaultdict(lambda: defaultdict(list))
        for annot in frame_annots:
            seq_annot[annot["sequence_name"]][annot["camera_name"]].append(annot)

        for seq in sorted(seq_annot):
            try:
                files = _clip()
                for cam in ("left", "right"):
                    for frame in seq_annot[seq][cam]:
                        im_path = osp.join(root, split, frame["image"]["path"])
                        if not osp.isfile(im_path):
                            raise FileNotFoundError(im_path)
                        files["image"][cam].append(im_path)
                        files["depth"][cam].append(osp.join(root, split, frame["depth"]["path"]))
                        files["viewpoint"][cam].append(frame["viewpoint"])
                        files["image_size"][cam].append(frame["image"].get("size"))
                seq_len = len(files["image"]["left"])
                logging.info(f"seq {seq}: {seq_len} frames")
                scale = self._d2d_scale(files)
                if split == "train":
                    for ref_idx in range(0, seq_len, 3):
                        step = 1 if sample_len == 1 else int(self.rng.integers(1, 6))
                        if ref_idx + step * sample_len < seq_len:
                            self._add(files, range(ref_idx, ref_idx + step * sample_len, step),
                                      scale)
                else:
                    step = sample_len if sample_len > 0 else seq_len
                    for n, ref_idx in enumerate(range(0, seq_len, step)):
                        self._add(files, range(ref_idx, min(ref_idx + step, seq_len)), scale)
                        self.extra_info.append(seq)
                        if 0 < only_first_n_samples <= n + 1:
                            break
            except (KeyError, IndexError, OSError, ValueError) as e:
                # a sequence with a missing frame or a malformed annotation is
                # skipped, as the JAX reader does
                logging.warning(f"skipping sequence {seq}: {e!r}")

    def _add(self, files, frames, scale: float) -> None:
        sample = _clip()
        for cam in ("left", "right"):
            for idx in frames:
                for k in ("image", "depth"):
                    sample[k][cam].append(files[k][cam][idx])
        sample["depth2disp_scale"] = scale
        self.sample_list.append(sample)

    @staticmethod
    def _d2d_scale(files) -> float:
        """Focal length in pixels times the baseline, from the first frame's
        viewpoints. NDC -> pixels: fx_px = fx_ndc * W / 2 for
        'ndc_norm_image_bounds', fx_ndc * min(W, H) / 2 for 'ndc_isotropic';
        the baseline T_right[0] - T_left[0] (OpenCV's tvec negates x)."""
        vp_l, vp_r = files["viewpoint"]["left"][0], files["viewpoint"]["right"][0]
        size = (files.get("image_size", {}).get("left") or [None])[0]
        h, w = (float(s) for s in (size or (720, 1280)))  # Dynamic Replica's (H, W)
        fmt = str(vp_l.get("intrinsics_format", "ndc_norm_image_bounds")).lower()
        if fmt == "ndc_norm_image_bounds":
            rescale_x = w / 2.0
        elif fmt == "ndc_isotropic":
            rescale_x = min(w, h) / 2.0
        else:
            raise ValueError(f"unknown intrinsics_format: {fmt}")
        focal_px = float(vp_l["focal_length"][0]) * rescale_x
        return focal_px * (float(vp_r["T"][0]) - float(vp_l["T"][0]))


class InfinigenStereoVideoDataset(StereoSequenceDataset):
    """Infinigen renders: `<scene>/frames/Image/camera_{0,1}/*.png`, depth
    `frames/Depth/camera_0/*.npy`, and the camera's K and baseline in
    `frames/camview/camera_0/*.npz` (baseline 0.075 when absent)."""

    def __init__(self, aug_params=None, root="datasets/infinigen", sample_len=-1):
        super().__init__(aug_params)
        self.sample_len = sample_len
        for scene in sorted(glob(osp.join(root, "*"))):
            lefts = sorted(glob(osp.join(scene, "frames/Image/camera_0/*.png")))
            rights = sorted(glob(osp.join(scene, "frames/Image/camera_1/*.png")))
            depths = sorted(glob(osp.join(scene, "frames/Depth/camera_0/*.npy")))
            if not lefts or len(lefts) != len(rights):
                continue
            cam_files = sorted(glob(osp.join(scene, "frames/camview/camera_0/*.npz")))
            scale = 1.0
            if cam_files:
                cam = np.load(cam_files[0])
                k = cam["K"] if "K" in cam else None
                baseline = float(cam["baseline"]) if "baseline" in cam else 0.075
                scale = (float(k[0, 0]) if k is not None else 1.0) * baseline
            step = sample_len if sample_len > 0 else len(lefts)
            for ref in range(0, len(lefts), step):
                sample = _clip()
                for idx in range(ref, min(ref + step, len(lefts))):
                    sample["image"]["left"].append(lefts[idx])
                    sample["image"]["right"].append(rights[idx])
                    if depths:
                        sample["depth"]["left"].append(depths[idx])
                sample["depth2disp_scale"] = scale
                self.sample_list.append(sample)
                self.extra_info.append(osp.basename(scene))


def _south_kensington_images(scene: str) -> tuple[list, list]:
    """A capture's left and right PNG frames: `<scene>/images/{left,right}`,
    else `<scene>/{left,right}`, else `<scene>/image_{left,right}`."""
    for pat_l, pat_r in (("images/left/*.png", "images/right/*.png"),
                         ("left/*.png", "right/*.png"),
                         ("image_left/*.png", "image_right/*.png")):
        lefts = sorted(glob(osp.join(scene, pat_l)))
        if lefts:
            return lefts, sorted(glob(osp.join(scene, pat_r)))
    return [], []


def _frames_sample(lefts, rights, frames) -> defaultdict:
    sample = _clip()
    for idx in frames:
        sample["image"]["left"].append(lefts[idx])
        sample["image"]["right"].append(rights[idx])
    return sample


class SouthKensingtonStereoVideoDataset(StereoSequenceDataset):
    """South Kensington: real ZED captures without ground truth, one scene a
    directory of `root` (frames as `_south_kensington_images` finds them),
    in contiguous chunks of sample_len frames (a scene whose left and right
    frames differ in number is skipped)."""

    def __init__(self, aug_params=None, root="datasets/southkensington", sample_len=-1):
        super().__init__(aug_params)
        self.sample_len = sample_len
        self.split = "test"
        for scene in sorted(glob(osp.join(root, "*"))):
            lefts, rights = _south_kensington_images(scene)
            if not lefts or len(lefts) != len(rights):
                continue
            step = sample_len if sample_len > 0 else len(lefts)
            for ref in range(0, len(lefts), step):
                self.sample_list.append(
                    _frames_sample(lefts, rights, range(ref, min(ref + step, len(lefts)))))
                self.extra_info.append(osp.basename(scene))


class SouthKensingtonStereoVideoSubDataset(StereoSequenceDataset):
    """One named South Kensington capture, `<root>/<dtype>/<subname>`, in
    chunks of sample_len frames (the whole capture when sample_len is not in
    (0, length)), at most only_first_n_samples of them; raises when the
    capture has no stereo frames."""

    def __init__(self, aug_params=None, root="datasets/southkensington", dtype="indoor",
                 subname="video010", sample_len=-1, only_first_n_samples=-1):
        super().__init__(aug_params)
        self.sample_len = sample_len
        self.split = "test"
        scene = osp.join(root, dtype, subname)
        lefts, rights = _south_kensington_images(scene)
        if not lefts or len(lefts) != len(rights):
            raise FileNotFoundError(f"no stereo frames under {scene}")
        n = len(lefts)
        step = sample_len if 0 < sample_len < n else n
        for count, ref in enumerate(range(0, n, step), start=1):
            self.sample_list.append(_frames_sample(lefts, rights, range(ref, min(ref + step, n))))
            self.extra_info.append(subname)
            if 0 < only_first_n_samples <= count:
                break


class KITTIDepthDataset(StereoSequenceDataset):
    """KITTI's sparse LiDAR depth: one sample a drive,
    `<root>/<train|val>/<drive>/proj_depth/groundtruth/image_02/*.png` with
    the frames under `<root>/raw/<date>/<drive>/image_0{2,3}/data/`; the
    focal length 721.5377 px and the 0.54 m baseline (sparse)."""

    KITTI_BASELINE = 0.54  # meters, rectified stereo rig

    def __init__(self, aug_params=None, root="datasets/kitti_depth", split="train",
                 sample_len=-1):
        super().__init__(aug_params, sparse=True)
        self.sample_len, self.split = sample_len, split
        split_dir = "train" if split == "train" else "val"
        for drive in sorted(glob(osp.join(root, split_dir, "*"))):
            name = osp.basename(drive)
            raw = osp.join(root, "raw", name[:10], name)
            sample = _clip()
            for depth_l in sorted(glob(osp.join(drive, "proj_depth/groundtruth/image_02/*.png"))):
                frame = osp.basename(depth_l)
                img_l = osp.join(raw, "image_02/data", frame)
                img_r = osp.join(raw, "image_03/data", frame)
                if osp.isfile(img_l) and osp.isfile(img_r):
                    sample["image"]["left"].append(img_l)
                    sample["image"]["right"].append(img_r)
                    sample["depth"]["left"].append(depth_l)
            if sample["image"]["left"]:
                sample["depth2disp_scale"] = 721.5377 * self.KITTI_BASELINE
                self.sample_list.append(sample)
                self.extra_info.append(name)


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
        self.extra_info = [f"synthetic_{i}" for i in range(num_seqs)]

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
                     dynamic_replica_root="datasets/dynamic_replica_data",
                     use_synthetic_fallback=True, seed=0):
    """The training loader: the reference's mixture, SceneFlow (final pass)
    + Dynamic Replica (train) for each root on disk, x50, shuffled, with
    the augmentor's right-view jitter (`yjitter` in the JAX package); with
    neither root, the synthetic dataset (or, without the fallback,
    FileNotFoundError)."""
    from ppmstereo_tpu_torch.data.loader import PrefetchLoader

    aug_params = {
        "crop_size": crop_size,
        "min_scale": -0.2,
        "max_scale": 0.4,
        "saturation_range": (0.0, 1.4),
    }
    parts = []
    if osp.isdir(sceneflow_root):
        parts.append(SequenceSceneFlowDataset(aug_params, root=sceneflow_root,
                                              dstype="frames_finalpass", sample_len=sample_len))
    if osp.isdir(osp.join(dynamic_replica_root, "train")):
        parts.append(DynamicReplicaDataset(aug_params, root=dynamic_replica_root,
                                           split="train", sample_len=sample_len))
    if not parts:
        if not use_synthetic_fallback:
            raise FileNotFoundError("no training datasets found")
        logging.warning("no datasets on disk; using SyntheticStereoDataset")
        parts = [SyntheticStereoDataset(aug_params, num_seqs=64, sample_len=sample_len,
                                        height=crop_size[0] + 32, width=crop_size[1] + 64)]
    dataset = parts[0]
    for p in parts[1:]:
        dataset = dataset + p
    return PrefetchLoader(dataset * 50, batch_size=batch_size, num_workers=num_workers,
                          seed=seed)
