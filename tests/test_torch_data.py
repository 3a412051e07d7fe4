"""The port's training data against the JAX package's: the synthetic clip,
the augmentor (same seed, same input) and the loader.

The JAX package renders and augments with OpenCV, the port in numpy. The
synthetic clip's blur is bit-exact. OpenCV's fixed-point bilinear resize
and its vectorised HSV -> RGB round differently in places
(`ppmstereo_tpu_torch/data/augmentor.py`), so augmented images are held to
within one level (1 LSB of uint8) on at least 99.5 % of the pixels;
disparity to 1e-3 px. A level of difference inside the jitter can grow to 3
(contrast and saturation factors up to 1.4 each, then truncation), so no
pixel may differ by more than 4.
Everything else (random draws, crops, jitter arithmetic) is the same, so a
different draw order or crop would move whole images by many levels.
"""

import numpy as np
import pytest

from ppmstereo_tpu.data import augmentor as jaug
from ppmstereo_tpu.data import datasets as jds
from ppmstereo_tpu.data import loader as jloader
from ppmstereo_tpu_torch.data import augmentor as taug
from ppmstereo_tpu_torch.data import datasets as tds
from ppmstereo_tpu_torch.data import loader as tloader

AUG = {"crop_size": (64, 96), "min_scale": -0.2, "max_scale": 0.4,
       "saturation_range": (0.0, 1.4)}
JAX_AUG = dict(AUG, yjitter=True)  # the JAX training mixture's setting


def _assert_images_close(got, want):
    assert got.shape == want.shape
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert diff.max() <= 4.0, diff.max()
    assert (diff <= 1.0).mean() >= 0.995, (diff <= 1.0).mean()


def _assert_sample_close(got, want):
    assert set(got) == set(want)
    _assert_images_close(got["img"], want["img"])
    np.testing.assert_allclose(got["disp"], want["disp"], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got["valid"], want["valid"])


@pytest.mark.parametrize("seed,t,h,w", [(0, 3, 40, 72), (5, 2, 96, 160)])
def test_synthetic_clip_matches_jax(seed, t, h, w):
    got = tds.SyntheticStereoDataset(num_seqs=1, sample_len=t, height=h, width=w,
                                     seed=seed)._load_sample(0)
    want = jds.SyntheticStereoDataset(num_seqs=1, sample_len=t, height=h, width=w,
                                      seed=seed)._load_sample(0)
    assert got["img"].dtype == np.uint8
    np.testing.assert_array_equal(got["img"], want["img"])
    np.testing.assert_array_equal(got["disp"], want["disp"])
    np.testing.assert_array_equal(got["valid"], want["valid"])


@pytest.mark.parametrize("fx,fy", [(1.37, 0.81), (0.6, 1.9), (1.05, 1.05), (2.0, 2.0)])
def test_resize_linear_matches_cv2(rng, fx, fy):
    cv2 = pytest.importorskip("cv2")
    img = rng.integers(0, 256, (67, 93, 3)).astype(np.uint8)
    want = cv2.resize(img, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)
    got = taug.resize_linear(img, fx, fy)
    assert got.dtype == np.uint8
    _assert_images_close(got, want)
    flow = rng.standard_normal((67, 93, 2)).astype(np.float32)
    want = cv2.resize(flow, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(taug.resize_linear(flow, fx, fy), want, rtol=0, atol=1e-5)


def test_hsv_round_trip_matches_cv2():
    """Every 3rd level of each channel, as an image of 86 rows (OpenCV takes
    another code path for images one pixel wide)."""
    cv2 = pytest.importorskip("cv2")
    levels = np.arange(0, 256, 3)
    rgb = np.stack(np.meshgrid(levels, levels, levels), -1).reshape(86, -1, 3).astype(np.uint8)
    hsv = cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)
    np.testing.assert_array_equal(taug.rgb_to_hsv(rgb), hsv)
    hsv[..., 0] = (hsv[..., 0].astype(np.int32) + 37) % 180
    got, want = taug.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
    assert np.abs(got.astype(int) - want).max() <= 1
    assert (got == want).mean() >= 0.98


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_augmentor_matches_jax(seed):
    clip = jds.SyntheticStereoDataset(num_seqs=1, sample_len=3, height=96, width=160,
                                      seed=seed)._load_sample(0)
    got_img, got_disp = taug.SequenceDispFlowAugmentor(seed=seed, **AUG)(clip["img"], clip["disp"])
    want_img, want_disp = jaug.SequenceDispFlowAugmentor(seed=seed, **JAX_AUG)(clip["img"], clip["disp"])
    assert got_img.shape == (3, 2, 64, 96, 3)
    _assert_images_close(got_img, want_img)
    np.testing.assert_allclose(got_disp, want_disp, rtol=0, atol=1e-3)


class _SeededPerSample:
    """A JAX dataset whose augmentor draws each sample from a generator
    seeded from (seed, epoch, index), as the port's loader seeds it."""

    def __init__(self, dataset, seed):
        self.dataset, self.seed, self.epoch = dataset, seed, 0

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        self.dataset.augmentor.rng = np.random.default_rng((self.seed, self.epoch, int(index)))
        return self.dataset[index]


def test_loader_matches_jax():
    """Two epochs of the shuffled loader over an augmented synthetic set,
    against the JAX loader (one worker thread) whose augmentor is reseeded
    per sample from (seed, epoch, index) as the port's loader seeds it."""
    kw = dict(num_seqs=3, sample_len=2, height=96, width=160, seed=4)
    tl = tloader.PrefetchLoader(tds.SyntheticStereoDataset(dict(AUG, seed=9), **kw) * 2,
                                batch_size=2, num_workers=1, seed=3)
    jds_seeded = _SeededPerSample(jds.SyntheticStereoDataset(dict(JAX_AUG, seed=9), **kw) * 2, 3)
    jl = jloader.PrefetchLoader(jds_seeded, batch_size=2, num_workers=1, seed=3)
    assert len(tl) == len(jl) == 3
    for epoch in range(2):
        jds_seeded.epoch = epoch
        batches = list(zip(tl, jl, strict=True))
        assert len(batches) == 3
        for got, want in batches:
            assert set(got) == {"left", "right", "disparity", "valid"}
            assert got["left"].shape == (2, 2, 64, 96, 3)
            assert got["disparity"].shape == (2, 2, 64, 96, 1)
            _assert_images_close(got["left"], want["left"])
            _assert_images_close(got["right"], want["right"])
            np.testing.assert_allclose(got["disparity"], want["disparity"], rtol=0, atol=1e-3)
            np.testing.assert_array_equal(got["valid"], want["valid"])


def test_loaders_of_one_seed_yield_identical_batches():
    """Four threads augment in any order; each sample's generator comes from
    (seed, epoch, index), so two loaders of one seed give the same batches,
    epoch after epoch, and another seed gives others."""
    kw = dict(num_seqs=4, sample_len=2, height=96, width=160, seed=0)

    def epochs(seed):
        loader = tloader.PrefetchLoader(tds.SyntheticStereoDataset(dict(AUG), **kw) * 2,
                                        batch_size=2, num_workers=4, seed=seed)
        return [list(loader) for _ in range(2)]

    first, second, other = epochs(5), epochs(5), epochs(6)
    for e in range(2):
        assert len(first[e]) == len(second[e]) == 4
        for a, b in zip(first[e], second[e]):
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
    assert not np.array_equal(first[0][0]["left"], first[1][0]["left"])
    assert not np.array_equal(first[0][0]["left"], other[0][0]["left"])


def test_dataset_sample_matches_jax():
    kw = dict(num_seqs=2, sample_len=2, height=96, width=160, seed=7)
    got = tds.SyntheticStereoDataset(dict(AUG, seed=1), **kw)[1]
    want = jds.SyntheticStereoDataset(dict(JAX_AUG, seed=1), **kw)[1]
    _assert_sample_close(got, want)


def test_loader_raises_a_worker_failure():
    class Broken(tds.SyntheticStereoDataset):
        def _load_sample(self, sample):
            raise OSError("unreadable frame")

    loader = tloader.PrefetchLoader(Broken(num_seqs=2), batch_size=1, num_workers=1)
    with pytest.raises(OSError, match="unreadable"):
        next(iter(loader))


def test_fetch_dataloader_refuses_datasets_it_cannot_read(tmp_path):
    """A SceneFlow root with nothing readable in it is a part of the
    mixture, as in the JAX package, not a reason to fall back: its loader
    has no batch, and training on it raises. With no root on disk the
    synthetic fallback trains."""
    from ppmstereo_tpu_torch.train.trainer import TrainConfig, train

    (tmp_path / "SceneFlow").mkdir()
    kw = dict(crop_size=(64, 96), sample_len=2, batch_size=1, num_workers=1,
              sceneflow_root=str(tmp_path / "SceneFlow"),
              dynamic_replica_root=str(tmp_path / "none"))
    empty = tds.fetch_dataloader(**kw)
    assert len(empty) == len(jds.fetch_dataloader(**kw)) == 0
    with pytest.raises(ValueError, match="yielded no batch"):
        train(TrainConfig(num_steps=1, exp_dir=str(tmp_path / "run")), loader=empty,
              device="cpu")
    loader = tds.fetch_dataloader(crop_size=(64, 96), sample_len=2, batch_size=1,
                                  num_workers=1, sceneflow_root=str(tmp_path / "none"),
                                  dynamic_replica_root=str(tmp_path / "none"))
    batch = next(iter(loader))
    assert batch["left"].shape == (1, 2, 64, 96, 3)
    assert len(loader) == 64 * 50
