"""The reference training recipe in the port against the JAX package, on
miniature dataset trees written as tests/test_torch_readers.py writes them:

* `fetch_dataloader`'s mixture (SceneFlow's final pass + Dynamic Replica's
  train split, x50) and `ConcatStereoDataset`'s indexing: the same sample
  lists and, unaugmented, the same samples, index for index;
* `SequenceSintelStereoTrain`'s sample list and samples;
* the sparse augmentor against the JAX class: the same draws, so the same
  crops; `resize_sparse_flow_map` bit for bit; images within one level on
  99.5 % of the pixels (tests/test_torch_data.py's limits: the port resizes
  and converts colours in numpy, the JAX package in OpenCV);
* the train CLI's `--config` (a YAML preset) and `--evaluate_freq`, on the
  CPU;
* the JAX trainer's options the port refuses (a seq or space axis, a data
  axis without its process group, uint8 images) raising;
* `train(enable_eval=True, save_callback=...)` on the CPU: the callback
  runs after every periodic save with the port's state, and the
  in-training evaluation dumps its JSON and logs its metrics.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from ppmstereo_tpu.data import augmentor as jaug
from ppmstereo_tpu.data import datasets as jds
from ppmstereo_tpu.data import frame_utils as jfu
from ppmstereo_tpu_torch.cli import train as tcli
from ppmstereo_tpu_torch.data import augmentor as taug
from ppmstereo_tpu_torch.data import datasets as tds
from ppmstereo_tpu_torch.data.png import write_png
from ppmstereo_tpu_torch.train import trainer as ttrainer
from ppmstereo_tpu_torch.train.state import TrainState
from tests.torch_data_workers import tensorboard_without_tensorflow

torch.set_num_threads(1)
H, W = 40, 56


def _rgb(path, seed):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    write_png(str(path), rng.integers(0, 255, (H, W, 3), dtype=np.uint8))


def _sceneflow(root, rng):
    for seq in ("FlyingThings3D/frames_finalpass/TRAIN/A/0000", "Monkaa/frames_finalpass/a_rain"):
        for cam in ("left", "right"):
            for i in range(5):
                _rgb(root / seq / cam / f"{i:04d}.png", seed=i)
                pfm = root / seq.replace("frames_finalpass", "disparity") / cam / f"{i:04d}.pfm"
                os.makedirs(pfm.parent, exist_ok=True)
                jfu.write_pfm(str(pfm), rng.uniform(1, 40, (H, W)).astype(np.float32))


def _dynamic_replica_train(root, rng):
    split = root / "train"
    annots = []
    for seq, n in (("seqA", 9), ("seqB", 19)):
        for cam in ("left", "right"):
            for i in range(n):
                img_rel, depth_rel = f"{seq}/{cam}_{i:03d}.png", f"{seq}/depth_{cam}_{i:03d}.png"
                _rgb(split / img_rel, seed=100 + i)
                os.makedirs((split / depth_rel).parent, exist_ok=True)
                depth = rng.uniform(2, 30, (H, W)).astype(np.float16)
                write_png(str(split / depth_rel), depth.view(np.uint16))
                annots.append({
                    "sequence_name": seq, "camera_name": cam,
                    "image": {"path": img_rel, "size": [H, W]}, "depth": {"path": depth_rel},
                    "viewpoint": {"focal_length": [2.0, 2.0], "principal_point": [0, 0],
                                  "intrinsics_format": "ndc_norm_image_bounds",
                                  "T": [0.0, 0, 0] if cam == "left" else [0.5, 0, 0]}})
    with gzip.open(split / "frame_annotations_train.jgz", "wt", encoding="utf8") as f:
        json.dump(annots, f)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("recipe")
    rng = np.random.default_rng(0)
    _sceneflow(root / "SceneFlow", rng)
    _dynamic_replica_train(root / "dr", rng)
    return root


def _plain(sample):
    """A sample list entry as plain data (the readers build defaultdicts)."""
    return json.loads(json.dumps(sample))


def _parts(dataset):
    return dataset.datasets if hasattr(dataset, "datasets") else [dataset]


def test_mixture_matches_jax(trees):
    """Both roots: SceneFlow's clips (forward and time-reversed) and Dynamic
    Replica's train clips (random strides), x50; the same parts, sample
    lists and length as the JAX package's loader, and a batch drawn."""
    kw = dict(crop_size=(24, 32), sample_len=3, batch_size=2, num_workers=1,
              sceneflow_root=str(trees / "SceneFlow"), dynamic_replica_root=str(trees / "dr"))
    port = tds.fetch_dataloader(**kw)
    ref = jds.fetch_dataloader(**kw)
    tparts, jparts = _parts(port.dataset), _parts(ref.dataset)
    assert [type(p).__name__ for p in tparts] == [type(p).__name__ for p in jparts] == \
        ["SequenceSceneFlowDataset", "DynamicReplicaDataset"]
    for tp, jp in zip(tparts, jparts):
        assert len(tp) > 0 and len(tp) % 50 == 0
        assert [_plain(s) for s in tp.sample_list] == [_plain(s) for s in jp.sample_list]
        assert jp.augmentor.yjitter  # the port's augmentor always jitters the right view
    assert len(port.dataset) == len(ref.dataset) and len(port) == len(ref)
    batch = next(iter(port))
    assert batch["left"].shape == (2, 3, 24, 32, 3)
    assert np.isfinite(batch["disparity"]).all()


def test_mixture_falls_back_or_refuses_without_data(tmp_path):
    none = str(tmp_path / "none")
    loader = tds.fetch_dataloader(crop_size=(24, 32), sample_len=2, batch_size=1, num_workers=1,
                                  sceneflow_root=none, dynamic_replica_root=none)
    assert isinstance(loader.dataset, tds.SyntheticStereoDataset)
    with pytest.raises(FileNotFoundError, match="no training datasets"):
        tds.fetch_dataloader(sceneflow_root=none, dynamic_replica_root=none,
                             use_synthetic_fallback=False)


def test_concat_dataset_indexes_as_jax(trees):
    """`a + b`, `(a + b) * 2` and a nested sum, unaugmented: sample i of the
    port's equals sample i of the JAX package's, across the boundaries."""
    def parts(pkg):
        sf = pkg.SequenceSceneFlowDataset(root=str(trees / "SceneFlow"), sample_len=2,
                                          add_driving=False)
        dr = pkg.DynamicReplicaDataset(root=str(trees / "dr"), split="train", sample_len=2)
        return sf, dr

    (tsf, tdr), (jsf, jdr) = parts(tds), parts(jds)
    for tcat, jcat in (((tsf + tdr) * 2, (jsf + jdr) * 2), (tsf + (tdr + tsf), jsf + (jdr + jsf))):
        assert isinstance(tcat, tds.ConcatStereoDataset)
        assert len(tcat.datasets) == len(jcat.datasets)
        assert len(tcat) == len(jcat) > len(tsf) + 1
        for i in sorted({0, len(tsf) - 1, len(tsf), len(tsf) + 1, len(tcat) - 1}):
            got, want = tcat[i], jcat[i]
            assert set(got) == set(want)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{i} {key}")
        with pytest.raises(IndexError):
            tcat[len(tcat)]


def _sintel(root, rng):
    for seq, n in (("alley_1", 5), ("bamboo_2", 3)):
        for i in range(1, n + 1):
            frame = f"frame_{i:04d}.png"
            for d in ("final_left", "final_right"):
                _rgb(root / "training" / d / seq / frame, seed=i)
            for d, img in (("disparities", rng.integers(0, 40, (H, W, 3), dtype=np.uint8)),
                           ("occlusions", (rng.random((H, W)) < 0.2).astype(np.uint8) * 255)):
                os.makedirs(root / "training" / d / seq, exist_ok=True)
                write_png(str(root / "training" / d / seq / frame), img)


def test_sintel_train_matches_jax(tmp_path):
    """Clips of 2 frames sliding by one, forward and time-reversed: 3 x 2 of
    the 5-frame sequence and 1 x 2 of the 3-frame one, dense."""
    _sintel(tmp_path, np.random.default_rng(1))
    port = tds.SequenceSintelStereoTrain(root=str(tmp_path), sample_len=2)
    ref = jds.SequenceSintelStereoTrain(root=str(tmp_path), sample_len=2)
    assert len(port) == len(ref) == 8 and not port.sparse
    assert [_plain(s) for s in port.sample_list] == [_plain(s) for s in ref.sample_list]
    for i in (0, 1, 7):
        got, want = port[i], ref[i]
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def _assert_images_close(got, want):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert got.shape == want.shape
    assert diff.max() <= 4.0 and (diff <= 1.0).mean() >= 0.995


def test_resize_sparse_flow_map_is_jax_bit_for_bit(rng):
    flow = rng.standard_normal((37, 53, 2)).astype(np.float32) * 20
    valid = (rng.random((37, 53)) < 0.4).astype(np.float32)
    for fx, fy in ((1.37, 0.81), (0.6, 1.9), (2.0, 2.0)):
        got = taug.SequenceDispSparseFlowAugmentor.resize_sparse_flow_map(flow, valid, fx, fy)
        want = jaug.SequenceDispSparseFlowAugmentor.resize_sparse_flow_map(flow, valid, fx, fy)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert got[1].sum() > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sparse_augmentor_matches_jax(seed):
    aug = {"crop_size": (48, 80), "min_scale": -0.2, "max_scale": 0.4,
           "saturation_range": (0.0, 1.4)}
    clip = jds.SyntheticStereoDataset(num_seqs=1, sample_len=3, height=80, width=128,
                                      seed=seed)._load_sample(0)
    valid = (np.random.default_rng(seed).random((3, 1, 80, 128)) < 0.3).astype(np.float32)
    got = taug.SequenceDispSparseFlowAugmentor(seed=seed, **aug)(clip["img"], clip["disp"], valid)
    want = jaug.SequenceDispSparseFlowAugmentor(seed=seed, **aug)(clip["img"], clip["disp"],
                                                                   valid)
    assert got[0].shape == (3, 2, 48, 80, 3)
    _assert_images_close(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_sparse_dataset_takes_aug_params(tmp_path):
    """A sparse dataset (Sintel's evaluation reader) with aug_params no
    longer raises: its augmentor is the sparse one, and its sample equals
    the JAX package's for the same seed."""
    _sintel(tmp_path, np.random.default_rng(2))
    aug = {"crop_size": (24, 32), "min_scale": -0.2, "max_scale": 0.4, "seed": 3}
    port = tds.SequenceSintelStereo(dstype="final", aug_params=aug, root=str(tmp_path))
    ref = jds.SequenceSintelStereo(dstype="final", aug_params=aug, root=str(tmp_path))
    assert isinstance(port.augmentor, taug.SequenceDispSparseFlowAugmentor)
    got, want = port[0], ref[0]
    _assert_images_close(got["img"], want["img"])
    np.testing.assert_array_equal(got["disp"], want["disp"])
    np.testing.assert_array_equal(got["valid"], want["valid"])


PRESET = """# a tiny TrainConfig preset
model_name: ppmstereo
num_steps: 2
batch_size: 1
sample_len: 2
train_iters: 1
mixed_precision: false
num_workers: 1
save_freq: 100
log_freq: 1
model_kwargs:
  use_cnet: false
  attention_type: null
  top_k: 2
"""


def test_train_cli_config_preset(tmp_path):
    """--config reads the YAML preset (its model_kwargs reaching the model),
    overrides apply on top, and the run trains 2 steps on the synthetic
    fallback at 32 x 64."""
    preset = tmp_path / "preset.yaml"
    preset.write_text(PRESET)
    tensorboard_without_tensorflow()
    state = tcli.main(["--device", "cpu", "--config", str(preset), "crop_size=[32,64]",
                       f"exp_dir={tmp_path / 'run'}"])
    assert state.step == 2
    assert not hasattr(state.model, "cnet") and state.model.cfg.top_k == 2
    records = [json.loads(x) for x in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in records)
    assert (tmp_path / "run" / "ckpt" / "step_2.pt").is_file()


def test_train_cli_flags_reach_the_config(monkeypatch):
    seen = []
    monkeypatch.setattr(ttrainer, "train", lambda cfg, device=None: seen.append(cfg))
    tcli.main(["--device", "cpu", "--evaluate_freq", "7", "space_parallel=2", "log_freq=3"])
    (cfg,) = seen
    assert (cfg.eval_freq, cfg.space_parallel, cfg.log_freq) == (7, 2, 3)


@pytest.mark.parametrize("field,value,match", [
    ("data_parallel", 2, r"needs a process group of 2 ranks"),
    ("seq_parallel", 2, r"a clip of 5 frames does not divide over a seq axis of 2"),
    ("space_parallel", 4, r"ROADMAP §1 item 7\.3"),
    ("wire_uint8", True, "f32 images")])
def test_trainer_refuses_what_it_does_not_run(field, value, match):
    """A data axis without a process group of its size, and a clip that the
    seq axis does not divide, are wrong launches (ValueError); space
    training (item 7.3's space half, after item 7.2) and uint8 images are
    not ported. tests/test_torch_seq_train.py holds the other refusals of
    seq training."""
    cfg = ttrainer.TrainConfig(**{field: value})
    error = ValueError if field in ("data_parallel", "seq_parallel") else NotImplementedError
    with pytest.raises(error, match=match):
        ttrainer.train(cfg, device="cpu")


def test_train_with_eval_and_save_callback(tmp_path):
    """2 steps at 64 x 128: a save and the callback at each step, and the
    in-training evaluation at step 2 (two 4-frame synthetic clips)."""
    cfg = ttrainer.TrainConfig(num_steps=2, batch_size=1, sample_len=3, train_iters=1,
                               crop_size=(64, 128), mixed_precision=False,
                               exp_dir=str(tmp_path), ckpt_after_steps=0, save_freq=1,
                               eval_freq=2, num_workers=1, log_freq=1)
    calls = []
    tensorboard_without_tensorflow()
    state = ttrainer.train(cfg, enable_eval=True, device="cpu",
                           save_callback=lambda step, st: calls.append((step, st)))
    assert [step for step, _ in calls] == [1, 2]
    assert all(isinstance(st, TrainState) and st is state for _, st in calls)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["step_1.pt", "step_2.pt"]
    dumped = json.loads((tmp_path / "result_intrain_2.json").read_text())
    assert dumped["aggregate"]["num_sequences"] == 2
    assert np.isfinite(dumped["aggregate"]["epe_mean"])
    records = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    evals = [r for r in records if "eval/epe_mean" in r]
    assert [r["step"] for r in evals] == [2]
    assert evals[0]["eval/epe_mean"] == dumped["aggregate"]["epe_mean"]
