"""The port's evaluation path against the JAX package's: the EPE/TEPE
metrics, the sequence evaluator and its JSON dump, the visualisations, and
the evaluate and demo CLIs on the CPU at a tiny size.

Metrics: the per-pixel errors are f32 in both packages and the bad-px
counts must be equal; the JAX package sums in f32 where the port sums in
f64, so the means agree within 1e-5 relative (f32 sums of ~1e4 terms).
"""

import gzip
import json
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ppmstereo_tpu.evaluation import evaluator as jev
from ppmstereo_tpu.evaluation import metrics as jmet
from ppmstereo_tpu.evaluation import visualization as jvis
from ppmstereo_tpu_torch.cli import demo as tdemo
from ppmstereo_tpu_torch.cli import evaluate as tcli
from ppmstereo_tpu_torch.data import datasets as tds
from ppmstereo_tpu_torch.evaluation import evaluator as tev
from ppmstereo_tpu_torch.evaluation import metrics as tmet
from ppmstereo_tpu_torch.evaluation import visualization as tvis
from ppmstereo_tpu_torch.models.zoo import model_zoo
from ppmstereo_tpu_torch.utils.weights import load_npz

torch.set_num_threads(2)
ANCHOR = Path(__file__).resolve().parent.parent / "checkpoints" / "anchor_r5.npz"
PRESETS = Path(__file__).resolve().parent.parent / "ppmstereo_tpu_torch" / "configs"
METRIC_RTOL = 1e-5


# --------------------------------------------------------------- metrics
@pytest.mark.parametrize("crop", [0, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed, crop):
    """Random predictions against ground truth with NaNs, a soft mask with
    values on both sides of the threshold, and exact hits (zero errors,
    which leave the denominators)."""
    rng = np.random.default_rng(seed)
    t, h, w = 6, 30, 40
    gt = rng.uniform(0, 60, (t, h, w, 1)).astype(np.float32)
    pred = gt + rng.normal(0, 1.5, gt.shape).astype(np.float32)
    pred[:, :5] = gt[:, :5]  # exact
    gt[rng.random(gt.shape) < 0.05] = np.nan
    mask = rng.choice([0.0, 0.3, 0.6, 1.0], size=(t, h, w, 1)).astype(np.float32)
    got = tmet.eval_endpoint_error_sequence(pred, gt, mask, crop=crop)
    want = {k: float(v) for k, v in jmet.eval_endpoint_error_sequence(
        jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask), crop=crop).items()}
    assert set(got) == set(want) and len(got) == 10
    for k in want:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, atol=0, err_msg=k)
    assert got["epe_mean"] > 0.5 and 0 < got["epe_bad_1px"] < 100


def test_metrics_of_a_perfect_and_an_empty_prediction():
    gt = np.full((3, 8, 8, 1), 5.0, np.float32)
    mask = np.ones_like(gt)
    for x in (gt, np.zeros_like(gt)):
        got = tmet.eval_endpoint_error_sequence(x, gt, 0 * mask if x is gt else mask)
        want = jmet.eval_endpoint_error_sequence(jnp.asarray(x), jnp.asarray(gt),
                                                 jnp.asarray(0 * mask if x is gt else mask))
        for k in want:
            np.testing.assert_allclose(got[k], float(want[k]), rtol=METRIC_RTOL, err_msg=k)


def test_aggregate_matches_jax():
    per_seq = [{"epe_mean": 1.0, "fps": 3.0}, {"epe_mean": 2.5, "fps": 1.0}]
    lengths = [40, 10]
    assert tmet.aggregate_sequence_results(per_seq, lengths) == \
        jmet.aggregate_sequence_results(per_seq, lengths)
    assert tmet.aggregate_sequence_results([], []) == {}


# -------------------------------------------------------- visualisations
def test_visualisations_match_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    t, h, w = 4, 24, 32
    disp = rng.uniform(2, 40, (t, h, w)).astype(np.float32)
    images = rng.integers(0, 255, (t, h, w, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tvis.colorize_disparity(disp[0]),
                                  jvis.colorize_disparity(disp[0]))
    np.testing.assert_array_equal(tvis.colorize_disparity(disp[0], 5, 20),
                                  jvis.colorize_disparity(disp[0], 5, 20))
    np.testing.assert_array_equal(tvis.disparity_to_depth(disp, 400.0, 0.2),
                                  jvis.disparity_to_depth(disp, 400.0, 0.2))
    for got, want in zip(tvis.render_prediction_views(disp[0], images[0]),
                         jvis.render_prediction_views(disp[0], images[0])):
        np.testing.assert_array_equal(got, want)
    frames = rng.integers(0, 255, (t, h, w, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tvis.variance_masked_mean(frames),
                                  jvis.variance_masked_mean(frames))
    # the JAX package without OpenCV writes .npy files, as the port always does
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = tvis.save_reconstruction_views(disp, images, str(tmp_path / "port"), "s")
    want = jvis.save_reconstruction_views(disp, images, str(tmp_path / "jax"), "s")
    assert set(got) == set(want) == {"angle_15", "angle_-15", "changing_angle"}
    for mode in want:
        for suffix in (".npy", "_varmask.npy"):
            a = np.load(got[mode].replace(".npy", suffix))
            b = np.load(want[mode].replace(".npy", suffix))
            assert a.dtype == np.uint8
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- evaluator
H, W, FRAMES = 40, 72, 6


def _dr_tree(root: Path, seed: int = 0, frames: int = FRAMES, split: str = "valid"):
    """A Dynamic Replica split of one sequence: PNG frames of the synthetic
    clip and float16 depth made from its disparity."""
    from ppmstereo_tpu_torch.data.datasets import SyntheticStereoDataset
    from ppmstereo_tpu_torch.data.png import write_png

    sample = SyntheticStereoDataset(num_seqs=1, sample_len=frames, height=H, width=W,
                                    seed=seed)._load_sample(0)
    focal_ndc, baseline = 2.0, 0.5  # depth2disp scale = 2 * W / 2 * 0.5 = W / 2
    annots = []
    for cam_i, cam in enumerate(("left", "right")):
        for i in range(frames):
            img_rel, depth_rel = f"seq/{cam}_{i:03d}.png", f"seq/{cam}_depth_{i:03d}.png"
            os.makedirs(root / split / "seq", exist_ok=True)
            write_png(str(root / split / img_rel), sample["img"][i, cam_i])
            depth = (focal_ndc * W / 2 * baseline) / -sample["disp"][i, 0, :, :, 0]
            write_png(str(root / split / depth_rel), depth.astype(np.float16).view(np.uint16))
            annots.append({"sequence_name": "seq", "camera_name": cam,
                           "image": {"path": img_rel, "size": [H, W]},
                           "depth": {"path": depth_rel},
                           "viewpoint": {"focal_length": [focal_ndc, focal_ndc],
                                         "intrinsics_format": "ndc_norm_image_bounds",
                                         "T": [0.0 if cam == "left" else baseline, 0, 0]}})
    with gzip.open(root / split / f"frame_annotations_{split}.jgz", "wt", encoding="utf8") as f:
        json.dump(annots, f)
    return -sample["disp"][:, 0, :, :, 0]


@pytest.fixture(scope="module")
def dr_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    gt = _dr_tree(root / "dynamic_replica_data")
    return root, gt


@pytest.fixture(scope="module")
def predictor():
    return model_zoo("PPMStereoModel", kernel_size=4, iters=1, params=load_npz(ANCHOR),
                     device="cpu", mixed_precision=False)


def test_reader_gives_the_clips_disparity(dr_root):
    """Depth written as float16 from the clip's disparity reads back as that
    disparity within the float16 rounding of the depth (2^-11 relative)."""
    root, gt = dr_root
    ds = tds.DynamicReplicaDataset(root=str(root / "dynamic_replica_data"), split="valid",
                                   sample_len=FRAMES)
    sample = ds[0]
    disp = -sample["disp"][:, 0, :, :, 0]
    np.testing.assert_allclose(disp, gt, rtol=2.0**-11, atol=0)
    assert sample["valid"].min() == 1.0


def test_evaluator_matches_jax_and_dumps_json(dr_root, predictor, tmp_path):
    """The port's Evaluator on the port's reader against the JAX Evaluator
    on the same predictions (the port's predictor, as numpy): equal metrics
    but fps, and a JSON file that reads back as the returned results."""
    root, _ = dr_root
    ds = tds.DynamicReplicaDataset(root=str(root / "dynamic_replica_data"), split="valid",
                                   sample_len=4)
    assert len(ds) == 2  # frames 0-3 and the tail 4-5
    cfg = tev.EvalConfig(exp_dir=str(tmp_path / "port"), crop=2)
    got = tev.Evaluator(cfg).evaluate_sequence(predictor, ds)
    want = jev.Evaluator(jev.EvalConfig(exp_dir=str(tmp_path / "jax"), crop=2)) \
        .evaluate_sequence(predictor, ds)
    assert got["aggregate"]["num_sequences"] == 2 and got["aggregate"]["fps"] > 0
    assert [r["name"] for r in got["per_sequence"]] == ["seq", "seq"]
    for g, w in zip(got["per_sequence"] + [got["aggregate"]],
                    want["per_sequence"] + [want["aggregate"]]):
        assert set(g) == set(w)
        for k in w:
            if k not in ("fps", "name"):
                np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL, err_msg=k)
    assert np.isfinite(got["aggregate"]["epe_mean"])
    path = tev.Evaluator(cfg).dump(got, "dynamicreplica")
    assert path.endswith("result_dynamicreplica_final.json")
    assert json.load(open(path)) == json.loads(json.dumps(got))


def test_evaluator_without_ground_truth_and_with_visualisations(tmp_path, predictor):
    class NoGT:
        extra_info = []

        def __len__(self):
            return 1

        def __getitem__(self, i):
            rng = np.random.default_rng(i)
            return {"img": rng.uniform(0, 255, (3, 2, 32, 32, 3)).astype(np.float32)}

    cfg = tev.EvalConfig(exp_dir=str(tmp_path), visualize=True)
    out = tev.Evaluator(cfg).evaluate_sequence(predictor, NoGT())
    assert set(out["aggregate"]) == {"fps", "num_sequences"}
    assert out["per_sequence"][0]["name"] == "seq_0"
    assert sorted(os.listdir(tmp_path / "visualisations"))[0] == \
        "seq_0_reconstruction_mode_angle_-15.npy"


# ------------------------------------------------------------------ CLIs
def _cli_args(root, exp_dir):
    return [f"dataset_root={root}", f"exp_dir={exp_dir}", "sample_len=4",
            "only_first_n_samples=2", "crop=2", "MODEL.kernel_size=4", "MODEL.iters=1",
            f"MODEL.checkpoint={ANCHOR}", "MODEL.model_kwargs=mixed_precision=False"]


def test_evaluate_cli_matches_the_evaluator(dr_root, predictor, tmp_path, capsys):
    """`cli.evaluate --device cpu` with the Dynamic Replica preset and
    overrides: its JSON equals the Evaluator's on the same predictor and
    dataset (fps apart)."""
    root, _ = dr_root
    preset = PRESETS / "eval_dynamic_replica_40_frames.yaml"
    exp_dir = tmp_path / "cli"
    results = tcli.main(["--device", "cpu", "--config", str(preset),
                         *_cli_args(root, exp_dir)])
    assert "epe_mean" in capsys.readouterr().out
    dumped = json.load(open(exp_dir / "result_dynamicreplica_final.json"))
    assert dumped == json.loads(json.dumps(results))
    ds = tds.DynamicReplicaDataset(root=str(root / "dynamic_replica_data"), split="valid",
                                   sample_len=4, only_first_n_samples=2)
    direct = tev.Evaluator(tev.EvalConfig(crop=2)).evaluate_sequence(predictor, ds)
    for g, w in zip(dumped["per_sequence"] + [dumped["aggregate"]],
                    direct["per_sequence"] + [direct["aggregate"]]):
        assert {k: v for k, v in g.items() if k != "fps"} == \
            {k: v for k, v in w.items() if k != "fps"}


def test_evaluate_cli_real_captures(tmp_path, predictor):
    """dataset_name=real evaluates each real capture found (Dynamic
    Replica's layout, split 'test') and dumps one JSON each."""
    _dr_tree(tmp_path / "dynamic_replica_data" / "real" / "teddy_static", seed=4, split="test")
    args = [a for a in _cli_args(tmp_path, tmp_path / "out") if "only_first" not in a]
    results = tcli.main(["--device", "cpu", "dataset_name=real", *args])
    assert set(results) == {"teddy_static"}
    dumped = json.load(open(tmp_path / "out" / "result_real_teddy_static_final.json"))
    ds = tds.DynamicReplicaDataset(
        root=str(tmp_path / "dynamic_replica_data" / "real" / "teddy_static"), split="test",
        sample_len=4, only_first_n_samples=1)
    direct = tev.Evaluator(tev.EvalConfig(crop=2)).evaluate_sequence(predictor, ds)
    assert {k: v for k, v in dumped["aggregate"].items() if k != "fps"} == \
        {k: v for k, v in direct["aggregate"].items() if k != "fps"}


def test_real_preset_runs_dynamic_stereo(tmp_path):
    """The port's `real` preset (DynamicStereoModel) through the evaluate
    CLI on a real/<sequence> tree, at a tiny size in f32: from the seeded
    initialisation, and with MODEL.checkpoint= a DynamicStereo npz; each
    equal to the Evaluator on the same predictor (fps apart)."""
    from ppmstereo_tpu_torch.utils.weights import export_npz

    seq = tmp_path / "dynamic_replica_data" / "real" / "teddy_static"
    _dr_tree(seq, seed=5, split="test")
    ds = tds.DynamicReplicaDataset(root=str(seq), split="test", sample_len=4,
                                   only_first_n_samples=1)
    small = ["sample_len=4", "MODEL.kernel_size=4", "MODEL.iters=1", "crop=2",
             "MODEL.model_kwargs=mixed_precision=False"]
    seeded = model_zoo("DynamicStereoModel", kernel_size=4, iters=1, device="cpu",
                       mixed_precision=False, seed=3)
    npz = tmp_path / "ds.npz"
    export_npz(seeded.model, npz)
    for name, extra, pred in (
            ("seeded", [], model_zoo("DynamicStereoModel", kernel_size=4, iters=1,
                                     device="cpu", mixed_precision=False)),
            ("checkpoint", [f"MODEL.checkpoint={npz}"], seeded)):
        out = tmp_path / name
        results = tcli.main(["--device", "cpu", "--config", str(PRESETS / "eval_real.yaml"),
                             f"dataset_root={tmp_path}", f"exp_dir={out}", *small, *extra])
        assert set(results) == {"teddy_static"}
        dumped = json.load(open(out / "result_real_teddy_static_final.json"))
        direct = tev.Evaluator(tev.EvalConfig(crop=2)).evaluate_sequence(pred, ds)
        assert {k: v for k, v in dumped["aggregate"].items() if k != "fps"} == \
            {k: v for k, v in direct["aggregate"].items() if k != "fps"}
        assert dumped["aggregate"]["num_sequences"] == 1


def test_cli_loads_a_trainer_checkpoint(dr_root, tmp_path):
    """MODEL.checkpoint as a directory of the port's trainer: the newest
    step_<n>.pt's parameters, the same predictions as the anchor's npz."""
    from ppmstereo_tpu_torch.models.ppm_stereo import PPMStereo, PPMStereoConfig
    from ppmstereo_tpu_torch.utils.weights import load_flax_params

    model = PPMStereo(PPMStereoConfig(mixed_precision=False), iters=1)
    load_flax_params(model, load_npz(ANCHOR))
    ckpt = tmp_path / "train"
    ckpt.mkdir()
    torch.save({"model": model.state_dict(), "optimizer": {}, "step": 3}, ckpt / "step_3.pt")
    root, _ = dr_root
    args = _cli_args(root, tmp_path / "a")
    from_npz = tcli.main(["--device", "cpu", "dataset_name=dynamicreplica", *args])
    args = _cli_args(root, tmp_path / "b")
    args[7] = f"MODEL.checkpoint={ckpt}"
    from_dir = tcli.main(["--device", "cpu", *args])
    assert from_npz["aggregate"]["epe_mean"] == from_dir["aggregate"]["epe_mean"]
    with pytest.raises(FileNotFoundError, match="step_"):
        tcli.main(["--device", "cpu", *args[:7], f"MODEL.checkpoint={tmp_path}", args[8]])


def test_cli_refusals(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main([f"exp_dir={tmp_path}", "MODEL.iters=1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdemo.main(["--left", str(tmp_path), "--right", str(tmp_path)])
    with pytest.raises(FileNotFoundError, match="no frames"):
        tdemo.main(["--device", "cpu", "--left", str(tmp_path), "--right", str(tmp_path),
                    "--iters", "1", "--model_kwargs", "mixed_precision=False"])
    with pytest.raises(NotImplementedError, match=r"ROADMAP §1 item 7\.2"):
        tcli.main(["--device", "cpu", "MODEL.mesh=1x1x2"])
    with pytest.raises(ValueError, match="unknown model 'NoSuchStereoModel'"):
        tcli.main(["--device", "cpu", "MODEL.model_name=NoSuchStereoModel"])
    with pytest.raises(AttributeError, match="no field nope"):
        tcli.main(["--device", "cpu", "MODEL.nope=1"])


def test_demo_cli_writes_frames_and_npz(dr_root, predictor, tmp_path):
    """Frame directories in (4 frames in chunks of 3: windows of 3 and 1),
    one colour-mapped PNG per frame and the raw disparities out; the
    disparities equal the predictor's on each chunk."""
    src = tmp_path / "frames"
    rng = np.random.default_rng(5)
    video = rng.integers(0, 255, (4, 2, 32, 48, 3)).astype(np.uint8)
    for cam_i, cam in enumerate(("left", "right")):
        (src / cam).mkdir(parents=True)
        for i in range(4):
            Image.fromarray(video[i, cam_i]).save(str(src / cam / f"{i:04d}.png"))
    out = tmp_path / "out"
    disp = tdemo.main(["--device", "cpu", "--left", str(src / "left"), "--right",
                       str(src / "right"), "--output", str(out), "--kernel_size", "4",
                       "--iters", "1", "--frame_size", "3", "--save_npz",
                       f"--checkpoint={ANCHOR}", "--model_kwargs", "mixed_precision=False"])
    frames = sorted(p.name for p in out.glob("disparity_*.png"))
    assert frames == [f"disparity_{i:05d}.png" for i in range(4)]
    assert np.asarray(Image.open(out / frames[0])).shape == (32, 48, 3)
    saved = np.load(out / "disparity.npz")["disparity"]
    want = np.concatenate([predictor({"stereo_video": video[s:s + 3].astype(np.float32)})
                           ["disparity"] for s in (0, 3)])[..., 0]
    assert saved.shape == disp.shape == (4, 32, 48)
    np.testing.assert_array_equal(saved, want)
