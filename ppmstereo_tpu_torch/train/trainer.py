"""The one-card training loop (counterpart of ppmstereo_tpu/train/trainer.py
on one device in one process): data -> train step -> metrics ->
checkpoints -> in-training evaluation.

    state = train(TrainConfig(num_steps=1000), device="cuda")
    state = train(TrainConfig(model_name="stereoanyvideo"), device="cuda")

`model_name` picks one of the JAX trainer's six models (`build_train_model`):
ppmstereo and memstereo (PPMStereo), ppmstereo_vda (PPMStereo with the
Video-Depth-Anything features), dynamicstereo, bidastereo and
stereoanyvideo, each at its config's defaults with `mixed_precision` and
`model_kwargs` on top. A fresh run starts from `utils/init.py`'s
initialisation (seeded with `cfg.seed`), or from flat flax parameters given
as `init_params` (e.g. `load_npz("checkpoints/anchor_r5.npz")`, or an
import CLI's npz) with a fresh optimiser; a run whose `exp_dir` holds a
checkpoint resumes from it. The JAX trainer's mesh (data, sequence and space
parallelism; ROADMAP §1 item 7) and uint8 images on the wire are refused.
"""

from __future__ import annotations

import logging
import time
from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch

from ppmstereo_tpu_torch.models.bidastereo import BiDAStereo, BiDAStereoConfig
from ppmstereo_tpu_torch.models.dynamic_stereo import DynamicStereo, DynamicStereoConfig
from ppmstereo_tpu_torch.models.ppm_stereo import PPMStereo, PPMStereoConfig
from ppmstereo_tpu_torch.models.stereoanyvideo import StereoAnyVideo, StereoAnyVideoConfig
from ppmstereo_tpu_torch.train.checkpoints import CheckpointManager
from ppmstereo_tpu_torch.train.state import TrainOptimizer, TrainState, param_label
from ppmstereo_tpu_torch.train.step import to_device, train_step
from ppmstereo_tpu_torch.utils.device import resolve_device, set_precision
from ppmstereo_tpu_torch.utils.init import init_model
from ppmstereo_tpu_torch.utils.logging_utils import MetricsLogger
from ppmstereo_tpu_torch.utils.weights import load_flax_params, model_to_flax


@dataclass
class TrainConfig:
    """The JAX package's TrainConfig with its defaults (the shipped recipe).
    model_kwargs: further fields of the model's config (e.g. {"use_cnet":
    False} for PPMStereo). The mesh (data_parallel, seq_parallel,
    space_parallel: 0 or 1 each) and wire_uint8 exist for the JAX package's
    presets; a mesh above one device or uint8 images raise in `train` (the
    port ships f32 images to the card, as the JAX package's wire_dtype is
    omitted)."""

    model_name: str = "ppmstereo"
    num_steps: int = 200_000
    batch_size: int = 2
    lr: float = 3e-4
    sample_len: int = 5
    train_iters: int = 10
    crop_size: tuple = (320, 512)
    mixed_precision: bool = True
    exp_dir: str = "./outputs/train"
    ckpt_after_steps: int = 80_000
    save_freq: int = 5_000
    eval_freq: int = 5_000
    num_workers: int = 4
    seed: int = 0
    log_freq: int = 100  # running-mean flush interval
    model_kwargs: dict | None = None
    data_parallel: int = 0  # 0: all devices, which is one here
    seq_parallel: int = 1
    space_parallel: int = 1
    wire_uint8: bool = False


def check_supported(cfg: TrainConfig) -> None:
    """Raise for the JAX trainer's options the port does not run."""
    mesh = {"data_parallel": cfg.data_parallel, "seq_parallel": cfg.seq_parallel,
            "space_parallel": cfg.space_parallel}
    if any(n > 1 for n in mesh.values()):
        raise NotImplementedError(f"{mesh}: the port trains on one card in one process; DDP "
                                  "and seq/space training are ROADMAP §1 item 7")
    if cfg.wire_uint8:
        raise NotImplementedError("wire_uint8=True: the port ships f32 images to the card "
                                  "(omitted on purpose, as the predictor's wire_dtype is; "
                                  "ROADMAP §3)")


def build_train_model(cfg: TrainConfig) -> tuple[torch.nn.Module, bool]:
    """The train-mode model of `cfg.model_name` (the JAX `build_train_model`'s names and
    config arguments; the time embedding's `num_frames` is the clip length
    for the three models with an SST) and whether it has an uncertainty
    head. Unknown names raise."""
    name, kwargs = cfg.model_name, cfg.model_kwargs or {}
    precision = {"mixed_precision": cfg.mixed_precision}
    if name in ("ppmstereo", "memstereo", "ppmstereo_vda"):
        vfm = {"use_vfm": True} if name == "ppmstereo_vda" else {}
        mcfg = PPMStereoConfig(num_frames=cfg.sample_len, **precision, **vfm, **kwargs)
        return PPMStereo(mcfg, cfg.train_iters, test_mode=False), True
    if name == "dynamicstereo":
        mcfg = DynamicStereoConfig(num_frames=cfg.sample_len, **precision, **kwargs)
        return DynamicStereo(mcfg, cfg.train_iters, test_mode=False), False
    if name == "bidastereo":
        return BiDAStereo(BiDAStereoConfig(**precision, **kwargs), cfg.train_iters,
                          test_mode=False), False
    if name == "stereoanyvideo":
        return StereoAnyVideo(StereoAnyVideoConfig(**precision, **kwargs), cfg.train_iters,
                              test_mode=False), False
    raise ValueError(f"unknown model {name}")


# the zoo's name of each trained model, and the models whose evaluation
# predictor is sized by the training clip (their SST's time embedding)
ZOO_NAMES = {"ppmstereo": "PPMStereoModel", "memstereo": "PPMStereoModel",
             "ppmstereo_vda": "PPMStereoVDAModel", "dynamicstereo": "DynamicStereoModel",
             "bidastereo": "BiDAStereoModel", "stereoanyvideo": "StereoAnyVideoModel"}
WITH_NUM_FRAMES = ("ppmstereo", "memstereo", "ppmstereo_vda", "dynamicstereo")


def build_eval_predictor(cfg: TrainConfig, params: Mapping[str, np.ndarray],
                         eval_iters: int = 10, kernel_size: int = 10,
                         device: str | torch.device | None = None):
    """A test-mode predictor of the training model's configuration over the
    flat flax `params` (the current ones, for in-training evaluation)."""
    from ppmstereo_tpu_torch.models.zoo import model_zoo

    kwargs = dict(mixed_precision=cfg.mixed_precision, **(cfg.model_kwargs or {}))
    if cfg.model_name in WITH_NUM_FRAMES:
        kwargs["num_frames"] = cfg.sample_len
    return model_zoo(ZOO_NAMES[cfg.model_name], kernel_size=kernel_size, iters=eval_iters,
                     params=params, device=device, **kwargs)


def run_in_training_eval(cfg: TrainConfig, params: Mapping[str, np.ndarray], step: int,
                         logger: MetricsLogger, eval_dataset=None,
                         device: str | torch.device | None = None) -> dict:
    """Evaluate the current parameters on `eval_dataset` (by default two
    synthetic clips of 4 frames at the crop size): the results go to
    `<exp_dir>/result_intrain_<step>.json` and, prefixed `eval/`, to the
    metrics log; where the logger has a TensorBoard writer, the first
    clip's first disparity map goes there as an image."""
    from ppmstereo_tpu_torch.evaluation.evaluator import EvalConfig, Evaluator
    from ppmstereo_tpu_torch.evaluation.visualization import colorize_disparity

    if eval_dataset is None:
        from ppmstereo_tpu_torch.data.datasets import SyntheticStereoDataset

        eval_dataset = SyntheticStereoDataset(num_seqs=2, sample_len=4,
                                              height=cfg.crop_size[0], width=cfg.crop_size[1])
    predictor = build_eval_predictor(cfg, params, device=device)
    evaluator = Evaluator(EvalConfig(exp_dir=cfg.exp_dir))
    results = evaluator.evaluate_sequence(predictor, eval_dataset)
    evaluator.dump(results, "intrain", step)
    logger.write_dict(step, results["aggregate"], prefix="eval/")
    if logger.writer is not None:
        out = predictor({"stereo_video": eval_dataset[0]["img"][:2]})
        img = colorize_disparity(out["disparity"][0, ..., 0])
        logger.writer.add_image("eval/disparity", img.transpose(2, 0, 1), step)
    return results


def train(cfg: TrainConfig, loader=None, max_steps: int | None = None,
          eval_dataset=None, enable_eval: bool = False, save_callback=None,
          init_params: Mapping[str, np.ndarray] | None = None,
          device: str | torch.device | None = None) -> TrainState:
    """Run training on `device` (`cuda` unless another is named; raises
    without a card) and return the final state. `loader` defaults to
    `fetch_dataloader` (the SceneFlow + Dynamic Replica mixture, or the
    synthetic dataset) and is iterated again at each epoch: a one-shot
    iterator must yield every step's batch, and a pass that yields none
    raises. `max_steps` stops the run early without changing the schedule
    (which spans cfg.num_steps).

    Every save_freq steps after ckpt_after_steps the state is saved and
    `save_callback(step, state)` runs right after. With enable_eval, every
    eval_freq steps `run_in_training_eval` scores the current parameters
    on `eval_dataset`."""
    from ppmstereo_tpu_torch.data.datasets import fetch_dataloader

    check_supported(cfg)
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_precision()
    if loader is None:
        loader = fetch_dataloader(crop_size=cfg.crop_size, sample_len=cfg.sample_len,
                                  batch_size=cfg.batch_size, num_workers=cfg.num_workers,
                                  seed=cfg.seed)
    model, has_uncertainty = build_train_model(cfg)
    init_model(model, cfg.seed)
    model.to(dev)
    state = TrainState(model, TrainOptimizer(model, num_steps=cfg.num_steps, lr=cfg.lr),
                       has_uncertainty)
    counts = {"train": 0, "frozen": 0}
    for name, p in model.named_parameters():
        counts["frozen" if param_label(name) == "frozen" else "train"] += p.numel()
    logging.info(f"model {cfg.model_name}: {counts['train'] / 1e6:.1f}M trainable and "
                 f"{counts['frozen'] / 1e6:.1f}M frozen params on {dev}, "
                 f"{'with' if has_uncertainty else 'no'} uncertainty head")

    ckpt = CheckpointManager(f"{cfg.exp_dir}/ckpt")
    if ckpt.restore(state):
        logging.info(f"resumed from step {state.step}")
    elif init_params is not None:
        load_flax_params(model, init_params)
        logging.info("seeded params from init_params (fresh optimizer)")

    logger = MetricsLogger(cfg.exp_dir, sum_freq=cfg.log_freq)
    limit = max_steps if max_steps is not None else cfg.num_steps
    # reading the metrics waits for the device: do it at most every 50 steps
    push_every = max(1, min(50, cfg.log_freq))
    t_last = time.perf_counter()
    while state.step < limit:
        start = state.step
        for batch in loader:
            state, metrics = train_step(state, to_device(batch, dev))
            if state.step % push_every == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                metrics["steps_per_s"] = push_every / (now - t_last)
                t_last = now
                logger.push(state.step, metrics)
            if state.step % cfg.save_freq == 0 and state.step > cfg.ckpt_after_steps:
                ckpt.save(state)
                if save_callback is not None:
                    save_callback(state.step, state)
            if enable_eval and state.step % cfg.eval_freq == 0:
                run_in_training_eval(cfg, model_to_flax(model), state.step,
                                     logger, eval_dataset, device=dev)
            if state.step >= limit:
                break
        if state.step == start:
            raise ValueError(f"the loader yielded no batch at step {start} of {limit}: "
                             "pass a re-iterable loader or max_steps it can fill")
    ckpt.save(state)
    logger.flush(state.step)
    logger.close()
    return state
