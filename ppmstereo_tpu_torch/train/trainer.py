"""The one-card training loop (counterpart of ppmstereo_tpu/train/trainer.py
for PPMStereo on one device in one process): data -> train step ->
metrics -> checkpoints.

    state = train(TrainConfig(num_steps=1000), device="cuda")

A fresh run starts from `utils/init.py`'s initialisation (seeded with
`cfg.seed`), or from flat flax parameters given as `init_params` (e.g.
`load_npz("checkpoints/anchor_r5.npz")`) with a fresh optimiser; a run
whose `exp_dir` holds a checkpoint resumes from it. The mesh options of the
JAX trainer (data, sequence and space parallelism) and the other models of
the zoo wait for later slices of the port.
"""

from __future__ import annotations

import logging
import time
from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch

from ppmstereo_tpu_torch.models.ppm_stereo import PPMStereo
from ppmstereo_tpu_torch.train.checkpoints import CheckpointManager
from ppmstereo_tpu_torch.train.state import TrainOptimizer, TrainState
from ppmstereo_tpu_torch.train.step import to_device, train_step
from ppmstereo_tpu_torch.utils.device import resolve_device, set_precision
from ppmstereo_tpu_torch.utils.init import init_ppmstereo
from ppmstereo_tpu_torch.utils.logging_utils import MetricsLogger
from ppmstereo_tpu_torch.utils.weights import load_flax_params


@dataclass
class TrainConfig:
    """The JAX package's TrainConfig defaults (the shipped recipe) for the
    fields a one-card PPMStereo run reads."""

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
    num_workers: int = 4
    seed: int = 0
    log_freq: int = 100  # running-mean flush interval


def build_train_model(cfg: TrainConfig) -> PPMStereo:
    if cfg.model_name not in ("ppmstereo", "memstereo"):
        raise ValueError(f"model {cfg.model_name!r}: the port trains PPMStereo only; "
                         "the rest of the zoo is a later slice (ROADMAP)")
    return PPMStereo(cfg.train_iters, cfg.mixed_precision, test_mode=False,
                     num_frames=cfg.sample_len)


def train(cfg: TrainConfig, loader=None, max_steps: int | None = None,
          init_params: Mapping[str, np.ndarray] | None = None,
          device: str | torch.device | None = None) -> TrainState:
    """Run training on `device` (`cuda` unless another is named; raises
    without a card) and return the final state. `loader` defaults to
    `fetch_dataloader` (the synthetic dataset) and is iterated again at
    each epoch: a one-shot iterator must yield every step's batch, and a
    pass that yields none raises. `max_steps` stops the run early without
    changing the schedule (which spans cfg.num_steps)."""
    from ppmstereo_tpu_torch.data.datasets import fetch_dataloader

    dev = resolve_device(device)
    if dev.type == "cuda":
        set_precision()
    if loader is None:
        loader = fetch_dataloader(crop_size=cfg.crop_size, sample_len=cfg.sample_len,
                                  batch_size=cfg.batch_size, num_workers=cfg.num_workers,
                                  seed=cfg.seed)
    model = build_train_model(cfg)
    init_ppmstereo(model, cfg.seed)
    model.to(dev)
    state = TrainState(model, TrainOptimizer(model, num_steps=cfg.num_steps, lr=cfg.lr))
    n_params = sum(p.numel() for p in model.parameters())
    logging.info(f"model {cfg.model_name}: {n_params / 1e6:.1f}M params on {dev}")

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
            if state.step >= limit:
                break
        if state.step == start:
            raise ValueError(f"the loader yielded no batch at step {start} of {limit}: "
                             "pass a re-iterable loader or max_steps it can fill")
    ckpt.save(state)
    logger.flush(state.step)
    logger.close()
    return state
