"""The training loop (counterpart of ppmstereo_tpu/train/trainer.py): data
-> train step -> metrics -> checkpoints -> in-training evaluation, on one
card or data-parallel over a process group (one process per card).

    state = train(TrainConfig(num_steps=1000), device="cuda")
    state = train(TrainConfig(model_name="stereoanyvideo"), device="cuda")

    # N cards: torchrun --nproc_per_node N -m ppmstereo_tpu_torch.cli.train
    # a clip's frames over 2 of them: ... cli.train --seq_parallel 2 --sample_len 6

`model_name` picks one of the JAX trainer's six models (`build_train_model`):
ppmstereo and memstereo (PPMStereo), ppmstereo_vda (PPMStereo with the
Video-Depth-Anything features), dynamicstereo, bidastereo and
stereoanyvideo, each at its config's defaults with `mixed_precision` and
`model_kwargs` on top. A fresh run starts from `utils/init.py`'s
initialisation (seeded with `cfg.seed`), or from flat flax parameters given
as `init_params` (e.g. `load_npz("checkpoints/anchor_r5.npz")`, or an
import CLI's npz) with a fresh optimiser; a run whose `exp_dir` holds a
checkpoint resumes from it.

Parallelism: in an initialised process group (`parallel/mesh.py::
join_group`, which the train CLI calls) the group's ranks form the mesh
(data, seq) = (data_parallel, seq_parallel), row-major: ranks r S .. r S +
S - 1 share data coordinate r. Each data coordinate loads its block of
every global batch of `batch_size` clips; over a seq axis of S > 1
(PPMStereo only) the S ranks of a data coordinate load the same clips and
each takes its block of their frames (`parallel/sharding.py::
local_frames`), so a clip of `sample_len` frames the axis does not divide
raises, as the JAX sharding P("data", "seq", "space") does. The train
step sums the gradients over data x seq (`train/step.py`): the step is the
one-process step on the global batch, as the JAX trainer's under
`MeshSpec(data, seq)`. The initial parameters are rank 0's, broadcast over
the group; a resume is read by every rank from the same file. Only rank 0
(data 0, seq 0) writes checkpoints and the metrics log and runs the
in-training evaluation, in one process outside the mesh, as the JAX trainer
runs it; the other ranks wait for it. The JAX trainer's `space` axis
(ROADMAP §1 item 7.3's space half, after item 7.2), `seq` for the other
models (item 7.1b) and uint8 images on the wire are refused.
"""

from __future__ import annotations

import logging
import time
from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ppmstereo_tpu_torch.models.bidastereo import BiDAStereo, BiDAStereoConfig
from ppmstereo_tpu_torch.models.dynamic_stereo import DynamicStereo, DynamicStereoConfig
from ppmstereo_tpu_torch.models.ppm_stereo import PPMStereo, PPMStereoConfig
from ppmstereo_tpu_torch.models.stereoanyvideo import StereoAnyVideo, StereoAnyVideoConfig
from ppmstereo_tpu_torch.parallel.collectives import broadcast_tensors_
from ppmstereo_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from ppmstereo_tpu_torch.parallel.sharding import local_batch, local_frames
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
    False} for PPMStereo). data_parallel: the size of the data axis, 0 for
    the process group's (`data_parallel_size`). seq_parallel: the size of
    the seq axis, over which each clip's frames spread (PPMStereo only;
    sample_len must divide by it). space_parallel above 1 and wire_uint8
    exist for the JAX package's presets and raise in `train` (the port
    ships f32 images to the card, as the JAX package's wire_dtype is
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
    data_parallel: int = 0  # 0: every rank of the process group
    seq_parallel: int = 1
    space_parallel: int = 1
    wire_uint8: bool = False


# the model names whose train-mode forward runs over a seq axis: PPMStereo
# without the Video-Depth-Anything features (memstereo builds the same model)
SEQ_MODELS = ("ppmstereo", "memstereo")


def check_supported(cfg: TrainConfig) -> None:
    """Raise for the JAX trainer's options the port does not run, and for a
    clip that the seq axis does not divide (as the JAX package's placement
    of the batch on its mesh does)."""
    if cfg.space_parallel > 1:
        raise NotImplementedError(
            f"space_parallel={cfg.space_parallel}: the space axis in training is ROADMAP §1 "
            "item 7.3's space half, after item 7.2 (every convolution of a window sharded "
            "over space)")
    if cfg.seq_parallel > 1:
        if cfg.model_name not in SEQ_MODELS:
            raise NotImplementedError(
                f"seq_parallel={cfg.seq_parallel} with model {cfg.model_name!r}: the seq axis "
                f"runs for {' and '.join(SEQ_MODELS)}; PPMStereo-VDA's and the baselines' is "
                "ROADMAP §1 item 7.1b")
        if cfg.sample_len % cfg.seq_parallel:
            raise ValueError(f"sample_len={cfg.sample_len}: a clip of {cfg.sample_len} frames "
                             f"does not divide over a seq axis of {cfg.seq_parallel}")
    if cfg.wire_uint8:
        raise NotImplementedError("wire_uint8=True: the port ships f32 images to the card "
                                  "(omitted on purpose, as the predictor's wire_dtype is; "
                                  "ROADMAP §3)")


def data_parallel_size(cfg: TrainConfig, world: int) -> int:
    """The data axis of a run in a group of `world` processes: data_parallel,
    or for 0 the processes left by seq and space, cut to the largest divisor
    of batch_size (the JAX trainer's rule over its devices)."""
    if cfg.data_parallel:
        return cfg.data_parallel
    cap = max(1, world // (cfg.seq_parallel * cfg.space_parallel))
    return max(d for d in range(1, min(cap, cfg.batch_size) + 1) if cfg.batch_size % d == 0)


def build_train_model(cfg: TrainConfig, mesh=None) -> tuple[torch.nn.Module, bool]:
    """The train-mode model of `cfg.model_name` (the JAX `build_train_model`'s names and
    config arguments; the time embedding's `num_frames` is the clip length
    for the three models with an SST) and whether it has an uncertainty
    head. Unknown names raise. `mesh` (data and seq axes) reaches the
    PPMStereo family, whose batch mean couples the clips and whose frames
    spread over seq; the other models treat each clip alone and refuse seq
    (`check_supported`)."""
    name, kwargs = cfg.model_name, cfg.model_kwargs or {}
    precision = {"mixed_precision": cfg.mixed_precision}
    if name in ("ppmstereo", "memstereo", "ppmstereo_vda"):
        vfm = {"use_vfm": True} if name == "ppmstereo_vda" else {}
        mcfg = PPMStereoConfig(num_frames=cfg.sample_len, **precision, **vfm, **kwargs)
        return PPMStereo(mcfg, cfg.train_iters, test_mode=False, mesh=mesh), True
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

    In a process group (see the module's docstring) a caller's `loader`
    yields global batches and each rank takes its block of clips and of
    their frames; the default loader loads the data coordinate's block
    alone. A mesh of data x seq that does not span the group raises.

    Every save_freq steps after ckpt_after_steps the state is saved and
    `save_callback(step, state)` runs right after (rank 0). With
    enable_eval, every eval_freq steps `run_in_training_eval` scores the
    current parameters on `eval_dataset` (rank 0; the others wait at a
    barrier that the group's timeout bounds)."""
    from ppmstereo_tpu_torch.data.datasets import fetch_dataloader

    check_supported(cfg)
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_precision()
    world = dist.get_world_size() if dist.is_initialized() else 1
    dp, seq = data_parallel_size(cfg, world), cfg.seq_parallel
    if dp * seq != world:
        raise ValueError(f"data_parallel={dp} (batch {cfg.batch_size}) x seq_parallel={seq} "
                         f"needs a process group of {dp * seq} ranks, one per card (torchrun "
                         f"--nproc_per_node {dp * seq}); this one has {world}")
    mesh = make_mesh(MeshSpec(data=dp, seq=seq)) if world > 1 else None
    group = mesh.replica_group if mesh is not None else None
    rank = mesh.coords["data"] if mesh is not None else 0
    lead = mesh is None or dist.get_rank() == 0  # data 0, seq 0
    if loader is None:
        loader = fetch_dataloader(crop_size=cfg.crop_size, sample_len=cfg.sample_len,
                                  batch_size=cfg.batch_size, num_workers=cfg.num_workers,
                                  seed=cfg.seed, data_rank=rank, data_size=dp)
        if seq > 1:
            loader = _LocalBlocks(loader, mesh, clips=False)
    elif mesh is not None:
        loader = _LocalBlocks(loader, mesh)
    model, has_uncertainty = build_train_model(cfg, mesh)
    init_model(model, cfg.seed)
    model.to(dev)
    state = TrainState(model, TrainOptimizer(model, num_steps=cfg.num_steps, lr=cfg.lr),
                       has_uncertainty, replica_group=group)
    counts = {"train": 0, "frozen": 0}
    for name, p in model.named_parameters():
        counts["frozen" if param_label(name) == "frozen" else "train"] += p.numel()
    logging.info(f"model {cfg.model_name}: {counts['train'] / 1e6:.1f}M trainable and "
                 f"{counts['frozen'] / 1e6:.1f}M frozen params on {dev}, "
                 f"{'with' if has_uncertainty else 'no'} uncertainty head"
                 + (f", mesh {mesh.coords} of {mesh.shape}" if mesh is not None else ""))

    ckpt = CheckpointManager(f"{cfg.exp_dir}/ckpt", write=lead)
    if ckpt.restore(state):
        logging.info(f"resumed from step {state.step}")
    elif init_params is not None:
        load_flax_params(model, init_params)
        logging.info("seeded params from init_params (fresh optimizer)")
    if group is not None:  # every rank starts from rank 0's tensors
        broadcast_tensors_(list(model.parameters()) + list(model.buffers()), group)

    logger = MetricsLogger(cfg.exp_dir, sum_freq=cfg.log_freq, write=lead)
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
                if ckpt.save(state) and save_callback is not None:
                    save_callback(state.step, state)
            if enable_eval and state.step % cfg.eval_freq == 0:
                if lead:
                    run_in_training_eval(cfg, model_to_flax(model), state.step,
                                         logger, eval_dataset, device=dev)
                if group is not None:
                    dist.barrier(group)
            if state.step >= limit:
                break
        if state.step == start:
            raise ValueError(f"the loader yielded no batch at step {start} of {limit}: "
                             "pass a re-iterable loader or max_steps it can fill")
    ckpt.save(state)
    logger.flush(state.step)
    logger.close()
    return state


class _LocalBlocks:
    """A loader's batches as this rank's part of them on `mesh`: its data
    coordinate's block of the clips (unless `clips` is False: the loader
    loads that block alone) and its seq coordinate's block of their frames
    (re-iterable when the loader is)."""

    def __init__(self, loader, mesh, clips: bool = True):
        self.loader, self.mesh, self.clips = loader, mesh, clips

    def __iter__(self):
        shape, coords = self.mesh.shape, self.mesh.coords
        for batch in self.loader:
            if self.clips:
                batch = local_batch(batch, coords["data"], shape["data"])
            if shape["seq"] > 1:
                batch = local_frames(batch, coords["seq"], shape["seq"])
            yield batch
