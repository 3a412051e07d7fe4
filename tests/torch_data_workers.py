"""Process bodies for the port's data-axis tests
(tests/test_torch_data_*.py), run by
`ppmstereo_tpu_torch.parallel.launch.run_group` in spawned processes. They
import torch and the port only, so a spawned process starts quickly.
Results travel back as numpy arrays and plain values."""

from __future__ import annotations

import numpy as np
import torch

NUM_STEPS, LR = 1000, 3e-4  # tests/torch_train_parity.py's schedule


def tensorboard_without_tensorflow() -> None:
    """Let TensorBoard's event writer (the trainer's MetricsLogger) run on
    its own TensorFlow-free stub in this process. Where TensorFlow is
    installed, the writer's first event imports it: ~22 s of a process's
    time on an 8-core CPU host, for events that no test reads. The event
    file is written either way."""
    import sys
    import types

    sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))


def _mesh(spec):
    from ppmstereo_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    return make_mesh(MeshSpec(*spec))


def _flat(tensors: dict, model) -> dict:
    from ppmstereo_tpu_torch.utils.weights import state_dict_to_flax, transposed_kernels

    return state_dict_to_flax({k: v.detach() for k, v in tensors.items()},
                              transposed_kernels(model))


def loss_shares(rank, world, preds, gt, valid, uncs):
    """This rank's block of the global batch through the sequence loss
    over the data axis (its share and the global metrics) and alone (its
    own mean)."""
    from ppmstereo_tpu_torch.parallel.sharding import local_slice
    from ppmstereo_tpu_torch.train.loss import sequence_loss

    mesh = _mesh((world, 1, 1))
    mine = local_slice(gt.shape[0], rank, world)
    args = (torch.from_numpy(preds[:, mine]), torch.from_numpy(gt[mine]),
            torch.from_numpy(valid[mine]))
    unc = torch.from_numpy(uncs[:, mine])
    share, metrics = sequence_loss(*args, uncertainties=unc, group=mesh.groups["data"])
    alone, _ = sequence_loss(*args, uncertainties=unc)
    return float(share), {k: float(v) for k, v in metrics.items()}, float(alone)


def mesh_step(model, has_unc, batch, mesh):
    """One train step of `model` on this rank's part of the global `batch`
    (its data coordinate's block of the clips, and over a seq axis its
    block of their frames): (metrics, the reduced gradients, the
    parameters after the update) as flat flax names."""
    from ppmstereo_tpu_torch.parallel.sharding import local_batch, local_frames
    from ppmstereo_tpu_torch.train.state import TrainOptimizer, TrainState
    from ppmstereo_tpu_torch.train.step import to_device, train_step

    group = None if mesh is None else mesh.replica_group
    opt = TrainOptimizer(model, num_steps=NUM_STEPS, lr=LR)
    state = TrainState(model, opt, has_unc, replica_group=group)
    names = {id(p): n for n, p in model.named_parameters()}
    grads = {}
    step = opt.step

    def recording_step():  # the gradients the optimiser reads: the reduced ones
        for g, p in zip(opt.gradients(), (p for grp in opt.groups for p in grp)):
            grads[names[id(p)]] = g.clone()
        return step()

    opt.step = recording_step
    if mesh is not None:
        batch = local_batch(batch, mesh.coords["data"], mesh.shape["data"])
        batch = local_frames(batch, mesh.coords["seq"], mesh.shape["seq"])
    state, metrics = train_step(state, to_device(batch, torch.device("cpu")))
    return ({k: float(v) for k, v in metrics.items()}, _flat(grads, model),
            _flat(dict(model.state_dict()), model))


def ppm_model(anchor_path, mesh):
    from ppmstereo_tpu_torch.models.ppm_stereo import PPMStereo, PPMStereoConfig
    from ppmstereo_tpu_torch.utils.weights import load_flax_params, load_npz

    model = PPMStereo(PPMStereoConfig(mixed_precision=False), iters=2, mesh=mesh)
    load_flax_params(model, load_npz(anchor_path))
    return model


def train_steps(rank, world, anchor_path, batch, ds_batch, ds_kwargs):
    """One data-parallel train step of the tiny PPMStereo from the anchor
    (sound, then with the batch mean of the picked scores taken over this
    rank's clips alone: the fault), and one of DynamicStereo at
    `ds_kwargs` from the port's seeded initialisation, on this rank's
    block of each global batch."""
    from ppmstereo_tpu_torch.models import ppm_stereo
    from ppmstereo_tpu_torch.train.trainer import TrainConfig, build_train_model
    from ppmstereo_tpu_torch.utils.init import init_model

    mesh = _mesh((world, 1, 1))
    out = {"sound": mesh_step(ppm_model(anchor_path, mesh), True, batch, mesh)}
    batch_mean = ppm_stereo.batch_mean
    ppm_stereo.batch_mean = lambda x, group=None: batch_mean(x)
    try:
        out["local_mean"] = mesh_step(ppm_model(anchor_path, mesh), True, batch, mesh)
    finally:
        ppm_stereo.batch_mean = batch_mean
    model, has_unc = build_train_model(TrainConfig(**ds_kwargs), mesh)
    init_model(model, 0)
    out["dynamicstereo"] = mesh_step(model, has_unc, ds_batch, mesh)
    return out


def one_process_step(cfg_kwargs, batch):
    """The port's one-process train step of build_train_model(TrainConfig(
    **cfg_kwargs)) at init_model(0) on the whole `batch` (the reference
    of the data-parallel step)."""
    from ppmstereo_tpu_torch.train.trainer import TrainConfig, build_train_model
    from ppmstereo_tpu_torch.utils.init import init_model

    model, has_unc = build_train_model(TrainConfig(**cfg_kwargs))
    init_model(model, 0)
    return mesh_step(model, has_unc, batch, None)


def fake_window_fn(left, right):
    """tests/test_harness.py::TestParallelStreaming's window function: the
    disparity is mean |left - right| per pixel, the uncertainty 0."""
    d = (left - right).abs().mean(dim=-1, keepdim=True)
    return d, torch.zeros_like(d)


def fake_predictor(batch):
    """A numpy predictor for the evaluation tests: mean |left - right|."""
    video = np.asarray(batch["stereo_video"], np.float32)
    return {"disparity": np.abs(video[:, 0] - video[:, 1]).mean(-1, keepdims=True)}


def _zoo(anchor_path, mesh, **kwargs):
    from ppmstereo_tpu_torch.models.zoo import model_zoo
    from ppmstereo_tpu_torch.utils.weights import load_npz

    return model_zoo("PPMStereoModel", kernel_size=4, iters=2, params=load_npz(anchor_path),
                     device="cpu", mixed_precision=False, mesh=mesh, **kwargs)


def data_axis_paths(rank, world, cases, anchor_path, pair, clip, sequences, eval_args):
    """Every inference path of the data axis in one group: the
    ParallelWindowPredictor on each (k, video) case; the tiny PPMStereo
    through model_zoo(batch_windows=2, mesh) on the stacked pair of windows
    (its batched-window call) and on the whole clip; evaluate_distributed
    on `sequences`; the evaluate CLI with MODEL.mesh (`eval_args` plus a
    results directory of this rank's)."""
    from ppmstereo_tpu_torch.cli import evaluate as cli
    from ppmstereo_tpu_torch.evaluation.distributed import evaluate_distributed
    from ppmstereo_tpu_torch.models.inference import SlidingWindowPredictor
    from ppmstereo_tpu_torch.parallel.streaming import ParallelWindowPredictor

    mesh = _mesh((world, 1, 1))
    out = {"windows": [ParallelWindowPredictor(fake_window_fn, mesh, kernel_size=k,
                                               device="cpu")(video)
                       for k, video in cases]}
    pred = _zoo(anchor_path, mesh, batch_windows=2)
    pl, pr = (torch.from_numpy(np.ascontiguousarray(pair[:, :, v])) for v in (0, 1))
    out["pair"] = [o.numpy() for o in pred.predictor._run_window_batch(pl, pr)]
    out["clip"] = pred({"stereo_video": clip})["disparity"]
    three = SlidingWindowPredictor(fake_window_fn, kernel_size=4, device="cpu", batch_windows=3,
                                   data_group=mesh.groups["data"])
    try:
        three(np.zeros((8, 2, 32, 32, 3), np.float32))  # windows at 0, 2, 4: one batch of 3
    except ValueError as exc:
        out["indivisible"] = str(exc)
    out["eval"] = evaluate_distributed(None, fake_predictor, sequences)
    exp_dir = f"{eval_args['exp_root']}/rank{rank}"
    out["cli"] = cli.main(["--device", "cpu", *eval_args["args"], f"exp_dir={exp_dir}",
                           "MODEL.mesh=2x1x1"])
    return out


def pair_over_data_and_space(rank, world, anchor_path, pair):
    """The stacked pair of windows through model_zoo(batch_windows=2) under a
    (data 2, space 2) mesh: each data rank's window rings its play steps over
    its space pair."""
    from ppmstereo_tpu_torch.parallel import ring_attention

    pred = _zoo(anchor_path, _mesh((2, 1, 2)), batch_windows=2)
    pl, pr = (torch.from_numpy(np.ascontiguousarray(pair[:, :, v])) for v in (0, 1))
    outs = pred.predictor._run_window_batch(pl, pr)
    return [o.numpy() for o in outs], ring_attention.shift.messages


def train_cli(rank, world, args):
    """The train CLI under a group of `world` ranks: (the final step, the
    optimiser's update count, the checkpoints this process saved, and its
    parameters as numpy)."""
    from ppmstereo_tpu_torch.cli import train as cli

    tensorboard_without_tensorflow()
    saves = []
    save = torch.save
    torch.save = lambda obj, f, *a, **k: saves.append(str(f)) or save(obj, f, *a, **k)
    try:
        state = cli.main(args)
    finally:
        torch.save = save
    params = {k: v.numpy() for k, v in state.model.state_dict().items()}
    return state.step, state.optimizer.count, saves, params
