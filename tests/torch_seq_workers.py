"""Process bodies for tests/test_torch_seq_inference.py and
tests/test_torch_seq_train.py, run by
`ppmstereo_tpu_torch.parallel.launch.run_group` in spawned processes. They
import torch and the port only, so a spawned process starts quickly.
Results travel back as numpy arrays and plain values."""

from __future__ import annotations

import copy
import functools

import numpy as np
import torch

K, ITERS, WARM_ITERS = 4, 2, 1
# the clip of the window modes and of data x seq, held against the port's
# own unsharded paths: the video's first 6 frames (windows at 0 and 2 and a
# tail of 2 at 4); data x seq's cropped to 32 x 64
MODE_FRAMES, CROP_H, CROP_W = 6, 32, 64


def crop_clip(video):
    return np.ascontiguousarray(video[:MODE_FRAMES, :, :CROP_H, :CROP_W])


def _mesh(spec):
    from ppmstereo_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    return make_mesh(MeshSpec(*spec))


@functools.cache
def _anchor(anchor_path):
    from ppmstereo_tpu_torch.utils.weights import load_npz

    return load_npz(anchor_path)


def _zoo(anchor_path, mesh=None, **kwargs):
    from ppmstereo_tpu_torch.models.zoo import model_zoo

    return model_zoo("PPMStereoModel", kernel_size=K, iters=ITERS, params=_anchor(anchor_path),
                     device="cpu", mixed_precision=False, mesh=mesh, **kwargs)


def _recording(pred) -> list:
    """Record every top-k pick of the predictor's model (the whole window's
    picks, stage by stage, window by window)."""
    picks: list = []
    model = pred.model
    forward = model.forward
    model.forward = lambda *args, **kwargs: forward(*args, picks=picks, **kwargs)
    return picks


def zero_halos(sharding):
    """The fault: every time halo's frames read as zeros (the messages still
    go, so the processes stay in step). Returns the undo."""
    halo = sharding.FrameShard.halo

    def zeroed(self, x, h):
        out = halo(self, x, h)
        edge = torch.zeros_like(out[:, :h])
        return torch.cat([edge, out[:, h: out.shape[1] - h], edge], dim=1)

    sharding.FrameShard.halo = zeroed
    return lambda: setattr(sharding.FrameShard, "halo", halo)


def ungathered_bank(sharding):
    """The fault: the play's bank is not gathered; a picked frame of another
    process reads as zeros. Returns the undo."""
    gather_bank = sharding.FrameShard.gather_bank

    def local_only(self, x):
        whole = x.new_zeros(x.shape[0], self.total, *x.shape[2:])
        whole[:, self.offset: self.offset + self.count] = x
        return whole

    sharding.FrameShard.gather_bank = local_only
    return lambda: setattr(sharding.FrameShard, "gather_bank", gather_bank)


FAULTS = {"zero_halos": zero_halos, "ungathered_bank": ungathered_bank}


def _units(model, shard, frames: int = 4) -> dict:
    """Each frame-mixing module of the anchor's `model` on a seeded input of
    `frames` frames, sharded over `shard` against unsharded (both in this
    process): the max |difference| of each."""
    from ppmstereo_tpu_torch.ops.upsample import convex_upsample_3d

    rng = np.random.default_rng(11)

    def draw(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    h, w = 16, 32
    ub16, ub04 = model.update_block16.update_block, model.update_block04.update_block
    # the GRU in f64: its time convolutions sum 2,560 terms, and in f32 a
    # block of other extent sums them in another order (1.8e-6 apart)
    gru = copy.deepcopy(ub04.gru).double()
    for m in gru.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    net, x = torch.tanh(draw(1, frames, h, w, 128)), draw(1, frames, h, w, 384)
    net64, x64 = net.double(), x.double()
    flow, mask = draw(1, frames, h, w, 2, scale=3.0), draw(1, frames, h, w, 27 * 16)
    f1, f2 = draw(1, frames, 4, 8, 256), draw(1, frames, 4, 8, 256)
    cases = {
        "SKSepConvGRU3D": (lambda s: gru(shard.local(net64) if s else net64,
                                         shard.local(x64) if s else x64, s)),
        "FlowHead": lambda s: ub04.flow_head(shard.local(net) if s else net, s),
        "convex_upsample_3d": lambda s: convex_upsample_3d(
            shard.local(flow) if s else flow, shard.local(mask) if s else mask, 4, s),
        "TimeAttnBlock": lambda s: ub16.time_attn(shard.local(x) if s else x, s),
        "SSTBlock": lambda s: torch.cat(model.sst(shard.local(f1) if s else f1,
                                                  shard.local(f2) if s else f2, s), dim=-1),
    }
    out = {}
    with torch.no_grad():
        for name, fn in cases.items():
            want = fn(None)
            got = shard.gather(fn(shard).contiguous())
            out[name] = float((got - want).abs().max())
    return out


def seq_paths(rank, world, anchor_path, video, cli_args):
    """The seq axis over a group of 2 (seq 2): the units against unsharded;
    the strict predictor on `video` and the whole-clip path on its first 2
    frames (outputs and picks); the warm, encoder-cache and batch_windows=2
    predictors on its first MODE_FRAMES frames; the two faults on the first
    window; the evaluate CLI with MODEL.mesh=1x2x1 (`cli_args` plus a
    results directory of this rank's). Then this rank's share of the
    unsharded references of the three modes (rank 0 warm and encoder
    cache, rank 1 batch_windows=2, also on `crop_clip(video)` for data x
    seq)."""
    from ppmstereo_tpu_torch.cli import evaluate as cli
    from ppmstereo_tpu_torch.parallel import sharding

    mesh = _mesh((1, world, 1))
    out = {}
    strict = _zoo(anchor_path, mesh)
    shard = sharding.frame_shard(4, mesh.groups["seq"])
    out["units"] = _units(strict.model, shard)
    picks = _recording(strict)
    out["strict"] = strict({"stereo_video": video})
    out["strict_picks"] = [p.numpy() for p in picks]
    del picks[:]
    out["whole"] = strict({"stereo_video": video[:2]})
    out["whole_picks"] = [p.numpy() for p in picks]
    modes = {"warm_start": {"warm_start": True, "warm_iters": WARM_ITERS},
             "encoder_cache": {"encoder_cache": True}, "batch_windows": {"batch_windows": 2}}
    clip = video[:MODE_FRAMES]
    for name, kwargs in modes.items():
        out[name] = _zoo(anchor_path, mesh, **kwargs)({"stereo_video": clip})
    left, right = (torch.from_numpy(np.ascontiguousarray(video[None, :K, v])) for v in (0, 1))
    for name, fault in FAULTS.items():
        undo = fault(sharding)
        try:
            with torch.no_grad():
                out[name] = strict.model(left, right)[0].numpy()
        finally:
            undo()
    exp_dir = f"{cli_args['exp_root']}/rank{rank}"
    out["cli"] = cli.main(["--device", "cpu", *cli_args["args"], f"exp_dir={exp_dir}",
                           "MODEL.mesh=1x2x1"])
    for name in (("warm_start", "encoder_cache") if rank == 0 else ("batch_windows",)):
        out[f"unsharded_{name}"] = _zoo(anchor_path, **modes[name])({"stereo_video": clip})
    if rank == 1:  # data x seq's reference
        out["unsharded_crop"] = _zoo(anchor_path, batch_windows=2)(
            {"stereo_video": crop_clip(video)})
    return out


def four_ranks(rank, world, anchor_path, video):
    """The seq axis composed with the others over a group of 4: the strict
    predictor on `video` under seq x space = 2 x 2 (its ring messages
    counted); under data x seq = 2 x 2, on `crop_clip(video)`, the
    zoo's batch_windows=2 predictor and the ParallelWindowPredictor, and the
    latter again with the seq axis left out of its model (the same data
    groups: its reference)."""
    from ppmstereo_tpu_torch.parallel import ring_attention
    from ppmstereo_tpu_torch.parallel.mesh import Mesh, MeshSpec
    from ppmstereo_tpu_torch.parallel.streaming import ParallelWindowPredictor

    out = {}
    ring_attention.shift.messages = 0
    out["seq_space"] = _zoo(anchor_path, _mesh((1, 2, 2)))({"stereo_video": video})
    out["messages"] = ring_attention.shift.messages
    mesh = _mesh((2, 2, 1))
    clip = crop_clip(video)
    out["data_seq"] = _zoo(anchor_path, mesh, batch_windows=2)({"stereo_video": clip})
    no_seq = Mesh(MeshSpec(data=2), dict(mesh.coords, seq=0),
                  dict(mesh.groups, seq=None), mesh.batch_group)
    for name, m in (("parallel", mesh), ("parallel_no_seq", no_seq)):
        model = _zoo(anchor_path, m).model

        def window_fn(left, right, model=model):
            return model(left, right)

        out[name] = ParallelWindowPredictor(window_fn, m, kernel_size=K, device="cpu")(clip)
    return out


# ------------------------------------------------------------ seq training
def local_gather_grad(collectives):
    """The fault: the gather's backward keeps this rank's block of its own
    cotangent (the other ranks' cotangents of its frames are lost). Returns
    the undo."""
    import torch.distributed as dist

    gather = collectives._GatherFrames
    backward = gather.backward

    def local(ctx, grad):
        me, size = dist.get_rank(ctx.group), dist.get_world_size(ctx.group)
        return grad.chunk(size, dim=1)[me].contiguous(), None, None

    gather.backward = staticmethod(local)
    return lambda: setattr(gather, "backward", backward)


def dropped_halo_grad(collectives):
    """The fault: the halo's backward keeps the cotangent of the rank's own
    frames and drops the halos' (nothing goes back to the neighbours).
    Returns the undo."""
    halo = collectives._TimeHalo
    backward = halo.backward

    def dropped(ctx, grad):
        h = ctx.h
        return grad[:, h: grad.shape[1] - h].contiguous(), None, None, None

    halo.backward = staticmethod(dropped)
    return lambda: setattr(halo, "backward", backward)


TRAIN_FAULTS = {"local_gather_grad": local_gather_grad, "dropped_halo_grad": dropped_halo_grad}
# (name, frames a rank, halo): the gather, halos of 1 and 2, and a block
# thinner than its halo (through the gather)
COLLECTIVE_CASES = (("gather", 2, 0), ("halo_1", 2, 1), ("halo_2", 2, 2), ("halo_thin", 1, 2))
FD_EPS = 1e-6


def collective_grads(group) -> dict:
    """The backward of gather_frames and time_halo over the seq `group`, in
    f64, for each of COLLECTIVE_CASES: every rank takes the loss
    <W_r, op(x_r)> with its own seeded cotangent W_r, and the gradient of
    its block x_r must be its block of the gradient of the ranks' summed
    losses. Read against (a) the same ops on the unsharded tensor (the
    gathered clip, or the zero-padded clip's window of each rank),
    differentiated by autograd, and (b) central differences of the summed
    loss, element by element of the whole clip (all ranks step together).
    Returns {case: (max |grad - unsharded|, max |grad - differences|)}."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from ppmstereo_tpu_torch.parallel.collectives import all_reduce_, gather_frames, time_halo

    me, size = dist.get_rank(group), dist.get_world_size(group)
    out = {}
    for name, n, h in COLLECTIVE_CASES:
        rng = np.random.default_rng(5)
        full = torch.from_numpy(rng.standard_normal((2, size * n, 3, 2)))
        wide = n * size if h == 0 else n + 2 * h
        weights = [torch.from_numpy(np.random.default_rng(100 + r).standard_normal(
            (2, wide, 3, 2))) for r in range(size)]

        def op(x):
            return gather_frames(x, group) if h == 0 else time_halo(x, h, group)

        def unsharded(x, r):
            return x if h == 0 else F.pad(x, (0, 0, 0, 0, h, h))[:, r * n: r * n + n + 2 * h]

        x = full[:, me * n: (me + 1) * n].clone().requires_grad_(True)
        (weights[me] * op(x)).sum().backward()
        ref = full.clone().requires_grad_(True)
        sum((weights[r] * unsharded(ref, r)).sum() for r in range(size)).backward()
        want = ref.grad[:, me * n: (me + 1) * n]

        def total(x_local):  # the ranks' summed loss, on every rank
            with torch.no_grad():
                loss = (weights[me] * op(x_local)).sum().reshape(1)
            return float(all_reduce_(loss, group))

        numeric = torch.zeros_like(full)
        flat = numeric.view(-1)
        for e in range(full.numel()):
            steps = []
            for sign in (1.0, -1.0):
                bumped = full.clone()
                bumped.view(-1)[e] += sign * FD_EPS
                steps.append(total(bumped[:, me * n: (me + 1) * n].contiguous()))
            flat[e] = (steps[0] - steps[1]) / (2 * FD_EPS)
        numeric = numeric[:, me * n: (me + 1) * n]
        out[name] = (float((x.grad - want).abs().max()), float((x.grad - numeric).abs().max()))
    return out


def seq_train(rank, world, anchor_path, batch, cli_args):
    """Seq training over a group of 2 (seq 2): the collectives' backward
    (`collective_grads`); one train step of the tiny PPMStereo from the
    anchor on this rank's frames of `batch` (sound, then with each of
    TRAIN_FAULTS), with the bytes received over seq in its forward and its
    backward; the train CLI with --seq_parallel 2 for one step (`cli_args`
    plus a checkpoint directory). Rank 1 then takes the port's one-process
    step on the whole batch (the reference)."""
    from ppmstereo_tpu_torch.cli import train as cli
    from ppmstereo_tpu_torch.parallel import collectives, sharding
    from tests.torch_data_workers import mesh_step, ppm_model, tensorboard_without_tensorflow

    mesh = _mesh((1, world, 1))
    out = {"units": collective_grads(mesh.groups["seq"])}
    sharding.RECEIVED.update(dict.fromkeys(sharding.RECEIVED, 0))
    out["sound"] = mesh_step(ppm_model(anchor_path, mesh), True, batch, mesh)
    out["received"] = dict(sharding.RECEIVED)
    for name, fault in TRAIN_FAULTS.items():
        undo = fault(collectives)
        try:
            out[name] = mesh_step(ppm_model(anchor_path, mesh), True, batch, mesh)
        finally:
            undo()
    tensorboard_without_tensorflow()
    saves = []
    save = torch.save
    torch.save = lambda obj, f, *a, **k: saves.append(str(f)) or save(obj, f, *a, **k)
    sharding.RECEIVED.update(dict.fromkeys(sharding.RECEIVED, 0))
    try:
        state = cli.main(cli_args)
    finally:
        torch.save = save
    out["cli"] = dict(step=state.step, count=state.optimizer.count, saves=saves,
                      received=dict(sharding.RECEIVED),
                      params={k: v.numpy() for k, v in state.model.state_dict().items()})
    del state
    if rank == 1:
        out["one"] = mesh_step(ppm_model(anchor_path, None), True, batch, None)
    return out


def data_seq_train(rank, world, anchor_path, batch):
    """Over a group of 4: one train step of the tiny PPMStereo at data x seq
    = 2 x 2 on this rank's clip's frames of `batch`; the collectives'
    backward over a seq axis of 4 (two middle ranks). Rank 3 then takes
    the port's one-process step on the whole batch (the reference)."""
    from tests.torch_data_workers import mesh_step, ppm_model

    mesh = _mesh((2, 2, 1))
    out = {"step": mesh_step(ppm_model(anchor_path, mesh), True, batch, mesh)}
    out["units"] = collective_grads(_mesh((1, world, 1)).groups["seq"])
    if rank == 3:
        out["one"] = mesh_step(ppm_model(anchor_path, None), True, batch, None)
    return out
