"""Process bodies for tests/test_torch_ring_attention.py, run by
`ppmstereo_tpu_torch.parallel.launch.run_group` in spawned processes. They
import torch and the port only, so a spawned process starts quickly."""

from __future__ import annotations

import numpy as np
import torch


def ring_block(rank, world, spec, q, k, v, scale):
    """The port's ring over this rank's space subgroup on its (seq, space)
    block of q (B, R, H, W, C) and k/v (B, R, K, H, W, C); returns the
    rank's coordinates and its output block."""
    from ppmstereo_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from ppmstereo_tpu_torch.parallel.ring_attention import ring_play_attention

    mesh = make_mesh(MeshSpec(*spec))
    r, h = q.shape[1], q.shape[2]
    n_seq, n_space = mesh.shape["seq"], mesh.shape["space"]
    s, p = mesh.coords["seq"], mesh.coords["space"]
    frames = slice(s * r // n_seq, (s + 1) * r // n_seq)
    rows = slice(p * h // n_space, (p + 1) * h // n_space)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    out = ring_play_attention(q[:, frames, rows], k[:, frames, :, rows],
                              v[:, frames, :, rows], scale, mesh.groups["space"])
    return (s, p), out.numpy()


def anchor_params_of(model, flat):
    """The anchor's flat parameters that `model` has (a model without the
    context net has no `cnet/...`)."""
    names = {"params/" + n.rsplit(".", 1)[0].replace(".", "/") for n in model.state_dict()}
    return {k: v for k, v in flat.items() if k.rsplit("/", 1)[0] in names}


def model_forward(rank, world, anchor_path, left, right, iters, cfg_kwargs=None):
    """The port's f32 test-mode PPMStereo (at PPMStereoConfig(**cfg_kwargs),
    with the anchor's parameters that it has) with the play steps ringed
    over a space mesh of all ranks; returns (disparity, uncertainty, ring
    messages this rank sent)."""
    from ppmstereo_tpu_torch.models.ppm_stereo import PPMStereo, PPMStereoConfig
    from ppmstereo_tpu_torch.parallel import ring_attention
    from ppmstereo_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from ppmstereo_tpu_torch.utils.weights import load_flax_params, load_npz

    cfg = PPMStereoConfig(mixed_precision=False, **(cfg_kwargs or {}))
    model = PPMStereo(cfg, iters=iters, test_mode=True, mesh=make_mesh(MeshSpec(space=world)))
    load_flax_params(model, anchor_params_of(model, load_npz(anchor_path)))
    with torch.no_grad():
        disp, unc = model(torch.from_numpy(left), torch.from_numpy(right))
    return disp.numpy(), unc.numpy(), ring_attention.shift.messages


def make_mesh_fails(rank, world, spec):
    """make_mesh(spec) in a group of the wrong size: the error's text."""
    from ppmstereo_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    try:
        make_mesh(MeshSpec(*spec))
    except ValueError as exc:
        return str(exc)
    return None


def mesh_coords(rank, world, spec):
    """This rank's coordinates and each axis group's ranks (global)."""
    import torch.distributed as dist

    from ppmstereo_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    mesh = make_mesh(MeshSpec(*spec))
    groups = {axis: None if g is None else dist.get_process_group_ranks(g)
              for axis, g in mesh.groups.items()}
    return mesh.coords, groups
