"""The port's checkpoint import against the JAX package's: the mapping
tables key for key, `load_state_dict`, the CLI's npz against the JAX CLI's
on the same synthetic state dict, its exit codes, and the imported npz
through the port's `model_zoo` against the JAX model.

The synthetic state dicts are the tables inverted over the JAX models'
parameter shapes (`jax.eval_shape` of their init at the JAX CLI's shape),
with seeded values in the reference's torch layouts.

The JAX CLI (`ppmstereo_tpu.cli.import_torch.main`) cannot run
DynamicStereoModel or BiDAStereoModel as it stands: it passes
`force_xla_attention=True` to configs that have no such field (a
TypeError), and it looks for BiDAStereo's RAFT under "raft.fnet.conv1.weight"
where its table names "raft.model.*". Nothing in the JAX package changes, so
the comparison runs the JAX CLI with both configs taking and dropping that
keyword and with the RAFT table always included (`_jax_cli_shims`); the
port's CLI has neither fault.

For PPMStereoVDAModel and StereoAnyVideoModel the JAX CLI has two more
faults, which `_jax_cli_shims` works around too and the port's CLI repairs
(tests/test_torch_import_vda.py compares the two families' npz and shows the
first fault; `test_jax_cli_drops_stereoanyvideo_backbone` the second): it
converts the
DPT head's two transposed convolutions (`head.resize_layers.0/1`, torch
ConvTranspose2d (I, O, kh, kw)) with `grn_transform`, that is as Conv2d
weights, I and O swapped and not flipped in space, where its own
`vda_transform` is right; and it imports StereoAnyVideo's backbone only
when a key starts with "backbone.", where StereoAnyVideo's table names it
"depthnet.depthanything.*".

Where the JAX CLI must exit 0, its template init (`jax.jit(model.init)` at
its shape, 30-200 s of compilation here) runs as `jax.eval_shape` with
zeros (`_jax_cli_init_shapes`): the synthetic state dict then maps onto
every parameter of the model (`_synthetic_state_dict` asserts that the
table names every one, and exit 0 means none is missing), so each is
overwritten and no init value reaches the npz. Where the JAX CLI leaves
tensors at its init (`test_jax_cli_drops_stereoanyvideo_backbone`), it
runs its real init.
"""

import contextlib

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppmstereo_tpu.cli import import_torch as jcli
from ppmstereo_tpu.models import bidastereo as jbida
from ppmstereo_tpu.models import dynamic_stereo as jds
from ppmstereo_tpu.models.ppm_stereo import PPMStereo as JPPMStereo
from ppmstereo_tpu.models.ppm_stereo import PPMStereoConfig as JPPMConfig
from ppmstereo_tpu.models import stereoanyvideo as jsav
from ppmstereo_tpu.utils import ppm_mapping as jppm
from ppmstereo_tpu.utils import torch_import as jti
from ppmstereo_tpu.utils import vda_mapping as jvda
from ppmstereo_tpu.utils import zoo_mappings as jzoo
from ppmstereo_tpu_torch.cli import import_torch as tcli
from ppmstereo_tpu_torch.models import dynamic_stereo as tds
from ppmstereo_tpu_torch.models.zoo import model_zoo as tmodel_zoo
from ppmstereo_tpu_torch.utils import ppm_mapping as tppm
from ppmstereo_tpu_torch.utils import torch_import as tti
from ppmstereo_tpu_torch.utils import vda_mapping as tvda
from ppmstereo_tpu_torch.utils import zoo_mappings as tzoo
from ppmstereo_tpu_torch.utils.weights import load_npz
from tests.torch_zoo_parity import DISP_TOL, max_diff, stereo_clip

torch.set_num_threads(1)
AT = "self_stereo_temporal_update_time_update_space"
TABLES = [  # (the module: ppm_mapping or zoo_mappings, the table, its arguments)
    ("ppm", "ppmstereo_mapping", {}), ("ppm", "ppmstereo_mapping", {"attention_type": AT}),
    ("ppm", "ppmstereo_mapping", {"attention_type": AT, "use_cnet": True}),
    ("ppm", "basic_encoder_mapping", {"t": "fnet", "f": "fnet"}),
    ("ppm", "sst_mapping", {"f": "sst", "attention_type": AT, "depth": 2}),
    ("ppm", "contextnet_mapping", {}),
    ("ppm", "sequence_update_block3d_mapping", {"t": "u", "f": "u", "attention_type": AT}),
    ("zoo", "dynamicstereo_mapping", {}), ("zoo", "dynamicstereo_mapping",
                                           {"attention_type": None}),
    ("zoo", "bidastereo_mapping", {}), ("zoo", "bidastereo_mapping", {"include_raft": False}),
    ("zoo", "raft_mapping", {}), ("zoo", "raft_mapping", {"t": "raft.model", "f": "raft/raft"}),
    ("zoo", "raftstereo_mapping", {}), ("zoo", "raftstereo_mapping", {"t": "m", "f": "m"}),
    ("zoo", "sep_gru3d_mapping", {"t": "g", "f": "g"}),
    ("zoo", "sep_gru2d_mapping", {"t": "g", "f": "g"}),
    ("zoo", "ds_update_block_mapping", {"t": "u", "f": "u", "attention_type": AT}),
    ("zoo", "rs_multi_encoder_mapping", {"t": "c", "f": "c", "norm": "instance"}),
    ("zoo", "sav_update_block_mapping", {"t": "u", "f": "u"}),
    ("zoo", "stereoanyvideo_mapping", {}), ("zoo", "stereoanyvideo_mapping",
                                            {"include_vda": False}),
    ("zoo", "multilevel_vfm_mapping", {"t": "fnet", "f": "fnet"}),
    ("zoo", "ppmstereo_vda_mapping", {}), ("zoo", "ppmstereo_vda_mapping",
                                           {"attention_type": AT}),
    ("vda", "vda_mapping", {}), ("vda", "vda_mapping", {"t": "b", "f": "b", "encoder": "vitl"}),
    ("vda", "dinov2_mapping", {"t": "p", "f": "p"}),
    ("vda", "temporal_module_mapping", {"t": "m", "f": "m"}),
    ("vda", "dpt_head_mapping", {"t": "head", "f": "head"}),
]
# the JAX CLI's template shape and its models (iters 2, test mode, f32)
CLI_MODELS = {
    "DynamicStereoModel": (lambda: jds.DynamicStereo(cfg=jds.DynamicStereoConfig(
        mixed_precision=False), iters=2, test_mode=True), []),
    "BiDAStereoModel": (lambda: jbida.BiDAStereo(cfg=jbida.BiDAStereoConfig(
        mixed_precision=False), iters=2, test_mode=True), []),
    "PPMStereoModel": (lambda: JPPMStereo(cfg=JPPMConfig(
        mixed_precision=False, use_cnet=False, attention_type="", force_xla_attention=True),
        iters=2, test_mode=True), ["--no_cnet", "--attention_type", ""]),
    "PPMStereoVDAModel": (lambda: JPPMStereo(cfg=JPPMConfig(
        mixed_precision=False, use_cnet=True, use_vfm=True, attention_type=AT,
        force_xla_attention=True), iters=2, test_mode=True), []),
    "StereoAnyVideoModel": (lambda: jsav.StereoAnyVideo(cfg=jsav.StereoAnyVideoConfig(
        mixed_precision=False), iters=2, test_mode=True), []),
}
RESIZE_KEYS = ("head.resize_layers.0.weight", "head.resize_layers.1.weight")
_TORCH_PERM = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


@pytest.mark.parametrize("module,name,kwargs", TABLES,
                         ids=[f"{n}-{i}" for i, (_, n, _) in enumerate(TABLES)])
def test_tables_equal_jax(module, name, kwargs):
    port, ref = {"ppm": (tppm, jppm), "zoo": (tzoo, jzoo), "vda": (tvda, jvda)}[module]
    table = getattr(port, name)(**kwargs)
    assert table and table == getattr(ref, name)(**kwargs)


def test_dead_keys_and_transform_equal_jax():
    assert tzoo.ZOO_DEAD_KEY_TAGS == jzoo.ZOO_DEAD_KEY_TAGS
    assert tppm.DEAD_REFERENCE_KEYS == jppm.DEAD_REFERENCE_KEYS
    mapping = tzoo.raft_mapping()
    for key in ("a.temporal_attn.qkv.weight", "cnet.norm1.num_batches_tracked", "fnet.conv1.weight",
                "x.encoder.init_conv.0.weight", "cnet.convnext.head.bias"):
        assert tzoo.is_zoo_dead_key(key, mapping) == jzoo.is_zoo_dead_key(key, mapping)
        assert tppm.is_dead_reference_key(key, {}) == jppm.is_dead_reference_key(key, {})
    rng = np.random.default_rng(0)
    assert tvda.VDA_DEAD_KEY_TAGS == jvda.VDA_DEAD_KEY_TAGS
    vda = tvda.vda_mapping("backbone", "backbone")
    for key in ("backbone.pretrained.mask_token", "backbone.head.scratch.output_conv2.0.weight",
                "backbone.pretrained.norm.weight", "x.pos_encoder.pe"):
        assert tvda.is_vda_dead_key(key, vda) == jvda.is_vda_dead_key(key, vda)
    rng = np.random.default_rng(1)
    for key in ("b.head.resize_layers.0.weight", "b.head.resize_layers.1.weight",
                "b.head.projects.0.weight", "b.pretrained.blocks.0.attn.qkv.weight"):
        w = rng.normal(size=(6, 6) if "qkv" in key else (6, 5, 3, 2)).astype(np.float32)
        np.testing.assert_array_equal(tvda.vda_transform(key, w), jvda.vda_transform(key, w))
    for key, shape in (("cnet.convnext.stages.0.0.grn.gamma", (1, 1, 1, 96)),
                       ("fnet.conv1.weight", (64, 3, 7, 7)), ("g.convz1.weight", (8, 4, 1, 1, 5)),
                       ("m.q_proj.weight", (6, 4)), ("sst.time_embed", (1, 5, 8)),
                       ("x.bias", (8,))):
        w = rng.normal(size=shape).astype(np.float32)
        np.testing.assert_array_equal(tppm.grn_transform(key, w), jppm.grn_transform(key, w))


def test_load_state_dict_unwraps_like_jax(tmp_path):
    sd = {"fnet.conv1.weight": torch.arange(6.0).reshape(2, 3), "x.bias": torch.ones(2)}
    cases = {"plain.pth": sd, "model.pth": {"model": sd},
             "state.pth": {"state_dict": {f"module.{k}": v for k, v in sd.items()}, "epoch": 3},
             "both.pth": {"model": {"state_dict": sd}}}
    for name, obj in cases.items():
        torch.save(obj, tmp_path / name)
    np.savez(tmp_path / "arrays.npz", **{f"module.{k}": v.numpy() for k, v in sd.items()})
    for name in [*cases, "arrays.npz"]:
        got = tti.load_state_dict(str(tmp_path / name))
        want = jti.load_state_dict(str(tmp_path / name))
        assert sorted(got) == sorted(want) == sorted(sd)
        for k in sd:
            np.testing.assert_array_equal(got[k], want[k])


class _NotATensor:
    """A pickled object a weights-only load must refuse."""


def test_load_state_dict_refuses_pickled_objects(tmp_path):
    path = tmp_path / "ckpt.pth"
    torch.save({"model": {"a.weight": torch.zeros(2)}, "extra": _NotATensor()}, path)
    with pytest.raises(ValueError, match="weights_only"):
        tti.load_state_dict(str(path))
    assert "a.weight" in jti.load_state_dict(str(path))  # the JAX package unpickles it


def _draw(fkey: str, shape: tuple, rng) -> np.ndarray:
    """A value of the scale the JAX initialisers give the leaf: kernels
    U(+-1/sqrt(fan_in)), norm scales near 1, variances positive."""
    leaf = fkey.rsplit("/", 1)[-1]
    if leaf == "kernel":
        bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
        return rng.uniform(-bound, bound, shape)
    if leaf == "scale":
        return 1.0 + 0.1 * rng.normal(size=shape)
    if leaf == "var":
        return 0.5 + rng.random(shape)
    return 0.1 * rng.normal(size=shape)


@functools.lru_cache(maxsize=None)
def _synthetic_state_dict(model_name: str, seed: int = 0) -> dict[str, np.ndarray]:
    """The table inverted over the JAX model's parameter shapes: every mapped
    reference key with seeded values in the torch layout (the transposed
    convolutions in ConvTranspose2d's, the inverse of `deconv2d_w`). Cached:
    callers copy before they change it."""
    make, _ = CLI_MODELS[model_name]
    shape = (1, 4, 64, 96, 3)
    zeros = jnp.zeros(shape, jnp.float32)
    shapes = jax.eval_shape(make().init, jax.random.PRNGKey(0), zeros, zeros)
    flat = {"/".join(k): v.shape for k, v in jti.flatten_params(shapes["params"]).items()}
    if model_name == "PPMStereoModel":
        mapping = jppm.ppmstereo_mapping(attention_type="", use_cnet=False)
    elif model_name == "DynamicStereoModel":
        mapping = jzoo.dynamicstereo_mapping()
    elif model_name == "PPMStereoVDAModel":
        mapping = jzoo.ppmstereo_vda_mapping(attention_type=AT)
    elif model_name == "StereoAnyVideoModel":
        mapping = jzoo.stereoanyvideo_mapping(include_vda=True)
    else:
        mapping = jzoo.bidastereo_mapping(include_raft=True)
    assert set(mapping.values()) == set(flat)  # the table names every parameter
    rng = np.random.default_rng(seed)
    sd = {}
    for tkey, fkey in mapping.items():
        w = _draw(fkey, flat[fkey], rng).astype(np.float32)
        if ".grn." in tkey:
            w = w.reshape(1, 1, 1, -1)
        elif tkey.endswith(RESIZE_KEYS):
            w = np.ascontiguousarray(w[::-1, ::-1].transpose(2, 3, 0, 1))
        elif w.ndim in _TORCH_PERM:
            w = np.ascontiguousarray(w.transpose(_TORCH_PERM[w.ndim]))
        sd[tkey] = w
    return sd


def _save_pth(sd: dict, path) -> str:
    torch.save({"model": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}}, path)
    return str(path)


def _jax_cli_shims(monkeypatch, transposed_convs: bool = True, sav_backbone: bool = True):
    """See the module docstring: the JAX CLI's faults worked around in this
    process only; `transposed_convs` and `sav_backbone` switch the VDA
    families' two."""
    for mod, cfg in ((jds, "DynamicStereoConfig"), (jbida, "BiDAStereoConfig")):
        real = getattr(mod, cfg)
        monkeypatch.setattr(mod, cfg, lambda *a, _real=real, force_xla_attention=None, **k:
                            _real(*a, **k))
    table = jzoo.bidastereo_mapping
    monkeypatch.setattr(jzoo, "bidastereo_mapping", lambda include_raft=True: table(True))
    if transposed_convs:
        grn = jppm.grn_transform
        monkeypatch.setattr(jppm, "grn_transform", lambda name, w: jvda.vda_transform(name, w)
                            if name.endswith(RESIZE_KEYS) else grn(name, w))
    if sav_backbone:
        sav = jzoo.stereoanyvideo_mapping
        monkeypatch.setattr(jzoo, "stereoanyvideo_mapping", lambda include_vda=True: sav(True))


@pytest.fixture(scope="module")
def ds_ckpt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ds")
    sd = _synthetic_state_dict("DynamicStereoModel")
    return sd, _save_pth(sd, tmp / "ds.pth")


@pytest.mark.parametrize("model_name", ["DynamicStereoModel", "BiDAStereoModel",
                                        "PPMStereoModel"])
def test_cli_writes_the_jax_clis_npz(model_name, tmp_path, monkeypatch, ds_ckpt):
    sd = ds_ckpt[0] if model_name == "DynamicStereoModel" else _synthetic_state_dict(model_name)
    cli_parity(model_name, sd, tmp_path, monkeypatch)


@contextlib.contextmanager
def _jax_cli_init_shapes():
    """`jax.jit(fn)(*args)` as zeros of `jax.eval_shape(fn, *args)` while
    the JAX CLI runs (see the module docstring)."""
    real = jax.jit

    def shapes_only(fn, *jit_args, **jit_kwargs):
        return lambda *args: jax.tree_util.tree_map(
            lambda x: np.zeros(x.shape, x.dtype), jax.eval_shape(fn, *args))

    jax.jit = shapes_only
    try:
        yield
    finally:
        jax.jit = real


def cli_parity(model_name: str, sd: dict, tmp_path, monkeypatch) -> None:
    """The port CLI's npz of `sd` equals the JAX CLI's (shimmed) array for
    array; the fault: a tensor left in the torch layout is refused."""
    ckpt = _save_pth(sd, tmp_path / "ckpt.pth")
    flags = CLI_MODELS[model_name][1]
    assert tcli.main([ckpt, str(tmp_path / "port.npz"), "--model", model_name, *flags]) == 0
    _jax_cli_shims(monkeypatch)
    with _jax_cli_init_shapes():
        rc = jcli.main([ckpt, str(tmp_path / "jax.npz"), "--model", model_name, *flags])
    assert rc == 0
    got, want = load_npz(tmp_path / "port.npz"), load_npz(tmp_path / "jax.npz")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float16
        np.testing.assert_array_equal(got[k], want[k])
    monkeypatch.setattr(tppm, "convert_tensor", lambda name, w: w)
    with pytest.raises(ValueError, match="shape mismatch"):
        tcli.main([ckpt, str(tmp_path / "port.npz"), "--model", model_name, *flags])


def test_cli_exit_codes(tmp_path, ds_ckpt):
    sd, ckpt = ds_ckpt
    out = str(tmp_path / "o.npz")
    assert tcli.main([ckpt, out, "--model", "DynamicStereoModel"]) == 0
    missing = dict(sd)
    del missing["update_block04.gru.convq3.weight"]
    path = _save_pth(missing, tmp_path / "missing.pth")
    assert tcli.main([path, out, "--model", "DynamicStereoModel"]) == 1
    assert tcli.main([path, out, "--model", "DynamicStereoModel", "--allow_partial"]) == 0
    extra = dict(sd, **{"fnet.layer9.conv1.weight": np.zeros((2, 2, 3, 3), np.float32),
                        "cnet.norm1.num_batches_tracked": np.zeros((), np.float32)})
    path = _save_pth(extra, tmp_path / "extra.pth")
    assert tcli.main([path, out, "--model", "DynamicStereoModel"]) == 1  # one unmapped


def test_imported_npz_through_the_zoo_matches_jax(tmp_path, ds_ckpt, monkeypatch):
    """The port CLI's npz of the synthetic DynamicStereo checkpoint through
    the port's `model_zoo` and through the JAX model with the same npz, on a
    3-frame 64x128 clip (one window), in f32."""
    _, ckpt = ds_ckpt
    out = tmp_path / "ds.npz"
    assert tcli.main([ckpt, str(out), "--model", "DynamicStereoModel"]) == 0
    flat = {k: v.astype(np.float32) for k, v in load_npz(out).items()}
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    left, right, video = stereo_clip(3, 64, 128, seed=7)
    jm = jds.DynamicStereo(cfg=jds.DynamicStereoConfig(mixed_precision=False), iters=2,
                           test_mode=True)
    want = np.abs(np.asarray(jax.jit(jm.apply)({"params": tree}, jnp.asarray(left),
                                                jnp.asarray(right))))[0]
    pred = tmodel_zoo("DynamicStereoModel", kernel_size=4, iters=2, device="cpu",
                      mixed_precision=False, params=flat)
    got = pred({"stereo_video": video})["disparity"]
    assert got.shape == want.shape == (3, 64, 128, 1)
    assert max_diff(got, want) <= DISP_TOL
    interp = tds.interp_bilinear  # the fault: the reference's stage-sign quirk dropped
    monkeypatch.setattr(tds, "interp_bilinear",
                        lambda x, hw: -interp(x, hw) if x.shape[-1] == 2 else interp(x, hw))
    assert max_diff(pred({"stereo_video": video})["disparity"], want) > DISP_TOL


def port_and_jax_npz(model_name: str, tmp_path, monkeypatch, init_shapes: bool = False,
                     **shims):
    """The port CLI's and the JAX CLI's (with `shims`; with `init_shapes`
    its init as `_jax_cli_init_shapes`) npz of the synthetic checkpoint, and
    their exit codes."""
    sd = _synthetic_state_dict(model_name)
    ckpt = _save_pth(sd, tmp_path / "ckpt.pth")
    port_rc = tcli.main([ckpt, str(tmp_path / "port.npz"), "--model", model_name])
    _jax_cli_shims(monkeypatch, **shims)
    with _jax_cli_init_shapes() if init_shapes else contextlib.nullcontext():
        jax_rc = jcli.main([ckpt, str(tmp_path / "jax.npz"), "--model", model_name])
    return sd, load_npz(tmp_path / "port.npz"), load_npz(tmp_path / "jax.npz"), port_rc, jax_rc


def test_jax_cli_drops_stereoanyvideo_backbone(tmp_path, monkeypatch):
    """The unshimmed JAX CLI on a StereoAnyVideo checkpoint leaves out its
    `depthnet.depthanything.*` tensors (exit code 1: they are live and
    unmapped) and keeps its own initialisation there; the port's CLI imports
    them (exit 0), and a backbone tensor no model reads (`mask_token`) is
    not counted as unmapped."""
    sd, got, want, port_rc, jax_rc = port_and_jax_npz(
        "StereoAnyVideoModel", tmp_path, monkeypatch, transposed_convs=False,
        sav_backbone=False)
    assert (port_rc, jax_rc) == (0, 1)
    backbone = [k for k in want if k.startswith("depthnet/depthanything/")]
    assert len(backbone) > 200
    for k in want:
        if k not in backbone:
            np.testing.assert_array_equal(got[k], want[k])
    key = "depthnet/depthanything/pretrained/pos_embed"
    np.testing.assert_array_equal(got[key], sd["depthnet.depthanything.pretrained.pos_embed"]
                                  .astype(np.float16))
    assert not np.array_equal(got[key], want[key])
    extra = dict(sd, **{"depthnet.depthanything.pretrained.mask_token":
                        np.zeros((1, 384), np.float32)})
    path = _save_pth(extra, tmp_path / "extra.pth")
    assert tcli.main([path, str(tmp_path / "o.npz"), "--model", "StereoAnyVideoModel"]) == 0
