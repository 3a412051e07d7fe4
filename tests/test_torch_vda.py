"""The port's Video-Depth-Anything backbone (nn/vda) against the JAX
package's: the position-embedding interpolation, DINOv2's intermediate
layers, the motion module, the DPT-temporal head with and without its
fusion paths, `depth_features` and `fusion_features`, `DepthExtractor`,
the ConvTranspose carry, and the ViT-L build's parameter shapes, in f32.

Weights: the JAX modules' `jax.jit(init)` parameters carried across with
`utils/weights.py`, with every motion module's zero-initialised `proj_out`
drawn (`draw_proj_out`): at zero the motion modules would not reach the
output. Inputs: seeded numpy arrays; DINOv2 runs at 56x84, a 4x6 patch grid,
so the position embedding is interpolated from the 37x37 grid.

Tolerance: 1e-5 relative to each output's largest magnitude (BLOCK_REL);
measured on the CPU at most 2.3e-6 (DepthExtractor), the faults 9.0e-2 and
more. Each test has a fault reading above its limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from ppmstereo_tpu.nn.vda import dinov2 as jdino
from ppmstereo_tpu.nn.vda import dpt as jdpt
from ppmstereo_tpu.nn.vda import motion as jmotion
from ppmstereo_tpu.nn.vda import video_depth as jvd
from ppmstereo_tpu_torch.nn.vda import dinov2 as tdino
from ppmstereo_tpu_torch.nn.vda import dpt as tdpt
from ppmstereo_tpu_torch.nn.vda import motion as tmotion
from ppmstereo_tpu_torch.nn.vda import video_depth as tvd
from ppmstereo_tpu_torch.ops.geometry import interp_bilinear
from ppmstereo_tpu_torch.utils import weights as tweights
from tests.torch_zoo_parity import carried, jax_apply, jax_init, max_diff, port_apply

torch.set_num_threads(1)
BLOCK_REL = 1e-5
B, T, H, W = 1, 2, 56, 84  # a (4, 6) patch grid


def draw_proj_out(tree: dict, seed: int = 0, std: float = 0.1) -> dict:
    """Draw every motion module's `proj_out` leaves (zero at init) in place."""
    rng = np.random.default_rng(seed)

    def visit(node):
        for key, val in node.items():
            if key == "proj_out":
                for leaf in val:
                    val[leaf] = rng.normal(0, std, val[leaf].shape).astype(np.float32)
            elif isinstance(val, dict):
                visit(val)

    visit(tree)
    return tree


def rel_diff(got, want) -> float:
    return max_diff(got, want) / float(np.abs(np.asarray(want, np.float64)).max())


def test_interpolate_pos_embed_matches_jax_and_torch():
    """Against the JAX function and torch's own bicubic F.interpolate with
    the same scale factors; the fault: DINOv2's 0.1 offset dropped."""
    rng = np.random.default_rng(0)
    pe = rng.normal(size=(1, 37, 37, 16)).astype(np.float32)
    for ph, pw in ((4, 6), (23, 17), (37, 11)):
        want = np.asarray(jdino.interpolate_pos_embed(jnp.asarray(pe), ph, pw, 37))
        got = tdino.interpolate_pos_embed(torch.from_numpy(pe), ph, pw, 37).numpy()
        ref = F.interpolate(torch.from_numpy(pe).permute(0, 3, 1, 2),
                            scale_factor=((ph + 0.1) / 37, (pw + 0.1) / 37), mode="bicubic",
                            antialias=False).permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape == ref.shape == (1, ph, pw, 16)
        assert max_diff(got, want) <= 1e-5 and max_diff(got, ref) <= 1e-4
        no_offset = tdino.interpolate_pos_embed(torch.from_numpy(pe), ph, pw, 37, offset=0.0)
        if ph != 37 or pw != 37:
            assert max_diff(no_offset.numpy(), want) > 1e-4


@pytest.fixture(scope="module")
def dino():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    jm = jdino.DINOv2("vits")
    tree = jax_init(jm, x)
    return tree, x


def test_dinov2_intermediate_layers(dino, monkeypatch):
    """The four requested layers' patch and class tokens, each after the
    final norm; the fault: the final norm skipped."""
    tree, x = dino
    idx = jdino.intermediate_layer_idx("vits")
    want = jax_apply(jdino.DINOv2("vits"), tree, x)  # its default layers are ViT-S's
    model = carried(tdino.DINOv2("vits"), tree)
    with torch.no_grad():
        got = [tuple(t.numpy() for t in pair)
               for pair in model.get_intermediate_layers(torch.from_numpy(x), idx)]
    assert len(got) == len(want) == 4
    for (gp, gc), (wp, wc) in zip(got, want):
        assert gp.shape == wp.shape == (2, 24, 384) and gc.shape == wc.shape == (2, 384)
        assert rel_diff(gp, wp) <= BLOCK_REL and rel_diff(gc, wc) <= BLOCK_REL
    assert tdino.intermediate_layer_idx("vitl") == jdino.intermediate_layer_idx("vitl")
    assert all(tdino.embed_dim(n) == jdino.embed_dim(n) for n in ("vits", "vitb", "vitl"))
    assert tdino._CONFIGS == jdino._CONFIGS
    monkeypatch.setattr(model, "norm", torch.nn.Identity())
    with torch.no_grad():
        wrong = model.get_intermediate_layers(torch.from_numpy(x), idx)[0][0].numpy()
    assert rel_diff(wrong, want[0][0]) > BLOCK_REL


def test_temporal_module(monkeypatch):
    """(B, T, H, W, C) through the motion module; the fault: the frames'
    position encoding dropped."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 4, 5, 64)).astype(np.float32)
    jm = jmotion.TemporalModule(64)
    tree = draw_proj_out(jax_init(jm, x), seed=2)
    want = jax_apply(jm, tree, x)
    model = carried(tmotion.TemporalModule(64), tree)
    got = port_apply(model, x)
    assert got.shape == want.shape
    assert rel_diff(got, want) <= BLOCK_REL
    assert max_diff(got, x) > 1e-2  # the module moves its input
    monkeypatch.setattr(tmotion, "_sinusoidal_pe", lambda n, d: np.zeros((n, d), np.float32))
    assert rel_diff(port_apply(model, x), want) > BLOCK_REL


@pytest.fixture(scope="module")
def head():
    """The DPT head's JAX parameters (proj_out drawn) and 4 random
    (tokens, cls) layers of B*T = 2 frames on the 4x6 grid."""
    rng = np.random.default_rng(3)
    feats = [(rng.normal(size=(B * T, 24, 384)).astype(np.float32),
              rng.normal(size=(B * T, 384)).astype(np.float32)) for _ in range(4)]
    jm = jdpt.DPTHeadTemporal(in_channels=384)
    args = [tuple(jnp.asarray(a) for a in pair) for pair in feats]
    tree = jax.jit(lambda k, f: jm.init(k, f, 4, 6, T, return_paths=True))(
        jax.random.PRNGKey(0), args)
    tree = draw_proj_out(jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree), 3)
    return tree, feats


def _head_outputs(tree, feats, return_paths, model=None):
    jm = jdpt.DPTHeadTemporal(in_channels=384)
    args = [tuple(jnp.asarray(a) for a in pair) for pair in feats]
    want = jax.jit(lambda p, f: jm.apply(p, f, 4, 6, T, return_paths=return_paths))(tree, args)
    want = jax.tree_util.tree_map(np.asarray, want)
    model = model or carried(tdpt.DPTHeadTemporal(384), tree)
    with torch.no_grad():
        got = model([tuple(torch.from_numpy(a) for a in pair) for pair in feats], 4, 6, T,
                    return_paths=return_paths)
    return jax.tree_util.tree_map(lambda t: t.numpy(), got), want, model


@pytest.mark.parametrize("return_paths", [False, True])
def test_dpt_head(head, return_paths):
    tree, feats = head
    got, want, _ = _head_outputs(tree, feats, return_paths)
    if return_paths:
        (got, got_paths), (want, want_paths) = got, want
        shapes = [(2, 32, 48, 64), (2, 16, 24, 64), (2, 8, 12, 64), (2, 4, 6, 64)]
        assert [p.shape for p in got_paths] == [p.shape for p in want_paths] == shapes
        for g, w in zip(got_paths, want_paths):
            assert rel_diff(g, w) <= BLOCK_REL
    assert got.shape == want.shape == (2, 56, 84, 32)
    assert rel_diff(got, want) <= BLOCK_REL


@pytest.mark.parametrize("fault", ["unflipped", "in_out_swapped"])
def test_conv_transpose_carry(head, monkeypatch, fault):
    """The flax ConvTranspose kernels (resize_0 4x4/4 and resize_1 2x2/2,
    48 -> 48 and 96 -> 96 wide for ViT-S, so a wrong layout keeps its shape)
    carried as torch's ConvTranspose2d weights: a flax nn.ConvTranspose and
    the port's on the same input and kernel, then the head's finest path;
    the faults, the carry without the spatial flip or with I and O swapped,
    must move both."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 5, 8)).astype(np.float32)
    jm = fnn.ConvTranspose(8, (4, 4), strides=(4, 4), padding="VALID")
    tree = jax_init(jm, x)
    want = jax_apply(jm, tree, x)
    layer = tdpt.ConvTranspose(8, 8, (4, 4))
    tweights.load_flax_params(layer, tweights.flatten_params(tree))
    assert max_diff(port_apply(layer, x), want) <= 1e-5
    tree_head, feats = head
    _, want_head, _ = _head_outputs(tree_head, feats, True)
    wrong = {"unflipped": lambda k: k.transpose(2, 3, 0, 1),
             "in_out_swapped": lambda k: k[::-1, ::-1].transpose(3, 2, 0, 1)}[fault]
    monkeypatch.setattr(tweights, "transposed_to_torch", wrong)
    tweights.load_flax_params(layer, tweights.flatten_params(tree))
    assert max_diff(port_apply(layer, x), want) > 1e-2
    got_head, _, _ = _head_outputs(tree_head, feats, True,
                                   carried(tdpt.DPTHeadTemporal(384), tree_head))
    assert rel_diff(got_head[1][0], want_head[1][0]) > BLOCK_REL


@pytest.fixture(scope="module")
def vda():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, T, H, W, 3)).astype(np.float32)
    jm = jvd.VideoDepthAnything()
    tree = jax.jit(lambda k, a: jm.init(k, a, method=jm.fusion_features, t=T))(
        jax.random.PRNGKey(1), jnp.asarray(x))
    tree = draw_proj_out(jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree), 5)
    return tree, x


def test_depth_and_fusion_features(vda):
    tree, x = vda
    jm = jvd.VideoDepthAnything()
    want_depth = np.asarray(jax.jit(lambda p, a: jm.apply(p, a, T, method=jm.depth_features))(
        tree, jnp.asarray(x)))
    want_paths = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda p, a: jm.apply(p, a, T, method=jm.fusion_features))(tree, jnp.asarray(x)))
    model = carried(tvd.VideoDepthAnything(), tree)
    with torch.no_grad():
        got_depth = model.depth_features(torch.from_numpy(x)).numpy()
        got_paths = [p.numpy() for p in model.fusion_features(torch.from_numpy(x))]
    assert got_depth.shape == want_depth.shape == (B, T, H, W, 32)
    assert rel_diff(got_depth, want_depth) <= BLOCK_REL
    assert [p.shape for p in got_paths] == [p.shape for p in want_paths]
    assert [p.shape[2:4] for p in got_paths] == [(32, 48), (16, 24), (8, 12), (4, 6)]
    for g, w in zip(got_paths, want_paths):
        assert rel_diff(g, w) <= BLOCK_REL
    # the fault: the frames of the video reversed before the motion modules
    # see them (each frame alone would be unchanged)
    with torch.no_grad():
        flipped = model.depth_features(torch.from_numpy(x[:, ::-1].copy())).numpy()[:, ::-1]
    assert rel_diff(flipped, want_depth) > BLOCK_REL


def test_depth_extractor_and_normalize(monkeypatch):
    """DepthExtractor at 64x96 (resized to 56x84 for the backbone and back)
    on ImageNet-normalised frames; the fault: align_corners=True resizes."""
    rng = np.random.default_rng(6)
    raw = rng.uniform(0, 255, (B, T, 64, 96, 3)).astype(np.float32)
    norm = np.asarray(jvd.imagenet_normalize(jnp.asarray(raw)))
    got_norm = tvd.imagenet_normalize(torch.from_numpy(raw)).numpy()
    assert max_diff(got_norm, norm) <= 1e-5
    jm = jvd.DepthExtractor()
    tree = draw_proj_out(jax_init(jm, norm), seed=6)
    want = jax_apply(jm, tree, norm)
    model = carried(tvd.DepthExtractor(), tree)
    got = port_apply(model, norm)
    assert got.shape == want.shape == (B, T, 16, 24, 32)
    assert rel_diff(got, want) <= BLOCK_REL
    monkeypatch.setattr(tvd, "interp_ac_false", interp_bilinear)
    assert rel_diff(port_apply(model, norm), want) > BLOCK_REL


def test_vitl_parameter_shapes():
    """VideoDepthAnything("vitl") built (no forward): its parameters are the
    JAX tree's, name for name and shape for shape."""
    x = jnp.zeros((1, 2, 28, 28, 3), jnp.float32)
    jm = jvd.VideoDepthAnything(encoder="vitl")
    shapes = jax.eval_shape(lambda k: jm.init(k, x, method=jm.fusion_features, t=2),
                            jax.random.PRNGKey(0))
    want = {"/".join(path): tuple(leaf.shape) for path, leaf in
            _flat_paths(shapes["params"])}
    model = tvd.VideoDepthAnything("vitl")
    got = {k.removeprefix("params/"): v.shape for k, v in tweights.state_dict_to_flax(
        model.state_dict(), tweights.transposed_kernels(model)).items()}
    assert got == want
    assert sum(np.prod(s) for s in got.values()) > 3e8  # ViT-L: ~335M parameters


def _flat_paths(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat_paths(val, prefix + (key,))
        else:
            yield prefix + (key,), val
