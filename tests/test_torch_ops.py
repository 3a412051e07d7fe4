"""The port's ops (ppmstereo_tpu_torch/ops) against the JAX package's on the
same numpy inputs, plus the port's import boundary and device selection.

Tolerances: f32 at small shapes. Pure data movement (padding, pooling,
gathers, pixel shuffles) must agree to 1e-6; sums and products that the two
libraries may order differently get 1e-5 (a few f32 ulps at the magnitudes
of these inputs).
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppmstereo_tpu.ops import corr as jcorr
from ppmstereo_tpu.ops import geometry as jgeo
from ppmstereo_tpu.ops import padding as jpad
from ppmstereo_tpu.ops import upsample as jup
from ppmstereo_tpu_torch.ops import corr as tcorr
from ppmstereo_tpu_torch.ops import geometry as tgeo
from ppmstereo_tpu_torch.ops import padding as tpad
from ppmstereo_tpu_torch.ops import upsample as tup
from ppmstereo_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
EXACT = 1e-6
F32 = 1e-5


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_coords_grid_x():
    _close(tgeo.coords_grid_x(3, 4, 7), jgeo.coords_grid_x(3, 4, 7), EXACT)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("in_size,out_size", [(5, 11), (12, 6), (7, 7), (1, 4), (9, 1)])
def test_two_tap_resize_1d(rng, align_corners, in_size, out_size):
    x = _randn(rng, 2, in_size, 3, 4)
    got = tgeo.two_tap_resize_1d(torch.from_numpy(x), 1, out_size, align_corners)
    want = jgeo.two_tap_resize_1d(jnp.asarray(x), 1, out_size, align_corners)
    _close(got, want, F32)


@pytest.mark.parametrize("out_hw", [(14, 18), (3, 4), (7, 9)])
def test_interp_bilinear_and_ac_false(rng, out_hw):
    x = _randn(rng, 2, 3, 7, 9, 4)
    _close(tgeo.interp_bilinear(torch.from_numpy(x), out_hw),
           jgeo.interp_bilinear(jnp.asarray(x), out_hw), F32)
    _close(tgeo.interp_ac_false(torch.from_numpy(x), out_hw),
           jgeo.interp_ac_false(jnp.asarray(x), out_hw), F32)


def test_upsample2x_nearest(rng):
    x = _randn(rng, 2, 3, 5, 4)
    _close(tgeo.upsample2x_nearest(torch.from_numpy(x)),
           jgeo.upsample2x_nearest(jnp.asarray(x)), EXACT)


@pytest.mark.parametrize("window", [2, 4])
def test_avg_pool2d(rng, window):
    x = _randn(rng, 2, 3, 16, 13, 5)
    _close(tgeo.avg_pool2d(torch.from_numpy(x), window),
           jgeo.avg_pool2d(jnp.asarray(x), window, window), F32)


def test_avg_pool_w(rng):
    x = _randn(rng, 2, 3, 4, 9)
    _close(tgeo.avg_pool_w(torch.from_numpy(x)), jgeo.avg_pool_w(jnp.asarray(x), 2, 2), F32)


@pytest.mark.parametrize("shape,out_hw", [((2, 3, 8, 12, 4), (2, 3)),
                                          ((2, 3, 7, 10, 4), (3, 4)),
                                          ((1, 5, 4, 6, 2), (1, 1))])
def test_adaptive_max_pool2d(rng, shape, out_hw):
    x = _randn(rng, *shape)
    _close(tgeo.adaptive_max_pool2d(torch.from_numpy(x), out_hw),
           jgeo.adaptive_max_pool2d(jnp.asarray(x), out_hw), EXACT)


def test_cosine_similarity_matrix(rng):
    a, b = _randn(rng, 2, 5, 12), _randn(rng, 2, 5, 12)
    a[0, 1] = 0.0  # zero vector: exercises the eps clamp
    _close(tgeo.cosine_similarity_matrix(torch.from_numpy(a), torch.from_numpy(b)),
           jgeo.cosine_similarity_matrix(jnp.asarray(a), jnp.asarray(b)), F32)


@pytest.mark.parametrize("hw", [(37, 50), (64, 96), (33, 31), (1, 65), (31, 32)])
def test_input_padder(rng, hw):
    x = _randn(rng, 1, 2, *hw, 3)
    tp, jp = tpad.InputPadder(*hw), jpad.InputPadder(*hw)
    assert tp.padded_hw == jp.padded_hw
    (tx,), (jx,) = tp.pad(torch.from_numpy(x)), jp.pad(jnp.asarray(x))
    _close(tx, jx, EXACT)
    _close(tp.unpad(tx), x, EXACT)


def test_neighborhood_and_pixel_shuffle(rng):
    x = _randn(rng, 1, 3, 4, 5, 2)
    _close(tup._neighborhood_3d(torch.from_numpy(x)),
           jup._neighborhood_3d(jnp.asarray(x)), EXACT)
    up = _randn(rng, 1, 3, 4, 5, 16, 2)
    _close(tup._pixel_shuffle(torch.from_numpy(up), 4),
           jup._pixel_shuffle(jnp.asarray(up), 4), EXACT)


def test_convex_upsample_3d(rng):
    flow = _randn(rng, 1, 3, 4, 5, 2)
    mask = _randn(rng, 1, 3, 4, 5, 27 * 16)
    _close(tup.convex_upsample_3d(torch.from_numpy(flow), torch.from_numpy(mask), 4),
           jup.convex_upsample_3d(jnp.asarray(flow), jnp.asarray(mask), 4), F32)


def test_corr_volume_and_pyramid(rng):
    f1, f2 = _randn(rng, 2, 3, 16, 8), _randn(rng, 2, 3, 16, 8)
    tp = tcorr.build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    jp = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    assert len(tp) == len(jp) == 4
    for t_level, j_level in zip(tp, jp):
        _close(t_level, j_level, F32)


@pytest.mark.parametrize("radius", [1, 4])
def test_corr_lookup(rng, radius):
    f1, f2 = _randn(rng, 2, 3, 16, 8), _randn(rng, 2, 3, 16, 8)
    # coordinates inside, at and past both edges, with fractional parts
    coords = rng.uniform(-6.0, 22.0, (2, 3, 16)).astype(np.float32)
    coords[0, 0, :4] = [0.0, 15.0, -0.5, 15.5]
    tp = tcorr.build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    jp = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    got = tcorr.corr_lookup(tp, torch.from_numpy(coords), radius)
    want = jcorr.corr_lookup(jp, jnp.asarray(coords), radius, impl="gather")
    assert got.shape == want.shape == (2, 3, 16, 4 * (2 * radius + 1))
    _close(got, want, F32)


def _port_sources():
    return sorted((REPO / "ppmstereo_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 10
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "ppmstereo_tpu"), (
                    f"{path.relative_to(REPO)} imports {name}"
                )


def test_native_library_and_peaks_are_the_ports_own():
    """The port builds stereoio from its own `csrc/stereoio.cpp` and no
    string of its sources names the repo's `native/` directory or the JAX
    package's library; `utils/profiling.py` names no TPU peak."""
    import re

    from ppmstereo_tpu_torch.kernels import _build

    assert (_build.CSRC / "stereoio.cpp").is_file()
    assert '_build.build("stereoio")' in (REPO / "ppmstereo_tpu_torch/data/native.py").read_text()
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert not re.search(r"(^|/)native(/|$)|libstereoio\.so", node.value), (
                    f"{path.relative_to(REPO)} names {node.value!r}")
    profiling = (REPO / "ppmstereo_tpu_torch/utils/profiling.py").read_text()
    for tpu in ("V5E", "v5e", "TPU", "197e12", "819e9"):
        assert tpu not in profiling


def test_resolve_device_has_no_silent_cpu_fallback():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
