"""Kernel 6 on the baselines' paths: DynamicStereo's three stages (the
pyramid in the model's dtype) and RAFT-Stereo's folded window (an f32
pyramid of every frame pair, f32 features), one launch an iteration.

On the CPU: the arguments each window hands to the lookup are ones the
kernel takes (contiguous levels of one dtype, f32 contiguous coordinates,
radius 4, 4 levels, the levels' shapes), and the launches per window are
counted. The `cuda`-marked tests (they skip here) hold the kernel to its
plain version on a card, bit for bit, at RAFT-Stereo's 1/4 shapes and over
whole windows of both models. This file imports nothing of JAX, so the card's
machine collects it.
"""

import numpy as np
import pytest
import torch

from ppmstereo_tpu_torch.kernels import corr_lookup as kl
from ppmstereo_tpu_torch.models import dynamic_stereo, raft_stereo
from ppmstereo_tpu_torch.models.zoo import model_zoo
from ppmstereo_tpu_torch.ops.corr import build_corr_pyramid, corr_lookup

torch.set_num_threads(1)
LOOKUP_MODULES = {"DynamicStereoModel": dynamic_stereo, "RAFTStereoModel": raft_stereo}


def _clip(frames: int, h: int, w: int, seed: int):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, (frames, 2, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("name,iters,per_window", [
    ("DynamicStereoModel", 4, 2 + 2 + 4), ("RAFTStereoModel", 3, 3)])
def test_lookup_arguments_on_the_baselines_paths(name, iters, per_window, monkeypatch):
    """A 4-frame window at 64x128 (f32 on the CPU): every lookup gets
    arguments kernel 6 takes, DynamicStereo's at its three stages (B.T 4 at
    1/16, 1/8, 1/4), RAFT-Stereo's at 1/4 with the window's 4 frame pairs
    in the batch."""
    calls = []

    def recording(pyramid, coords_x, radius, out_dtype):
        calls.append((tuple(tuple(c.shape) for c in pyramid), tuple(coords_x.shape), radius,
                      out_dtype, [c.dtype for c in pyramid], coords_x.dtype,
                      all(c.is_contiguous() for c in pyramid) and coords_x.is_contiguous()))
        return kl.corr_lookup_kernel(pyramid, coords_x, radius, out_dtype=out_dtype)

    monkeypatch.setattr(LOOKUP_MODULES[name], "corr_lookup_kernel", recording)
    pred = model_zoo(name, kernel_size=10, iters=iters, device="cpu", mixed_precision=False)
    out = pred({"stereo_video": _clip(4, 64, 128, seed=0)})
    assert out["disparity"].shape == (4, 64, 128, 1)
    assert len(calls) == per_window
    grids = [(4, 4, 8), (4, 8, 16), (4, 16, 32)] if name == "DynamicStereoModel" else [
        (4, 16, 32)]
    for pyr, coords, radius, out_dtype, dtypes, cdtype, contiguous in calls:
        assert coords in grids and radius == 4 and contiguous
        assert cdtype == torch.float32 and dtypes == [torch.float32] * 4
        assert out_dtype == torch.float32
        n, h, w = coords
        assert pyr == tuple((n, h, w, w >> lvl) for lvl in range(4))


@pytest.mark.cuda
def test_kernel6_f32_at_raft_stereo_shapes_on_card():
    """Kernel 6's f32-in, f32-out instance on a RAFT-Stereo pyramid: 10
    folded frames of a 320x512 clip at 1/4 (80 x 128, W2 = 128 / 2^l),
    coordinates inside and outside the rows, bit-equal to the plain lookup."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    gen = torch.Generator(device="cuda").manual_seed(0)
    f1 = torch.randn(10, 80, 128, 256, generator=gen, device="cuda")
    f2 = torch.randn(10, 80, 128, 256, generator=gen, device="cuda")
    pyramid = build_corr_pyramid(f1, f2, 4)
    assert [p.dtype for p in pyramid] == [torch.float32] * 4
    coords = torch.arange(128, device="cuda", dtype=torch.float32) + (
        torch.rand(10, 80, 128, generator=gen, device="cuda") * 160 - 120)
    before = kl.corr_lookup_kernel.launches
    got = kl.corr_lookup_kernel(pyramid, coords, 4, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert kl.corr_lookup_kernel.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (10, 80, 128, 36)
    assert torch.equal(got, corr_lookup(pyramid, coords, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("name,iters,per_window", [
    ("DynamicStereoModel", 4, 2 + 2 + 4), ("RAFTStereoModel", 6, 6)])
def test_window_with_kernel6_equals_plain_lookup_on_card(name, iters, per_window,
                                                         monkeypatch):
    """One window of 5 frames at 128x256 through `model_zoo` in the shipped
    dtype (seeded weights): kernel 6 launched once a lookup, and the
    disparity bit-equal to the same window with the plain lookup."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    video = _clip(5, 128, 256, seed=5)
    pred = model_zoo(name, kernel_size=10, iters=iters, seed=3)
    kl.corr_lookup_kernel.launches = 0
    with_kernel = pred({"stereo_video": video})["disparity"]
    assert kl.corr_lookup_kernel.launches == per_window
    monkeypatch.setattr(LOOKUP_MODULES[name], "corr_lookup_kernel",
                        lambda pyr, x, radius, out_dtype: corr_lookup(pyr, x, radius).to(
                            out_dtype))
    plain = pred({"stereo_video": video})["disparity"]
    assert np.isfinite(with_kernel).all()
    np.testing.assert_array_equal(with_kernel, plain)
