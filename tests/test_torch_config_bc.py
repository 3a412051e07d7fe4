"""Configurations B (`use_convex_3d=False, corr_levels=3, corr_radius=3,
sst_depth=2`) and C (`hidden_dim=64, dim=192`) in test mode through the
port's PPMStereo and the JAX package's, with the port's initialisation
carried across and its parameter set checked against the JAX model's
(tests/torch_config_parity.py::checked_port_params); 4 frames at 64 x 96,
in f32.

B takes the 2-D convex upsample (9 taps x 16), a 3-level radius-3 lookup
(21 correlation channels) and two SST rounds; C a 64-channel GRU state with
192-channel features. Limits: tests/test_torch_model.py's, 1e-4 px and
3e-6, with a fault reading that must break them: B with its lookup's
radius read as 2, C with its play step's softmax scale doubled.
"""

import numpy as np
import pytest
import torch

from ppmstereo_tpu_torch.kernels import play_attention as tpa
from ppmstereo_tpu_torch.models import ppm_stereo as tppm
from ppmstereo_tpu_torch.ops import corr as tcorr
from tests import torch_config_parity as cp

torch.set_num_threads(1)
T, H, W, ITERS = 4, 64, 96, 2


def _faulty_lookup(pyramid, coords_x, radius, out_dtype=torch.float32):
    """The lookup of radius - 1, zero-padded to the channels of radius."""
    taps = 2 * radius + 1
    inner = tcorr.corr_lookup(pyramid, coords_x, radius - 1)
    out = torch.zeros(*coords_x.shape, len(pyramid) * taps)
    for lvl in range(len(pyramid)):
        out[..., lvl * taps + 1: (lvl + 1) * taps - 1] = \
            inner[..., lvl * (taps - 2): (lvl + 1) * (taps - 2)]
    return out.to(out_dtype)


FAULTS = {
    "B": ("corr_lookup_kernel", _faulty_lookup),
    "C": ("play_attention", lambda q, k, v, scale: tpa.play_attention(q, k, v, 2 * scale)),
}


@pytest.mark.parametrize("name,kwargs", [("B", cp.CONFIG_B), ("C", cp.CONFIG_C)])
def test_config_matches_jax(name, kwargs, monkeypatch):
    left, right = cp.clip(T, H, W, seed=5)
    tree = cp.checked_port_params(kwargs, left, right, ITERS)
    jd, ju = cp.run_jax(kwargs, tree, left, right, ITERS, test_mode=True)
    model = cp.port_model(kwargs, tree, T, ITERS, test_mode=True)
    td, tu = cp.run_port(model, left, right)
    assert td.shape == jd.shape == (1, T, H, W, 1) and np.isfinite(td).all()
    np.testing.assert_allclose(td, jd, rtol=0, atol=cp.DISP_TOL)
    np.testing.assert_allclose(tu, ju, rtol=0, atol=cp.UNC_TOL)

    attr, fault = FAULTS[name]
    monkeypatch.setattr(tppm, attr, fault)
    fd, fu = cp.run_port(model, left, right)
    assert np.abs(fd - jd).max() > cp.DISP_TOL
    assert np.abs(fu - ju).max() > cp.UNC_TOL


def test_config_b_and_c_layers():
    """B's mask head is 2-D with 9 x 16 channels and its motion encoder reads
    3 x 7 correlation channels; C's GRU state is 64 wide."""
    b = tppm.PPMStereo(tppm.PPMStereoConfig(mixed_precision=False, **cp.CONFIG_B), iters=2)
    ub = b.update_block04.update_block
    assert tuple(ub.mask_conv2.Conv_0.weight.shape) == (9 * 16, 128 + 128, 1, 1)
    assert ub.encoder.convc1.ffn1_a.Conv_0.weight.shape[1] == 21
    assert not hasattr(b.sst, "time_attn_blocks_2") and hasattr(b.sst, "time_attn_blocks_1")
    c = tppm.PPMStereo(tppm.PPMStereoConfig(mixed_precision=False, **cp.CONFIG_C), iters=2)
    ub = c.update_block04.update_block
    assert tuple(ub.mask_conv2.Conv_0.weight.shape) == (27 * 16, 64 + 128, 1, 1, 1)
    assert ub.flow_head.Conv_0.Conv_0.weight.shape[1] == 64
