"""Configuration A, the JAX package's multi-device configuration
(`use_cnet=False, attention_type=None, top_k=T`), through the port's
PPMStereo and the JAX package's, with the port's initialisation carried
across and its parameter set checked against the JAX model's
(tests/torch_config_parity.py::checked_port_params), in test mode and
train mode.

Without the context net the GRU state and context come from fnet's features
alone, and the input needs a height of a multiple of 16 only (the SST's
1/16 grid): 48 x 80 here. Without an attention type the SST adds its
position encoding only and no stage attends before its GRU. top_k = T picks
every frame. Limits: tests/test_torch_model.py's, 1e-4 px and 3e-6; a
wrong play step (its softmax scale doubled) must break them, and the top-k
picks must be identical.
"""

import jax
import numpy as np
import pytest
import torch

from ppmstereo_tpu_torch.kernels import play_attention as tpa
from ppmstereo_tpu_torch.models import ppm_stereo as tppm
from tests import torch_config_parity as cp

torch.set_num_threads(1)
T, H, W, ITERS = 4, 48, 80, 2
KWARGS = dict(cp.CONFIG_A, top_k=T)


@pytest.fixture(scope="module")
def setup():
    left, right = cp.clip(T, H, W, seed=3)
    return left, right, cp.checked_port_params(KWARGS, left, right, ITERS)


def test_config_a_has_no_context_net_and_no_attention(setup):
    _, _, tree = setup
    model = cp.port_model(KWARGS, tree, T, ITERS, test_mode=True)
    names = [n for n, _ in model.named_parameters()]
    assert not any(n.startswith(("cnet.", "sst.")) for n in names)
    assert not any("time_attn" in n or "space_attn" in n for n in names)
    assert set(tree["params"]) == {n.split(".")[0] for n in names}


def test_config_a_test_mode_matches_jax(setup, monkeypatch):
    left, right, tree = setup
    jax_picks = []
    top_k = jax.lax.top_k

    def recording_top_k(x, k):
        out = top_k(x, k)
        jax.debug.callback(lambda idx: jax_picks.append(np.asarray(idx)), out[1], ordered=True)
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
    jd, ju = cp.run_jax(KWARGS, tree, left, right, ITERS, test_mode=True)
    jax.effects_barrier()
    model = cp.port_model(KWARGS, tree, T, ITERS, test_mode=True)
    port_picks = []
    td, tu = cp.run_port(model, left, right, picks=port_picks)
    assert len(jax_picks) == len(port_picks) == 4  # 1 + 1 + 2 iterations
    for jp, tp in zip(jax_picks, port_picks):
        assert tp.shape[-1] == T
        np.testing.assert_array_equal(tp.numpy(), jp)
    assert td.shape == jd.shape == (1, T, H, W, 1) and np.isfinite(td).all()
    np.testing.assert_allclose(td, jd, rtol=0, atol=cp.DISP_TOL)
    np.testing.assert_allclose(tu, ju, rtol=0, atol=cp.UNC_TOL)

    # the limits catch a wrong play step
    monkeypatch.setattr(tppm, "play_attention",
                        lambda q, k, v, scale: tpa.play_attention(q, k, v, 2 * scale))
    fd, fu = cp.run_port(model, left, right)
    assert np.abs(fd - jd).max() > cp.DISP_TOL
    assert np.abs(fu - ju).max() > cp.UNC_TOL


def test_config_a_train_mode_matches_jax(setup):
    """Every iteration's full-resolution prediction and uncertainty (1 + 1 +
    2 of them), as the train step's loss reads them."""
    left, right, tree = setup
    jp, ju = cp.run_jax(KWARGS, tree, left, right, ITERS, test_mode=False)
    model = cp.port_model(KWARGS, tree, T, ITERS, test_mode=False)
    tp, tu = cp.run_port(model, left, right)
    assert tp.shape == jp.shape == (4, 1, T, H, W, 1)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=cp.DISP_TOL)
    np.testing.assert_allclose(tu, ju, rtol=0, atol=cp.UNC_TOL)
