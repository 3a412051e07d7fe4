"""The port's window modes against the JAX package's predictor: fast,
batched, warm, encoder-cached, warm with the cache, aligned, and without
the uncertainty output. tests/test_torch_forward_entries.py holds the
forward entries they run on.

Weights: the committed anchor, carried into the port. Inputs: the JAX
package's synthetic clips, made from a numpy seed. A 12-frame clip at 40 x 72
(padded to 64 x 96) with kernel 6 gives windows of 6, 6, 6 and a tail of 3.

Tolerance: as in tests/test_torch_model.py. Both packages run in f32 except
the play step's bf16 q/k/v; the port differs from the JAX package by about
1e-5 px of disparity and 4e-7 of uncertainty, a wrong play step by at least
6.9e-4 px; the limits are 1e-4 px and 3e-6. Warm windows are compared with
the JAX package's warm windows, not with strict ones: warm start is not
meant to reproduce the strict answer.

The JAX predictors of all modes share one set of jitted windows (a jit of a
new window shape takes tens of seconds on the CPU).
"""

import numpy as np
import pytest
import torch

from ppmstereo_tpu.models import inference as jinf
from ppmstereo_tpu.models.zoo import model_zoo as jmodel_zoo
from ppmstereo_tpu_torch.models import inference as tinf
from ppmstereo_tpu_torch.models import ppm_stereo as tppm
from ppmstereo_tpu_torch.models.zoo import available_models
from ppmstereo_tpu_torch.models.zoo import model_zoo as tmodel_zoo
from tests.torch_parity_data import load_anchor, synthetic_clip

torch.set_num_threads(1)
DISP_TOL = 1e-4
UNC_TOL = 3e-6
K, ITERS, WARM_ITERS = 6, 2, 1


@pytest.fixture(scope="module")
def anchor():
    return load_anchor()


@pytest.fixture(scope="module")
def video():
    return synthetic_clip(12, 40, 72, seed=1)[0]


# mode: (port model_zoo kwargs, JAX SlidingWindowPredictor kwargs, the JAX
# window functions it takes); align_windows and fetch_uncertainty are options
# of the predictor, not of the zoo
MODES = {
    "strict": ({}, {}, ()),
    "fast_mode": ({"fast_mode": True}, {"fast_mode": True}, ()),
    "batch_windows": ({"batch_windows": 2}, {"batch_windows": 2}, ()),
    "warm_start": ({"warm_start": True, "warm_iters": WARM_ITERS}, {}, ("warm",)),
    "encoder_cache": ({"encoder_cache": True}, {}, ("cache",)),
    "warm_cache": ({"warm_start": True, "warm_iters": WARM_ITERS, "encoder_cache": True}, {},
                   ("warm", "cache")),
    "align_windows": ({}, {"align_windows": True}, ()),
    "no_uncertainty": ({}, {"fetch_uncertainty": False}, ()),
}


@pytest.fixture(scope="module")
def jax_outputs(anchor, video):
    """The JAX predictor's output in each mode, computed on first use; the
    strict mode first, so its jitted windows (with both outputs) exist
    before the no-uncertainty mode reuses them."""
    _, tree = anchor
    full = jmodel_zoo("PPMStereoModel", kernel_size=K, iters=ITERS, params=tree,
                      mixed_precision=False, force_xla_attention=True, warm_start=True,
                      warm_iters=WARM_ITERS, encoder_cache=True).predictor
    jitted: dict = {}
    cache: dict = {}

    def run(mode):
        if mode not in cache:
            if mode != "strict":
                run("strict")
            _, options, fns = MODES[mode]
            kwargs = dict(options)
            if "warm" in fns:
                kwargs["warm_window_fn"] = full.warm_window_fn
            if "cache" in fns:
                kwargs.update(encode_window_fn=full.encode_window_fn,
                              body_window_fn=full.body_window_fn,
                              warm_body_window_fn=full.warm_body_window_fn)
            pred = jinf.SlidingWindowPredictor(full.window_fn, kernel_size=K, **kwargs)
            pred._jitted = jitted
            cache[mode] = pred(video)
        return cache[mode]

    return run


def _port_predictor(flat, mode):
    zoo_kwargs, options, _ = MODES[mode]
    pred = tmodel_zoo("PPMStereoModel", kernel_size=K, iters=ITERS, params=flat, device="cpu",
                      mixed_precision=False, **zoo_kwargs)
    if "align_windows" in options or "fetch_uncertainty" in options:
        pred.predictor = tinf.SlidingWindowPredictor(pred.model, kernel_size=K, device="cpu",
                                                     **options)
    return pred


@pytest.fixture(scope="module")
def port_outputs(anchor, video):
    """The port's output in each mode, computed on first use."""
    cache: dict = {}

    def run(mode):
        if mode not in cache:
            cache[mode] = _port_predictor(anchor[0], mode)({"stereo_video": video})
        return cache[mode]

    return run


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_matches_jax(jax_outputs, port_outputs, mode):
    want = jax_outputs(mode)
    got = port_outputs(mode)
    names = {"disparity"} if mode == "no_uncertainty" else {"disparity", "uncertainties"}
    assert set(got) == set(want) == names
    for name in names:
        assert got[name].shape == want[name].shape == (12, 40, 72, 1)
        assert got[name].dtype == np.float32 and np.isfinite(got[name]).all()
        tol = DISP_TOL if name == "disparity" else UNC_TOL
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=tol)
    if mode in ("warm_start", "warm_cache", "fast_mode", "align_windows"):
        # non-parity by design: the answer is not the strict one
        assert np.abs(got["disparity"] - jax_outputs("strict")["disparity"]).max() > 10 * DISP_TOL


@pytest.mark.parametrize("mode", ["batch_windows", "encoder_cache"])
def test_strict_modes_match_the_port_strict_run(port_outputs, mode):
    """Batched windows and the encoder cache are strict by design: the port's
    outputs equal its strict run's within the limits (on the CPU a batch of
    two windows may take another convolution algorithm, ~1.5e-5 px)."""
    strict, got = port_outputs("strict"), port_outputs(mode)
    for name, tol in (("disparity", DISP_TOL), ("uncertainties", UNC_TOL)):
        np.testing.assert_allclose(got[name], strict[name], rtol=0, atol=tol)


def test_encoder_cache_is_bit_equal_to_strict(port_outputs):
    """The predictor runs the encoders on gcd(K, K // 2) frames a call, so a
    cached frame's features are the bits a strict window computes for it,
    and the cached run equals the strict run exactly."""
    strict, got = port_outputs("strict"), port_outputs("encoder_cache")
    for name in ("disparity", "uncertainties"):
        np.testing.assert_array_equal(got[name], strict[name])


@pytest.mark.parametrize("k,chunk", [(6, 3), (10, 5), (20, 10), (9, None)])
def test_windows_encode_in_calls_of_gcd_frames(anchor, k, chunk):
    """The zoo's window, warm window and cache encoder run the encoders on
    gcd(k, k // 2) frames a call, or on the whole window where that is 1."""
    flat, _ = anchor
    pred = tmodel_zoo("PPMStereoModel", kernel_size=k, iters=1, params=flat, device="cpu",
                      mixed_precision=False, warm_start=True, encoder_cache=True)
    seen = []

    class Stop(Exception):
        pass

    def spy(left, right, frames_per_call=None):
        seen.append(frames_per_call)
        raise Stop

    pred.model.encode_frames = spy
    x = torch.zeros(1, k, 8, 8, 3)
    p = pred.predictor
    for call in (lambda: p.window_fn(x, x), lambda: p.warm_window_fn(x, x, x[..., :1]),
                 lambda: p.encode_window_fn(x, x)):
        with pytest.raises(Stop):
            call()
    assert seen == [chunk] * 3


def test_mode_switches_of_the_predictor(anchor):
    """Which chains a zoo predictor runs: the encoder cache needs
    overlapping windows run one at a time."""
    flat, _ = anchor
    assert available_models() == ["BiDAStereoModel", "DynamicStereoModel", "PPMStereoModel",
                                  "PPMStereoVDAModel", "RAFTStereoModel",
                                  "StereoAnyVideoModel"]

    def build(**kw):
        return tmodel_zoo("PPMStereoModel", kernel_size=K, iters=ITERS, params=flat,
                          device="cpu", mixed_precision=False, **kw).predictor

    assert build(encoder_cache=True).encoder_cache
    assert build(warm_start=True, encoder_cache=True).encoder_cache
    assert not build(encoder_cache=True, fast_mode=True).encoder_cache
    assert not build(encoder_cache=True, batch_windows=2).encoder_cache
    assert build(warm_start=True).warm_window_fn is not None
    assert build().warm_window_fn is None and not build().encoder_cache


def test_zoo_builds_random_weights_from_a_seed_and_loads_params(anchor):
    """params=None initialises from `seed` as utils/init.py does (the JAX
    zoo's random weights); load_params then carries the anchor in."""
    from ppmstereo_tpu_torch.utils.init import init_model

    flat, _ = anchor
    pred = tmodel_zoo("PPMStereoModel", kernel_size=K, iters=ITERS, params=None, seed=3,
                      device="cpu", mixed_precision=False)
    want = tppm.PPMStereo(tppm.PPMStereoConfig(mixed_precision=False), ITERS, test_mode=True)
    init_model(want, 3)
    for (name, p), q in zip(pred.model.state_dict().items(), want.state_dict().values()):
        assert torch.equal(p, q), name
    pred.load_params(flat)
    loaded = tmodel_zoo("PPMStereoModel", kernel_size=K, iters=ITERS, params=flat,
                        device="cpu", mixed_precision=False)
    for (name, p), q in zip(pred.model.state_dict().items(), loaded.model.state_dict().values()):
        assert torch.equal(p, q), name


@pytest.mark.parametrize("mode", ["warm_start", "warm_cache"])
def test_warm_windows_run_the_quarter_stage_only(anchor, video, monkeypatch, mode):
    """The first window runs the cold cascade (1 + 1 + 2 play steps); every
    later window runs the 1/4 loop alone, WARM_ITERS play steps, with the
    model's own parameters."""
    flat, _ = anchor
    pred = _port_predictor(flat, mode)
    calls = []
    play = tppm.play_attention

    def counted(q, k, v, scale):
        calls.append(q.shape[1])
        return play(q, k, v, scale)

    monkeypatch.setattr(tppm, "play_attention", counted)
    per_window = []
    for name in ("_run_window", "_run_window_warm", "_run_window_cached",
                 "_run_window_warm_cached"):
        fn = getattr(pred.predictor, name)

        def wrapped(*args, _fn=fn, **kwargs):
            before = len(calls)
            out = _fn(*args, **kwargs)
            per_window.append(len(calls) - before)
            return out

        monkeypatch.setattr(pred.predictor, name, wrapped)
    pred({"stereo_video": video})
    assert per_window == [ITERS // 2 + ITERS // 2 + ITERS] + [WARM_ITERS] * 3
