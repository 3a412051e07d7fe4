"""The port's PPMStereo test-mode forward and strict sliding-window predictor
against the JAX package's, at shipped widths and a tiny size.

Weights: the committed anchor `checkpoints/anchor_r5.npz`, parameters the
JAX package trained, carried into the port with `utils/weights.py`. Trained
weights make the play step matter (its blend `beta` is zero at
initialisation) and give the frame scores of a real model.

Inputs: the JAX package's synthetic stereo clips (layered textures with
known disparity), made from a numpy seed.

Tolerance: both models run in f32 (`mixed_precision=False`) except the play
step, which rounds q/k/v to bf16 in both. An f32 difference in the last bit
of q can round to a neighbouring bf16 value, so the play output may differ by
about 2^-8 relative in places. Measured on the CPU, the port differs from
the JAX package by at most 1.24e-5 px of disparity and 3.6e-7 of
uncertainty over these tests; a wrong play step (its softmax scale doubled)
moves them by at least 6.9e-4 px and 1.85e-5. The limits, 1e-4 px and
3e-6, sit between the two, near 8x from each. The top-k frame picks must be
identical.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppmstereo_tpu.data.datasets import SyntheticStereoDataset
from ppmstereo_tpu.models import inference as jinf
from ppmstereo_tpu.models.ppm_stereo import PPMStereo as JPPMStereo
from ppmstereo_tpu.models.ppm_stereo import PPMStereoConfig as JConfig
from ppmstereo_tpu.models.zoo import model_zoo as jmodel_zoo
from ppmstereo_tpu_torch.kernels import play_attention as tpa
from ppmstereo_tpu_torch.models import inference as tinf
from ppmstereo_tpu_torch.models import ppm_stereo as tppm
from ppmstereo_tpu_torch.models.zoo import model_zoo as tmodel_zoo
from ppmstereo_tpu_torch.utils.weights import load_flax_params, load_npz

torch.set_num_threads(1)
ANCHOR = Path(__file__).resolve().parent.parent / "checkpoints" / "anchor_r5.npz"
DISP_TOL = 1e-4
UNC_TOL = 3e-6


@pytest.fixture(scope="module")
def anchor():
    flat = {k: v.astype(np.float32) for k, v in load_npz(ANCHOR).items()}
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return flat, tree


def _clip(frames, h, w, seed=0):
    """(frames, 2, h, w, 3) float32 in [0, 255] and its |disparity|."""
    ds = SyntheticStereoDataset(num_seqs=1, sample_len=frames, height=h, width=w, seed=seed)
    sample = ds._load_sample(0)
    return sample["img"].astype(np.float32), -sample["disp"][:, 0, :, :, 0]


def test_forward_matches_jax_with_identical_picks(anchor, monkeypatch):
    flat, tree = anchor
    video, _ = _clip(5, 64, 128)
    left, right = video[None, :, 0], video[None, :, 1]

    jax_picks = []
    top_k = jax.lax.top_k

    def recording_top_k(x, k):
        out = top_k(x, k)
        jax.debug.callback(lambda idx: jax_picks.append(np.asarray(idx)), out[1], ordered=True)
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
    jm = JPPMStereo(cfg=JConfig(mixed_precision=False, force_xla_attention=True),
                    iters=4, test_mode=True)
    jd, ju = jax.jit(jm.apply)(tree, jnp.asarray(left), jnp.asarray(right))
    jd, ju = np.asarray(jd), np.asarray(ju)
    jax.effects_barrier()

    tm = tppm.PPMStereo(tppm.PPMStereoConfig(mixed_precision=False), iters=4, test_mode=True)
    load_flax_params(tm, flat)
    port_picks = []
    with torch.no_grad():
        td, tu = tm(torch.from_numpy(left), torch.from_numpy(right), picks=port_picks)

    # 2 + 2 + 4 iterations over the three stages
    assert len(jax_picks) == len(port_picks) == 8
    for jp, tp in zip(jax_picks, port_picks):
        np.testing.assert_array_equal(tp.numpy(), jp)
    assert td.shape == jd.shape == (1, 5, 64, 128, 1)
    assert np.isfinite(td.numpy()).all()
    np.testing.assert_allclose(td.numpy(), jd, rtol=0, atol=DISP_TOL)
    np.testing.assert_allclose(tu.numpy(), ju, rtol=0, atol=UNC_TOL)

    # the limits are tight enough to catch a wrong play step
    monkeypatch.setattr(tppm, "play_attention",
                        lambda q, k, v, scale: tpa.play_attention(q, k, v, 2 * scale))
    with torch.no_grad():
        fd, fu = tm(torch.from_numpy(left), torch.from_numpy(right))
    assert np.abs(fd.numpy() - jd).max() > DISP_TOL
    assert np.abs(fu.numpy() - ju).max() > UNC_TOL


def test_bf16_forward_tracks_jax(anchor):
    """The shipped bf16 policy. XLA fuses chains of elementwise ops and
    rounds their result to bf16 once, PyTorch rounds after each op, so
    single values drift by bf16 ulps (2^-8 relative) through some hundred
    layers and eight iterations; measured, the disparity differs by 0.013 px
    on average and the accuracy not at all (EPE 3.7098 vs 3.7105 px on this
    tiny clip). Bounds: 0.05 px mean difference, 0.02 px of EPE."""
    flat, tree = anchor
    video, gt = _clip(5, 64, 128)
    left, right = video[None, :, 0], video[None, :, 1]
    jm = JPPMStereo(cfg=JConfig(force_xla_attention=True), iters=4, test_mode=True)
    jd = np.asarray(jax.jit(jm.apply)(tree, jnp.asarray(left), jnp.asarray(right))[0])
    tm = tppm.PPMStereo(iters=4, test_mode=True)
    load_flax_params(tm, flat)
    with torch.no_grad():
        td = tm(torch.from_numpy(left), torch.from_numpy(right))[0].numpy()
    assert td.dtype == np.float32 and np.isfinite(td).all()
    assert np.abs(td - jd).mean() <= 0.05
    epe_port = np.abs(np.abs(td[0, ..., 0]) - gt).mean()
    epe_jax = np.abs(np.abs(jd[0, ..., 0]) - gt).mean()
    assert abs(epe_port - epe_jax) <= 0.02


def test_model_of_another_clip_length_loads_the_anchor(anchor):
    """A model built for 3-frame clips (a training `sample_len` of 3) loads
    the anchor's 5-frame time embedding as it is, as the JAX package does,
    and resizes it to each clip at apply time: its forward matches the JAX
    model's with the same parameters, and the trainer seeds from it."""
    from ppmstereo_tpu_torch.train.trainer import TrainConfig, build_train_model

    flat, tree = anchor
    video, _ = _clip(3, 64, 128, seed=2)
    left, right = video[None, :, 0], video[None, :, 1]
    # flax sizes the embedding from the parameters it is given (5 frames)
    # and resizes it to the clip at apply time
    jm = JPPMStereo(cfg=JConfig(mixed_precision=False, force_xla_attention=True),
                    iters=2, test_mode=True)
    jd, ju = (np.asarray(x) for x in jax.jit(jm.apply)(tree, jnp.asarray(left),
                                                         jnp.asarray(right)))
    tm = tppm.PPMStereo(tppm.PPMStereoConfig(mixed_precision=False, num_frames=3), iters=2,
                        test_mode=True)
    param = tm.sst.time_embed
    load_flax_params(tm, flat)
    assert tm.sst.time_embed is param and tuple(param.shape) == (1, 5, 256)
    with torch.no_grad():
        td, tu = (x.numpy() for x in tm(torch.from_numpy(left), torch.from_numpy(right)))
    np.testing.assert_allclose(td, jd, rtol=0, atol=DISP_TOL)
    np.testing.assert_allclose(tu, ju, rtol=0, atol=UNC_TOL)
    train_model, has_uncertainty = build_train_model(TrainConfig(sample_len=3, train_iters=2))
    assert has_uncertainty
    load_flax_params(train_model, flat)
    assert tuple(train_model.sst.time_embed.shape) == (1, 5, 256)


@pytest.mark.parametrize("k,n_out", [(6, 12), (5, 17)])
def test_strict_predictor_matches_jax(anchor, k, n_out):
    """12 frames at 40 x 72 (padded to 64 x 96). Kernel 6 (stride 3, odd)
    makes windows of 6, 6, 6 and a tail of 3, trimmed (0, 2), (1, 2), (1, 2),
    (1, 0). Kernel 5 (stride 2) makes windows of 5, 5, 5, 5, 4 and 2, whose
    trims overlap: both packages return 17 frames (test_stitching_matches_jax)."""
    flat, tree = anchor
    video, _ = _clip(12, 40, 72, seed=1)
    jpred = jmodel_zoo("PPMStereoModel", kernel_size=k, iters=2, params=tree,
                       mixed_precision=False, force_xla_attention=True)
    tpred = tmodel_zoo("PPMStereoModel", kernel_size=k, iters=2, params=flat,
                       device="cpu", mixed_precision=False)
    want = jpred({"stereo_video": video})
    got = tpred({"stereo_video": video})
    assert set(got) == {"disparity", "uncertainties"}
    for name in got:
        assert got[name].shape == want[name].shape == (n_out, 40, 72, 1)
        tol = DISP_TOL if name == "disparity" else UNC_TOL
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=tol)
    assert (got["disparity"] >= 0).all()


@pytest.mark.parametrize("k", [4, 5, 6, 10, 11])
def test_window_trim_bounds_match_jax(k):
    stride = k // 2
    for i in range(0, 40, stride):
        for wlen in range(1, k + 1):
            assert tinf.window_trim_bounds(i, wlen, k, stride) == \
                jinf.window_trim_bounds(i, wlen, k, stride)


@pytest.mark.parametrize("n,k", [(23, 10), (17, 6), (12, 5), (4, 6)])
def test_stitching_matches_jax(n, k):
    """Both predictors over a window function whose output depends on the
    position of a frame inside its window: stitching must agree exactly,
    odd strides (10 -> 5, 6 -> 3) and a clip shorter than a window included.

    An odd kernel (5 -> stride 2) keeps k - 2 frames of each window while
    the windows advance by 2, so the reference's strict trim returns more
    frames than the clip has (17 for 12); the port reproduces that."""
    rng = np.random.default_rng(n)
    video = rng.uniform(0, 255, (n, 2, 20, 36, 3)).astype(np.float32)

    def jwindow(left, right):
        pos = jnp.arange(left.shape[1], dtype=jnp.float32)[None, :, None, None, None]
        return left.mean(-1, keepdims=True) - 1000.0 * pos, right[..., :1] + pos

    def twindow(left, right):
        pos = torch.arange(left.shape[1], dtype=torch.float32)[None, :, None, None, None]
        return left.mean(-1, keepdim=True) - 1000.0 * pos, right[..., :1] + pos

    want = jinf.SlidingWindowPredictor(jwindow, kernel_size=k)(video)
    got = tinf.SlidingWindowPredictor(twindow, kernel_size=k, device="cpu")(video)
    for name in ("disparity", "uncertainties"):
        assert got[name].shape == want[name].shape
        assert got[name].shape[1:] == (20, 36, 1)
        if k % 2 == 0:
            assert got[name].shape[0] == n
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-3)


def test_model_zoo_requires_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel_zoo("PPMStereoModel", params={}, kernel_size=5, iters=1)
    with pytest.raises(ValueError, match="unknown model"):
        tmodel_zoo("NoSuchModel", params={}, device="cpu")


@pytest.mark.parametrize("test_mode", [True, False])
def test_lookup_kernel_runs_in_test_mode_only(monkeypatch, test_mode):
    """The model's test_mode chooses the lookup: a test-mode iteration calls
    kernel 6's wrapper (`corr_lookup_kernel`, with the model's dtype as its
    output dtype) once, a train-mode iteration the differentiable plain
    lookup, never the kernel. 1 + 1 + 2 iterations over the three stages;
    random weights, f32, a 3-frame 64x128 clip."""
    calls = {"kernel": [], "plain": 0}
    kernel, plain = tppm.corr_lookup_kernel, tppm.corr_lookup

    def counted_kernel(pyramid, coords_x, radius, out_dtype):
        calls["kernel"].append(out_dtype)
        return kernel(pyramid, coords_x, radius, out_dtype=out_dtype)

    def counted_plain(*args):
        calls["plain"] += 1
        return plain(*args)

    monkeypatch.setattr(tppm, "corr_lookup_kernel", counted_kernel)
    monkeypatch.setattr(tppm, "corr_lookup", counted_plain)
    torch.manual_seed(0)
    model = tppm.PPMStereo(tppm.PPMStereoConfig(mixed_precision=False), iters=2,
                           test_mode=test_mode).eval()
    video, _ = _clip(3, 64, 128)
    with torch.no_grad():
        out = model(torch.from_numpy(video[None, :, 0]), torch.from_numpy(video[None, :, 1]))
    assert all(torch.isfinite(x).all() for x in out)
    if test_mode:
        assert calls == {"kernel": [torch.float32] * 4, "plain": 0}
    else:
        assert calls == {"kernel": [], "plain": 4}
