"""The train CLI's tiny CPU run of every model the JAX trainer trains but
PPMStereo (tests/test_torch_train.py runs that one): one step at 64x128,
a checkpoint holding every tensor of the model, the frozen ones included,
and a second call that resumes from it and takes one more step
(tests/torch_train_parity.py::tiny_cli_run); and for the two models with
transposed convolutions, the in-training evaluation's and a saved
checkpoint's weights against the trained model's. Apart from the per-model
parity files, so that `--dist loadfile` spreads them over workers.
"""

import pytest
import torch

from ppmstereo_tpu_torch.cli.evaluate import load_checkpoint
from ppmstereo_tpu_torch.data.datasets import SyntheticStereoDataset
from ppmstereo_tpu_torch.models.zoo import model_zoo as tmodel_zoo
from ppmstereo_tpu_torch.train import trainer as ttrainer
from tests import torch_train_parity as tp
from tests.torch_data_workers import tensorboard_without_tensorflow

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["memstereo", "ppmstereo_vda", "dynamicstereo", "bidastereo",
                                  "stereoanyvideo"])
def test_cli_tiny_run_on_the_cpu_and_resume(name, tmp_path):
    state = tp.tiny_cli_run(name, tmp_path)
    frozen = [n for n, p in state.model.named_parameters() if not p.requires_grad]
    assert bool(frozen) == (name != "dynamicstereo")


@pytest.mark.parametrize("name", ["ppmstereo_vda", "stereoanyvideo"])
def test_evaluation_and_checkpoint_hold_the_trained_weights(name, tmp_path, monkeypatch):
    """Both VDA families' DPT heads hold transposed convolutions, whose torch
    and flax kernels differ in layout but, at ViT-S, not in shape (a wrong
    carry loads): after one step of `train(enable_eval=True)` the in-training
    evaluation's model, and a predictor loading the saved step_1.pt through
    the evaluate CLI's `load_checkpoint`, hold the trained model's tensors
    bit for bit."""
    built = []
    build = ttrainer.build_eval_predictor
    monkeypatch.setattr(ttrainer, "build_eval_predictor",
                        lambda *a, **k: built.append(build(*a, **k)) or built[-1])
    cfg = ttrainer.TrainConfig(model_name=name, sample_len=2, train_iters=1, crop_size=(64, 128),
                               mixed_precision=False, exp_dir=str(tmp_path), eval_freq=1,
                               save_freq=1, ckpt_after_steps=0, log_freq=1)
    clip = SyntheticStereoDataset(num_seqs=1, sample_len=2, height=64, width=128)
    tensorboard_without_tensorflow()
    state = ttrainer.train(cfg, loader=[tp.batch(2, 64, 128)], max_steps=1, enable_eval=True,
                           eval_dataset=clip, device="cpu")
    trained = state.model.state_dict()

    def same_tensors(model) -> bool:
        got = model.state_dict()
        assert set(got) == set(trained)
        return all(torch.equal(got[k], v) for k, v in trained.items())

    assert len(built) == 1 and same_tensors(built[0].model)
    num_frames = {"num_frames": 2} if name in ttrainer.WITH_NUM_FRAMES else {}
    fresh = tmodel_zoo(ttrainer.ZOO_NAMES[name], iters=1, device="cpu", seed=1,
                       mixed_precision=False, **num_frames)
    assert not same_tensors(fresh.model)
    load_checkpoint(fresh, str(tmp_path / "ckpt"))
    assert same_tensors(fresh.model)
