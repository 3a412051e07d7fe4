"""The import CLI's two Video-Depth-Anything families, PPMStereoVDAModel and
StereoAnyVideoModel: the port CLI's npz of a synthetic checkpoint against
the JAX CLI's, with the JAX CLI's faults worked around in the test process
(tests/test_torch_import.py's `_jax_cli_shims`, whose docstring names
them), and the first of its two VDA faults, the DPT head's transposed
convolutions converted as Conv2d weights, against the JAX CLI without that
workaround. Apart from tests/test_torch_import.py because each JAX CLI run
traces its model's init (`jax.eval_shape`, 10-20 s here; see
tests/test_torch_import.py's docstring).
"""

import numpy as np
import pytest
import torch

from ppmstereo_tpu.utils import torch_import as jti
from ppmstereo_tpu_torch.utils import torch_import as tti
from tests.test_torch_import import _synthetic_state_dict, cli_parity, port_and_jax_npz

torch.set_num_threads(1)


@pytest.mark.parametrize("model_name", ["PPMStereoVDAModel", "StereoAnyVideoModel"])
def test_cli_writes_the_jax_clis_npz(model_name, tmp_path, monkeypatch):
    cli_parity(model_name, _synthetic_state_dict(model_name), tmp_path, monkeypatch)


def test_jax_cli_converts_transposed_convs_as_conv2d(tmp_path, monkeypatch):
    """The JAX CLI on a StereoAnyVideo checkpoint, with only its backbone
    fault worked around (so that it imports the backbone at all), writes the
    DPT head's ConvTranspose2d weights through the Conv2d transpose: I and O
    swapped, not flipped (ViT-S's have I = O, so the shapes fit and nothing
    fails). The port's CLI writes `deconv2d_w` of them; every other array is
    the same."""
    sd, got, want, port_rc, jax_rc = port_and_jax_npz(
        "StereoAnyVideoModel", tmp_path, monkeypatch, init_shapes=True,
        transposed_convs=False)
    assert port_rc == jax_rc == 0
    resize = {f"depthnet/depthanything/head/resize_{i}/kernel":
              f"depthnet.depthanything.head.resize_layers.{i}.weight" for i in (0, 1)}
    assert sorted(got) == sorted(want)
    for k in want:
        if k not in resize:
            np.testing.assert_array_equal(got[k], want[k])
    for fkey, tkey in resize.items():
        w = sd[tkey]
        assert w.shape[0] == w.shape[1]  # I = O
        np.testing.assert_array_equal(want[fkey], jti.conv2d_w(w).astype(np.float16))
        np.testing.assert_array_equal(got[fkey], tti.deconv2d_w(w).astype(np.float16))
        assert not np.array_equal(got[fkey], want[fkey])
