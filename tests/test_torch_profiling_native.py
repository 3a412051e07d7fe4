"""The port's profiling utilities (ppmstereo_tpu_torch/utils/profiling.py)
and native readers (ppmstereo_tpu_torch/data/native.py) against the JAX
package's.

The analytic counts must return exactly the JAX package's FLOPs and bytes;
only the peaks differ (the H100 SXM's). The native readers must give the
JAX package's numpy readers' arrays bit for bit, and the fused photometric
pass the JAX binding's bytes (both libraries are compiled from the same
code with the same flags).
"""

import json
import time

import numpy as np
import pytest
import torch

from ppmstereo_tpu.data import frame_utils as jfu
from ppmstereo_tpu.data import native as jnative
from ppmstereo_tpu.utils import profiling as jprof
from ppmstereo_tpu_torch.data import frame_utils as tfu
from ppmstereo_tpu_torch.data import native as tnative
from ppmstereo_tpu_torch.kernels import _build
from ppmstereo_tpu_torch.utils import profiling as tprof

COSTS = [
    ("corr_volume_cost", (2, 40, 64, 64, 256)),
    ("corr_lookup_cost", (10, 80, 128, 128)),
    ("corr_lookup_cost", (3, 7, 11, 13, 9, 2)),
    ("play_attention_cost", (1, 10, 80 * 128, 5, 128)),
    ("play_attention_cost", (1, 20, 184 * 320, 5, 128)),
    ("gru3d_cost", (1, 10, 80, 128, 128, 257)),
    ("ppm_iteration_cost", (1, 10, 80, 128)),
    ("ppm_iteration_cost", (2, 5, 20, 32, 128, 3)),
]


@pytest.mark.parametrize("name,args", COSTS)
def test_cost_counts_are_the_jax_packages(name, args):
    got, want = getattr(tprof, name)(*args), getattr(jprof, name)(*args)
    assert (got.flops, got.bytes) == (want.flops, want.bytes)
    assert got.light_speed_s == max(got.flops / tprof.H100_BF16_FLOPS,
                                    got.bytes / tprof.H100_HBM_BYTES_S)


def test_play_attention_light_speed_on_the_h100():
    """Kernel 1 at the 320x512 1/4 shape: 2.684e12 FLOP over 989 TFLOP/s is
    2.714 ms against 314.6 MB over 3.35 TB/s, 0.094 ms: compute-bound."""
    cost = tprof.play_attention_cost(1, 10, 10240, 5, 128)
    assert cost.flops == pytest.approx(2.684e12, rel=1e-3)
    assert cost.bytes == pytest.approx(314.6e6, rel=1e-3)
    assert cost.light_speed_s == pytest.approx(2.714e-3, rel=1e-3)
    assert cost.memory_s == pytest.approx(0.0939e-3, rel=1e-3)
    assert cost.bound == "compute"
    assert (tprof.H100_BF16_FLOPS, tprof.H100_HBM_BYTES_S) == (989e12, 3.35e12)
    at_720p = tprof.play_attention_cost(1, 20, 58880, 5, 128)
    assert at_720p.light_speed_s == pytest.approx(179.5e-3, rel=1e-3)


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with tprof.trace(str(tmp_path)):
        torch.mm(a, a)
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_timed_fills_results(capsys):
    results = {}
    with tprof.timed("cpu block", results, device="cpu"):
        torch.ones(8).sum()
    with tprof.timed("host block", results):
        pass
    assert set(results) == {"cpu block", "host block"}
    assert all(0.0 <= s < 5.0 for s in results.values())
    with tprof.timed("printed"):
        pass
    assert "[timed] printed:" in capsys.readouterr().out


@pytest.mark.parametrize("shape", [(13, 17), (9, 11, 3)])
@pytest.mark.parametrize("little_endian", [True, False])
def test_native_pfm_matches_the_jax_readers(tmp_path, rng, shape, little_endian):
    data = rng.standard_normal(shape).astype(np.float32)
    path = str(tmp_path / "x.pfm")
    if little_endian:
        tfu.write_pfm(path, data)
    else:  # a big-endian file: positive scale, bytes swapped
        with open(path, "wb") as f:
            f.write(b"PF\n" if data.ndim == 3 else b"Pf\n")
            f.write(f"{shape[1]} {shape[0]}\n1.0\n".encode())
            np.flipud(data).astype(">f4").tofile(f)
    got = tnative.read_pfm(path)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, jfu.read_pfm(path))
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(tfu.read_gen(path), jfu.read_gen(path))


def _write_flo(path, flow):
    with open(path, "wb") as f:
        np.array([202021.25], np.float32).tofile(f)
        np.array([flow.shape[1], flow.shape[0]], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def test_native_flo_matches_the_jax_readers(tmp_path, rng):
    flow = rng.standard_normal((9, 11, 2)).astype(np.float32)
    path = str(tmp_path / "x.flo")
    _write_flo(path, flow)
    got = tnative.read_flo(path)
    np.testing.assert_array_equal(got, jfu.read_flow(path))
    np.testing.assert_array_equal(tfu.read_gen(path), jfu.read_gen(path))


def test_read_gen_goes_through_the_native_readers(tmp_path, rng, monkeypatch):
    calls = []
    for name in ("read_pfm", "read_flo"):
        fn = getattr(tnative, name)
        monkeypatch.setattr(tnative, name, lambda p, fn=fn, name=name: calls.append(name) or fn(p))
    tfu.write_pfm(str(tmp_path / "d.pfm"), rng.standard_normal((5, 6)).astype(np.float32))
    _write_flo(str(tmp_path / "f.flo"), rng.standard_normal((4, 3, 2)).astype(np.float32))
    tfu.read_gen(str(tmp_path / "d.pfm"))
    tfu.read_gen(str(tmp_path / "f.flo"))
    assert calls == ["read_pfm", "read_flo"]


def test_native_read_of_a_missing_or_bad_file_raises(tmp_path):
    with pytest.raises(IOError, match="read_pfm"):
        tnative.read_pfm(str(tmp_path / "missing.pfm"))
    (tmp_path / "bad.flo").write_bytes(b"\0" * 16)
    with pytest.raises(IOError, match="read_flo"):
        tnative.read_flo(str(tmp_path / "bad.flo"))


def _load_jax_binding():
    """The JAX package's binding with its library loaded. It builds the
    library in place with `make` at first use; another test process doing
    the same may leave it half-written for a moment (the binding then falls
    back to numpy), so a failed load is retried."""
    for _ in range(5):
        if jnative.available():
            return
        jnative._lib = None
        time.sleep(2.0)
    pytest.fail("the JAX package's native library did not load")


@pytest.mark.parametrize("params,order", [
    ((1.2, 0.9, 1.1, 1.0, 1.0), (0, 1, 2)),
    ((0.8, 1.3, 0.7, 0.9, 1.05), (2, 0, 1)),
    ((1.05, 1.0, 1.4, 1.2, 0.95), (1, 2, 0)),
])
def test_photometric_fused_matches_the_jax_binding(rng, params, order):
    _load_jax_binding()
    img = rng.integers(0, 256, (2, 48, 64, 3)).astype(np.uint8)
    want = jnative.photometric_fused(img.copy(), *params, np.array(order))
    src = img.copy()
    got = tnative.photometric_fused(src, *params, np.array(order))
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(src, want)  # in place, as the JAX binding
    assert not np.array_equal(got, img)


def test_native_library_is_the_ports_own_build():
    assert tnative.available()
    built = _build.build("stereoio")
    assert built.path.parent == _build.BUILD_DIR
    assert built.path.name.startswith("libstereoio_")


def test_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "stereoio.cpp").write_text("int read_pfm( { this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    with pytest.raises(RuntimeError, match=r"g\+\+ failed for stereoio\.cpp:[\s\S]*error"):
        tnative.available()
    assert not list((tmp_path / "build").glob("*.so"))
