"""The port's kernel bindings and builds, checked on the CPU (no nvcc, no
card): every `extern "C"` function of `ppmstereo_tpu_torch/csrc/*.cu` is
bound with a ctypes argument list of its own length, with a pointer type for
every pointer and the stream (a missing or short list passes each as a
32-bit int and cuts 64-bit pointers); every wrapper's launch names a library
that defines the function; and a library's name changes when a `csrc/*.cuh`
header does."""

import ctypes
import re
from pathlib import Path

import pytest

from ppmstereo_tpu_torch.kernels import _build
from ppmstereo_tpu_torch.kernels import corr_lookup as tcl
from ppmstereo_tpu_torch.kernels import play_attention as tpa

KERNELS = Path(tpa.__file__).resolve().parent
EXTERN_C = re.compile(r'extern "C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)
# the ctypes type of each scalar C parameter type
SCALARS = {"int": ctypes.c_int, "float": ctypes.c_float, "int64_t": ctypes.c_int64}
# every bound function's argument list, by C name
ARGTYPES = {**tpa._ARGTYPES, "corr_lookup": tcl._ARGTYPES}


def _extern_c() -> dict:
    """{function: (source name, [C parameter, ...])} over csrc/*.cu."""
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in EXTERN_C.findall(src.read_text()):
            assert name not in found, f"{name} is defined in {found[name][0]} and {src.name}"
            found[name] = (src.stem, [p.strip() for p in params.split(",")])
    return found


FUNCTIONS = _extern_c()


def test_every_extern_c_function_is_bound():
    assert FUNCTIONS, "no extern \"C\" function found under csrc/"
    assert set(FUNCTIONS) == set(ARGTYPES)


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_argtypes_match_the_c_signature(name):
    _, params = FUNCTIONS[name]
    argtypes = ARGTYPES[name]
    assert len(argtypes) == len(params), f"{name}: {len(params)} C parameters, {len(argtypes)} argtypes"
    for param, argtype in zip(params, argtypes):
        if "*" in param:  # a pointer, or the stream (void*)
            assert argtype is ctypes.c_void_p or issubclass(argtype, ctypes._Pointer), (name, param)
        else:
            ctype = param.rsplit(None, 1)[0].replace("const ", "")
            assert argtype is SCALARS[ctype], (name, param, argtype)


def _launch_sites() -> list:
    """(library, function) of every launch in the wrappers' sources."""
    sites = re.findall(r'_launch\(\s*"(\w+)",\s*"(\w+)"', (KERNELS / "play_attention.py").read_text())
    sites += re.findall(r'_build\.build\("(\w+)"\)\.lib\.(\w+)', (KERNELS / "corr_lookup.py").read_text())
    return sites


def test_every_launch_names_the_library_that_defines_it():
    sites = _launch_sites()
    assert {fn for _, fn in sites} == set(FUNCTIONS)
    for library, fn in sites:
        assert FUNCTIONS[fn][0] == library, f"{fn} is launched from lib{library}, defined in {FUNCTIONS[fn][0]}.cu"


def test_build_name_follows_headers(tmp_path, monkeypatch):
    """A header edit gives a new library name (so a stale library is never
    loaded); an unchanged tree reuses the built one. nvcc and the loader
    are replaced by stubs that record the call."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "common.cuh"\nextern "C" int k(void* stream) { return 0; }\n')
    (csrc / "common.cuh").write_text("constexpr int TILE = 64;\n")
    compiled = []

    def fake_nvcc(cmd, **kwargs):
        target = Path(cmd[cmd.index("-o") + 1])
        target.write_bytes(b"")
        compiled.append(target)
        return type("Done", (), {"returncode": 0, "stdout": "", "stderr": ""})()

    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)

    first = _build.build("k").path
    _build._LOADED.clear()
    assert _build.build("k").path == first and len(compiled) == 1  # unchanged: no rebuild
    (csrc / "common.cuh").write_text("constexpr int TILE = 128;\n")
    _build._LOADED.clear()
    second = _build.build("k").path
    assert second != first and second.name.startswith("libk_") and len(compiled) == 2
    (csrc / "extra.cuh").write_text("// a new header\n")
    _build._LOADED.clear()
    assert _build.build("k").path not in (first, second) and len(compiled) == 3
