"""The port's kernel bindings and builds, checked on the CPU (no nvcc, no
card): every `extern "C"` function of `ppmstereo_tpu_torch/csrc/*.cu` is
bound with a ctypes argument list of its own length, with a pointer type for
every pointer and the stream (a missing or short list passes each as a
32-bit int and cuts 64-bit pointers); every wrapper's launch names a library
that defines the function; a library's name changes when a `csrc/*.cuh`
header does; chip_smoke.py's readers of the machine code, of ptxas's report
(HGMMA and UTMALDG in each Hopper kernel, no spills) and of the profiler's
kernel times, and tools/ab_lookup.py's summary, on canned input."""

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


# A short `cuobjdump --dump-sass` text of a library with two kernels (the
# layout the tool prints: a "Function :" line, then one instruction a line)
_SASS = """
	code for sm_90a
		Function : _ZN54_GLOBAL__N__e38b9198_21_play_attention_bwd_cu_a5c87dce28play_attention_bwd_dq_kernelE14CUtensorMap_st
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   UTMALDG.3D [UR8], [UR4] ;
        /*0020*/                   UTMALDG.3D [UR16], [UR4] ;
        /*0030*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0040*/                   EXIT ;
		Function : _ZN54_GLOBAL__N__e38b9198_21_play_attention_bwd_cu_a5c87dce29play_attention_bwd_dkv_kernelE14CUtensorMap_st
        /*0000*/                   UTMALDG.1D [UR8], [UR4] ;
        /*0010*/                   HGMMA.64x128x16.F32.BF16 R24, R120, gdesc[UR8], R24 ;
        /*0020*/                   HGMMA.64x128x16.F32.BF16 R24, R124, gdesc[UR12], R24, gsb0 ;
        /*0030*/                   EXIT ;
"""
_KERNELS = {"bwd_dq": "play_attention_bwd_dq_kernel", "bwd_dkv": "play_attention_bwd_dkv_kernel"}


def test_sass_counts_reads_each_kernels_instructions():
    import chip_smoke

    assert chip_smoke.sass_counts(_SASS, _KERNELS) == {
        "bwd_dq": {"HGMMA": 1, "UTMALDG": 2}, "bwd_dkv": {"HGMMA": 2, "UTMALDG": 1}}


@pytest.mark.parametrize("case", ["no_hgmma", "no_utmaldg", "missing_kernel", "two_matches"])
def test_sass_counts_raises(case):
    """A kernel without wgmma or TMA loads, a kernel the dump lacks, and a
    fragment that names two functions each fail the check."""
    import chip_smoke

    dump, kernels = _SASS, dict(_KERNELS)
    if case == "no_hgmma":
        dump = dump.replace("HGMMA.64x64x16", "HMMA.16816")
    elif case == "no_utmaldg":
        dump = dump.replace("UTMALDG.1D", "LDG.E.128")
    elif case == "missing_kernel":
        kernels["fwd"] = "play_attention_fwd_kernelILb0E"
    else:
        kernels["both"] = "play_attention_bwd_d"
    with pytest.raises(RuntimeError, match="lacks|functions named"):
        chip_smoke.sass_counts(dump, kernels)


_PTXAS = """ptxas info    : Compiling entry function '_ZN_x_28play_attention_bwd_dq_kernelE' for 'sm_90a'
ptxas info    : Function properties for _ZN_x_28play_attention_bwd_dq_kernelE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 496 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN_x_29play_attention_bwd_dkv_kernelE' for 'sm_90a'
ptxas info    : Function properties for _ZN_x_29play_attention_bwd_dkv_kernelE
    8 bytes stack frame, 240 bytes spill stores, 240 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 624 bytes cmem[0]
"""


def test_ptxas_spills_reads_each_kernel_and_raises_on_a_spill():
    import chip_smoke

    assert chip_smoke.ptxas_spills(_PTXAS, {"bwd_dq": _KERNELS["bwd_dq"]}) == {"bwd_dq": 0}
    with pytest.raises(RuntimeError, match="spilled 480 bytes"):
        chip_smoke.ptxas_spills(_PTXAS, _KERNELS)
    with pytest.raises(RuntimeError, match="no ptxas spill line"):
        chip_smoke.ptxas_spills(_PTXAS, {"fwd": "play_attention_fwd_kernelILb0E"})


def _variant_cases():
    import sys

    sys.path.insert(0, str(KERNELS.parents[1] / "tools"))
    import bwd_variants
    import fwd_variants

    return [(tool, name) for tool in (fwd_variants, bwd_variants) for name in tool.VARIANTS]


@pytest.mark.parametrize("tool,name", _variant_cases(),
                         ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_kernel_variants_apply_to_the_sources(tool, name):
    """Every edit of tools/fwd_variants.py and tools/bwd_variants.py finds
    its text exactly once in the kernel source or a header as they stand, so
    the tools still build what they name."""
    import fwd_variants

    files = fwd_variants.edited_sources(name, tool.SOURCE, tool.VARIANTS)
    assert tool.SOURCE.name in files and "hopper.cuh" in files
    unedited = fwd_variants.edited_sources("committed", tool.SOURCE, tool.VARIANTS)
    assert (files == unedited) == (not tool.VARIANTS[name])


def test_kernel_5_is_a_mode_of_the_forward_library():
    """The ring hop lives in csrc/play_attention_fwd.cu beside kernels 1 and
    2 (the mma.sync source is gone) and keeps its C signature; chip_smoke.py
    checks its SASS as one of the forward library's Hopper kernels."""
    import chip_smoke

    assert not (_build.CSRC / "play_attention.cu").exists()
    assert FUNCTIONS["play_attention_carry"] == ("play_attention_fwd", [
        "const void* q", "const void* k", "const void* v", "void* o", "void* m", "void* l",
        "int B", "int Lq", "int Lk", "float scale_log2", "void* stream"])
    assert set(chip_smoke.KERNEL_LIBRARIES) == {src for src, _ in FUNCTIONS.values()}
    assert chip_smoke.HOPPER_KERNELS["play_attention_fwd"]["play_attention_carry"] == (
        "play_attention_fwd_kernelILi2E")


def test_lookup_binding_takes_the_dtypes():
    """Kernel 6's entry point takes its six level pointers and widths (the
    level counts 1 to 6 it is built for) as scalars (no ctypes arrays built
    per call) and the pyramid's and the output's dtype as two int flags."""
    _, params = FUNCTIONS["corr_lookup"]
    assert [p.rsplit(None, 1)[1] for p in params] == [
        *(f"level{i}" for i in range(6)), *(f"width{i}" for i in range(6)),
        "num_levels", "radius", "coords", "out", "pixels", "pyramid_bf16", "out_bf16", "stream"]


def test_ptxas_resources_reads_every_instance():
    """Kernel 6's registers and spills, per template instance, from ptxas's
    report: a reading, which raises on nothing."""
    import chip_smoke

    text = _PTXAS.replace("play_attention_bwd_dq_kernel", "corr_lookup_kernelIffE").replace(
        "play_attention_bwd_dkv_kernel", "corr_lookup_kernelI13__nv_bfloat16S0_E")
    assert chip_smoke.ptxas_resources(text, "corr_lookup_kernel") == {
        "_ZN_x_28corr_lookup_kernelIffEE": {"spill_bytes": 0, "registers": 168},
        "_ZN_x_29corr_lookup_kernelI13__nv_bfloat16S0_EE": {"spill_bytes": 480,
                                                            "registers": 168}}
    assert chip_smoke.ptxas_resources(_PTXAS, "corr_lookup_kernel") == {}


def _events(*names):
    """Profiler averages as `key_averages()` gives them: (key, on the
    device, count, self device us)."""
    from types import SimpleNamespace

    import torch

    kinds = {True: torch.autograd.DeviceType.CUDA, False: torch.autograd.DeviceType.CPU}
    return [SimpleNamespace(key=key, device_type=kinds[dev], count=n, self_device_time_total=us)
            for key, dev, n, us in names]


@pytest.mark.parametrize("events,want", [
    # kernel 5's instance only: not kernels 1 and 2, not the host's range
    (_events(("void play_attention_fwd_kernel<2>(CUtensorMap_st, int)", True, 40, 25500.0),
             ("void play_attention_fwd_kernel<0>(CUtensorMap_st, int)", True, 20, 41000.0),
             ("void play_attention_fwd_kernel<1>(CUtensorMap_st, int)", True, 3, 999.0),
             ("play_attention_fwd_kernel<2>", False, 40, 7.0)),
     {"kernels": 40, "device_ms": 25.5}),
    # the profiler saw no device time: not measured
    (_events(("aten::add", False, 3, 0.0)), {"kernels": 0, "device_ms": None}),
])
def test_kernel_device_ms_sums_kernel_5s_instance(events, want):
    """chip_smoke.py's ring phase reads kernel 5's device time per window
    from the profiler's kernels named as its template instance."""
    import chip_smoke

    assert chip_smoke.kernel_device_ms(events, chip_smoke.CARRY_KERNEL) == want


def test_kernel_device_ms_raises_when_the_kernel_is_missing():
    """Device kernels recorded, none of them kernel 5: a wrong name, which
    must fail rather than read as not measured."""
    import chip_smoke

    events = _events(("void play_attention_fwd_kernel<0>(CUtensorMap_st, int)", True, 20, 1.0))
    with pytest.raises(RuntimeError, match="none of them play_attention_fwd_kernel<2>"):
        chip_smoke.kernel_device_ms(events, chip_smoke.CARRY_KERNEL)


def test_lookup_ab_summary_keeps_each_checkouts_runs():
    """tools/ab_lookup.py sets each checkout's runs side by side in their
    order, leaves a case a version does not take empty, and reads
    bit-equality per checkout."""
    import sys

    sys.path.insert(0, str(KERNELS.parents[1] / "tools"))
    import ab_lookup

    def run(host, bf16=None, equal=True):
        out = {"1/16 float32": dict(bit_equal=True, host_us=host, event_us=host + 1)}
        if bf16 is not None:
            out["1/16 bfloat16"] = dict(bit_equal=equal, host_us=bf16, event_us=bf16 + 1)
        return out

    runs = [("parent", run(50.0)), ("change", run(20.0, 21.0)),
            ("change", run(22.0, 23.0, equal=False)), ("parent", run(52.0))]
    times, equal = ab_lookup.summarise(runs)
    assert times["1/16 float32"] == {"parent host_us": [50.0, 52.0],
                                     "parent event_us": [51.0, 53.0],
                                     "change host_us": [20.0, 22.0],
                                     "change event_us": [21.0, 23.0]}
    assert times["1/16 bfloat16"]["parent host_us"] == []
    assert times["1/16 bfloat16"]["change event_us"] == [22.0, 24.0]
    assert equal == {"parent": True, "change": False}
