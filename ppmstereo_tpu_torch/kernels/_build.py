"""Build and load the port's CUDA kernels and its host library.

Each source under `ppmstereo_tpu_torch/csrc/` is compiled into a shared
library with a plain C interface and loaded with `ctypes`: a `.cu` source
(a kernel) by `nvcc` for sm_90a, a `.cpp` source (`stereoio.cpp`, the data
readers of `data/native.py`) by `g++` for the host's CPU (`-march=native`).
The library lands in `build/ppmstereo_tpu_torch/` at the repository root,
named after a hash of the source, every header under `csrc/` (`*.cuh`), the
compiler's flags and, for a host library, the instruction set that
`-march=native` selects on this machine, so a source is rebuilt only when
one of them changed. The build writes a temporary file and renames it into
place, so an interrupted build leaves no half-written library and no lock
file.

Nothing here runs at import: a kernel is built the first time its wrapper
launches it on a CUDA tensor (or when `chip_smoke.py` asks for the build),
the host library the first time a reader calls it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ppmstereo_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the flags of native/Makefile, so that the port's readers compute what the
# JAX package's binding does, bit for bit
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native", "-shared")
GXX_LIBS = ("-lpthread",)
BUILD_TIMEOUT_S = 300


@dataclass
class BuiltKernel:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    seconds: float  # the compiler's wall time; 0.0 when the library was already built
    log: str        # the compiler's output (nvcc: registers, shared memory, spills)


_LOADED: dict[str, BuiltKernel] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: the port's host library needs a C++ compiler")


def _host_target(gxx: str) -> bytes:
    """The macros that `-march=native` defines on this machine (its
    instruction set), which a host library's name hashes."""
    proc = subprocess.run([gxx, "-march=native", "-dM", "-E", "-x", "c++", "-"],
                          input="", capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.encode()


def _source_digest(src: Path, flags: tuple, target: bytes = b"") -> str:
    """Hash of a source, every `csrc/*.cuh` (names and contents, in order),
    the compiler's flags and `target`: the part of a library's name that
    changes when any of them does."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flags).encode())
    h.update(target)
    return h.hexdigest()[:16]


def build(name: str) -> BuiltKernel:
    """Compile `csrc/<name>.cu` (nvcc) or `csrc/<name>.cpp` (g++) if needed
    and load it (cached per process); a failed build raises with the
    compiler's output."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC / f"{name}.cu"
    if src.exists():
        compiler, flags, libs, target = _nvcc(), NVCC_FLAGS, (), b""
    else:
        src = CSRC / f"{name}.cpp"
        if not src.exists():
            raise FileNotFoundError(f"no source {name}.cu or {name}.cpp under {CSRC}")
        compiler, flags, libs = _gxx(), GXX_FLAGS, GXX_LIBS
        target = _host_target(compiler)
    digest = _source_digest(src, flags + libs, target)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"lib{name}_{digest}.so"
    log_path = lib_path.with_suffix(".log")
    seconds = 0.0
    if not lib_path.exists():
        tmp = BUILD_DIR / f".{lib_path.name}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [compiler, *flags, "-o", str(tmp), str(src), *libs],
            capture_output=True, text=True, timeout=BUILD_TIMEOUT_S,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{Path(compiler).name} failed for {src.name}:\n{log}")
        log_path.write_text(log)
        os.replace(tmp, lib_path)
    built = BuiltKernel(
        lib=ctypes.CDLL(str(lib_path)), path=lib_path, seconds=seconds,
        log=log_path.read_text() if log_path.exists() else "",
    )
    _LOADED[name] = built
    return built
