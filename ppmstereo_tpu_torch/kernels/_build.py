"""Build and load the port's CUDA kernels.

Each source under `ppmstereo_tpu_torch/csrc/` is compiled by `nvcc` into a
shared library with a plain C interface and loaded with `ctypes`. The
library lands in `build/ppmstereo_tpu_torch/` at the repository root, named
after a hash of the source, every header under `csrc/` (`*.cuh`) and the
flags, so a source is rebuilt only when it or a header it may include
changed. The build writes a temporary file and renames it into place, so
an interrupted build leaves no half-written library and no lock file.

Nothing here runs at import: a kernel is built the first time its wrapper
launches it on a CUDA tensor (or when `chip_smoke.py` asks for the build).
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
BUILD_TIMEOUT_S = 300


@dataclass
class BuiltKernel:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    seconds: float  # nvcc wall time; 0.0 when the library was already built
    log: str        # nvcc's output (registers, shared memory, spills)


_LOADED: dict[str, BuiltKernel] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _source_digest(src: Path) -> str:
    """Hash of a source, every `csrc/*.cuh` (names and contents, in order)
    and the nvcc flags: the part of a library's name that changes when any
    of them does."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str) -> BuiltKernel:
    """Compile `csrc/<name>.cu` if needed and load it (cached per process)."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC / f"{name}.cu"
    digest = _source_digest(src)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"lib{name}_{digest}.so"
    log_path = lib_path.with_suffix(".log")
    seconds = 0.0
    if not lib_path.exists():
        tmp = BUILD_DIR / f".{lib_path.name}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True, timeout=BUILD_TIMEOUT_S,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {src.name}:\n{log}")
        log_path.write_text(log)
        os.replace(tmp, lib_path)
    built = BuiltKernel(
        lib=ctypes.CDLL(str(lib_path)), path=lib_path, seconds=seconds,
        log=log_path.read_text() if log_path.exists() else "",
    )
    _LOADED[name] = built
    return built
