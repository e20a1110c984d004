"""Build and load the CUDA kernels of harp_tpu_torch/csrc, and the card's
nvJPEG frame decoder (native/frameloader_nvjpeg.cu).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with ctypes. Libraries are built at first use
into ``harp_tpu_torch/_build/`` (git-ignored) under a name that hashes the
source and the flags, so an edited source is rebuilt and an unchanged one is
reused. ``build_all`` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG / "_build"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON = ["-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
          "-Xptxas", "-v"]
# No --use_fast_math anywhere. The raster sources must not contract
# a*b - c*d into FMAs: ids have to equal the plain version's exactly.
# Paths are relative to the package.
SOURCES = {
    "raster": ("csrc/raster.cu", ["-fmad=false"]),
    "pcf_scatter": ("csrc/pcf_scatter.cu", []),
    "segment_sum": ("csrc/segment_sum.cu", []),
    "nvjpeg": ("native/frameloader_nvjpeg.cu", ["-lnvjpeg"]),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> tuple[Path, list[str]]:
    src, extra = SOURCES[name]
    path = _PKG / src
    flags = ARCH + COMMON + extra
    h = hashlib.sha256(path.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{h}.so", [str(path)] + flags


def _start(name: str):
    """Start nvcc for `name` unless its library is built; returns
    (lib path, process or None, temp path)."""
    lib, args = _target(name)
    if lib.exists():
        return lib, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([_nvcc(), *args, "-o", str(tmp)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return lib, proc, tmp


def _finish(name: str, lib: Path, proc, tmp) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    return log


def command(name: str) -> str:
    """The nvcc command line that builds `name` (output path elided)."""
    return " ".join([_nvcc(), *_target(name)[1], "-o", "<lib>"])


def build_all() -> dict:
    """Build every library that is missing, one nvcc per source in
    parallel. Returns {"seconds": wall time, "logs": {name: nvcc output}}."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in SOURCES}
    logs = {name: _finish(name, *started[name]) for name in SOURCES}
    return {"seconds": time.perf_counter() - t0, "logs": logs}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    lib, proc, tmp = _start(name)
    _finish(name, lib, proc, tmp)
    return ctypes.CDLL(str(lib))


def check(rc: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
