"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, which is loaded with ``ctypes``.
The library lands in ``build/torch_kernels/`` at the repository root, named
by a hash of the sources, and is built on first use: importing this module
builds nothing, so the package imports on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib: Optional[ctypes.CDLL] = None
# what the last build printed (ptxas registers / shared memory per kernel)
# and how long it took; empty when the library came from an earlier build
build_log = ""
build_seconds = 0.0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path})")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtorch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for this exact source hash
    exists. Returns the library's path."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cus = [str(s) for s in _sources() if s.suffix == ".cu"]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *cus],
        capture_output=True, text=True,
    )
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Build if needed, load once, and declare every entry point's types."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.conv3x3_bhcw_fwd.argtypes = [vp] * 5 + [i32] * 7 + [vp]
    lib.conv3x3_bhcw_fwd.restype = i32
    _lib = lib
    return lib
