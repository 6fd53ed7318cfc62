"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``, all
at once, and the objects are linked into one shared library with a plain C
interface, which is loaded with ``ctypes``. The library lands in
``build/torch_kernels/`` at the repository root, named by a hash of the
sources and flags, and is built on first use: importing this module builds
nothing, so the package imports on a machine without ``nvcc``.
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"]
# per-source extra flags: the IoU target and the weighted NMS match their
# plain versions operation for operation, so no multiply-add contraction
# there
EXTRA_FLAGS = {"iou_target.cu": ["-fmad=false"], "wnms.cu": ["-fmad=false"]}

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


def _sources(csrc: Path = CSRC):
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def library_path(csrc: Path = CSRC) -> Path:
    h = hashlib.sha256()
    for src in _sources(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(EXTRA_FLAGS.items())).encode())
    return BUILD_DIR / f"libtorch_kernels_{h.hexdigest()[:16]}.so"


def build(csrc: Path = CSRC) -> Path:
    """Compile the sources in ``csrc`` unless a library for this exact
    source hash exists. Returns the library's path."""
    global build_log, build_seconds
    out = library_path(csrc)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in _sources(csrc) if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, *EXTRA_FLAGS.get(src.name, []), "-c",
               "-o", str(obj), str(src)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, proc in jobs:
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    objs = [str(obj) for _, obj, _ in jobs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *objs],
                              capture_output=True, text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Build if needed, load once, and declare every entry point's types."""
    global _lib
    if _lib is None:
        _lib = load_from(CSRC)
    return _lib


def load_from(csrc: Path) -> ctypes.CDLL:
    """Build the sources in ``csrc`` (a variant of csrc/, for a profiling
    tool) and bind them; the package's own library is left as it is. An
    entry point that the variant does not have (an older build's) stays
    unbound."""
    lib = ctypes.CDLL(str(build(csrc)))
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    strides = ctypes.POINTER(ctypes.c_longlong)
    entry_points = {
        "conv3x3_bhcw_fwd": [vp] * 14 + [i32] * 15 + [vp],
        "conv3x3_wgrad": [vp] * 11 + [i32] * 10 + [vp],
        "iou_prep": ([vp, strides] * 2 + [i32] * 3 + [vp] + [i32] * 3
                     + [vp] * 4),
        "iou_clip": ([vp, strides] * 2 + [i32] * 3 + [vp] * 2 + [i32] * 3
                     + [vp] * 2),
        "meta_block_grid": [i32] * 5,
        "meta_block_part_floats": [i32] * 2,
        "meta_stats_fwd": [vp] * 8 + [i32] * 6 + [vp],
        "meta_agg_fwd": [vp] * 10 + [i32] * 6 + [vp],
        "meta_block_bwd": [vp] * 13 + [i32] * 7 + [vp],
        "meta_kernel_taps": [vp] * 7 + [i32] * 6 + [vp],
        "wnms_launch": [vp] * 3 + [i32] * 2 + [f32] * 2 + [i32] * 3
                       + [vp] + [i32] + [vp] * 5,
    }
    for name, argtypes in entry_points.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, i32
    return lib
