"""Build and load the port's CUDA kernels.

Each ``<name>.cu`` in this directory is compiled at first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface under
``build/oneshotdet_tpu_torch/`` at the root of the checkout, and loaded with
``ctypes``. The library file name carries a hash of the source and of the
headers of this directory that it includes, so an edited source or header is
rebuilt and a stale library is never loaded. Nothing here is
imported or built when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

SOURCES = ("roi_align", "roi_align_bwd", "roi_head", "group_norm", "roi_align_v3",
           "roi_align_v4")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
# Flags of one source on top of NVCC_FLAGS.
SOURCE_FLAGS = {
    # no contracted multiply-adds: the ROIAlign kernel repeats its plain
    # version's float32 operations in the same order, and equals it exactly
    "roi_align": ("-fmad=false",),
    # the backward's weights and products are the plain version's (only the
    # order of its atomic sums differs)
    "roi_align_bwd": ("-fmad=false",),
    # the same for the cross-ROI variants and GroupNorm: their plain versions
    # repeat the kernels' float32 operations in order
    "roi_align_v3": ("-fmad=false",),
    "roi_align_v4": ("-fmad=false",),
    "group_norm": ("-fmad=false",),
}


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())

_SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = _SRC_DIR.parents[1] / "build" / "oneshotdet_tpu_torch"

_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
            "CUDA kernels are built from source at first use")
    return found


def _library_path(name: str) -> Path:
    src = (_SRC_DIR / f"{name}.cu").read_bytes()
    for header in re.findall(rb'^#include "([\w.]+)"', src, re.M):
        src += (_SRC_DIR / header.decode()).read_bytes()
    digest = hashlib.sha1(src + " ".join(_flags(name)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source that has no current library, one ``nvcc``
    per source, all started together. Returns {name: library path}; the
    compiler's output (``-Xptxas -v``: registers, spills) lands in
    ``build_logs``. Raises if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _library_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(n), "-o", str(tmp), str(_SRC_DIR / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, path)
    failed = []
    for n, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        build_logs[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib
