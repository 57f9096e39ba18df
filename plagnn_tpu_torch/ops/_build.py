"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/<name>_<hash>.so``, a shared
library with a plain C interface, where the hash covers the source, every
shared header ``csrc/*.cuh`` and the flags: a changed source or header
builds anew, an unchanged one loads the library it finds.  Building happens
at first use, so ``python3 chip_smoke.py`` alone builds the kernels;
``build_all`` starts one nvcc per source, all at once.  Only the CUDA
toolkit's own headers are used.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

from ..utils.profiling import span

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("spmm_max_fwd", "spmm_max_bwd", "spmm_sum", "spmm_gat", "pcc_diff_scan",
           "common_neighbors", "dma_ceiling")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build_all(verbose: bool = False) -> Dict[str, str]:
    """Compile every source whose library is missing, one nvcc per source
    in parallel.  Returns {name: compiler output} for what was built
    (``verbose`` adds ptxas' register and spill report); raises if any
    failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC_DIR),
               *(["-Xptxas=-v"] if verbose else []),
               "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use.  A miss
    (the build and the load) is the span ``setup.kernel_load``."""
    lib = _LIBS.get(name)
    if lib is None:
        with span("setup.kernel_load"):
            path = lib_path(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def timed_build(verbose: bool = False):
    """(seconds, logs) for building and loading every kernel library."""
    t0 = time.perf_counter()
    logs = build_all(verbose=verbose)
    for name in SOURCES:
        load(name)
    return time.perf_counter() - t0, logs
