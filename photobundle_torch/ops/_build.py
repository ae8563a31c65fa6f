"""Build and load the hand-written CUDA kernels in photobundle_torch/csrc.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
into a shared library loaded with ctypes (no PyTorch headers, so a build
takes seconds). The library is built at first use into
`build/torch_kernels/` at the repository root, named by a hash of its
source and flags, so an edited source is rebuilt and a stale binary is
never loaded. Only sources in the checkout are built; no binary is
committed.

This module imports nothing CUDA-specific: the CPU test suite imports every
module, and a build is only attempted when a kernel is launched on a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    log: str          # nvcc / ptxas output of this process's build ("" if
                      # the hash-named library already existed)
    seconds: float    # build time in this process (0.0 if it existed)


_LOADED: dict[str, Built] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of photobundle_torch "
                       "are built from csrc/ with the CUDA toolkit")


def _library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


def build_all(names) -> dict[str, Built]:
    """Build (one `nvcc` per source, all started together) and load every
    `csrc/<name>.cu` of `names`. Each library is loaded once per process;
    a hash-named library that already exists is not rebuilt. A loaded
    library costs one dict lookup (wrappers call this at every launch):
    its source is hashed only when it is first loaded."""
    pending = {}
    for name in names:
        if name in _LOADED:
            continue
        path = _library_path(name)
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        pending[name] = (proc, tmp, path, time.perf_counter())
    logs = {}
    # Every nvcc is waited for before any failure is raised, so none
    # outlives the call.
    for name, (proc, tmp, path, t0) in pending.items():
        out, _ = proc.communicate()
        logs[name] = (out.strip(), time.perf_counter() - t0)
    for name, (proc, tmp, path, t0) in pending.items():
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {CSRC / name}.cu:\n"
                               f"{logs[name][0]}")
        os.replace(tmp, path)    # atomic: concurrent builds never see
                                 # a half-written library
    for name in names:
        if name not in _LOADED:
            path = _library_path(name)
            log, seconds = logs.get(name, ("", 0.0))
            _LOADED[name] = Built(ctypes.CDLL(str(path)), path, log, seconds)
    return {name: _LOADED[name] for name in names}


def library(name: str) -> Built:
    """Build (when its hash-named library is missing) and load
    `csrc/<name>.cu`. Loaded once per process."""
    return build_all([name])[name]
