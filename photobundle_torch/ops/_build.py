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


def library(name: str) -> Built:
    """Build (when its hash-named library is missing) and load
    `csrc/<name>.cu`. Loaded once per process."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"{name}_{digest}.so"
    log, seconds = "", 0.0
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = (proc.stdout + proc.stderr).strip()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {src}:\n{log}")
        os.replace(tmp, path)    # atomic: concurrent builds never see
                                 # a half-written library
    built = Built(ctypes.CDLL(str(path)), path, log, seconds)
    _LOADED[name] = built
    return built
