"""ctypes bindings for the native host runtime (pb_native.cpp).

The port's copy of photobundle_tpu/native: `pb_native.cpp` is that
package's source, byte for byte, and this module binds the same C
functions with the same Python API (PNG decode, block matching, 4-path
SGM, the X-Sobel prefilter, the speckle filter and the prefetching
decode + stereo + depth pipeline). It imports nothing of the JAX package.

The shared library is built at first use with the system toolchain (g++,
libpng, zlib, OpenMP) and the JAX package's flags into `build/native/` at
the repository root, named by a hash of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded. The build
runs under a file lock and ends with an atomic rename: concurrent
processes (test workers, several runs of the command line) never load a
half-written library. The library is built with -march=native for the
machine that builds it: never copy `build/native/` to another machine.
Everything here is host-side I/O and preprocessing; the solve stays on
the card.
Callers must tolerate `available() == False` (a missing toolchain or
libpng) and take the Python path, as the JAX package's callers do.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("pb_native.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
             "-std=c++17")
LIBS = ("-lpng", "-lz", "-lpthread")

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libpb_native_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> str | None:
    """Build the library at `path` unless it exists; None, or the error."""
    if path.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{path.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)     # one process builds, others wait
        if path.exists():
            return None
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LIBS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except Exception as e:  # toolchain missing
            return f"{type(e).__name__}: {e}"
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            return proc.stderr[-2000:]
        os.replace(tmp, path)
    return None


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        path = library_path()
        _build_error = _build(path)
        if _build_error is not None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            _build_error = f"OSError: {e}"
            return None
        lib.pb_png_size.argtypes = [ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)]
        lib.pb_png_size.restype = ctypes.c_int
        lib.pb_png_read_gray.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int]
        lib.pb_png_read_gray.restype = ctypes.c_int
        lib.pb_block_match.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)]
        lib.pb_block_match.restype = ctypes.c_int
        lib.pb_prefilter_xsobel.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_float]
        lib.pb_prefilter_xsobel.restype = ctypes.c_int
        lib.pb_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int]
        lib.pb_loader_create.restype = ctypes.c_void_p
        lib.pb_speckle_filter.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int]
        lib.pb_speckle_filter.restype = ctypes.c_int
        lib.pb_sgbm.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8)]
        lib.pb_sgbm.restype = ctypes.c_int
        lib.pb_loader_get.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)]
        lib.pb_loader_get.restype = ctypes.c_int
        lib.pb_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.pb_loader_destroy.restype = None
        lib.pb_loader_seek.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.pb_loader_seek.restype = None
        lib.pb_omp_max_threads.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the runtime built and loaded (builds it at the first call)."""
    return _load() is not None


def build_error() -> str | None:
    """Why the runtime is unavailable (None where it loaded)."""
    _load()
    return _build_error


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def png_size(path: str) -> tuple[int, int]:
    """(height, width) of a PNG file."""
    lib = _load()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.pb_png_size(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if rc:
        raise IOError(f"pb_png_size({path}) -> {rc}")
    return h.value, w.value


def imread_gray(path: str) -> np.ndarray:
    """float32 grayscale in [0, 1] of a PNG file (libpng decode)."""
    lib = _load()
    h, w = png_size(path)
    out = np.empty((h, w), np.float32)
    rc = lib.pb_png_read_gray(path.encode(), _fptr(out), w, h)
    if rc:
        raise IOError(f"pb_png_read_gray({path}) -> {rc}")
    return out


def prefilter_xsobel(img: np.ndarray, cap: float) -> np.ndarray:
    """cv::StereoBM PREFILTER_XSOBEL analog; the kernel of
    image/stereo.prefilter_xsobel."""
    lib = _load()
    img = np.ascontiguousarray(img, np.float32)
    h, w = img.shape
    out = np.empty((h, w), np.float32)
    rc = lib.pb_prefilter_xsobel(_fptr(img), _fptr(out), h, w, cap)
    if rc:
        raise RuntimeError(f"pb_prefilter_xsobel -> {rc}")
    return out


def _match_inputs(left, right, prefilter_cap: float):
    left = np.ascontiguousarray(left, np.float32)
    right = np.ascontiguousarray(right, np.float32)
    if prefilter_cap > 0.0:
        left = prefilter_xsobel(left, prefilter_cap)
        right = prefilter_xsobel(right, prefilter_cap)
    return left, right


def semi_global_match(left: np.ndarray, right: np.ndarray, *,
                      num_disparities: int = 64, min_disparity: int = 1,
                      sad_radius: int = 2, p1: float = 0.03, p2: float = 0.4,
                      uniqueness_ratio: float = 0.97,
                      texture_threshold: float = 0.02,
                      prefilter_cap: float = 0.0):
    """OpenMP 4-path SGM; the semantics of image/stereo.semi_global_match.
    Returns (disparity (H, W) f32, validity (H, W) bool)."""
    lib = _load()
    left, right = _match_inputs(left, right, prefilter_cap)
    h, w = left.shape
    disp = np.empty((h, w), np.float32)
    valid = np.empty((h, w), np.uint8)
    rc = lib.pb_sgbm(
        _fptr(left), _fptr(right), h, w, num_disparities, min_disparity,
        sad_radius, p1, p2, uniqueness_ratio, texture_threshold, _fptr(disp),
        _u8ptr(valid))
    if rc:
        raise RuntimeError(f"pb_sgbm -> {rc}")
    return disp, valid.astype(bool)


def block_match(left: np.ndarray, right: np.ndarray, *,
                num_disparities: int = 64, min_disparity: int = 1,
                sad_radius: int = 4, uniqueness_ratio: float = 0.97,
                texture_threshold: float = 0.02,
                prefilter_cap: float = 0.0):
    """OpenMP SAD block matcher; the semantics of image/stereo.block_match.
    Returns (disparity (H, W) f32, validity (H, W) bool)."""
    lib = _load()
    left, right = _match_inputs(left, right, prefilter_cap)
    h, w = left.shape
    disp = np.empty((h, w), np.float32)
    valid = np.empty((h, w), np.uint8)
    rc = lib.pb_block_match(
        _fptr(left), _fptr(right), h, w, num_disparities, min_disparity,
        sad_radius, uniqueness_ratio, texture_threshold, _fptr(disp),
        _u8ptr(valid))
    if rc:
        raise RuntimeError(f"pb_block_match -> {rc}")
    return disp, valid.astype(bool)


def speckle_filter(disp: np.ndarray, valid: np.ndarray, *,
                   max_diff: float = 1.0, min_region: int = 50):
    """cv::filterSpeckles: invalidate connected disparity components
    smaller than `min_region` pixels (on copies; returns the filtered
    (disparity, validity)). The traversal of `speckle_filter_numpy`."""
    lib = _load()
    disp = np.ascontiguousarray(disp, np.float32).copy()
    valid = np.ascontiguousarray(valid, np.uint8).copy()
    h, w = disp.shape
    lib.pb_speckle_filter(_fptr(disp), _u8ptr(valid), h, w, max_diff,
                          min_region)
    return disp, valid.astype(bool)


def speckle_filter_numpy(disp: np.ndarray, valid: np.ndarray, *,
                         max_diff: float = 1.0, min_region: int = 50):
    """The pure-Python speckle filter (io/speckle.py), for where the
    runtime is unavailable: the same decisions, bitwise."""
    from ..io.speckle import speckle_filter_numpy as python_filter

    return python_filter(disp, valid, max_diff=max_diff,
                         min_region=min_region)


class PrefetchingLoader:
    """Threaded decode + stereo + depth pipeline over a frame list.

    Workers stay `prefetch_ahead` frames in front of the consumer, so PNG
    decode and block matching for frame t+1..t+k overlap the solver's work
    on frame t."""

    def __init__(self, left_paths, right_paths, *, num_disparities: int,
                 min_disparity: int, sad_radius: int,
                 uniqueness_ratio: float, texture_threshold: float,
                 fx: float, baseline: float, min_depth: float,
                 max_depth: float, n_threads: int = 2,
                 prefetch_ahead: int = 4, algorithm: str = "BM",
                 speckle_size: int = 0, speckle_range: float = 1.0,
                 prefilter_cap: float = 0.0):
        self._handle = None
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        if len(left_paths) != len(right_paths):
            raise ValueError(f"{len(left_paths)} left images but "
                             f"{len(right_paths)} right images")
        self._n = len(left_paths)
        self.shape = png_size(left_paths[0])
        h, w = self.shape
        self._lbuf = (ctypes.c_char_p * self._n)(
            *[p.encode() for p in left_paths])
        self._rbuf = (ctypes.c_char_p * self._n)(
            *[p.encode() for p in right_paths])
        algo = 1 if algorithm.upper() == "SGBM" else 0
        self._handle = lib.pb_loader_create(
            self._lbuf, self._rbuf, self._n, h, w, num_disparities,
            min_disparity, sad_radius, algo, uniqueness_ratio,
            texture_threshold, speckle_size, speckle_range, prefilter_cap,
            fx, baseline, min_depth, max_depth, n_threads, prefetch_ahead)
        self._lib = lib

    def __len__(self):
        return self._n

    def seek(self, i: int):
        """Resume support: skip production of frames before i."""
        self._lib.pb_loader_seek(self._handle, i)

    def get(self, i: int):
        """(image, depth, depth_valid) for frame i; blocks until ready."""
        h, w = self.shape
        img = np.empty((h, w), np.float32)
        depth = np.empty((h, w), np.float32)
        ok = np.empty((h, w), np.uint8)
        rc = self._lib.pb_loader_get(self._handle, i, _fptr(img),
                                     _fptr(depth), _u8ptr(ok))
        if rc:
            raise IOError(f"frame {i} failed to load (status {rc})")
        return img, depth, ok.astype(bool)

    def close(self):
        if self._handle:
            self._lib.pb_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
