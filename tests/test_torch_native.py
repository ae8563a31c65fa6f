"""The port's native host runtime (photobundle_torch/native) against the JAX
package's (photobundle_tpu/native), the twin of tests/test_native.py.

Both packages build one source (the port's copy equals the JAX package's
byte for byte) with one flag set, each into its own library, so their
functions agree bitwise on the same inputs; the port's speckle filter
equals its pure-Python one (io/speckle.py); the port's dataset takes the
producer each dataLoader mode names; concurrent processes build one
library without loading a half-written one."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from photobundle_tpu import native as jnative
from photobundle_tpu.config import PBAConfig as JConfig
from photobundle_tpu.io import kitti as jkitti
from photobundle_torch import native
from photobundle_torch.config import PBAConfig
from photobundle_torch.image import stereo
from photobundle_torch.io import kitti, png
from photobundle_torch.io.speckle import speckle_filter_numpy

from synthetic import write_kitti_dataset
from test_native import _stereo_pair
from torch_parity import few_threads  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def runtimes():
    """Both packages' runtimes, built (skips with the reason where the
    toolchain cannot build them)."""
    for mod in (native, jnative):
        if not mod.available():
            pytest.skip(f"{mod.__name__} did not build: {mod.build_error()}")


def test_source_is_the_jax_copy():
    port = REPO / "photobundle_torch" / "native" / "pb_native.cpp"
    ref = REPO / "photobundle_tpu" / "native" / "pb_native.cpp"
    assert port.read_bytes() == ref.read_bytes()
    assert native.SOURCE == port
    assert native.library_path().parent == REPO / "build" / "native"


def test_png_decode_matches_jax(runtimes, tmp_path, rng):
    arr = rng.integers(0, 256, (37, 61), dtype=np.uint8)
    path = str(tmp_path / "g.png")
    png.write_png_gray(path, arr)
    assert native.png_size(path) == arr.shape
    img = native.imread_gray(path)
    np.testing.assert_array_equal(img, jnative.imread_gray(path))
    np.testing.assert_allclose(img, arr.astype(np.float32) / 255.0,
                               atol=1e-7)
    np.testing.assert_allclose(img, kitti._imread_gray(path), atol=1e-7)


MATCHERS = {
    "bm": ("block_match", dict(num_disparities=24, min_disparity=1,
                               sad_radius=3)),
    "bm prefilter": ("block_match", dict(num_disparities=24,
                                         min_disparity=1, sad_radius=3,
                                         prefilter_cap=0.12)),
    "sgbm": ("semi_global_match", dict(num_disparities=24, min_disparity=1,
                                       sad_radius=2)),
}


@pytest.mark.parametrize("case", sorted(MATCHERS))
def test_matchers_equal_jax(runtimes, rng, case):
    """BM, BM on the X-Sobel prefiltered pair, and SGM: bitwise the JAX
    package's native functions, and near the true disparity."""
    name, kw = MATCHERS[case]
    left, right = _stereo_pair(rng)
    d, v = getattr(native, name)(left, right, **kw)
    jd, jv = getattr(jnative, name)(left, right, **kw)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(d, jd)
    assert v.mean() > 0.2
    assert abs(np.median(d[v]) - 7.3) < 0.5


def test_block_match_agrees_with_the_torch_matcher(runtimes, rng):
    """The native BM against the port's torch matcher (the other producer):
    the agreement tests/test_native.py asks of the JAX matcher."""
    import torch

    left, right = _stereo_pair(rng)
    kw = dict(num_disparities=24, min_disparity=1, sad_radius=3)
    d, v = native.block_match(left, right, **kw)
    dt, vt = stereo.block_match(torch.as_tensor(left),
                                torch.as_tensor(right), **kw)
    dt, vt = dt.numpy(), vt.numpy()
    assert (v == vt).mean() > 0.995
    both = v & vt
    assert both.sum() > 0.25 * both.size
    np.testing.assert_allclose(d[both], dt[both], atol=5e-3)


def test_prefilter_matches_jax_and_torch(runtimes, rng):
    import torch

    left, _ = _stereo_pair(rng)
    got = native.prefilter_xsobel(left, 0.12)
    np.testing.assert_array_equal(got, jnative.prefilter_xsobel(left, 0.12))
    np.testing.assert_allclose(
        got, stereo.prefilter_xsobel(torch.as_tensor(left), 0.12).numpy(),
        atol=1e-6)


def test_speckle_filter_equals_python_and_jax(runtimes, rng):
    """The native filter makes the pure-Python filter's decisions
    (io/speckle.py), bitwise, and the JAX package's native filter's."""
    h, w = 48, 72
    disp = (10.0 + np.cumsum(rng.normal(0, 0.3, (h, w)), axis=1)).astype(
        np.float32)
    valid = rng.random((h, w)) > 0.15
    disp[~valid] = 0.0
    kw = dict(max_diff=0.8, min_region=20)
    d, v = native.speckle_filter(disp, valid, **kw)
    for ref in (speckle_filter_numpy(disp, valid, **kw),
                native.speckle_filter_numpy(disp, valid, **kw),
                jnative.speckle_filter(disp, valid, **kw)):
        np.testing.assert_array_equal(v, ref[1])
        np.testing.assert_array_equal(d, ref[0])
    assert 0 < v.sum() < valid.sum()


def _write_pairs(tmp_path, rng, n, h=48, w=80):
    lefts, rights = [], []
    for i in range(n):
        left, right = _stereo_pair(rng, h, w, disp=5.0 + 0.3 * i)
        lp, rp = str(tmp_path / f"l{i}.png"), str(tmp_path / f"r{i}.png")
        png.write_png_gray(lp, np.clip(left * 255, 0, 255).astype(np.uint8))
        png.write_png_gray(rp, np.clip(right * 255, 0, 255).astype(np.uint8))
        lefts.append(lp)
        rights.append(rp)
    return lefts, rights


def test_prefetching_loader_with_seek_equals_jax(runtimes, tmp_path, rng):
    """The pipeline's frames, read in order and after a seek, equal the
    JAX package's loader's bitwise, with depth where the disparity is."""
    n = 6
    lefts, rights = _write_pairs(tmp_path, rng, n)
    kw = dict(num_disparities=16, min_disparity=1, sad_radius=3,
              uniqueness_ratio=0.97, texture_threshold=0.02, fx=100.0,
              baseline=0.5, min_depth=0.5, max_depth=100.0, n_threads=2,
              prefetch_ahead=2, speckle_size=20, speckle_range=1.0)
    ref = jnative.PrefetchingLoader(lefts, rights, **kw)
    want = [ref.get(i) for i in range(n)]
    ref.close()
    loader = native.PrefetchingLoader(lefts, rights, **kw)
    assert loader.shape == (48, 80) and len(loader) == n
    for i in range(n):
        for got, exp in zip(loader.get(i), want[i]):
            np.testing.assert_array_equal(got, exp)
        img, depth, ok = want[i]
        assert ok.any()
        expected = 50.0 / (5.0 + 0.3 * i)
        assert abs(np.median(depth[ok]) - expected) / expected < 0.2
    loader.close()
    resumed = native.PrefetchingLoader(lefts, rights, **kw)
    resumed.seek(4)
    for i in range(4, n):
        for got, exp in zip(resumed.get(i), want[i]):
            np.testing.assert_array_equal(got, exp)
    resumed.close()


DATASET = dict(sequence=0, numDisparities=32, sadWindowSize=5,
               minDepth=0.5, maxDepth=60.0, speckleWindowSize=30)


def _dataset(root, device="cpu", **kw):
    return kitti.create_dataset(PBAConfig(dataDir=root, **dict(DATASET,
                                                               **kw)),
                                device=device)


@pytest.mark.parametrize("mode,producer", [("native", "native"),
                                           ("auto", "native"),
                                           ("python", "torch")])
def test_data_loader_takes_its_producer(runtimes, tmp_path, rng, mode,
                                        producer):
    """dataLoader=native and auto take the native runtime where it builds
    (its frames bitwise the JAX package's native dataset's); python takes
    the torch matcher, whose speckle filter is the native one. The depth
    cache key names the producer."""
    root = str(tmp_path)
    write_kitti_dataset(root, 0, rng, n_frames=2, shape=(64, 96))
    ds = _dataset(root, dataLoader=mode,
                  depthCacheDir=str(tmp_path / "cache"))
    assert ds.producer == producer
    assert (ds._native is not None) == (producer == "native")
    assert f"_{producer}_" in os.path.basename(ds._cache_dir)
    frames = [ds.get_frame(i) for i in range(2)]
    jds = jkitti.create_dataset(JConfig(dataDir=root, dataLoader=mode,
                                        **DATASET))
    for f, jf in zip(frames, (jds.get_frame(i) for i in range(2))):
        assert f.depth_valid.any()
        if producer == "native":
            np.testing.assert_array_equal(f.image, jf.image)
            np.testing.assert_array_equal(f.depth, jf.depth)
            np.testing.assert_array_equal(f.depth_valid, jf.depth_valid)
    if producer == "torch":
        # The matcher path's native speckle filter is the Python one's.
        calls = []
        speckle = ds._speckle_filter

        def python_filter(disp, valid):
            calls.append(1)
            got = speckle(disp, valid)
            want = speckle_filter_numpy(disp, valid, max_diff=1.0,
                                        min_region=30)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            return got

        ds._speckle_filter = python_filter
        ds._cache_dir = None
        ds.get_frame(0)
        assert calls == [1]


def test_auto_without_the_runtime_takes_the_torch_matcher(tmp_path, rng,
                                                          monkeypatch):
    """Where the runtime does not build, auto takes the torch producer and
    the pure-Python speckle filter (logged once), and native raises with
    the build error (tests/test_torch_io.py::test_native_data_loader_raises
    checks the message)."""
    root = str(tmp_path)
    write_kitti_dataset(root, 0, rng, n_frames=2, shape=(48, 64))
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "build_error", lambda: "no g++ here")
    ds = _dataset(root, dataLoader="auto")
    assert ds.producer == "torch" and ds._native is None
    f = ds.get_frame(0)
    assert f.depth_valid.any() and ds._warned_speckle
    with pytest.raises(RuntimeError, match="no g\\+\\+ here"):
        _dataset(root, dataLoader="native")


def test_concurrent_builds_load_one_library(tmp_path):
    """Three processes that build the runtime into one empty directory at
    once: one compiles under the lock, the others wait and load the same
    finished library; no partial file is left."""
    script = ("import pathlib, sys\n"
              "from photobundle_torch import native\n"
              "native.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
              "assert native.available(), native.build_error()\n"
              "print(native.library_path())\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=str(tmp_path))
             for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    lib = pathlib.Path(paths.pop()).name
    assert {p.name for p in tmp_path.iterdir()} == {lib, f"{lib}.lock"}
