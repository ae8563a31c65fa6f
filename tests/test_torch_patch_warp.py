"""The fused patch-stats kernel's module vs the JAX package's Pallas path.

On the CPU the port's `evaluate_compressed(backend="cuda")` runs the
kernel's plain PyTorch version (`ops/patch_warp.patch_stats_reference`);
it is held against the JAX package's `evaluate_compressed(
backend="pallas", interpret=True)`, which runs `_warp_kernel_packed` in
Pallas interpret mode. Tolerances are those of tests/test_patch_stats.py.
The CUDA kernel itself is held against its plain version on a card by
tests/test_torch_cuda.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photobundle_tpu.core import residuals as jres
from photobundle_tpu.image import interp as jinterp
from photobundle_torch.core import residuals as tres
from photobundle_torch.ops import patch_warp as pw

from test_residuals import setup_problem
from torch_parity import assert_fields_close, port_problem, to_np


def multichannel(problem):
    """C = 3 descriptors from shifted copies of the image set (the JAX
    package's test_kernel_multichannel construction)."""
    cam, t_wc, x, patch, ch, g, obs, off = problem
    ch3 = jnp.concatenate([ch, ch * 0.5 + 0.1, ch * 2.0 - 0.3], axis=1)
    gx, gy = jinterp.image_gradients(ch3)
    patch3 = jnp.concatenate([patch, patch * 0.5, patch * 2.0], axis=1)
    return cam, t_wc, x, patch3, ch3, jnp.stack([gx, gy], axis=-1), obs, off


HUBER = 0.07


@functools.partial(jax.jit, static_argnames=("normalize",))
def _pallas(cam, t_wc, x, patch, ch, g, obs, off, prior, normalize):
    depth_prior = None if prior is None else (*prior, 5.0)
    return jres.evaluate_compressed(cam, t_wc, x, patch, ch, g, obs, off,
                                    HUBER, "sampled", depth_prior=depth_prior,
                                    backend="pallas", interpret=True,
                                    normalize=normalize)


def pallas_eval(problem, prior=None, normalize=True):
    """One jitted Pallas-interpret evaluation (compiled once per shape)."""
    if prior is not None:
        prior = tuple(jnp.asarray(a) for a in prior)
    return jax.device_get(_pallas(*problem, prior, normalize))


def port_eval(problem, prior=None, normalize=True):
    cam, t_wc, x, patch, ch, g, obs, off = port_problem(problem)
    if prior is not None:
        prior = (*(torch.as_tensor(a) for a in prior), 5.0)
    return tres.evaluate_compressed(cam, t_wc, x, patch, ch, g, obs, off,
                                    HUBER, "sampled", depth_prior=prior,
                                    backend="cuda", normalize=normalize)


def assert_matches_pallas(out, ref):
    np.testing.assert_array_equal(to_np(out.valid), np.asarray(ref.valid))
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-5)
    assert int(out.n_residuals) == int(ref.n_residuals)
    assert_fields_close(out, ref, ("gtg", "gtr"), atol=1e-4, rtol=1e-4)
    assert_fields_close(out, ref, ("a",), atol=1e-5, rtol=1e-5,
                        equal_nan=True)


@pytest.fixture(scope="module")
def problems():
    """Small problems by patch radius (tests/test_residuals.setup_problem)."""
    rng = np.random.default_rng(0)
    return {r: setup_problem(rng, n_pts=16, w=3, radius=r) for r in (1, 2)}


def variant(problem, channels=1, normalize=True, masked=None, nan_point=None):
    cam, t_wc, x, patch, ch, g, obs, off = (
        multichannel(problem) if channels == 3 else problem)
    if masked is not None:
        obs = obs.at[masked].set(False)
    if not normalize:
        patch = patch + 0.25          # raw (un-normalized) descriptors
    x = x + 0.015
    if nan_point is not None:
        x = x.at[nan_point].set(jnp.nan)
    return cam, t_wc, x, patch, ch, g, obs, off


CASES = {   # radius, channels, normalize, masked observation
    "r1-c1-mean": (1, 1, True, None),
    "r1-c3-off": (1, 3, False, (1, 0)),
    "r2-c1-mean": (2, 1, True, (2, 1)),
    "r2-c1-off": (2, 1, False, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_pallas_kernel_path(problems, case):
    radius, channels, normalize, masked = CASES[case]
    problem = variant(problems[radius], channels, normalize, masked)
    assert_matches_pallas(port_eval(problem, normalize=normalize),
                          pallas_eval(problem, normalize=normalize))


def test_depth_prior_matches_pallas_kernel_path(problems):
    rng = np.random.default_rng(1)
    prior = (rng.integers(0, 3, size=16).astype(np.int32),
             rng.uniform(0.05, 0.4, size=16).astype(np.float32))
    problem = variant(problems[2])
    out, ref = port_eval(problem, prior), pallas_eval(problem, prior)
    assert_matches_pallas(out, ref)
    assert_fields_close(out, ref, ("jp", "rp"), atol=1e-5, rtol=1e-5)
    assert float(to_np(out.rp).__abs__().sum()) > 0


def test_padding_isolation(problems):
    """Stats of the real points are unaffected by extra points that are
    masked out (the JAX package's group-padding test, on the port)."""
    cam, t_wc, x, patch, ch, g, obs, off = port_problem(problems[2])
    x, patch, obs = x[:9], patch[:9], obs[:9]
    kw = dict(huber_delta=0.07, backend="cuda")
    base = tres.evaluate_compressed(cam, t_wc, x, patch, ch, g, obs, off, **kw)
    x2 = torch.cat([x, x[:4] + 50.0])
    patch2 = torch.cat([patch, patch[:4]])
    obs2 = torch.cat([obs, torch.zeros((4, 3), dtype=torch.bool)])
    ext = tres.evaluate_compressed(cam, t_wc, x2, patch2, ch, g, obs2, off,
                                   **kw)
    np.testing.assert_allclose(float(ext.cost), float(base.cost), rtol=1e-6)
    assert torch.equal(ext.gtg[..., :9], base.gtg)
    assert torch.equal(ext.gtr[..., :9], base.gtr)
    assert float(ext.gtg[..., 9:].abs().sum()) == 0.0


def test_nan_observation_is_finite_and_masked(problems):
    """A point with NaN coordinates projects to NaN uv: its observations
    are invalid, their sums exact zeros (never NaN), and every other
    observation matches the Pallas path."""
    problem = variant(problems[2], nan_point=3)
    ref = pallas_eval(problem)
    out = port_eval(problem)
    assert not to_np(out.valid)[3].any()
    for name in ("gtg", "gtr", "jp", "rp"):
        got = to_np(getattr(out, name))
        assert np.isfinite(got).all(), name
        assert (got[..., 3] == 0).all(), name
    assert np.isfinite(float(out.cost))
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-5)
    assert_matches_pallas(out, ref)
    # The plain version itself, fed NaN uv on invalid observations.
    planes = pw.build_planes(*port_problem(problem)[4:6])
    uv = torch.full((2, 3, 2), float("nan"))
    uv[0, 1] = torch.tensor([20.5, 30.25])
    valid = torch.zeros((2, 3), dtype=torch.bool)
    valid[0, 1] = True
    stats = pw.patch_stats(planes, uv, valid, torch.zeros((2, 1, 25)), 2)
    assert torch.isfinite(stats).all()
    assert float(stats[:, 1, 0].abs().sum()) > 0
    assert float(stats.abs().sum() - stats[:, 1, 0].abs().sum()) == 0.0


def test_cpu_tensors_run_the_plain_version(problems, rng):
    cam, t_wc, x, patch, ch, g, obs, off = port_problem(problems[2])
    planes = pw.build_planes(ch[:2], g[:2])
    patch = patch[:6]
    uv = torch.as_tensor(rng.uniform(5.0, 60.0, size=(6, 2, 2)),
                         dtype=torch.float32)
    valid = torch.ones((6, 2), dtype=torch.bool)
    before = dict(pw.patch_stats.launches)
    out = pw.patch_stats(planes, uv, valid, patch, 2, norm="off")
    ref = pw.patch_stats_reference(planes, uv, valid, patch, 2, norm="off")
    assert torch.equal(out, ref)
    assert out.shape == (6, 2, 6)
    assert pw.patch_stats.launches == before


def test_build_planes_layout(rng):
    ch = torch.as_tensor(rng.standard_normal((2, 3, 5, 7)), dtype=torch.float32)
    g = torch.as_tensor(rng.standard_normal((2, 3, 5, 7, 2)),
                        dtype=torch.float32)
    planes = pw.build_planes(ch, g)
    assert planes.shape == (2, 3, 5, 7, 4) and planes.is_contiguous()
    assert torch.equal(planes[..., 0], ch)
    assert torch.equal(planes[..., 1:3], g)
    assert float(planes[..., 3].abs().sum()) == 0.0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    planes = torch.zeros((2, 1, 16, 16, 4))
    uv = torch.zeros((3, 2, 2))
    valid = torch.ones((3, 2), dtype=torch.bool)
    patch = torch.zeros((3, 1, 25))
    pw._check(planes, uv, valid, patch, 2)          # accepted as given
    with pytest.raises(ValueError, match="radius"):
        pw._check(planes, uv, valid, torch.zeros((3, 1, 121)), 5)
    with pytest.raises(ValueError, match="uv"):
        pw._check(planes, uv.double(), valid, patch, 2)
    with pytest.raises(ValueError, match="valid"):
        pw._check(planes, uv, valid[:, :1], patch, 2)
    with pytest.raises(ValueError, match="contiguous"):
        pw._check(planes, uv.transpose(0, 1).contiguous().transpose(0, 1),
                  valid, patch, 2)
    with pytest.raises(ValueError, match="meta"):
        pw.patch_stats(planes.to("meta"), uv, valid, patch, 2)


def test_editing_a_header_renames_the_library(monkeypatch, tmp_path):
    """The library name hashes the source and every csrc/ header it
    includes with quotes (directly or through another header): an edited
    header gives a new name, so a stale library is never loaded."""
    from photobundle_torch.ops import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include <cuda_runtime.h>\n'
                               '#include "outer.cuh"\nint k;\n')
    (csrc / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (csrc / "inner.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [p.name for p in _build._sources("k")] == ["k.cu", "outer.cuh",
                                                      "inner.cuh"]
    before = _build._library_path("k")
    (csrc / "inner.cuh").write_text("// v2\n")
    after = _build._library_path("k")
    assert before != after and after.name.startswith("k_")
    # The port's own kernels hash the shared epilogue header.
    monkeypatch.undo()
    for name in ("patch_warp", "patch_bicubic", "patch_scaled"):
        assert "patch_epilogue.cuh" in [p.name for p in
                                        _build._sources(name)], name


def test_norm_modes_and_launch_counts():
    """The kernels' normalization codes, and the launch counters that a
    CPU call leaves untouched."""
    from photobundle_torch.ops import _common
    from photobundle_torch.ops import patch_scaled as ps

    assert [_common.norm_code(m) for m in _common.NORMS] == [0, 1, 2]
    with pytest.raises(ValueError, match="normalization"):
        _common.norm_code("center")
    planes = torch.zeros((1, 1, 12, 12, 4))
    args = (torch.full((2, 1, 2), 5.5), torch.ones((2, 1)),
            torch.ones((2, 1), dtype=torch.bool), torch.zeros((2, 1, 9)))
    before = dict(ps.scaled_stats.launches)
    for norm in _common.NORMS:
        out = ps.scaled_stats(planes, *args, 1, norm)
        assert out.shape == (6, 1, 2) and torch.isfinite(out).all()
    assert ps.scaled_stats.launches == before
