"""The sample-storing `warp_patches` (K4's row store and K6) and the unfused
solve path (PB_GROUPED_STATS=0) vs the JAX package.

On the CPU the port's `ops/patch_samples.warp_patches` runs its kernel's
plain version (`store_reference`); it is held against the JAX package's
`warp_patches` in Pallas interpret mode, every variant ('rows' `_warp_kernel`,
'packed', 'block' and 'raw' `_warp_kernel_block`), jitted once per shape.
The problem is 10 points x 2 frames on 40x300 images: the Pallas kernels
unroll their loop by the largest power of two that divides N and interpret
mode compiles every copy, so 10 points keep the sixteen compiles cheap.
The CUDA kernel itself is held against its plain version on a card by
tests/test_torch_cuda.py."""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photobundle_tpu.core import residuals as jres
from photobundle_tpu.ops import patch_warp as jpw
from photobundle_torch.core import lm
from photobundle_torch.core import residuals as tres
from photobundle_torch.ops import _build, _common
from photobundle_torch.ops import patch_samples as smp
from photobundle_torch.ops import patch_warp as pw

from test_residuals import setup_problem
from test_torch_patch_warp import HUBER, port_eval, variant
from torch_parity import few_threads, port_problem, to_np  # noqa: F401

N_PTS, W, H, WI = 10, 2, 40, 300


@functools.lru_cache(maxsize=None)
def sample_inputs(radius: int, channels: int):
    """Planes with values in [0, 1) (numpy seed by shape), coordinates
    inside the margins for valid observations and NaN for invalid ones."""
    rng = np.random.default_rng(10 * radius + channels)
    ch = rng.random((W, channels, H, WI), np.float32)
    grads = rng.random((W, channels, H, WI, 2), np.float32)
    lo, hi = max(8.0, radius), max(8.0, radius + 2.0)   # inside the margins
    uv = rng.uniform([lo, lo], [WI - hi, H - hi],
                     size=(N_PTS, W, 2)).astype(np.float32)
    valid = rng.uniform(size=(N_PTS, W)) > 0.25
    valid[0, 0] = False
    uv[~valid] = np.nan
    return ch, grads, uv, valid


@functools.lru_cache(maxsize=None)
def jax_samples(radius: int, channels: int, variant_name: str):
    ch, grads, uv, valid = sample_inputs(radius, channels)
    panels = jpw.build_interleaved_panels(jnp.asarray(ch), jnp.asarray(grads),
                                          radius)
    return jax.device_get(jpw.warp_patches(
        panels, jnp.asarray(uv), jnp.asarray(valid), radius, interpret=True,
        variant=variant_name))


def port_samples(radius: int, channels: int, variant_name: str):
    ch, grads, uv, valid = sample_inputs(radius, channels)
    planes = pw.build_planes(torch.as_tensor(ch), torch.as_tensor(grads))
    return smp.warp_patches(planes, torch.as_tensor(uv),
                            torch.as_tensor(valid), radius, variant_name)


# (radius, channels, variant): every variant at R = 1, 2 and 5 (the first
# radius whose patch rows are a loop in the kernel); 'rows' alone at 10,
# past the kernel's compile-time instances (interpret mode compiles every
# Pallas copy, so the wide case stays small).
SAMPLE_CASES = [(r, c, v) for r in (1, 2, 5) for c in (1, 2)
                for v in smp.VARIANTS] + [(10, 1, "rows")]


@pytest.mark.parametrize("radius,channels,variant_name", SAMPLE_CASES)
def test_samples_match_the_jax_variant(radius, channels, variant_name):
    """Valid observations: the JAX variant's samples within 1e-6 (values
    in [0, 1)). Not bitwise: XLA's CPU code for the interpret-mode kernel
    contracts the four bilinear taps' products and sums into fused
    multiply-adds, while the port rounds every product and sum once (as
    its kernels do, built with -fmad=false), so samples differ by an ulp
    on about a quarter of the pixels. Invalid observations are zeros in
    the port; the TPU kernel stores a clamped window's samples there."""
    _, _, _, valid = sample_inputs(radius, channels)
    ref = jax_samples(radius, channels, variant_name)
    out = port_samples(radius, channels, variant_name)
    p = (2 * radius + 1) ** 2
    for got, want, name in zip(out, ref, ("s", "gx", "gy")):
        assert got.shape == (N_PTS, W, channels, p), name
        got = got.numpy()
        np.testing.assert_allclose(got[valid], np.asarray(want)[valid],
                                   rtol=0, atol=1e-6, err_msg=name)
        assert (got[~valid] == 0).all(), name


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("radius", [1, 2])
def test_variants_are_bitwise_alike(radius, channels):
    """Every store layout gives the same samples, bitwise: 'raw' combines
    the stored window in plain tensor ops in the kernel's tap order."""
    ref = port_samples(radius, channels, "rows")
    for name in smp.VARIANTS[1:]:
        for got, want in zip(port_samples(radius, channels, name), ref):
            assert torch.equal(got, want), name


def test_store_layouts():
    """Each layout's stored tensor: shape, frame-major observations, and
    the raw window's texels (value, d/dx, d/dy) lane-interleaved."""
    ch, grads, uv, valid = sample_inputs(2, 2)
    planes = pw.build_planes(torch.as_tensor(ch), torch.as_tensor(grads))
    uv_t, valid_t = torch.as_tensor(uv), torch.as_tensor(valid)
    m = N_PTS * W
    rows = smp.store_reference(planes, uv_t, valid_t, 2, "rows")
    block = smp.store_reference(planes, uv_t, valid_t, 2, "block")
    raw = smp.store_reference(planes, uv_t, valid_t, 2, "raw")
    assert rows.shape == (2, 5, m, 15) and block.shape == (2, m, 5, 15)
    assert raw.shape == (2, m, 6, 18)
    assert torch.equal(rows.permute(0, 2, 1, 3), block)
    p, f = 3, 1                           # observation f * N + p
    assert valid[p, f]
    x0, y0 = (int(np.floor(v)) - 2 for v in uv[p, f])
    want = planes[f, 1, y0:y0 + 6, x0:x0 + 6, :3].reshape(6, 18)
    assert torch.equal(raw[1, f * N_PTS + p], want)
    assert float(raw[:, 0].abs().sum()) == 0.0          # (0, 0) is invalid


def test_store_takes_the_fixed_grid_radii():
    """The store takes K1's patch radii, the JAX package's fixed-grid
    limit (1..19): the wrapper's check and the kernel's dispatch
    (compile-time instances to pb::kMaxSolveRadius, one runtime-radius
    instance above, up to kMaxFixedRadius) name the same range."""
    assert smp.RADII == _common.FIXED_RADII == tuple(range(1, 20))
    src = (Path(_build.CSRC) / "patch_samples.cu").read_text()
    top = int(re.search(r"constexpr int kMaxFixedRadius = (\d+);",
                        src).group(1))
    assert tuple(range(1, top + 1)) == _common.FIXED_RADII
    assert "pb::dispatch<pb::kMaxSolveRadius, true>" in src
    # The JAX fixed-grid panel has a positive lane stride exactly there.
    for r in _common.FIXED_RADII:
        assert jpw.lane_stride(r) > 0
    with pytest.raises(ValueError):
        jpw.lane_stride(_common.FIXED_RADII[-1] + 1)


def _three_copy_unpack(out, uv, valid, patch_radius, layout):
    """The relayout `unpack` replaced: three strided copies, one per plane
    (patch_warp.py:1122-1124 and :1151-1153)."""
    n, w = valid.shape
    ps = 2 * patch_radius + 1
    c = out.shape[0]
    if layout == "rows":
        out = out.reshape(c, ps, w, n, ps, 3).permute(3, 2, 0, 1, 4, 5)
    else:
        if layout == "raw":
            x = torch.where(valid, uv[..., 0], 0.0)
            y = torch.where(valid, uv[..., 1], 0.0)
            fxm = (x - torch.floor(x)).T.reshape(1, n * w, 1, 1)
            fym = (y - torch.floor(y)).T.reshape(1, n * w, 1, 1)
            out = ((1 - fxm) * (1 - fym) * out[..., :ps, :3 * ps]
                   + fxm * (1 - fym) * out[..., :ps, 3:]
                   + (1 - fxm) * fym * out[..., 1:, :3 * ps]
                   + fxm * fym * out[..., 1:, 3:])
        out = out.reshape(c, w, n, ps, ps, 3).permute(2, 1, 0, 3, 4, 5)
    return tuple(out[..., k].reshape(n, w, c, ps * ps) for k in range(3))


@pytest.mark.parametrize("layout", smp.LAYOUTS)
def test_unpack_is_bitwise_the_three_copy_relayout(layout):
    """`unpack`'s one permute-copy gives the three strided copies' (s, gx,
    gy) bitwise, each contiguous."""
    ch, grads, uv, valid = sample_inputs(2, 2)
    planes = pw.build_planes(torch.as_tensor(ch), torch.as_tensor(grads))
    uv_t, valid_t = torch.as_tensor(uv), torch.as_tensor(valid)
    out = smp.store_reference(planes, uv_t, valid_t, 2, layout)
    got = smp.unpack(out, uv_t, valid_t, 2, layout)
    want = _three_copy_unpack(out, uv_t, valid_t, 2, layout)
    for a, b in zip(got, want):
        assert a.shape == b.shape == (N_PTS, W, 2, 25)
        assert a.is_contiguous() and torch.equal(a, b)


def test_cpu_tensors_run_the_plain_version_and_bad_arguments_raise():
    before = dict(smp.warp_patches.launches)
    port_samples(1, 1, "raw")
    assert smp.warp_patches.launches == before
    assert set(before) == set(smp.LAYOUTS)
    planes = torch.zeros((1, 1, 16, 16, 4))
    args = (torch.zeros((2, 1, 2)), torch.ones((2, 1), dtype=torch.bool))
    with pytest.raises(ValueError, match="variant"):
        smp.warp_patches(planes, *args, 2, "tiles")
    with pytest.raises(ValueError, match="layout"):
        smp.store(planes, *args, 2, "packed")
    with pytest.raises(ValueError, match="meta"):
        smp.warp_patches(planes.to("meta"), *args, 2)
    assert [smp.layout_of(v) for v in smp.VARIANTS] == ["rows", "block",
                                                        "block", "raw"]


# ---------------------------------------------------------------------------
# The unfused solve path: PB_GROUPED_STATS=0
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("normalize",))
def _pallas_ungrouped(cam, t_wc, x, patch, ch, g, obs, off, normalize):
    """The JAX package's unfused branch (residuals.py:812-850); traced
    under PB_GROUPED_STATS=0 only."""
    return jres.evaluate_compressed(cam, t_wc, x, patch, ch, g, obs, off,
                                    HUBER, "sampled", backend="pallas",
                                    interpret=True, normalize=normalize)


@pytest.fixture(scope="module")
def problems():
    rng = np.random.default_rng(0)
    return {r: setup_problem(rng, n_pts=16, w=3, radius=r)
            for r in (1, 2, 5)}


UNGROUPED_CASES = {   # radius, channels, normalize, masked observation
    "r1-c3-mean": (1, 3, True, (1, 0)),
    "r2-c1-mean": (2, 1, True, (2, 1)),
    "r2-c1-off": (2, 1, False, None),
    "r5-c1-mean": (5, 1, True, None),     # a radius K1 rolls its rows at
}


@pytest.mark.parametrize("case", sorted(UNGROUPED_CASES))
def test_ungrouped_evaluation_matches_jax_and_the_fused_path(
        problems, monkeypatch, case):
    """`evaluate_compressed(backend="cuda", grouped_stats=False)` runs the
    row store's path (`_ungrouped_stats`, once) at every radius, and
    matches the JAX package's unfused branch and the port's fused K1 path
    to tests/test_patch_stats.py's tolerances."""
    radius, channels, normalize, masked = UNGROUPED_CASES[case]
    problem = variant(problems[radius], channels, normalize, masked)
    monkeypatch.setenv("PB_GROUPED_STATS", "0")
    ref = jax.device_get(_pallas_ungrouped(*problem, normalize))
    cam, t_wc, x, patch, ch, g, obs, off = port_problem(problem)
    ran = []
    real = tres._ungrouped_stats

    def spy(*args):
        ran.append(args[4])                  # the patch radius
        return real(*args)

    monkeypatch.setattr(tres, "_ungrouped_stats", spy)
    out = tres.evaluate_compressed(cam, t_wc, x, patch, ch, g, obs, off,
                                   HUBER, "sampled", backend="cuda",
                                   normalize=normalize, grouped_stats=False)
    assert ran == [radius]
    fused = port_eval(problem, normalize=normalize)
    for other in (ref, fused):
        np.testing.assert_array_equal(to_np(out.valid), to_np(other.valid))
        np.testing.assert_allclose(float(out.cost), float(other.cost),
                                   rtol=1e-5)
        for name in ("gtg", "gtr"):
            np.testing.assert_allclose(to_np(getattr(out, name)),
                                       to_np(getattr(other, name)),
                                       atol=1e-4, rtol=1e-4, err_msg=name)
    assert int(out.n_residuals) == int(ref.n_residuals)


def test_grouped_stats_flag_leaves_other_configurations_fused(problems):
    """Affine normalization and bicubic sampling keep their fused kernels
    under grouped_stats=False: bitwise the default evaluation."""
    cam, t_wc, x, patch, ch, g, obs, off = port_problem(problems[2])
    for kw in (dict(normalize="affine"), dict(gradient_mode="bicubic")):
        a, b = (tres.evaluate_compressed(cam, t_wc, x, patch, ch, g, obs,
                                         off, HUBER, backend="cuda",
                                         grouped_stats=flag, **kw)
                for flag in (True, False))
        assert torch.equal(a.gtg, b.gtg) and torch.equal(a.gtr, b.gtr), kw


def test_lm_solve_reads_pb_grouped_stats(problems, monkeypatch):
    """lm_solve with PB_GROUPED_STATS=0 runs the unfused path (the row
    store, `smp.store`, once per evaluation, its rows unpacked as
    `warp_patches` unpacks them): the same iterations and accepted steps
    as the fused solve on a damped start, costs within 1e-4 (f32 sums in
    another order)."""
    cam, t_wc, x, patch, ch, g, obs, off = port_problem(problems[2])
    pv = torch.ones(obs.shape[0], dtype=torch.bool)
    frozen = torch.tensor([True, False, False])
    kw = dict(huber_delta=HUBER, backend="cuda", max_iterations=3,
              initial_lambda=1.0, function_tolerance=0.0,
              parameter_tolerance=0.0)
    calls = []
    real = smp.store

    def counted(*args, **kwargs):
        calls.append(kwargs.get("layout", args[4] if len(args) > 4 else
                                "rows"))
        return real(*args, **kwargs)

    _, _, fused = lm.lm_solve(cam, t_wc, x + 0.01, patch, ch, g, obs, pv,
                              frozen, off, **kw)
    monkeypatch.setattr(smp, "store", counted)
    assert not calls
    monkeypatch.setenv("PB_GROUPED_STATS", "0")
    _, _, unfused = lm.lm_solve(cam, t_wc, x + 0.01, patch, ch, g, obs, pv,
                                frozen, off, **kw)
    assert calls == ["rows"] * (int(unfused.iterations) + 1)
    assert int(unfused.iterations) == int(fused.iterations) == 3
    assert torch.equal(unfused.accept_log, fused.accept_log)
    np.testing.assert_allclose(to_np(unfused.cost_log), to_np(fused.cost_log),
                               rtol=1e-4)
