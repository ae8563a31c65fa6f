"""The batch axes of the batched window solve's other kernels: K2, K3/K5,
K4's row store and sorted K1 (K1's own is in tests/test_torch_batched.py).

- Each kernel's plain version with a leading batch axis (what its wrapper
  runs on CPU tensors) is the stacked single-window calls, bitwise, at
  R = 1, 2, 4 in every normalization.
- The batched plain versions against `jax.vmap` of the JAX kernels in
  Pallas interpret mode (`warp_patches_bicubic`,
  `warp_patches_grouped_scaled`, `warp_patches_scaled`, `warp_patches`
  variant 'rows', `warp_patches_grouped` with sort_reuse=True), within
  the tolerances of each kernel's unbatched parity test.
- The batched solve (`lm.lm_solve_batched`) in the five configurations
  whose kernel is not K1: each window bitwise its own `lm_solve`, the
  configuration's kernel wrapper called once per evaluation with the
  three windows on its batch axis, and no wrapper called per window.
- One batched window solve from carried state with reference_exact's
  kernel (interpolation='bicubic') and with patchWarp='scale', against
  `jax.vmap` of the JAX engine's `_optimize_impl`, at the bounds of the
  configuration's unbatched parity test.

The CUDA kernels' batch axes are held bitwise to single-window launches on
a card by chip_smoke.py (phase 16).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photobundle_tpu.core import residuals as jres
from photobundle_tpu.core.engine import PhotometricBundleAdjustment as JPBA
from photobundle_tpu.ops import patch_warp as jpw
from photobundle_torch import convert
from photobundle_torch.core import lm as tlm
from photobundle_torch.core import residuals as tres
from photobundle_torch.core.batched import (
    BatchedPhotometricBundleAdjustment as BPBA)
from photobundle_torch.image import patches as tpatches
from photobundle_torch.ops import _common
from photobundle_torch.ops import patch_bicubic as pb
from photobundle_torch.ops import patch_samples as smp
from photobundle_torch.ops import patch_scaled as ps
from photobundle_torch.ops import patch_warp as pw

from synthetic import make_sequence, perturb_poses
from test_engine import small_cfg
from test_torch_engine import without_observations_at_margins
from test_torch_warp import scaled_margin_near
from torch_parity import few_threads  # noqa: F401  (module fixture)
from torch_parity import EngineTrace, port_camera, port_config

B, W, N, C, H, WI = 3, 3, 10, 2, 24, 40


def _windows(seed: int, radius: int, warped: bool = False):
    """B windows' sampling inputs of one shape, as numpy arrays from a
    seed: channels (B, W, C, H, Wi) in [0, 1), gradients, uv inside every
    kernel's margins (the warped grid's at rho <= 2), ragged validity
    with NaN coordinates where invalid, descriptors, scales rho in
    [0.5, 2] and a sort key per window."""
    rng = np.random.default_rng(seed)
    ch = rng.random((B, W, C, H, WI), dtype=np.float32)
    gr = 0.1 * rng.standard_normal((B, W, C, H, WI, 2), dtype=np.float32)
    lo = np.float32(2 * radius + 2 if warped else radius + 2)
    hi = np.array([WI, H], np.float32) - lo - 1
    uv = lo + rng.random((B, N, W, 2), dtype=np.float32) * (hi - lo)
    valid = rng.random((B, N, W)) > 0.2
    uv[~valid] = np.nan
    patch = rng.random((B, N, C, (2 * radius + 1) ** 2), dtype=np.float32)
    rho = rng.uniform(0.5, 2.0, (B, N, W)).astype(np.float32)
    key = rng.integers(0, 6, (B, N))                  # ties included
    return ch, gr, uv, valid, patch, rho, key


def _port(arrays):
    ch, gr, uv, valid, patch, rho, key = map(torch.as_tensor, arrays)
    planes = pw.build_planes(ch, gr)
    return ch, planes, uv, valid, patch, rho, key


def _order(key):
    """(feed, inverse) of each window, stacked (B, N)."""
    feed, inverse = zip(*(tres.sorted_dispatch_order(k) for k in key))
    return torch.stack(feed), torch.stack(inverse)


def _plain(kernel, radius, norm, inputs):
    """(the batched plain version, the B single calls stacked, the
    wrapper's batched call) of `kernel` on B windows' inputs."""
    ch, planes, uv, valid, patch, rho, key = inputs
    if kernel == "bicubic":
        args = (pb.build_value_planes(ch), uv, valid, patch)
        plain = functools.partial(pb.bicubic_stats_reference, *args, radius,
                                  norm)
        wrapped = functools.partial(pb.bicubic_stats, *args, radius, norm)
        single = lambda k: pb.bicubic_stats_reference(  # noqa: E731
            *(a[k] for a in args), radius, norm)
    elif kernel == "scaled":
        args = (planes, uv, rho, valid, patch)
        plain = functools.partial(ps.scaled_stats_reference, *args, radius,
                                  norm)
        wrapped = functools.partial(ps.scaled_stats, *args, radius, norm)
        single = lambda k: ps.scaled_stats_reference(  # noqa: E731
            *(a[k] for a in args), radius, norm)
    elif kernel == "rows":
        args = (planes, uv, valid)
        plain = functools.partial(smp.store_reference, *args, radius, norm)
        wrapped = functools.partial(smp.store, *args, radius, norm)
        single = lambda k: smp.store_reference(  # noqa: E731
            *(a[k] for a in args), radius, norm)
    else:
        args = (planes, uv, valid, patch)
        order = _order(key)
        plain = functools.partial(pw.sorted_patch_stats_reference, *args,
                                  radius, order, norm)
        wrapped = functools.partial(pw.sorted_patch_stats, *args, radius,
                                    order, norm)
        single = lambda k: pw.sorted_patch_stats_reference(  # noqa: E731
            *(a[k] for a in args), radius, tuple(o[k] for o in order), norm)
    return plain(), torch.stack([single(k) for k in range(B)]), wrapped()


STACKED_CASES = [(k, r, m) for k in ("bicubic", "scaled", "sorted")
                 for r in (1, 2, 4) for m in _common.NORMS] + [
                     ("rows", r, "rows") for r in (1, 2, 4)]


@pytest.mark.parametrize("kernel,radius,norm", STACKED_CASES)
def test_batched_plain_version_is_stacked_singles(kernel, radius, norm):
    """The plain version with a leading batch axis equals B stacked single
    calls, bitwise; the wrapper runs it on CPU tensors."""
    inputs = _port(_windows(radius, radius, warped=kernel == "scaled"))
    got, singles, wrapped = _plain(kernel, radius, norm, inputs)
    assert got.shape[0] == B
    assert torch.equal(got, singles)
    assert torch.equal(wrapped, singles)
    assert bool(torch.isfinite(got).all())


# ---------------------------------------------------------------------------
# Against jax.vmap of the JAX kernels in interpret mode
# ---------------------------------------------------------------------------

def _stats_of(s, gx, gy, patch, valid, norm):
    """(6, W, N) sums of JAX samples through the port's plain epilogue."""
    t = (torch.as_tensor(np.array(a)) for a in (s, gx, gy))
    return _common.stats_from_samples(*t, torch.as_tensor(patch),
                                      torch.as_tensor(valid), norm)


@functools.partial(jax.jit, static_argnames=("pr",))
def _jax_bicubic(ch, uv, valid, pr):
    def one(c, q, v):
        return jpw.warp_patches_bicubic(jpw.build_value_panels(c, pr), q, v,
                                        pr, interpret=True)
    return jax.vmap(one)(ch, uv, valid)


@functools.partial(jax.jit, static_argnames=("pr",))
def _jax_scaled(ch, gr, uv, rho, valid, pr):
    def one(c, g, q, r, v):
        panels = jpw.build_interleaved_panels(c, g, pr,
                                              win_px=jpw.scaled_win_px(pr))
        return jpw.warp_patches_scaled(panels, q, r, v, pr, interpret=True)
    return jax.vmap(one)(ch, gr, uv, rho, valid)


def _six(gtg, gtr, rr):
    return jnp.stack([gtg[:, 0, 0], gtg[:, 0, 1], gtg[:, 1, 1], gtr[:, 0],
                      gtr[:, 1], rr])


@functools.partial(jax.jit, static_argnames=("pr", "norm"))
def _jax_grouped_scaled(ch, gr, uv, rho, valid, patch, pr, norm):
    n = uv.shape[1]

    def one(c, g, q, r, v, d):
        panels = jpw.build_interleaved_panels(c, g, pr,
                                              win_px=jpw.scaled_win_px(pr))
        _, _, _, n_pad = jpw.packed_geometry(n, pr)
        packed, n_pad = jpw.warp_patches_grouped_scaled(
            panels, q, r, v, pr, interpret=True,
            dpack=jres._pack_descriptors(d, pr, n_pad),
            center=norm == "mean", fuse_stats=True)
        return _six(*jres._grouped_stats(packed, n, n_pad, pr, norm))
    return jax.vmap(one)(ch, gr, uv, rho, valid, patch)


@functools.partial(jax.jit, static_argnames=("pr",))
def _jax_rows(ch, gr, uv, valid, pr):
    def one(c, g, q, v):
        return jpw.warp_patches(jpw.build_interleaved_panels(c, g, pr), q, v,
                                pr, interpret=True, variant="rows")
    return jax.vmap(one)(ch, gr, uv, valid)


@functools.partial(jax.jit, static_argnames=("pr", "norm"))
def _jax_sorted(ch, gr, uv, valid, patch, key, pr, norm):
    n = uv.shape[1]

    def one(c, g, q, v, d, k):
        panels = jpw.build_interleaved_panels(c, g, pr)
        feed, unscatter, row_valid = jres.sorted_dispatch_order(k, n, pr)
        _, _, _, n_pad = jpw.packed_geometry(n, pr)
        packed, _ = jpw.warp_patches_grouped(
            panels, jnp.take(q, feed, axis=0),
            jnp.take(v, feed, axis=0) & row_valid[:, None], pr,
            interpret=True,
            dpack=jres._pack_descriptors(jnp.take(d, feed, axis=0), pr,
                                         n_pad),
            center=norm == "mean", fuse_stats=True, sort_reuse=True)
        return _six(*jres._grouped_stats(packed, n, n_pad, pr, norm,
                                         order=unscatter))
    return jax.vmap(one)(ch, gr, uv, valid, patch, key)


# (kernel, normalization, tolerance of its unbatched parity test):
# samples at 2e-6 (K2, tests/test_torch_bicubic.py) and 1e-6 (the row
# store, tests/test_torch_samples.py); the fused sums at 1e-4 (K1's,
# sorted K1's: tests/test_torch_patch_warp.py, tests/test_torch_sorted.py)
# and at 1e-3 absolute (K3/K5's, tests/test_torch_warp.py).
JAX_CASES = {
    "bicubic-mean": ("bicubic", "mean", dict(atol=1e-4, rtol=1e-4)),
    "scaled-mean": ("scaled", "mean", dict(atol=1e-3, rtol=1e-4)),
    "scaled-affine": ("scaled", "affine", dict(atol=1e-3, rtol=1e-4)),
    "rows": ("rows", "rows", dict(atol=1e-6, rtol=0)),
    "sorted-mean": ("sorted", "mean", dict(atol=1e-4, rtol=1e-4)),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_batched_plain_version_matches_vmapped_jax_kernel(case):
    kernel, norm, tol = JAX_CASES[case]
    pr = 2
    arrays = _windows(7, pr, warped=kernel == "scaled")
    ch, gr, uv, valid, patch, rho, key = arrays
    inputs = _port(arrays)
    j = jnp.asarray
    if kernel == "rows":
        got = smp.warp_patches(inputs[1], inputs[2], inputs[3], pr, "rows")
        want = jax.device_get(_jax_rows(j(ch), j(gr), j(uv), j(valid), pr))
        for a, b, name in zip(got, want, ("s", "gx", "gy")):
            assert tuple(a.shape) == b.shape == (B, N, W, C, (2 * pr + 1)**2)
            np.testing.assert_allclose(a.numpy()[valid], b[valid],
                                       err_msg=name, **tol)
            assert (a.numpy()[~valid] == 0).all()
        return
    got = _plain(kernel, pr, norm, inputs)[0].numpy()
    if kernel == "bicubic":
        samples = jax.device_get(_jax_bicubic(j(ch), j(uv), j(valid), pr))
        want = torch.stack([
            _stats_of(*(a[k] for a in samples), patch[k], valid[k], norm)
            for k in range(B)]).numpy()
        # The samples themselves at the unbatched test's 2e-6.
        mine = [pb.bicubic_patches_reference(
            inputs[0][k], inputs[2][k], inputs[3][k], pr) for k in range(B)]
        for k in range(B):
            for a, b in zip(mine[k], samples):
                np.testing.assert_allclose(a.numpy()[valid[k]],
                                           np.asarray(b[k])[valid[k]],
                                           atol=2e-6)
    elif kernel == "scaled" and norm == "affine":
        samples = jax.device_get(_jax_scaled(j(ch), j(gr), j(uv), j(rho),
                                             j(valid), pr))
        want = torch.stack([
            _stats_of(*(a[k] for a in samples), patch[k], valid[k], norm)
            for k in range(B)]).numpy()
    elif kernel == "scaled":
        want = jax.device_get(_jax_grouped_scaled(
            j(ch), j(gr), j(uv), j(rho), j(valid), j(patch), pr, norm))
    else:
        want = jax.device_get(_jax_sorted(
            j(ch), j(gr), j(uv), j(valid), j(patch), j(key.astype(np.int32)),
            pr, norm))
    assert got.shape == want.shape == (B, 6, W, N)
    mask = valid.transpose(0, 2, 1)[:, None]              # (B, 1, W, N)
    np.testing.assert_allclose(np.where(mask, got, 0.0),
                               np.where(mask, want, 0.0), **tol)
    assert (got[np.broadcast_to(~mask, got.shape)] == 0).all()


# ---------------------------------------------------------------------------
# The batched solve in each configuration
# ---------------------------------------------------------------------------

LM_KW = dict(huber_delta=0.05, initial_lambda=1e-2, max_iterations=6)
# configuration -> (lm_solve options, environment, the wrapper it calls)
SOLVE_CASES = {
    "bicubic": (dict(gradient_mode="bicubic"), {}, "bicubic_stats"),
    "scale": (dict(patch_warp="scale"), {}, "scaled_stats"),
    "scale-affine": (dict(patch_warp="scale", normalize="affine"), {},
                     "scaled_stats"),
    "rows": ({}, {"PB_GROUPED_STATS": "0"}, "store"),
    "sorted": ({}, {"PB_SORTED_DISPATCH": "1"}, "sorted_patch_stats"),
}
WRAPPERS = ((pw, "patch_stats"), (pw, "sorted_patch_stats"),
            (pb, "bicubic_stats"), (ps, "scaled_stats"), (smp, "store"))


@pytest.mark.parametrize("case", sorted(SOLVE_CASES))
def test_batched_solve_is_each_windows_solve(case, monkeypatch):
    """Three windows of tests/test_residuals.py's problem (their points
    pushed off by different amounts) as one batched solve on the cuda
    backend (its plain versions here): each window's poses, points and
    stats bitwise its own `lm_solve`; the configuration's kernel called
    once per evaluation (start evaluations and bodies, `lm.runs`) with
    the three windows on its batch axis, and no other kernel."""
    from test_residuals import setup_problem
    from torch_parity import port_problem

    options, env, wrapper = SOLVE_CASES[case]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    cam, t, x, patch, ch, g, obs, off = port_problem(
        setup_problem(np.random.default_rng(0), n_pts=24, w=4))
    kw = dict(LM_KW, backend="cuda", **options)
    if "patch_warp" in kw:
        slot = np.random.default_rng(1).integers(-1, 4, size=24)
        kw["patch_warp"] = (kw["patch_warp"], torch.as_tensor(slot))
    if kw.get("normalize") == "affine":
        patch = tpatches.affine_normalize(patch)
    frozen = torch.tensor([True, True, False, False])
    requests = [((cam, t, x + d, patch, ch, g, obs,
                  torch.ones(24, dtype=torch.bool), frozen, off), kw)
                for d in (0.0, 0.01, 0.02)]
    singles = [tlm.lm_solve(*a, **o) for a, o in requests]
    calls = []
    for module, name in WRAPPERS:
        real = getattr(module, name)
        # Value planes (W, C, H, Wi) for K2, texel planes (..., 4) else.
        window_dims = 4 if name == "bicubic_stats" else 5

        def counted(planes, *args, _real=real, _name=name,
                    _dims=window_dims, **kwargs):
            calls.append((_name, tuple(planes.shape[:-_dims])))
            return _real(planes, *args, **kwargs)

        monkeypatch.setattr(module, name, counted)
    tlm.reset_runs()
    t_b, x_b, st_b = tlm.lm_solve_batched(requests)
    for k, (t_s, x_s, st_s) in enumerate(singles):
        assert torch.equal(t_b[k], t_s) and torch.equal(x_b[k], x_s)
        for a, b in zip(st_b, st_s):                  # NaN-aware, bitwise
            np.testing.assert_array_equal(a[k].numpy(), b.numpy())
    evaluations = tlm.runs["starts"] + tlm.runs["bodies"]
    assert evaluations >= 2
    assert calls == [(wrapper, (B,))] * evaluations


# ---------------------------------------------------------------------------
# The window solve from carried state against the vmapped JAX engine
# ---------------------------------------------------------------------------

SOLVE_ITERS = 8
# reference_exact's kernel (K2: interpolation='bicubic') with the priors of
# tests/test_torch_engine.py's bicubic configuration: without the depth
# prior and with one fixed pose the synthetic window is too weakly
# conditioned for these bounds (the packages' f32 rounding differences
# grew to 1.4e-3 in the final cost).
ENGINE_CASES = {
    "reference_exact": dict(interpolation="bicubic"),
    "scale": dict(patchWarp="scale"),
}


@pytest.fixture(scope="module")
def scene():
    cam, images, depths, poses = make_sequence(np.random.default_rng(3),
                                               n_frames=6, shape=(96, 144))
    init = perturb_poses(np.random.default_rng(11), poses, trans_sigma=0.03,
                         rot_sigma=0.003, keep_first=2)
    return cam, images, depths, init


@pytest.fixture(scope="module", params=sorted(ENGINE_CASES))
def solves(request, scene):
    """The JAX engine in a configuration of ENGINE_CASES and the
    pre-solve states of its first two window solves."""
    cam, images, depths, init = scene
    cfg = small_cfg(maxIterations=SOLVE_ITERS, functionTolerance=0.0,
                    parameterTolerance=0.0, **ENGINE_CASES[request.param])
    jpba = JPBA(cam, images[0].shape, cfg)
    trace = EngineTrace(jpba)
    for i in range(6):
        jpba.add_frame(images[i], depths[i], init[i])
    return request.param, cfg, jpba, trace.solves


def test_batched_window_solve_matches_vmapped_reference(scene, solves):
    """The JAX engine's first two pre-solve states in the configuration,
    stacked B = 2, through the port's batched `_optimize` on the cuda
    backend (the kernels' plain versions) against `jax.vmap` of the JAX
    engine's `_optimize_impl` (XLA). Observations within 1e-4 px of a
    margin are cleared from the shared state
    (`without_observations_at_margins`); with the warp, also a 2 px band
    around the kernel path's margin 1 + rho R, which the JAX gather path's
    per-sample validity passes by a pixel. The warped solve is held to the
    bounds of its unbatched test
    (tests/test_torch_warp.py::test_engine_window_solve_with_warp_matches_jax:
    iterations, accept log, costs, poses), the bicubic one to
    tests/test_torch_batched.py's, which add the points."""
    cam, images = scene[:2]
    case, cfg, jpba, recs = solves
    tcfg = port_config(cfg).replace(solverBackend="cuda")
    bpba = BPBA(port_camera(cam), images[0].shape, tcfg, 2, device="cpu")
    assert bpba.backend == "cuda"
    states = []
    for r in recs[:2]:
        points_np, window_np = without_observations_at_margins(
            bpba._proto, *r["before"])
        if case == "scale":
            tp, tw = convert.engine_state_from_numpy(points_np, window_np)
            same = tp.ref_frame[:, None] == tw.frame_ids[None, :]
            slot = torch.where(same.any(1), torch.argmax(same.int(), 1), -1)
            z_ref, _ = tres.patch_warp_ref_geometry(tw.t_wc, tp.x_world,
                                                    slot)
            near = scaled_margin_near(bpba._proto.camera, tw.t_wc,
                                      tp.x_world, z_ref,
                                      tw.channels.shape[-2:],
                                      tcfg.patchRadius, tol=2.0)
            points_np = points_np._replace(obs=points_np.obs & ~near)
        states.append((points_np, window_np))
    points_np, window_np = convert.stack_engine_states(states)
    optimize = jax.jit(jax.vmap(functools.partial(jpba._optimize_impl,
                                                  reduce_fn=None)))
    jw, jp, want, jpv = jax.device_get(optimize(
        type(window_np)(*map(jnp.asarray, window_np)),
        type(points_np)(*map(jnp.asarray, points_np))))
    points, win = convert.batched_engine_state_from_numpy(points_np,
                                                          window_np)
    kernel = pb.bicubic_stats if case == "reference_exact" else ps.scaled_stats
    before = dict(kernel.launches)
    tw, tp, got, tpv = bpba._optimize(win, points)
    assert kernel.launches == before      # CPU tensors: the plain version
    np.testing.assert_array_equal(got.iterations.numpy(), want.iterations)
    assert (got.iterations.numpy() == SOLVE_ITERS).all()
    np.testing.assert_array_equal(got.accept_log.numpy(), want.accept_log)
    np.testing.assert_array_equal(tpv.numpy(), jpv)
    np.testing.assert_array_equal(got.n_residuals.numpy(), want.n_residuals)
    assert (got.n_residuals.numpy() > 0).all()
    np.testing.assert_array_equal(got.obs_per_frame.numpy(),
                                  want.obs_per_frame)
    np.testing.assert_allclose(got.initial_cost.numpy(), want.initial_cost,
                               rtol=1e-5)
    np.testing.assert_allclose(got.final_cost.numpy(), want.final_cost,
                               rtol=1e-4)
    assert (got.final_cost < got.initial_cost).all()
    np.testing.assert_allclose(tw.t_wc.numpy(), jw.t_wc, atol=1e-4)
    if case != "scale":
        np.testing.assert_allclose(tp.x_world.numpy(), jp.x_world,
                                   atol=1e-3, rtol=1e-4)
