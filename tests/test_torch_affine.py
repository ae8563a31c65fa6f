"""patchNormalization='affine' (the ZNCC unit norm) on the port against the
JAX package.

- The dense oracle `evaluate`: the analytic Jacobian of the normalized
  residual against torch.autograd (tests/test_residuals.py uses jax.jacfwd),
  gain and offset invariance, and the compressed statistics of both port
  backends against it (normal-equation blocks).
- The kernel path's plain versions with the affine epilogue against the
  JAX package's Pallas path in interpret mode: K1's (the port's K4 mode;
  the JAX package runs K4 `_warp_kernel` + XLA) and K2's (bicubic).
- tests/test_lm.py's tukey + affine composition, `lm_solve` against the
  JAX package's, and the engine: one window solve from the JAX engine's
  carried-over state, and tests/test_engine.py's gain-flicker run.

Tolerances are the JAX tests'. The CUDA kernels themselves are held
against their plain versions on a card by tests/test_torch_cuda.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photobundle_tpu.core import lm as jlm
from photobundle_tpu.core import residuals as jres
from photobundle_tpu.core.engine import PhotometricBundleAdjustment as JPBA
from photobundle_tpu.geometry import se3 as jse3
from photobundle_tpu.image import patches as jpatches
from photobundle_tpu.io import trajectory as traj_mod
from photobundle_torch import convert
from photobundle_torch.core import lm as tlm
from photobundle_torch.core import residuals as tres
from photobundle_torch.core.engine import PhotometricBundleAdjustment as TPBA
from photobundle_torch.geometry import se3 as tse3
from photobundle_torch.image import interp as tinterp
from photobundle_torch.image import patches as tpatches

from synthetic import make_sequence, perturb_poses
from test_engine import small_cfg
from test_residuals import setup_problem
from test_torch_engine import without_observations_at_margins
from test_torch_patch_warp import multichannel
from torch_parity import (EngineTrace, port_camera, port_config,
                          port_problem, to_np)

HUBER = 0.07


def affine_problem(rng, **kw):
    """tests/test_residuals.setup_problem with affine-normalized
    descriptors (the stored descriptor matches the mode)."""
    prob = setup_problem(rng, **kw)
    return (*prob[:3], jpatches.affine_normalize(prob[3]), *prob[4:])


def twist_hat(xi):
    """(W, 6) [rho | omega] -> (W, 4, 4) se(3) matrices."""
    m = torch.zeros(xi.shape[0], 4, 4, dtype=xi.dtype)
    m[:, :3, :3] = tse3.hat(xi[:, 3:])
    m[:, :3, 3] = xi[:, :3]
    return m


def test_affine_jacobians_match_autodiff():
    """The analytic G_eff = (G_c - ŝ(ŝᵀG_c)) / n propagation equals
    torch.autograd's Jacobian of the full normalized residual. The poses
    are perturbed as T (I + hat(xi)), which has exp's derivative at 0."""
    prob = affine_problem(np.random.default_rng(0), n_pts=6)
    cam, t_wc, x, patch, ch, g, obs, off = port_problem(prob)
    kw = dict(huber_delta=1e9, gradient_mode="exact", normalize="affine")
    out = tres.evaluate(cam, t_wc, x, patch, ch, g, obs, off, **kw)
    eye = torch.eye(4)

    def residual_fn(xi, x_all):
        t = t_wc @ (eye + twist_hat(xi))
        return tres.evaluate(cam, t, x_all, patch, ch, g, obs, off,
                             with_jacobians=False, **kw).r

    w, n = t_wc.shape[0], x.shape[0]
    j_pose, j_point = torch.autograd.functional.jacobian(
        residual_fn, (torch.zeros(w, 6), x))
    jp_auto = torch.stack([j_pose[:, f, :, f, :] for f in range(w)], 1)
    jx_auto = torch.stack([j_point[p, :, :, p, :] for p in range(n)], 0)
    assert bool(out.valid.all())
    np.testing.assert_allclose(out.j_pose.numpy(), jp_auto.numpy(),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(out.j_point.numpy(), jx_auto.numpy(),
                               atol=2e-4, rtol=1e-3)
    # And the JAX package's oracle.
    ref = jres.evaluate(*prob, **kw)
    np.testing.assert_allclose(out.r.numpy(), np.asarray(ref.r), atol=1e-5)
    np.testing.assert_allclose(out.j_pose.numpy(), np.asarray(ref.j_pose),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-5)


def test_affine_normalization_gain_offset_invariance():
    """Under 'affine' the residual and its Jacobians do not change with a
    per-frame gain and offset of the image; under 'mean' the gain moves the
    cost. The kernel path's plain version (K1's affine mode) keeps the
    invariance of its statistics too."""
    prob = setup_problem(np.random.default_rng(1), n_pts=8)
    cam, t_wc, x, patch, ch, g, obs, off = port_problem(prob)
    ch2 = ch.clone()
    ch2[2] = ch2[2] * 1.3 + 0.1
    gx2, gy2 = tinterp.image_gradients(ch2)
    g2 = torch.stack([gx2, gy2], dim=-1)
    kw = dict(huber_delta=1e9, gradient_mode="exact")
    patch_a = tpatches.affine_normalize(patch)
    a = tres.evaluate(cam, t_wc, x + 0.02, patch_a, ch, g, obs, off,
                      normalize="affine", **kw)
    b = tres.evaluate(cam, t_wc, x + 0.02, patch_a, ch2, g2, obs, off,
                      normalize="affine", **kw)
    assert abs(float(a.cost) - float(b.cost)) < 1e-6
    np.testing.assert_allclose(a.r.numpy(), b.r.numpy(), atol=5e-6)
    np.testing.assert_allclose(a.j_pose.numpy(), b.j_pose.numpy(), atol=2e-4)
    m1 = tres.evaluate(cam, t_wc, x + 0.02, patch, ch, g, obs, off,
                       normalize="mean", **kw)
    m2 = tres.evaluate(cam, t_wc, x + 0.02, patch, ch2, g2, obs, off,
                       normalize="mean", **kw)
    assert abs(float(m1.cost) - float(m2.cost)) > 1e-3
    ck = dict(huber_delta=1e9, backend="cuda", normalize="affine")
    ka = tres.evaluate_compressed(cam, t_wc, x + 0.02, patch_a, ch, g, obs,
                                  off, **ck)
    kb = tres.evaluate_compressed(cam, t_wc, x + 0.02, patch_a, ch2, g2, obs,
                                  off, **ck)
    np.testing.assert_allclose(float(ka.cost), float(kb.cost), rtol=1e-5)
    np.testing.assert_allclose(kb.gtr.numpy(), ka.gtr.numpy(), atol=1e-4)


def normal_blocks_dense(res):
    """Per-observation J^T J (N, W, 9, 9) and J^T r (N, W, 9) of the
    dense oracle's whitened residuals."""
    j = torch.cat([res.j_pose, res.j_point], dim=-1)
    return (torch.einsum("nwdi,nwdj->nwij", j, j),
            torch.einsum("nwdi,nwd->nwi", j, res.r))


def normal_blocks_compressed(res):
    """The same blocks from the factored statistics: A^T gtg A + jp jp^T
    and A^T gtr + jp rp."""
    a = res.a.permute(3, 0, 1, 2)                          # (N, W, 2, 9)
    gtg = res.gtg.permute(3, 0, 1, 2)
    gtr = res.gtr.permute(2, 0, 1)
    jp = res.jp.permute(2, 0, 1)                           # (N, W, 9)
    rp = res.rp.T
    h = (torch.einsum("nwki,nwkl,nwlj->nwij", a, gtg, a)
         + jp[..., :, None] * jp[..., None, :])
    b = torch.einsum("nwki,nwk->nwi", a, gtr) + jp * rp[..., None]
    return h, b


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_affine_compressed_matches_full(backend):
    """Compressed statistics under 'affine' (gather path; K1's affine mode
    as its plain version) reproduce the dense oracle's cost and normal
    equations, and the JAX package's compressed statistics."""
    prob = affine_problem(np.random.default_rng(2), n_pts=7)
    cam, t_wc, x, patch, ch, g, obs, off = port_problem(prob)
    kw = dict(huber_delta=1e9, gradient_mode="sampled", normalize="affine")
    full = tres.evaluate(cam, t_wc, x + 0.02, patch, ch, g, obs, off, **kw)
    comp = tres.evaluate_compressed(cam, t_wc, x + 0.02, patch, ch, g, obs,
                                    off, backend=backend, **kw)
    assert torch.equal(comp.valid, full.valid)
    np.testing.assert_allclose(float(comp.cost), float(full.cost), rtol=1e-5)
    for a, b in zip(normal_blocks_compressed(comp), normal_blocks_dense(full)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-3,
                                   rtol=1e-3)
    ref = jres.evaluate_compressed(*prob[:2], prob[2] + 0.02, *prob[3:],
                                   backend="xla", **kw)
    for name in ("gtg", "gtr"):
        np.testing.assert_allclose(to_np(getattr(comp, name)),
                                   np.asarray(getattr(ref, name)),
                                   atol=1e-3, rtol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# The kernel path's affine mode (K1 as K4, and K2) vs the JAX Pallas path
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("mode", "backend"))
def _jax_affine(cam, t, x, patch, ch, g, obs, off, mode, backend):
    kw = dict(interpret=True) if backend == "pallas" else {}
    return jres.evaluate_compressed(cam, t, x, patch, ch, g, obs, off, HUBER,
                                    mode, backend=backend,
                                    normalize="affine", **kw)


CASES = {   # radius, channels, sampling mode
    "r1-c1-sampled": (1, 1, "sampled"),
    "r2-c1-sampled": (2, 1, "sampled"),
    "r2-c3-sampled": (2, 3, "sampled"),
    "r2-c1-bicubic": (2, 1, "bicubic"),
    "r2-c3-bicubic": (2, 3, "bicubic"),
}


@pytest.fixture(scope="module")
def kernel_problems():
    rng = np.random.default_rng(3)
    return {r: setup_problem(rng, n_pts=16, w=3, radius=r) for r in (1, 2)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_path_affine_matches_pallas(kernel_problems, case):
    """The port's kernel path with affine normalization (on the CPU the
    plain versions of K1's and K2's affine modes) against the JAX
    package's Pallas path in interpret mode (K4 or K2, then XLA's affine
    algebra): same valid set, statistics, cost."""
    radius, channels, mode = CASES[case]
    prob = kernel_problems[radius]
    if channels == 3:
        prob = multichannel(prob)
    prob = (*prob[:2], prob[2] + 0.015, jpatches.affine_normalize(prob[3]),
            *prob[4:6], prob[6].at[2, 1].set(False), prob[7])
    ref = jax.device_get(_jax_affine(*prob, mode, "pallas"))
    cam, t, x, patch, ch, g, obs, off = port_problem(prob)
    out = tres.evaluate_compressed(cam, t, x, patch, ch, g, obs, off, HUBER,
                                   mode, backend="cuda", normalize="affine")
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    for name in ("gtg", "gtr"):
        np.testing.assert_allclose(to_np(getattr(out, name)),
                                   np.asarray(getattr(ref, name)),
                                   atol=1e-3, rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-5)
    # The gather path of the port on the common valid set.
    gat = tres.evaluate_compressed(cam, t, x, patch, ch, g, obs, off, HUBER,
                                   mode, backend="torch", normalize="affine")
    both = (gat.valid & out.valid).T.float()
    np.testing.assert_allclose((gat.gtr * both[:, None]).numpy(),
                               (out.gtr * both[:, None]).numpy(),
                               atol=1e-3, rtol=1e-4)


def test_tukey_with_affine_normalization_composes():
    """tests/test_lm.py's composition test on the port: dense and
    compressed paths agree under tukey + affine; inliers keep full weight
    and the corrupted block is cut to weight 0."""
    prob = affine_problem(np.random.default_rng(4), n_pts=24, w=3)
    cam, t_wc, x, patch, ch, g, obs, off = port_problem(prob)
    ch = ch.clone()
    ch[1, :, 30:60, 40:90] = 1.0
    kw = dict(huber_delta=0.3, robust_kind="tukey", gradient_mode="sampled",
              normalize="affine")
    full = tres.evaluate(cam, t_wc, x, patch, ch, g, obs, off, **kw)
    for backend in ("torch", "cuda"):
        comp = tres.evaluate_compressed(cam, t_wc, x, patch, ch, g, obs, off,
                                        backend=backend, **kw)
        v = (comp.valid & full.valid)
        np.testing.assert_allclose(float(comp.cost), float(full.cost),
                                   rtol=1e-5, err_msg=backend)
        hc, bc = normal_blocks_compressed(comp)
        hd, bd = normal_blocks_dense(full)
        np.testing.assert_allclose(hc[v].numpy(), hd[v].numpy(), atol=2e-3,
                                   rtol=1e-3)
        np.testing.assert_allclose(bc[v].numpy(), bd[v].numpy(), atol=2e-3,
                                   rtol=1e-3)
    raw = tres.evaluate(cam, t_wc, x, patch, ch, g, obs, off,
                        huber_delta=0.3, robust_kind="none",
                        gradient_mode="sampled", normalize="affine")
    w_t, _ = tres.robust_weight(torch.sum(raw.r * raw.r, dim=-1), 0.3,
                                "tukey")
    w_live = w_t[raw.valid]
    assert float(w_live.max()) > 0.9
    assert float(w_live.min()) == 0.0
    # The JAX package's cost of the same problem.
    ref = jres.evaluate(*prob[:4], jnp.asarray(ch.numpy()), *prob[5:], **kw)
    np.testing.assert_allclose(float(full.cost), float(ref.cost), rtol=1e-5)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_lm_solve_affine_matches_jax(backend):
    """tests/test_torch_lm.py's well-conditioned problem with affine
    normalization, solved by both packages (the JAX package on its gather
    path; the points lie 18 px inside the borders, so both port backends
    take its observations): same iterations and accept log, costs within
    1e-4, poses within 1e-4."""
    rng = np.random.default_rng(0)
    n, w = 48, 4
    prob = affine_problem(rng, n_pts=n, w=w, radius=3)
    xi = rng.standard_normal((w, 6)).astype(np.float32) * 0.01
    xi[:2] = 0.0
    prob = (prob[0], prob[1] @ jse3.se3_exp(jnp.asarray(xi)),
            prob[2] + 0.01, *prob[3:])
    frozen = np.array([True, True, False, False])
    kw = dict(huber_delta=0.3, initial_lambda=1e-2, max_iterations=6,
              function_tolerance=0.0, parameter_tolerance=0.0,
              normalize="affine")
    t_ref, _, ref = jax.device_get(jax.jit(
        lambda t, x: jlm.lm_solve(prob[0], t, x, *prob[3:7],
                                  jnp.ones(n, bool), jnp.asarray(frozen),
                                  prob[7], backend="xla", **kw))(
        prob[1], prob[2]))
    cam, t, x, patch, ch, g, obs, off = port_problem(prob)
    t_out, _, stats = tlm.lm_solve(cam, t, x, patch, ch, g, obs,
                                   torch.ones(n, dtype=torch.bool),
                                   torch.as_tensor(frozen), off,
                                   backend=backend, **kw)
    out = convert.stats_to_numpy(stats)
    assert int(out.iterations) == int(ref.iterations) == 6
    np.testing.assert_array_equal(out.accept_log, ref.accept_log)
    assert int(out.n_residuals) == int(ref.n_residuals)
    np.testing.assert_allclose(out.initial_cost, ref.initial_cost, rtol=1e-5)
    np.testing.assert_allclose(out.cost_log, ref.cost_log, rtol=1e-4)
    np.testing.assert_allclose(to_np(t_out), np.asarray(t_ref), atol=1e-4)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gain_scene():
    """tests/test_engine.py's gain-flicker scene: the textured sphere with
    a per-frame image gain in [0.7, 1.3], and jittered initial poses."""
    cam, images, depths, poses = make_sequence(np.random.default_rng(3),
                                               n_frames=10, shape=(96, 144))
    rng = np.random.default_rng(7)
    init = perturb_poses(rng, poses, trans_sigma=0.03, rot_sigma=0.003,
                         keep_first=2)
    gains = rng.uniform(0.7, 1.3, size=len(images)).astype(np.float32)
    images = [img * gn for img, gn in zip(images, gains)]
    return cam, images, depths, poses, init


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_engine_window_solve_affine_matches_jax(gain_scene, backend):
    """One window solve with patchNormalization='affine' from the JAX
    engine's carried-over state on the gain-flicker scene."""
    cam, images, depths, _, init = gain_scene
    cfg = small_cfg(maxIterations=8, functionTolerance=0.0,
                    parameterTolerance=0.0, patchNormalization="affine")
    jpba = JPBA(cam, images[0].shape, cfg)
    trace = EngineTrace(jpba)
    for i in range(5):
        jpba.add_frame(images[i], depths[i], init[i])
    tpba = TPBA(port_camera(cam), images[0].shape,
                port_config(cfg).replace(solverBackend=backend), device="cpu")
    points_np, window_np = without_observations_at_margins(
        tpba, *trace.solves[0]["before"])
    jw, _, want, _ = jpba._optimize(
        type(window_np)(*map(jnp.asarray, window_np)),
        type(points_np)(*map(jnp.asarray, points_np)))
    points, window = convert.engine_state_from_numpy(points_np, window_np)
    tw, _, got, _ = tpba._optimize(window, points)
    assert int(got.iterations) == int(want.iterations) == 8
    np.testing.assert_array_equal(got.accept_log.numpy(),
                                  np.asarray(want.accept_log))
    assert int(got.n_residuals) == int(want.n_residuals)
    np.testing.assert_allclose(float(got.initial_cost),
                               float(want.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(got.final_cost), float(want.final_cost),
                               rtol=1e-4)
    np.testing.assert_allclose(tw.t_wc.numpy(), np.asarray(jw.t_wc),
                               atol=1e-4)


def test_engine_affine_normalization_gain_robustness(gain_scene):
    """tests/test_engine.py's test on the port, through the kernel path's
    plain versions: on gain-flickering video the affine-normalized engine
    refines the jittered trajectory below 0.65x its ATE and beats the
    mean-normalized engine."""
    cam, images, depths, poses, init = gain_scene
    gt = traj_mod.Trajectory(poses.astype(np.float64))

    def run(**kw):
        cfg = port_config(small_cfg(**kw)).replace(solverBackend="cuda")
        pba = TPBA(port_camera(cam), images[0].shape, cfg, device="cpu")
        refined = traj_mod.Trajectory(init.copy().astype(np.float64))
        results = []
        for i, (img, depth) in enumerate(zip(images, depths)):
            res = pba.add_frame(img, depth, init[i])
            if res is not None:
                refined.update(res.frame_ids, res.poses)
                results.append(res)
        return traj_mod.ate_rmse(refined, gt, align=False), results

    a_init = traj_mod.ate_rmse(traj_mod.Trajectory(init.astype(np.float64)),
                               gt, align=False)
    a_aff, results = run(patchNormalization="affine")
    a_mean, _ = run()
    assert results
    for r in results:
        assert r.final_cost <= r.initial_cost + 1e-9
    assert a_aff < 0.65 * a_init, (a_init, a_aff)
    assert a_aff < a_mean, (a_aff, a_mean)
