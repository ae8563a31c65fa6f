"""The port's sliding-window engine against the JAX package's.

- One window solve (`_optimize`: LM + Schur with the depth prior, the
  pose-correction gate and the reanchor of excluded points) from the JAX
  engine's carried-over pre-solve state, in the default (bilinear,
  sampled) and the bicubic configuration, on both port backends. The
  solve is held to the reference's termination code, iteration count and
  accept log, its final cost within 1e-4 relative and its poses within
  1e-4: the window problem is well conditioned, so f32 rounding
  differences in the statistics (~1e-7 relative) stay far below these.
- Whole-sequence runs of the port's engine through `add_frame` on both
  backends, mirroring tests/test_engine.py's jittered-trajectory and
  bicubic tests (the same ATE bounds).
- The engine's refusals: parts of the JAX engine still to be ported, and
  configurations whose kernel is still to be ported, on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photobundle_tpu.core.engine import PhotometricBundleAdjustment as JPBA
from photobundle_tpu.io import trajectory as traj_mod
from photobundle_torch import convert
from photobundle_torch.core import residuals as tres
from photobundle_torch.core.engine import PhotometricBundleAdjustment as TPBA
from photobundle_torch.ops import patch_bicubic as pb
from photobundle_torch.ops import patch_warp as pw

from synthetic import make_sequence, perturb_poses
from test_engine import small_cfg
from torch_parity import EngineTrace, port_camera, port_config

N_FRAMES = 10
SOLVE_ITERS = 8       # every window solve runs to max_iterations

CONFIGS = {
    "default": dict(),
    "bicubic": dict(interpolation="bicubic"),
}


@pytest.fixture(scope="module")
def scene():
    cam, images, depths, poses = make_sequence(np.random.default_rng(3),
                                               n_frames=N_FRAMES,
                                               shape=(96, 144))
    init = perturb_poses(np.random.default_rng(11), poses, trans_sigma=0.03,
                         rot_sigma=0.003, keep_first=2)
    return cam, images, depths, poses, init


@pytest.fixture(scope="module")
def solves(scene):
    """Per configuration: the config, the JAX engine and the pre-solve
    states of its first two window solves (maxIterations=8, tolerances
    zeroed so that every solve runs all 8 iterations)."""
    cam, images, depths, _, init = scene
    out = {}
    for name, kw in CONFIGS.items():
        cfg = small_cfg(maxIterations=SOLVE_ITERS, functionTolerance=0.0,
                        parameterTolerance=0.0, **kw)
        jpba = JPBA(cam, images[0].shape, cfg)
        trace = EngineTrace(jpba)
        for i in range(6):
            jpba.add_frame(images[i], depths[i], init[i])
        out[name] = (cfg, jpba, trace.solves)
    return out


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("window", [0, 1])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_window_solve_matches_reference_from_carried_state(
        scene, solves, config, window, backend):
    cam, images = scene[:2]
    cfg, jpba, recs = solves[config]
    tpba = TPBA(port_camera(cam), images[0].shape,
                port_config(cfg).replace(solverBackend=backend))
    assert tpba.backend == backend
    points_np, window_np = without_observations_at_margins(
        tpba, *recs[window]["before"])
    # The reference's solve of this state, and the port's.
    jw, jp, want, jpv = jpba._optimize(
        type(window_np)(*map(jnp.asarray, window_np)),
        type(points_np)(*map(jnp.asarray, points_np)))
    points, win = convert.engine_state_from_numpy(points_np, window_np)
    tw, tp, got, tpv = tpba._optimize(win, points)
    assert int(got.termination) == int(want.termination) == 1
    assert int(got.iterations) == int(want.iterations) == SOLVE_ITERS
    np.testing.assert_array_equal(got.accept_log.numpy(),
                                  np.asarray(want.accept_log))
    np.testing.assert_array_equal(tpv.numpy(), np.asarray(jpv))
    assert int(got.n_residuals) == int(want.n_residuals)
    np.testing.assert_array_equal(got.obs_per_frame.numpy(),
                                  np.asarray(want.obs_per_frame))
    np.testing.assert_allclose(float(got.initial_cost),
                               float(want.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(got.final_cost), float(want.final_cost),
                               rtol=1e-4)
    assert float(got.final_cost) < float(got.initial_cost)
    np.testing.assert_allclose(tw.t_wc.numpy(), np.asarray(jw.t_wc),
                               atol=1e-4)
    # Points too (the solved ones, and the reanchored excluded ones).
    np.testing.assert_allclose(tp.x_world.numpy(), np.asarray(jp.x_world),
                               atol=1e-3, rtol=1e-4)


def without_observations_at_margins(tpba, points, window, tol=1e-4):
    """The pre-solve state with every observation cleared whose projection
    lies within `tol` px of a border margin (bilinear: the gather path's
    0 and W-1 and the kernel path's pr and W-2-pr; bicubic: pr+1 and
    W-3-pr). XLA fuses the projection's f32 arithmetic differently from
    PyTorch, so such an observation can fall on either side of its margin
    in the two packages (one did, in the bicubic configuration's first
    window: y = 91.000008 here, 91.0 under XLA, margin 91); the solves
    then optimize different problems."""
    pr = tpba.cfg.patchRadius
    tp, tw = convert.engine_state_from_numpy(points, window)
    _, uv, _, _, _ = tres._observation_geometry_pm(tpba.camera, tw.t_wc,
                                                   tp.x_world)
    h, w = window.channels.shape[-2:]
    near = torch.zeros(uv[:, 0].shape, dtype=torch.bool)
    for coord, size in ((uv[:, 0], w), (uv[:, 1], h)):
        for m in (0, pr, pr + 1, size - 1 - pr, size - 2 - pr, size - 3 - pr):
            near |= (coord - m).abs() < tol
    return points._replace(obs=points.obs & ~near.T.numpy()), window


def run_port(scene, cfg, device="cpu"):
    cam, images, depths, _, init = scene
    pba = TPBA(port_camera(cam), images[0].shape, cfg, device=device)
    refined = traj_mod.Trajectory(init.copy().astype(np.float64))
    results = []
    for i, (img, depth) in enumerate(zip(images, depths)):
        res = pba.add_frame(img, depth, init[i])
        if res is not None:
            refined.update(res.frame_ids, res.poses)
            results.append(res)
    return refined, results, pba


def ate(scene, refined):
    poses, init = scene[3], scene[4]
    gt = traj_mod.Trajectory(poses.astype(np.float64))
    return (traj_mod.ate_rmse(traj_mod.Trajectory(init.astype(np.float64)),
                              gt, align=False),
            traj_mod.ate_rmse(refined, gt, align=False))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_engine_improves_jittered_trajectory(scene, backend):
    """tests/test_engine.py::test_engine_improves_jittered_trajectory on the
    port: iid pose jitter in, ATE below 0.65x the initial out."""
    cfg = port_config(small_cfg()).replace(solverBackend=backend)
    refined, results, pba = run_port(scene, cfg)
    assert len(results) >= 5, "window never filled or solved"
    for r in results:
        assert r.final_cost <= r.initial_cost + 1e-9
        assert r.iterations == len(r.accept_log) and r.termination
        assert r.points_xyz.shape == (r.num_points, 3)
        assert np.isfinite(r.points_xyz).all()
    assert pba.num_active_points > 50
    ate_init, ate_ref = ate(scene, refined)
    assert ate_ref < 0.65 * ate_init, (ate_init, ate_ref)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_engine_bicubic_interpolation(scene, backend):
    """tests/test_engine.py::test_engine_bicubic_interpolation on the port:
    Catmull-Rom sampling end to end, ATE below 0.8x the initial."""
    cfg = port_config(small_cfg(interpolation="bicubic", maxIterations=20)
                      ).replace(solverBackend=backend)
    refined, results, _ = run_port(scene, cfg)
    assert results
    for r in results:
        assert r.final_cost <= r.initial_cost + 1e-9
    ate_init, ate_ref = ate(scene, refined)
    assert ate_ref < 0.8 * ate_init, (ate_init, ate_ref)


def test_refinement_level_and_uint8_frames(scene):
    """refinementLevel=1 solves on the half-resolution level (the
    tests/test_engine.py settings), fed 8-bit frames."""
    cam, images, depths, poses, init = scene
    cfg = port_config(small_cfg(pyramidLevels=2, refinementLevel=1,
                                patchRadius=1, maxIterations=20,
                                minSaliency=0.002, minScore=0.4,
                                maxFrameDistance=2, nonMaxSuppRadius=1,
                                maskBlockRadius=1))
    u8 = [np.round(im * 255.0).astype(np.uint8) for im in images]
    refined, results, pba = run_port((cam, u8, depths, poses, init), cfg)
    assert results and pba.level_shape == (48, 72)
    ate_init, ate_ref = ate(scene, refined)
    assert ate_ref < ate_init, (ate_init, ate_ref)


def test_cpu_engine_launches_no_kernel(scene):
    """On the CPU the cuda backend runs the kernels' plain versions."""
    before = (pw.patch_stats.launches, pb.bicubic_stats.launches)
    cfg = port_config(small_cfg(maxIterations=2)).replace(solverBackend="cuda")
    run_port(scene, cfg)
    assert (pw.patch_stats.launches, pb.bicubic_stats.launches) == before


NOT_PORTED = {
    "coarseToFine": dict(pyramidLevels=3, coarseToFine=True),
    "pipelineResults": dict(pipelineResults=True),
    "meshPoints": dict(meshPoints=2),
    "patchWarp": dict(patchWarp="scale"),
}


@pytest.mark.parametrize("what", sorted(NOT_PORTED))
def test_parts_still_to_port_raise(scene, what):
    cam, images = scene[:2]
    cfg = port_config(small_cfg(**NOT_PORTED[what]))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TPBA(port_camera(cam), images[0].shape, cfg)


def test_coarse_to_fine_without_coarse_levels_runs(scene):
    """coarseToFine with one pyramid level has no coarse level: it is the
    single-level solve (tests/test_engine.py's no-op test)."""
    cam, images = scene[:2]
    cfg = port_config(small_cfg(coarseToFine=True))
    TPBA(port_camera(cam), images[0].shape, cfg)


def test_snapshots_raise(scene):
    cam, images = scene[:2]
    pba = TPBA(port_camera(cam), images[0].shape, port_config(small_cfg()))
    for fn in (pba.save_state, pba.load_state):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn("unused.npz")


@pytest.mark.parametrize("kw,kernel", [
    (dict(patchNormalization="affine"), "K4"),
    (dict(patchNormalization="affine", interpolation="bicubic"), "K4"),
])
def test_unported_kernel_raises_on_a_card(scene, kw, kernel):
    """On a card, a configuration whose kernel is still to be ported is
    refused before any state is allocated, instead of running the plain
    path there."""
    cam, images = scene[:2]
    cfg = port_config(small_cfg(**kw))
    with pytest.raises(NotImplementedError, match=kernel):
        TPBA(port_camera(cam), images[0].shape, cfg, device="cuda")
    # solverBackend=torch runs it on the gather path (here on the CPU).
    TPBA(port_camera(cam), images[0].shape, cfg.replace(solverBackend="torch"))


def test_result_fetch_is_exact():
    """The window result's single device-to-host copy keeps every dtype
    and value."""
    from photobundle_torch.core.engine import _fetch
    ts = [torch.tensor([1.5, -2.25e-8], dtype=torch.float32),
          torch.tensor([[3, -4]], dtype=torch.int32),
          torch.tensor([True, False]),
          torch.tensor(7, dtype=torch.int32)]
    out = _fetch(ts)
    for a, b in zip(out, ts):
        assert a.dtype == b.numpy().dtype and a.shape == tuple(b.shape)
        np.testing.assert_array_equal(a, b.numpy())


def test_make_sequence_matches_the_test_scene():
    """entry.make_sequence (jax-free, used on the card) renders the
    repository's test scene: same camera, poses, images and depths as
    tests/synthetic.make_sequence from the same seed, to 1e-6 (the step
    poses come from each package's own se3_exp, equal to f32 rounding),
    and drift_poses the same drifted track."""
    import synthetic

    from photobundle_torch import entry

    jcam, jimgs, jdepths, jposes = synthetic.make_sequence(
        np.random.default_rng(3), n_frames=6, shape=(96, 144))
    tcam, timgs, tdepths, tposes = entry.make_sequence(
        np.random.default_rng(3), n_frames=6, shape=(96, 144))
    np.testing.assert_array_equal(np.asarray(tcam), np.asarray(jcam))
    np.testing.assert_allclose(tposes, jposes, atol=1e-6)
    for a, b in zip(timgs, jimgs):
        np.testing.assert_allclose(a, b, atol=1e-6)
    for a, b in zip(tdepths, jdepths):
        np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_allclose(
        entry.drift_poses(np.random.default_rng(17), tposes, 0.03, 0.003, 2),
        synthetic.drift_poses(np.random.default_rng(17), jposes, 0.03, 0.003,
                              2), atol=1e-6)
    # Other shapes and intrinsics: KITTI's, with the texture scaled.
    cam, imgs, depths, poses = entry.make_sequence(
        np.random.default_rng(0), n_frames=2, shape=(37, 123), fx=71.8856,
        cx=60.719, cy=18.522, baseline=0.537, texture_scale=100 / 71.8856,
        mark_misses=True)
    assert imgs[0].shape == depths[0].shape == (37, 123)
    assert float(cam.cx) == pytest.approx(60.719)
    # Rays past the sphere's silhouette see no surface: depth 0 (invalid).
    assert np.isfinite(imgs[1]).all() and (depths[1] >= 0).all()
    assert 0.5 < (depths[1] > 0).mean() < 1.0
    assert all((d > 0).all() for d in tdepths)
