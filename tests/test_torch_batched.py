"""The port's batched windows (core/batched.py) against the JAX package.

- K1 over a batch axis: the batched `patch_stats_reference` (what the
  wrapper runs on CPU tensors) is the stacked single-window calls,
  bitwise.
- The batched solve (`lm.lm_solve_batched`): bitwise each window's own
  `lm_solve` on both backends and with the priors, with K1 called once
  per evaluation for all the windows.
- One batched window solve from carried state: the JAX engine's first two
  pre-solve states (tests/test_torch_engine.py's `solves`), stacked B = 2,
  through the port's batched `_optimize` against `jax.vmap` of the JAX
  engine's `_optimize_impl` on XLA, with that file's bounds.
- The batched engine through `add_frames` against B single port engines
  fed the same frames, within the bounds of the reference's own oracle
  (tests/test_engine.py::test_batched_engine_matches_individual: equal
  frame ids and point counts, poses within 1e-3, final costs within 1e-3
  relative), and bitwise, at B = 2 and B = 1.
- A window that has ended passes through further bodies bitwise while the
  other window runs on.
- The refusals: a device mesh outside a torch.distributed world of its
  size, and a card the machine does not have (the card is the default
  device).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photobundle_tpu.core.engine import PhotometricBundleAdjustment as JPBA
from photobundle_torch import convert
from photobundle_torch.core import lm as tlm
from photobundle_torch.core.batched import (
    BatchedPhotometricBundleAdjustment as BPBA)
from photobundle_torch.core.engine import PhotometricBundleAdjustment as TPBA
from photobundle_torch.ops import patch_warp as pw

from synthetic import make_sequence, perturb_poses
from test_engine import small_cfg
from test_torch_engine import without_observations_at_margins
from torch_parity import few_threads  # noqa: F401  (module fixture)
from torch_parity import EngineTrace, port_camera, port_config

B = 3


def _windows(seed, radius, c=2, w=3, n=9, h=24, wi=30):
    """B windows' sampling inputs of one shape, from a numpy seed."""
    rng = np.random.default_rng(seed)
    ch = rng.random((B, w, c, h, wi), dtype=np.float32)
    gr = rng.standard_normal((B, w, c, h, wi, 2), dtype=np.float32)
    lo = np.float32(radius + 2)
    hi = np.array([wi - radius - 4, h - radius - 4], np.float32)
    uv = lo + rng.random((B, n, w, 2), dtype=np.float32) * (hi - lo)
    valid = rng.random((B, n, w)) > 0.2
    patch = rng.standard_normal((B, n, c, (2 * radius + 1) ** 2),
                                dtype=np.float32)
    ch, gr = torch.from_numpy(ch), torch.from_numpy(gr)
    planes = torch.stack([pw.build_planes(a, g) for a, g in zip(ch, gr)])
    return (ch, planes, torch.from_numpy(uv), torch.from_numpy(valid),
            torch.from_numpy(patch))


@pytest.mark.parametrize("norm", ["off", "mean", "affine"])
@pytest.mark.parametrize("radius", [1, 2, 4])
def test_batched_patch_stats_reference_is_stacked_singles(radius, norm):
    _, planes, uv, valid, patch = _windows(radius, radius)
    got = pw.patch_stats_reference(planes, uv, valid, patch, radius, norm)
    want = torch.stack([pw.patch_stats_reference(*a, radius, norm)
                        for a in zip(planes, uv, valid, patch)])
    assert got.shape == (B, 6, 3, 9)
    assert torch.equal(got, want)
    # The wrapper on CPU tensors runs it.
    assert torch.equal(pw.patch_stats(planes, uv, valid, patch, radius,
                                      norm), want)


LM_KW = dict(huber_delta=0.05, initial_lambda=1e-2, max_iterations=6)
LM_OPTIONS = {
    "torch": dict(backend="torch"),
    "cuda": dict(backend="cuda"),
    "cuda priors": dict(backend="cuda", motion_prior_weight=2.0),
}


@pytest.mark.parametrize("options", sorted(LM_OPTIONS))
def test_batched_solve_is_each_windows_solve(options, monkeypatch):
    """Three windows of tests/test_residuals.py's problem (their points
    pushed off by different amounts) as one batched solve: each window's
    poses, points and stats bitwise its own `lm_solve`; on the cuda
    backend K1 (its plain version here) is called once per evaluation
    with all three windows on its batch axis."""
    from test_residuals import setup_problem
    from torch_parity import port_problem

    cam, t, x, patch, ch, g, obs, off = port_problem(
        setup_problem(np.random.default_rng(0), n_pts=24, w=4))
    frozen = torch.tensor([True, True, False, False])
    kw = dict(LM_KW, **LM_OPTIONS[options])
    if "motion_prior_weight" in kw:
        kw["pose_prior"] = (t, 4.0)
    requests = [((cam, t, x + d, patch, ch, g, obs,
                  torch.ones(24, dtype=torch.bool), frozen, off), kw)
                for d in (0.0, 0.01, 0.02)]
    singles = [tlm.lm_solve(*a, **o) for a, o in requests]
    calls = []
    real = pw.patch_stats

    def counted(planes, *args):
        calls.append(tuple(planes.shape[:-5]))
        return real(planes, *args)

    monkeypatch.setattr(pw, "patch_stats", counted)
    t_b, x_b, st_b = tlm.lm_solve_batched(requests)
    for k, (t_s, x_s, st_s) in enumerate(singles):
        assert torch.equal(t_b[k], t_s) and torch.equal(x_b[k], x_s)
        for a, b in zip(st_b, st_s):                  # NaN-aware, bitwise
            np.testing.assert_array_equal(a[k].numpy(), b.numpy())
    bodies = max(int(st.iterations) for _, _, st in singles)
    if kw["backend"] == "cuda":
        assert calls == [(3,)] * (bodies + 1)
    else:
        assert not calls


# ---------------------------------------------------------------------------
# The window solve from carried state

SOLVE_ITERS = 8


@pytest.fixture(scope="module")
def scene():
    cam, images, depths, poses = make_sequence(np.random.default_rng(3),
                                               n_frames=7, shape=(96, 144))
    init = perturb_poses(np.random.default_rng(11), poses, trans_sigma=0.03,
                         rot_sigma=0.003, keep_first=2)
    return cam, images, depths, poses, init


@pytest.fixture(scope="module")
def solves(scene):
    """tests/test_torch_engine.py's `solves` fixture, default
    configuration: the JAX engine and the pre-solve states of its first
    two window solves."""
    cam, images, depths, _, init = scene
    cfg = small_cfg(maxIterations=SOLVE_ITERS, functionTolerance=0.0,
                    parameterTolerance=0.0)
    jpba = JPBA(cam, images[0].shape, cfg)
    trace = EngineTrace(jpba)
    for i in range(6):
        jpba.add_frame(images[i], depths[i], init[i])
    return cfg, jpba, trace.solves


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_batched_window_solve_matches_vmapped_reference(scene, solves,
                                                        backend):
    cam, images = scene[:2]
    cfg, jpba, recs = solves
    tcfg = port_config(cfg).replace(solverBackend=backend)
    bpba = BPBA(port_camera(cam), images[0].shape, tcfg, 2, device="cpu")
    states = [without_observations_at_margins(bpba._proto, *r["before"])
              for r in recs[:2]]
    points_np, window_np = convert.stack_engine_states(states)
    optimize = jax.jit(jax.vmap(functools.partial(jpba._optimize_impl,
                                                  reduce_fn=None)))
    jw, jp, want, jpv = jax.device_get(optimize(
        type(window_np)(*map(jnp.asarray, window_np)),
        type(points_np)(*map(jnp.asarray, points_np))))
    points, win = convert.batched_engine_state_from_numpy(points_np,
                                                          window_np)
    tw, tp, got, tpv = bpba._optimize(win, points)
    np.testing.assert_array_equal(got.termination.numpy(), [1, 1])
    np.testing.assert_array_equal(got.iterations.numpy(), want.iterations)
    assert (got.iterations.numpy() == SOLVE_ITERS).all()
    np.testing.assert_array_equal(got.accept_log.numpy(), want.accept_log)
    np.testing.assert_array_equal(tpv.numpy(), jpv)
    np.testing.assert_array_equal(got.n_residuals.numpy(), want.n_residuals)
    np.testing.assert_array_equal(got.obs_per_frame.numpy(),
                                  want.obs_per_frame)
    np.testing.assert_allclose(got.initial_cost.numpy(), want.initial_cost,
                               rtol=1e-5)
    np.testing.assert_allclose(got.final_cost.numpy(), want.final_cost,
                               rtol=1e-4)
    assert (got.final_cost < got.initial_cost).all()
    np.testing.assert_allclose(tw.t_wc.numpy(), jw.t_wc, atol=1e-4)
    np.testing.assert_allclose(tp.x_world.numpy(), jp.x_world, atol=1e-3,
                               rtol=1e-4)
    # The stacked state comes back in the JAX batched engine's layout.
    back, _ = convert.engine_state_to_numpy(tp, tw)
    assert back.x_world.shape == points_np.x_world.shape
    with pytest.raises(ValueError, match="leading batch axis"):
        convert.batched_engine_state_from_numpy(*recs[0]["before"])


# ---------------------------------------------------------------------------
# The engine through add_frames


@pytest.fixture(scope="module")
def second_scene():
    """A second sequence with the same intrinsics (make_sequence)."""
    _, images, depths, poses = make_sequence(np.random.default_rng(21),
                                             n_frames=7, shape=(96, 144))
    return images, depths, poses


def _single_runs(cam, seqs, cfg):
    out = []
    for images, depths, poses in seqs:
        pba = TPBA(cam, images[0].shape, cfg, device="cpu")
        out.append([r for i in range(len(images))
                    if (r := pba.add_frame(images[i], depths[i], poses[i]))])
    return out


def _batched_run(cam, seqs, cfg):
    bpba = BPBA(cam, seqs[0][0][0].shape, cfg, len(seqs), device="cpu")
    out = [[] for _ in seqs]
    for i in range(len(seqs[0][0])):
        rs = bpba.add_frames([s[0][i] for s in seqs], [s[1][i] for s in seqs],
                             [s[2][i] for s in seqs])
        for k, r in enumerate(rs or []):
            out[k].append(r)
    return out


def _assert_oracle(indiv, batched):
    """The reference oracle's bounds, then bitwise: each batched window
    runs the single engine's steps on its own tensors."""
    for ra_list, rb_list in zip(indiv, batched):
        assert len(ra_list) == len(rb_list) > 0
        for ra, rb in zip(ra_list, rb_list):
            np.testing.assert_array_equal(ra.frame_ids, rb.frame_ids)
            np.testing.assert_allclose(ra.poses, rb.poses, atol=1e-3)
            assert ra.num_points == rb.num_points
            np.testing.assert_allclose(ra.final_cost, rb.final_cost,
                                       rtol=1e-3)
            np.testing.assert_array_equal(ra.poses, rb.poses)
            np.testing.assert_array_equal(ra.points_xyz, rb.points_xyz)
            assert (ra.final_cost, ra.iterations, ra.termination) == (
                rb.final_cost, rb.iterations, rb.termination)


def test_batched_engine_matches_single_engines(scene, second_scene):
    """B = 2 sequences through `add_frames` on the kernel path's plain
    versions (backend 'cuda', the card's path) against two single
    engines."""
    cam, images, depths, poses = scene[:4]
    cfg = port_config(small_cfg(maxIterations=8)).replace(
        solverBackend="cuda")
    seqs = [(images, depths, poses), second_scene]
    tcam = port_camera(cam)
    _assert_oracle(_single_runs(tcam, seqs, cfg),
                   _batched_run(tcam, seqs, cfg))


def test_batch_of_one_matches_the_single_engine(scene):
    cam, images, depths, poses = scene[:4]
    cfg = port_config(small_cfg(maxIterations=8))
    seqs = [(images[:6], depths[:6], poses[:6])]
    tcam = port_camera(cam)
    indiv, batched = _single_runs(tcam, seqs, cfg), _batched_run(tcam, seqs,
                                                                 cfg)
    _assert_oracle(indiv, batched)


def test_ended_window_passes_through_bodies(scene, solves):
    """Two windows in one batched program, with a function tolerance of
    0.99: the JAX engine's first pre-solve state ends at its first
    accepted step, while its solved state (every step rejected) runs on;
    every field of the ended window stays bitwise as it was through the
    other's bodies."""
    cam, images = scene[:2]
    cfg, _, recs = solves
    pba = TPBA(port_camera(cam), images[0].shape, port_config(cfg),
               device="cpu")
    requests = []
    for state in (recs[0]["before"], recs[0]["after"]):
        points, win = convert.engine_state_from_numpy(*state)
        args, options = next(pba._optimize_plan(win, points))
        requests.append((args, dict(options, function_tolerance=0.99)))
    problems = [tlm.setup(*a, **o) for a, o in requests]
    start, body = tlm.program(tlm.stack_problems([p for p, _ in problems]),
                              problems[0][1])
    state, _ = start()
    ended = None
    for k in range(SOLVE_ITERS):
        state = body(state)
        if ended is None and int(state.term[0]) != 0:
            ended = [t[0].clone() for t in tlm._flat(state)]
            ended_at = k
    assert ended is not None and ended_at < SOLVE_ITERS - 2
    assert int(state.term[0]) == 2                  # function tolerance
    assert int(state.it[1]) == SOLVE_ITERS > int(state.it[0])
    for a, b in zip(ended, tlm._flat(state)):
        np.testing.assert_array_equal(a.numpy(), b[0].numpy())  # NaN-aware


@pytest.mark.parametrize("mesh", ["meshWindows", "meshPoints"])
def test_device_meshes_raise(scene, mesh):
    """A ('windows', 'points') mesh needs a torch.distributed world of its
    size (tests/test_torch_sharding.py runs one); outside one it raises,
    naming torchrun."""
    cam, images = scene[:2]
    cfg = port_config(small_cfg(**{mesh: 2}))
    with pytest.raises(RuntimeError, match="world of 2 ranks.*torchrun"):
        BPBA(port_camera(cam), images[0].shape, cfg, 2, device="cpu")


def test_batched_engine_defaults_to_the_card(scene, monkeypatch):
    import inspect

    assert inspect.signature(BPBA).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cam, images = scene[:2]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BPBA(port_camera(cam), images[0].shape, port_config(small_cfg()), 2)
