"""The slice as a whole: the port's lm_solve vs the JAX package's, plus the
problem generator and the solver's invariants on the port alone.

The parity problem is well conditioned on purpose (48 points, radius-3
patches, damped start): on weakly observed point depths, f32 rounding
differences between any two implementations grow through the LM steps
and would decide borderline accept/reject tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photobundle_tpu.core import lm as jlm
from photobundle_tpu.geometry import se3 as jse3
from photobundle_torch import convert, entry
from photobundle_torch.core import lm as tlm
from photobundle_torch.geometry import se3 as tse3

from __graft_entry__ import _make_problem
from test_residuals import setup_problem
from torch_parity import port_problem, to_np

N, W = 48, 4
KW = dict(huber_delta=0.05, initial_lambda=1e-2, max_iterations=6,
          function_tolerance=0.0, parameter_tolerance=0.0)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=N, w=W,
                                                         radius=3)
    xi = rng.standard_normal((W, 6)).astype(np.float32) * 0.01
    xi[:2] = 0.0
    t0 = jax.jit(lambda t, d: t @ jse3.se3_exp(d))(t_wc, jnp.asarray(xi))
    return (cam, t0, x + 0.01, patch, ch, g, obs, off), np.array(t_wc)


def priors(t_anchor):
    rng = np.random.default_rng(1)
    depth = (rng.integers(0, W, size=N).astype(np.int32),
             rng.uniform(0.05, 0.4, size=N).astype(np.float32))
    return depth, t_anchor


def _frozen():
    return np.array([True, True] + [False] * (W - 2))


@pytest.fixture(scope="module")
def jax_solves(problem):
    (cam, t0, x0, patch, ch, g, obs, off), t_gt = problem
    pv = jnp.ones((N,), bool)
    frozen = jnp.asarray(_frozen())

    @jax.jit
    def plain(t, x):
        return jlm.lm_solve(cam, t, x, patch, ch, g, obs, pv, frozen, off,
                            backend="xla", **KW)

    @jax.jit
    def with_priors(t, x, slot, q, anchor):
        return jlm.lm_solve(cam, t, x, patch, ch, g, obs, pv, frozen, off,
                            backend="xla", depth_prior=(slot, q, 5.0),
                            motion_prior_weight=3.0,
                            pose_prior=(anchor, 2.0, 4.0), **KW)

    (slot, q), anchor = priors(t_gt)
    return {False: jax.device_get(plain(t0, x0)),
            True: jax.device_get(with_priors(t0, x0, slot, q, anchor))}


def port_solve(problem, backend, use_priors, readback, **kw):
    """The port's solve of `problem` with LM_READBACK = `readback`: its
    result and the host reads of the termination code it made."""
    cam, t0, x0, patch, ch, g, obs, off = port_problem(problem[0])
    extra = {}
    if use_priors:
        (slot, q), anchor = priors(problem[1])
        extra = dict(depth_prior=(torch.as_tensor(slot), torch.as_tensor(q),
                                  5.0),
                     motion_prior_weight=3.0,
                     pose_prior=(torch.as_tensor(anchor), 2.0, 4.0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlm, "LM_READBACK", readback)
        tlm.reset_runs()
        out = tlm.lm_solve(
            cam, t0, x0, patch, ch, g, obs, torch.ones(N, dtype=torch.bool),
            torch.as_tensor(_frozen()), off, backend=backend,
            **{**KW, **kw}, **extra)
        return out, tlm.runs["readbacks"]


def assert_bitwise(got, want):
    """Every tensor of two nested tuples equal bit for bit (NaN too)."""
    got, want = tlm._flat(got), tlm._flat(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.is_floating_point():
            a, b = a.contiguous().view(torch.int32), b.contiguous().view(
                torch.int32)
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def every_body_read(problem):
    """The port's solves reading the termination code after every body."""
    return {(be, pr): port_solve(problem, be, pr, 1)[0]
            for be in ("torch", "cuda") for pr in (False, True)}


@pytest.mark.parametrize("readback", [1, 3, 8])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("use_priors", [False, True])
def test_lm_solve_matches_jax(problem, jax_solves, every_body_read, backend,
                              use_priors, readback):
    t_ref, x_ref, ref = jax_solves[use_priors]
    (t_out, x_out, stats), reads = port_solve(problem, backend, use_priors,
                                              readback)
    out = convert.stats_to_numpy(stats)
    assert int(out.iterations) == int(ref.iterations) == KW["max_iterations"]
    np.testing.assert_array_equal(out.accept_log, ref.accept_log)
    assert int(out.accepted_steps) == int(ref.accepted_steps)
    assert int(out.termination) == int(ref.termination)
    assert int(out.n_residuals) == int(ref.n_residuals)
    np.testing.assert_array_equal(out.obs_per_frame, ref.obs_per_frame)
    np.testing.assert_allclose(out.initial_cost, ref.initial_cost, rtol=1e-5)
    np.testing.assert_allclose(out.cost_log, ref.cost_log, rtol=1e-4)
    # Nielsen's update scales lambda by 1 - (2 rho - 1)^3, rho a ratio of
    # cost differences: a relative 1e-4 in costs is ~1e-3 in lambda.
    np.testing.assert_allclose(out.lambda_log, ref.lambda_log, rtol=1e-3)
    np.testing.assert_allclose(to_np(t_out), np.asarray(t_ref), atol=1e-4)
    np.testing.assert_allclose(to_np(x_out), np.asarray(x_ref), atol=1e-3)
    # Extra bodies after the end change nothing: the result is bitwise the
    # one read back after every body. A solve that runs to max_iterations
    # reads back after every `readback` bodies but the last.
    assert_bitwise((t_out, x_out, stats),
                   every_body_read[(backend, use_priors)])
    assert reads == -(-KW["max_iterations"] // readback) - 1


EARLY = dict(KW, function_tolerance=0.1, max_iterations=12)


@pytest.fixture(scope="module")
def jax_early(problem):
    """The JAX solve stopped by its function tolerance (3 of 12)."""
    (cam, t0, x0, patch, ch, g, obs, off), _ = problem
    return jax.device_get(jax.jit(lambda t, x: jlm.lm_solve(
        cam, t, x, patch, ch, g, obs, jnp.ones((N,), bool),
        jnp.asarray(_frozen()), off, backend="xla", **EARLY))(t0, x0))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_early_termination_matches_jax(problem, jax_early, backend):
    """A solve that stops before max_iterations, read back only after 8
    bodies (more than it runs): the same iterations, termination and
    accepted steps as the JAX solve, and its logs NaN past the end."""
    _, _, ref = jax_early
    (_, _, stats), reads = port_solve(problem, backend, False, 8, **EARLY)
    out = convert.stats_to_numpy(stats)
    it = int(ref.iterations)
    assert it < EARLY["max_iterations"]
    assert int(out.iterations) == it
    assert int(out.termination) == int(ref.termination) == 2
    np.testing.assert_array_equal(out.accept_log, ref.accept_log)
    np.testing.assert_allclose(out.cost_log[:it], ref.cost_log[:it],
                               rtol=1e-4)
    for name in ("cost_log", "lambda_log", "step_log"):
        assert np.isnan(getattr(ref, name)[it:]).all()
        assert np.isnan(getattr(out, name)[it:]).all(), name
    assert not out.accept_log[it:].any()
    assert reads == 1 and tlm.runs["bodies"] == 8


@pytest.mark.parametrize("ended_by", ["max_iterations", "function_tolerance"])
def test_body_on_a_finished_state_is_a_no_op(problem, ended_by):
    """One more body on a finished state returns it bitwise: after
    max_iterations bodies, and after a termination code."""
    cam, t0, x0, patch, ch, g, obs, off = port_problem(problem[0])
    kw = KW if ended_by == "max_iterations" else EARLY
    start, body = tlm.program(*tlm.setup(
        cam, t0, x0, patch, ch, g, obs, torch.ones(N, dtype=torch.bool),
        torch.as_tensor(_frozen()), off, backend="cuda", **kw))
    state, begun = start()
    for _ in range(kw["max_iterations"]):
        state = body(state)
    stats = tlm._stats(state, begun)
    assert tlm.TERMINATION_NAMES[int(stats.termination)] == ended_by
    assert_bitwise(body(state), state)


def test_prior_cost_matches_jax(problem):
    t0 = np.array(problem[0][1])
    anchor = problem[1]
    rel0 = np.array(jax.jit(lambda t: jse3.se3_inverse(t[:-1]) @ t[1:]
                            @ jse3.se3_exp(jnp.full((W - 1, 6), 0.01)))(t0))
    ref = jax.jit(lambda t, r, a: jlm.prior_cost(
        t, motion_prior_weight=3.0, rel0=r, pose_prior=(a, 2.0, 4.0)))(
        jnp.asarray(t0), jnp.asarray(rel0), jnp.asarray(anchor))
    out = tlm.prior_cost(torch.as_tensor(t0), motion_prior_weight=3.0,
                         rel0=torch.as_tensor(rel0),
                         pose_prior=(torch.as_tensor(anchor), 2.0, 4.0))
    assert float(out) > 0
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-4)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_frozen_poses_bitwise_invariant_at_world_scale(problem, backend):
    """Twin of tests/test_lm.py's regression: frozen gauge poses come out
    of the solve bitwise unchanged at KITTI-scale world coordinates (no
    reduced-precision matmul may touch pose products)."""
    cam, t_wc, x, patch, ch, g, obs, off = port_problem(problem[0])
    shift = torch.eye(4)
    shift[:3, 3] = torch.tensor([120.0, -45.0, -28.0])
    t_big = torch.einsum("ij,wjk->wik", shift, t_wc)
    x_big = tse3.transform_points(shift, x)
    frozen = torch.tensor([True, True, False, False])
    t_out, _, stats = tlm.lm_solve(
        cam, t_big, x_big, patch, ch, g, obs,
        torch.ones(N, dtype=torch.bool), frozen, off, huber_delta=1e9,
        max_iterations=8, backend=backend)
    assert int(stats.accepted_steps) >= 1
    assert torch.equal(t_out[:2], t_big[:2])


def test_min_obs_per_frame_freezes_weak_frames(problem):
    cam, t0, x0, patch, ch, g, obs, off = port_problem(problem[0])
    t_out, x_out, stats = tlm.lm_solve(
        cam, t0, x0, patch, ch, g, obs, torch.ones(N, dtype=torch.bool),
        torch.zeros(W, dtype=torch.bool), off, min_obs_per_frame=N + 1,
        **KW)
    assert torch.equal(t_out, t0)                  # every frame too weak
    assert int(stats.accepted_steps) >= 1          # points still refine
    assert not torch.equal(x_out, x0)


def test_gradient_tolerance_termination(problem):
    """At the optimum the gradient is tiny and gtol fires (code 5)."""
    cam, _, x0, patch, ch, g, obs, off = port_problem(problem[0])
    _, _, stats = tlm.lm_solve(
        cam, torch.as_tensor(problem[1]), x0 - 0.01, patch, ch, g, obs,
        torch.ones(N, dtype=torch.bool), torch.as_tensor(_frozen()), off,
        huber_delta=0.05,
        gradient_tolerance=1e-1, max_iterations=20, function_tolerance=0.0,
        parameter_tolerance=0.0)
    assert tlm.TERMINATION_NAMES[int(stats.termination)] == \
        "gradient_tolerance"
    assert int(stats.iterations) < 20


def test_make_problem_matches_jax():
    """entry.make_problem draws the same numbers as __graft_entry__."""
    cam_j, off_j, args_j = _make_problem(64, 3, 40, 72, 2, seed=3)
    cam_t, off_t, args_t = entry.make_problem(64, 3, 40, 72, 2, seed=3)
    for a, b in zip(cam_t, cam_j):
        assert float(a) == float(b)
    np.testing.assert_array_equal(to_np(off_t), np.asarray(off_j))
    names = ("t_wc", "x_world", "patch", "channels", "grads", "obs",
             "point_valid", "frozen")
    for name, a, b in zip(names, args_t, args_j):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    # Converting the JAX problem gives the port's own problem.
    cam_c, off_c, args_c = convert.problem_from_numpy(cam_j, off_j, args_j)
    assert all(float(a) == float(b) for a, b in zip(cam_c, cam_t))
    assert args_c[-1].dtype == torch.bool


def test_entry_solves_on_cpu():
    fn, args = entry.entry("cpu")
    t_out, x_out, stats = fn(*args)
    assert int(stats.iterations) >= 1
    assert float(stats.final_cost) < float(stats.initial_cost)
    assert torch.isfinite(t_out).all() and torch.isfinite(x_out).all()
