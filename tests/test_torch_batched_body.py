"""The LM body over a leading batch axis (core/lm.py `program`): the
batched window solve as one body, the twin of jax.vmap(_optimize_impl).

- Each batched module at B = 3 (the torch backend's evaluation, the
  normal equations, the point terms, the reduced camera system, its
  solve) against `jax.vmap` of its JAX counterpart on the CPU, within
  the f32 tolerances of tests/test_torch_residuals.py and
  tests/test_torch_schur.py, and bitwise the port's own calls on each
  window alone, stacked.
- The reduced solve's plain version (ops/chol_solve) against
  jax.vmap(cho_factor / cho_solve) at W = 5 and 10, with one window that
  is not positive definite: NaN in that window's solution alone.
- The ordered sums' plain versions (ops/ordered_sum): each row's sum
  independent of the other rows; the matrix-product form each window's
  own product, one operator for the batch.
- The body dispatches the same aten operations at B = 1 and B = 4, on
  both backends (counted with a TorchDispatchMode): its launches do not
  grow with the batch.
- A batch refuses windows whose cameras or patch offsets differ.
- bench_lm_breakdown's batched mode on a tiny problem.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from photobundle_tpu.core import residuals as jres
from photobundle_tpu.core import schur as jschur
from photobundle_torch.core import lm as tlm
from photobundle_torch.core import residuals as tres
from photobundle_torch.core import schur as tschur
from photobundle_torch.ops import chol_solve as tchol
from photobundle_torch.ops import ordered_sum

from test_residuals import setup_problem
from torch_parity import few_threads  # noqa: F401  (module fixture)
from torch_parity import assert_fields_close, port_problem, to_np

B, N, W = 3, 10, 3
HUBER = 0.05
SHIFTS = (0.01, 0.02, 0.035)             # window b's points pushed off


def tt(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def windows():
    """B windows of tests/test_residuals.py's problem (one image set,
    points pushed off by SHIFTS[b]) with the depth prior: the JAX inputs,
    the port's stacked (B, ...) inputs and the prior arrays."""
    rng = np.random.default_rng(0)
    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=N, w=W)
    obs = obs.at[2, 1].set(False)
    slot = rng.integers(0, W, size=N).astype(np.int32)
    q = rng.uniform(0.05, 0.4, size=N).astype(np.float32)
    xs = np.stack([np.asarray(x) + d for d in SHIFTS]).astype(np.float32)
    jax_in = (cam, t_wc, xs, patch, ch, g, obs, off, slot, q)
    cam_t, t_t, _, p_t, ch_t, g_t, obs_t, off_t = port_problem(
        (cam, t_wc, x, patch, ch, g, obs, off))

    def rep(t):
        return torch.stack([t] * B)

    port_in = (cam_t, rep(t_t), torch.as_tensor(xs), rep(p_t), rep(ch_t),
               rep(g_t), rep(obs_t), off_t, rep(torch.as_tensor(slot)),
               rep(torch.as_tensor(q)))
    return jax_in, port_in


def port_eval(port_in, b=None):
    """The port's torch-backend evaluation of all windows (b None) or of
    window b alone."""
    cam, t, x, p, ch, g, obs, off, slot, q = port_in
    pick = (lambda a: a) if b is None else (lambda a: a[b])
    return tres.evaluate_compressed(
        cam, pick(t), pick(x), pick(p), pick(ch), pick(g), pick(obs), off,
        HUBER, "sampled", depth_prior=(pick(slot), pick(q), 5.0),
        backend="torch")


@pytest.fixture(scope="module")
def stats(windows):
    """(the JAX vmapped statistics, the port's batched ones)."""
    (cam, t_wc, xs, patch, ch, g, obs, off, slot, q), port_in = windows
    ref = jax.device_get(jax.jit(jax.vmap(
        lambda x: jres.evaluate_compressed(
            cam, t_wc, x, patch, ch, g, obs, off, HUBER, "sampled",
            depth_prior=(jnp.asarray(slot), jnp.asarray(q), 5.0),
            backend="xla")))(jnp.asarray(xs)))
    return ref, port_eval(port_in)


def assert_stacked_singles(batched, singles):
    """Every field of a batched result bitwise its per-window results
    stacked (NaN equal to NaN)."""
    for name, got in zip(batched._fields, batched):
        want = torch.stack([getattr(s, name) for s in singles])
        np.testing.assert_array_equal(to_np(got), to_np(want),
                                      err_msg=name)


def test_batched_evaluation_matches_vmapped_jax(stats):
    ref, out = stats
    np.testing.assert_array_equal(to_np(out.valid), np.asarray(ref.valid))
    np.testing.assert_allclose(to_np(out.cost), np.asarray(ref.cost),
                               rtol=1e-5)
    np.testing.assert_array_equal(to_np(out.n_residuals),
                                  np.asarray(ref.n_residuals))
    assert_fields_close(out, ref, ("gtg", "gtr"), atol=1e-5, rtol=1e-4)
    assert_fields_close(out, ref, ("a", "jp", "rp"), atol=1e-5, rtol=1e-5)


def test_batched_evaluation_is_stacked_singles(windows, stats):
    assert_stacked_singles(stats[1], [port_eval(windows[1], b)
                                      for b in range(B)])


def normal_eqs(stats):
    ref_stats, _ = stats
    ref = jax.device_get(jax.jit(jax.vmap(
        jschur.build_normal_equations_compressed))(ref_stats))
    port_in = tres.CompressedResiduals(*(tt(v) for v in ref_stats))
    return ref, port_in


@pytest.mark.parametrize("name", ["hpp", "hpc", "hcc", "bp", "bc"])
def test_batched_normal_equations_match_vmapped_jax(stats, name):
    ref, port_in = normal_eqs(stats)
    out = tschur.build_normal_equations_compressed(port_in)
    np.testing.assert_allclose(to_np(getattr(out, name)),
                               np.asarray(getattr(ref, name)), atol=1e-5,
                               rtol=1e-5)


def test_batched_normal_equations_are_stacked_singles(stats):
    _, port_in = normal_eqs(stats)
    assert_stacked_singles(
        tschur.build_normal_equations_compressed(port_in),
        [tschur.build_normal_equations_compressed(
            type(port_in)(*(f[b] for f in port_in))) for b in range(B)])


def system_inputs():
    """Per window: lam, point validity, frozen poses. lam is
    tests/test_torch_schur.py's 1e-3 or more: at 3e-4 this small problem's
    reduced system has a condition number of ~5e4, and both packages' f32
    solves then stand 2-3e-4 from the f64 solve of the same system."""
    lam = np.array([1e-3, 1e-2, 2e-3], np.float32)
    pv = np.ones((B, N), bool)
    pv[0, [3, 7]] = False
    pv[2, 5] = False
    frozen = np.array([[True, False, False], [True, True, False],
                       [True, False, False]])
    return lam, pv, frozen


@pytest.fixture(scope="module")
def systems(stats):
    """(JAX vmapped SchurSystem, the port's batched one, the port's
    NormalEq and system inputs)."""
    ref_eq, _ = normal_eqs(stats)
    lam, pv, frozen = system_inputs()
    ref = jax.device_get(jax.jit(jax.vmap(jschur.reduce_camera_system))(
        ref_eq, jnp.asarray(lam), jnp.asarray(pv), jnp.asarray(frozen)))
    eq = tschur.NormalEq(*(tt(v) for v in ref_eq))
    out = tschur.reduce_camera_system(eq, tt(lam), tt(pv), tt(frozen))
    return ref, out, eq, (tt(lam), tt(pv), tt(frozen))


def test_batched_point_terms_match_vmapped_jax(systems):
    ref, _, eq, (lam, pv, _) = systems
    terms = tschur.point_terms(eq, lam, pv)
    want = np.asarray(ref.hpp_inv)
    np.testing.assert_allclose(to_np(terms.hpp_inv), want,
                               atol=1e-5 * np.abs(want).max(), rtol=1e-5)
    singles = [tschur.point_terms(type(eq)(*(f[b] for f in eq)), lam[b],
                                  pv[b]) for b in range(B)]
    assert_stacked_singles(terms, singles)


def test_batched_reduced_system_matches_vmapped_jax(systems):
    ref, out, eq, (lam, pv, frozen) = systems
    for name in ("s", "rhs", "hpp_inv", "hpc_d", "bp"):
        # S = Hcc_d - sum_n Hpc^T Hpp^-1 Hpc cancels: f32 error scales
        # with the largest entry (tests/test_torch_schur.py, 1e-5 of it on
        # its window; on these three windows rhs differs by up to 1.7e-5
        # of its largest entry, as much as the single-window port of the
        # parent commit differs on them).
        want = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(to_np(getattr(out, name)), want,
                                   atol=2e-5 * np.abs(want).max(), rtol=1e-5,
                                   err_msg=name)
    assert_stacked_singles(out, [tschur.reduce_camera_system(
        type(eq)(*(f[b] for f in eq)), lam[b], pv[b], frozen[b])
        for b in range(B)])


def test_batched_solve_matches_vmapped_jax(systems):
    ref, out, _, (_, pv, frozen) = systems
    dc_r, dp_r = jax.device_get(jax.jit(jax.vmap(jschur.solve_reduced))(ref))
    dc, dp = tschur.solve_reduced(out)
    np.testing.assert_allclose(to_np(dc), np.asarray(dc_r), atol=1e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(to_np(dp), np.asarray(dp_r), atol=1e-4,
                               rtol=1e-3)
    assert float(dc[frozen].abs().max()) == 0.0        # frozen gauge poses
    assert float(dp[~pv].abs().max()) == 0.0           # invalid points
    singles = [tschur.solve_reduced(type(out)(*(f[b] for f in out)))
               for b in range(B)]
    for got, want in zip((dc, dp), zip(*singles)):
        assert torch.equal(got, torch.stack(want))


@pytest.mark.parametrize("w", [5, 10])
def test_chol_solve_plain_version_matches_vmapped_cho_solve(w):
    """Well-conditioned SPD systems (m m^T + n I) within 1e-5 of their
    scale; window 1 has a negative pivot: NaN there, in both packages,
    and nowhere else."""
    n = 6 * w
    rng = np.random.default_rng(w)
    m = rng.standard_normal((B, n, n)).astype(np.float32)
    s = (m @ m.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)
    s[1, 4, 4] = -1.0
    b = rng.standard_normal((B, n)).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda a, r: jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(a, lower=True), r)))(s, b))
    got = to_np(tchol.chol_solve(tt(s), tt(b)))
    bad = np.array([False, True, False])
    assert np.isnan(got[bad]).all() and np.isnan(want[bad]).all()
    assert np.isfinite(got[~bad]).all()
    np.testing.assert_allclose(got[~bad], want[~bad],
                               atol=1e-5 * np.abs(want[~bad]).max())
    singles = [to_np(tchol.chol_solve(tt(s[k]), tt(b[k]))) for k in range(B)]
    np.testing.assert_array_equal(got, np.stack(singles))


def test_ordered_sums_plain_version():
    """Each row's sum and dot product is the row's alone: rows summed
    with others are bitwise rows summed alone; the values are the sums."""
    rng = np.random.default_rng(1)
    a = tt(rng.standard_normal((4, 5, 37)).astype(np.float32))
    c = tt(rng.standard_normal((4, 3, 37)).astype(np.float32))
    dots = ordered_sum.row_dot(a, c)
    assert dots.shape == (4, 5, 3)
    assert torch.equal(dots[2], ordered_sum.row_dot(a[2], c[2]))
    np.testing.assert_allclose(to_np(dots), np.einsum(
        "gpk,gqk->gpq", to_np(a).astype(np.float64), to_np(c)), rtol=1e-5,
        atol=1e-5)
    sums = ordered_sum.row_sum(a, 2)
    assert torch.equal(sums[1], ordered_sum.row_sum(a[1], 2))
    np.testing.assert_allclose(to_np(sums), to_np(a).astype(
        np.float64).sum((1, 2)), rtol=1e-5)


@pytest.mark.parametrize("shape", [(1, 30, 1536), (5, 6, 1536)])
def test_ordered_sums_matmul_plain_version(shape):
    """`contract`'s plain version (the CPU's contractions of the
    Schur terms, one (6W, 3N) matrix per window, and of the pose blocks,
    W (6, 3N) matrices per window): a batch of 4 windows bitwise each
    window's own call, the values the dot products, one operator."""
    rng = np.random.default_rng(2)
    a = tt(rng.standard_normal((4, *shape)).astype(np.float32))
    c = tt(rng.standard_normal((4, *shape)).astype(np.float32))
    with Ops() as ops:
        dots = ordered_sum.contract(a, c)
    assert sum(ops.ops.values()) == 1
    for b in range(4):
        assert torch.equal(dots[b], ordered_sum.contract(a[b], c[b]))
    np.testing.assert_allclose(to_np(dots), np.einsum(
        "...pk,...qk->...pq", to_np(a).astype(np.float64), to_np(c)),
        rtol=1e-4, atol=1e-3)


class Ops(TorchDispatchMode):
    """The aten operations dispatched while it is on, by name."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_body_dispatches_the_same_operations_at_every_batch(backend):
    """One LM body at B = 1 and at B = 4 (tests/test_residuals.py's
    problem, the windows' points pushed off by different amounts, the
    motion and pose priors on): the same aten operations, as many times
    each."""
    cam, t, x, patch, ch, g, obs, off = port_problem(
        setup_problem(np.random.default_rng(0), n_pts=24, w=4))
    kw = dict(huber_delta=HUBER, initial_lambda=1e-2, max_iterations=4,
              backend=backend, motion_prior_weight=2.0, pose_prior=(t, 4.0))
    frozen = torch.tensor([True, False, False, False])
    counts = []
    for b in (1, 4):
        problems = [tlm.setup(cam, t, x + 0.01 * k, patch, ch, g, obs,
                              torch.ones(24, dtype=torch.bool), frozen, off,
                              **kw) for k in range(b)]
        start, body = tlm.program(
            tlm.stack_problems([p for p, _ in problems]), problems[0][1])
        state, _ = start()
        with Ops() as ops:
            body(state)
        counts.append(ops.ops)
    assert sum(counts[0].values()) > 100
    assert counts[0] == counts[1]


def test_batch_refuses_windows_of_other_cameras_or_offsets():
    """The body shares one camera and one patch offset grid: a batch whose
    windows differ in either is refused, and equal values held in other
    tensors are taken."""
    cam, t, x, patch, ch, g, obs, off = port_problem(
        setup_problem(np.random.default_rng(0), n_pts=12, w=3))
    rest = (t, x, patch, ch, g, obs, torch.ones(12, dtype=torch.bool),
            torch.tensor([True, False, False]))
    kw = dict(huber_delta=HUBER, max_iterations=1)

    def solve(cam_b, off_b):
        return tlm.lm_solve_batched([((cam, *rest, off), kw),
                                     ((cam_b, *rest, off_b), kw)])

    with pytest.raises(ValueError, match="camera"):
        solve(cam._replace(fx=cam.fx + 1.0), off)
    with pytest.raises(ValueError, match="offset"):
        solve(cam, off + 1.0)
    t_b, _, _ = solve(cam._replace(fx=cam.fx.clone()), off.clone())
    assert torch.equal(t_b[0], t_b[1])


def test_breakdown_batched_mode_on_the_cpu(capsys):
    from photobundle_torch.tools import bench_lm_breakdown

    rec = bench_lm_breakdown.main(["24", "3", "2", "--height", "40",
                                   "--width", "64", "--batch", "2",
                                   "--device", "cpu"])
    assert rec["batched"]["batch"] == 2
    assert rec["batched"]["body_kernels"] == rec["body_kernels"]
    assert all(rec["phases"][k]["bitwise"] for k in rec["phases"])
    assert "at B = 2" in capsys.readouterr().out
