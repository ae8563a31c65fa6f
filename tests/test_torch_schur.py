"""Port vs JAX package: normal equations, Schur reduction, reduced solve.

Each port function gets exactly the JAX function's inputs (converted from
numpy), so the comparison isolates that function."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photobundle_tpu.core import residuals as jres
from photobundle_tpu.core import schur as jschur
from photobundle_torch.core import residuals as tres
from photobundle_torch.core import schur as tschur

from test_residuals import setup_problem
from torch_parity import to_np

N, W = 10, 3


def tt(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def stats():
    """JAX CompressedResiduals of a small problem with the depth prior."""
    rng = np.random.default_rng(0)
    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=N, w=W)
    obs = obs.at[2, 1].set(False)
    slot = jnp.asarray(rng.integers(0, W, size=N), jnp.int32)
    q = jnp.asarray(rng.uniform(0.05, 0.4, size=N).astype(np.float32))
    return jax.device_get(jax.jit(lambda xx: jres.evaluate_compressed(
        cam, t_wc, xx, patch, ch, g, obs, off, 0.05, "sampled",
        depth_prior=(slot, q, 5.0), backend="xla"))(x + 0.02))


@pytest.fixture(scope="module")
def eqs(stats):
    ref = jax.device_get(
        jax.jit(jschur.build_normal_equations_compressed)(stats))
    port_in = tres.CompressedResiduals(*(tt(v) for v in stats))
    return ref, tschur.build_normal_equations_compressed(port_in)


def system_inputs():
    rng = np.random.default_rng(3)
    coup = rng.standard_normal((W, W, 6, 6)).astype(np.float32) * 1e-3
    coup = coup + coup.transpose(1, 0, 3, 2)        # symmetric coupling
    coup[np.arange(W), np.arange(W)] = 0.0
    point_valid = np.ones(N, bool)
    point_valid[[3, 7]] = False
    frozen = np.array([True, False, False])
    return np.float32(1e-3), point_valid, frozen, coup


@pytest.mark.parametrize("name", ["hpp", "hpc", "hcc", "bp", "bc"])
def test_normal_equations_match_jax(eqs, name):
    ref, out = eqs
    np.testing.assert_allclose(to_np(getattr(out, name)),
                               np.asarray(getattr(ref, name)), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("coupling", [False, True])
def test_reduced_system_and_solve_match_jax(eqs, coupling):
    ref_eq, _ = eqs
    lam, pv, frozen, coup = system_inputs()
    coup = coup if coupling else None
    ref = jax.jit(jschur.reduce_camera_system)(
        ref_eq, jnp.asarray(lam), jnp.asarray(pv), jnp.asarray(frozen),
        pose_coupling=None if coup is None else jnp.asarray(coup))
    out = tschur.reduce_camera_system(
        tschur.NormalEq(*(tt(v) for v in ref_eq)), tt(lam), tt(pv),
        tt(frozen), pose_coupling=None if coup is None else tt(coup))
    for name in ("s", "rhs", "hpp_inv", "hpc_d", "bp"):
        # S = Hcc_d - sum_n Hpc^T Hpp^-1 Hpc cancels: f32 error scales
        # with the largest entry, not with each entry.
        want = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(to_np(getattr(out, name)), want,
                                   atol=1e-5 * np.abs(want).max(), rtol=1e-5,
                                   err_msg=name)
    dc_r, dp_r = jax.jit(jschur.solve_reduced)(ref)
    dc, dp = tschur.solve_reduced(out)
    np.testing.assert_allclose(to_np(dc), np.asarray(dc_r), atol=1e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(to_np(dp), np.asarray(dp_r), atol=1e-4,
                               rtol=1e-3)
    assert float(dc[0].abs().max()) == 0.0              # frozen gauge pose
    assert float(dp[[3, 7]].abs().max()) == 0.0         # invalid points
    pred_r = jschur.predicted_reduction(ref_eq, jnp.asarray(lam), dc_r, dp_r)
    pred = tschur.predicted_reduction(
        tschur.NormalEq(*(tt(v) for v in ref_eq)), tt(lam), tt(dc_r),
        tt(dp_r))
    np.testing.assert_allclose(float(pred), float(pred_r), rtol=1e-5)


def test_damping_and_inverse_match_jax():
    rng = np.random.default_rng(4)
    m = rng.standard_normal((3, 3, 20)).astype(np.float32)
    m = np.einsum("ijn,kjn->ikn", m, m)                  # SPD blocks
    m[..., 0] = 0.0                                      # singular block
    valid = np.ones(20, bool)
    valid[5] = False
    lam = np.float32(0.1)
    np.testing.assert_allclose(
        to_np(tschur._damped_nlast(tt(m), tt(lam))),
        np.asarray(jschur._damped_nlast(jnp.asarray(m), jnp.asarray(lam))),
        rtol=1e-6)
    inv = tschur.inv3x3_nlast(tt(m), tt(valid))
    np.testing.assert_allclose(
        to_np(inv), np.asarray(jschur.inv3x3_nlast(jnp.asarray(m),
                                                   jnp.asarray(valid))),
        rtol=1e-4, atol=1e-5)
    assert float(inv[..., 0].abs().max()) == 0.0
    assert float(inv[..., 5].abs().max()) == 0.0
    h = np.moveaxis(m, -1, 0)[:4]
    np.testing.assert_allclose(
        to_np(tschur._damped(tt(h), tt(lam))),
        np.asarray(jschur._damped(jnp.asarray(h), jnp.asarray(lam))),
        rtol=1e-6)


def test_failed_factorization_gives_nan_step_not_an_exception():
    w6, n = 12, 4
    sys = tschur.SchurSystem(
        s=-torch.eye(w6), rhs=torch.ones(w6),
        hpp_inv=torch.zeros((3, 3, n)), hpc_d=torch.zeros((2, 3, 6, n)),
        bp=torch.zeros((3, n)))
    dc, dp = tschur.solve_reduced(sys)
    assert bool(torch.isnan(dc).all())


@pytest.mark.parametrize("layout", ["point_minor", "point_major"])
def test_solve_dense_full_matches_jax(eqs, layout):
    """The dense oracle on the JAX oracle's inputs, in either layout,
    damped with lambda = 1: the two dense f32 LU solves then agree to
    1e-5 (at system_inputs()' lambda = 1e-3 the system's conditioning
    amplifies their different rounding to ~3e-4)."""
    ref_eq, _ = eqs
    _, pv, frozen, _ = system_inputs()
    lam = np.float32(1.0)
    port_eq = tschur.NormalEq(*(tt(v) for v in ref_eq))
    jax_eq = ref_eq
    if layout == "point_major":
        port_eq = tschur.to_point_major(port_eq)
        jax_eq = jschur.to_point_major(ref_eq)
    dc_r, dp_r = jax.jit(jschur.solve_dense_full)(
        jax_eq, jnp.asarray(lam), jnp.asarray(pv), jnp.asarray(frozen))
    dc, dp = tschur.solve_dense_full(port_eq, tt(lam), tt(pv), tt(frozen))
    np.testing.assert_allclose(to_np(dc), np.asarray(dc_r), rtol=1e-5)
    np.testing.assert_allclose(to_np(dp), np.asarray(dp_r), rtol=1e-5)


def test_schur_solve_matches_dense_oracle(eqs):
    """tests/test_schur.py's check on the port: the Schur step equals the
    full damped system solved densely, gauge and invalid points exactly
    still."""
    _, eq = eqs
    lam, pv, frozen, _ = (tt(v) for v in system_inputs())
    dc_s, dp_s = tschur.solve_reduced(
        tschur.reduce_camera_system(eq, lam, pv, frozen))
    dc_d, dp_d = tschur.solve_dense_full(eq, lam, pv, frozen)
    np.testing.assert_allclose(to_np(dc_s), to_np(dc_d), atol=1e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(to_np(dp_s), to_np(dp_d), atol=1e-4,
                               rtol=1e-3)
    assert float(dc_s[0].abs().max()) == float(dc_d[0].abs().max()) == 0.0
    assert float(dp_d[[3, 7]].abs().max()) == 0.0


# -- the dense oracles: inv3x3 and build_normal_equations ----------------

def test_inv3x3_matches_numpy_and_jax():
    """tests/test_schur.py's inverse on seeded SPD blocks, (..., 3, 3):
    against numpy's f64 inverse of the f32 blocks and the JAX inv3x3."""
    rng = np.random.default_rng(5)
    m = rng.standard_normal((20, 3, 3)).astype(np.float32)
    m = (m @ m.transpose(0, 2, 1) + 0.5 * np.eye(3)).astype(np.float32)
    inv = to_np(tschur.inv3x3(tt(m)))
    np.testing.assert_allclose(inv, np.linalg.inv(m.astype(np.float64)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(inv, np.asarray(jschur.inv3x3(jnp.asarray(m))),
                               rtol=1e-5, atol=1e-5)
    # The (3, 3, N) form is the same function.
    assert torch.equal(tschur.inv3x3(tt(m)),
                       tschur.inv3x3_nlast(tt(m).permute(1, 2, 0))
                       .permute(2, 0, 1))


def test_inv3x3_singular_returns_zero():
    assert float(tschur.inv3x3(torch.zeros((2, 3, 3))).abs().max()) == 0.0


def test_inv3x3_respects_valid_mask():
    m = torch.eye(3).repeat(3, 1, 1)
    inv = tschur.inv3x3(m, torch.tensor([True, False, True]))
    assert float(inv[1].abs().max()) == 0.0
    assert torch.equal(inv[0], torch.eye(3)) and torch.equal(inv[2],
                                                             torch.eye(3))


@functools.lru_cache(maxsize=1)
def dense_eqs(n, w):
    """Both packages' dense `evaluate` on tests/test_schur.py's problem
    (setup_problem, x + 0.01), and each one's build_normal_equations."""
    from torch_parity import port_problem
    rng = np.random.default_rng(0)
    problem = setup_problem(rng, n_pts=n, w=w)
    cam, t_wc, x, patch, ch, g, obs, off = problem
    kw = dict(huber_delta=1e9, gradient_mode="exact")
    ref = jres.evaluate(cam, t_wc, x + 0.01, patch, ch, g, obs, off, **kw)
    pcam, pt, px, ppatch, pch, pg, pobs, poff = port_problem(problem)
    out = tres.evaluate(pcam, pt, px + 0.01, ppatch, pch, pg, pobs, poff,
                        **kw)
    return (jschur.build_normal_equations(ref), ref,
            tschur.build_normal_equations(out), out)


@pytest.mark.parametrize("name", ["hpp", "hpc", "hcc", "bp", "bc"])
def test_dense_normal_equations_match_jax(name):
    """The port's oracle on the port's `evaluate` against the JAX one on
    the JAX `evaluate`, from the same numpy problem, at
    tests/test_schur.py's tolerance (atol 1e-3)."""
    ref, _, out, _ = dense_eqs(5, 3)
    assert isinstance(out, tschur.NormalEqDense)
    np.testing.assert_allclose(to_np(getattr(out, name)),
                               np.asarray(getattr(ref, name)), atol=1e-3,
                               rtol=1e-4)


def test_dense_normal_equations_are_the_dense_jtj():
    """tests/test_schur.py's dense J^T J check on the port."""
    _, _, eq, out = dense_eqs(5, 3)
    n, w, d = out.r.shape
    j = np.zeros((n * w * d, 6 * w + 3 * n), np.float32)
    r_flat = np.zeros((n * w * d,), np.float32)
    jp, jx, rr = to_np(out.j_pose), to_np(out.j_point), to_np(out.r)
    for p in range(n):
        for f in range(w):
            rows = slice((p * w + f) * d, (p * w + f + 1) * d)
            j[rows, 6 * f:6 * f + 6] = jp[p, f]
            j[rows, 6 * w + 3 * p:6 * w + 3 * p + 3] = jx[p, f]
            r_flat[rows] = rr[p, f]
    h, b = j.T @ j, -j.T @ r_flat
    for f in range(w):
        np.testing.assert_allclose(to_np(eq.hcc[f]),
                                   h[6 * f:6 * f + 6, 6 * f:6 * f + 6],
                                   atol=1e-3)
    for p in range(n):
        o = 6 * w + 3 * p
        np.testing.assert_allclose(to_np(eq.hpp[p]), h[o:o + 3, o:o + 3],
                                   atol=1e-3)
        for f in range(w):
            np.testing.assert_allclose(to_np(eq.hpc[p, f]),
                                       h[o:o + 3, 6 * f:6 * f + 6], atol=1e-3)
    np.testing.assert_allclose(to_np(eq.bc).reshape(-1), b[:6 * w],
                               atol=1e-3)
    np.testing.assert_allclose(to_np(eq.bp).reshape(-1), b[6 * w:],
                               atol=1e-3)


@pytest.mark.parametrize("prior", [False, True])
def test_compressed_normal_equations_match_dense(prior):
    """tests/test_schur.py:136-167 on the port: the compressed equations
    (the solve's) against the dense oracle's, Huber and masks included,
    with and without the inverse-depth prior, atol 2e-3."""
    from torch_parity import port_problem
    rng = np.random.default_rng(0)
    n = 7 if prior else 9
    cam, t_wc, x, patch, ch, g, obs, off = port_problem(
        setup_problem(rng, n_pts=n, w=3))
    kw = dict(huber_delta=0.05, gradient_mode="sampled")
    if prior:
        kw["depth_prior"] = (torch.as_tensor(rng.integers(0, 3, size=n)),
                             torch.as_tensor(rng.uniform(
                                 0.05, 0.4, size=n).astype(np.float32)), 5.0)
    else:
        obs = obs.clone()
        obs[1, 2] = obs[4, 0] = False
    full = tres.evaluate(cam, t_wc, x + 0.02, patch, ch, g, obs, off, **kw)
    comp = tres.evaluate_compressed(cam, t_wc, x + 0.02, patch, ch, g, obs,
                                    off, **kw)
    np.testing.assert_allclose(float(comp.cost), float(full.cost), rtol=1e-5)
    assert int(comp.n_residuals) == int(full.n_residuals)
    got = tschur.to_point_major(tschur.build_normal_equations_compressed(comp))
    want = tschur.build_normal_equations(full)
    for name in ("hpp", "hpc", "hcc", "bp", "bc"):
        np.testing.assert_allclose(to_np(getattr(got, name)),
                                   to_np(getattr(want, name)), atol=2e-3,
                                   rtol=1e-4, err_msg=name)
