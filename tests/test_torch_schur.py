"""Port vs JAX package: normal equations, Schur reduction, reduced solve.

Each port function gets exactly the JAX function's inputs (converted from
numpy), so the comparison isolates that function."""

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
