"""Port vs JAX package: the residual statistics of the gather path.

The port's `evaluate_compressed(backend="torch")` is held against the JAX
package's `evaluate_compressed(backend="xla")` on the same numpy inputs,
plus the point-minor geometry, the prior rows and the robust weights."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photobundle_tpu.core import residuals as jres
from photobundle_tpu.image import patches as jpatches
from photobundle_torch.core import residuals as tres

from test_residuals import setup_problem
from torch_parity import assert_fields_close, port_problem, to_np

HUBER = 0.05


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=12, w=3)
    obs = obs.at[1, 2].set(False).at[4, 0].set(False)
    return cam, t_wc, x + 0.02, patch, ch, g, obs, off


def prior_arrays(n):
    rng = np.random.default_rng(2)
    return (rng.integers(0, 3, size=n).astype(np.int32),
            rng.uniform(0.05, 0.4, size=n).astype(np.float32))


@functools.partial(jax.jit, static_argnames=("mode", "normalize", "kind"))
def _xla(cam, t_wc, x, patch, ch, g, obs, off, prior, mode, normalize, kind):
    depth_prior = None if prior is None else (*prior, 5.0)
    return jres.evaluate_compressed(cam, t_wc, x, patch, ch, g, obs, off,
                                    HUBER, mode, depth_prior=depth_prior,
                                    backend="xla", normalize=normalize,
                                    robust_kind=kind)


def both(problem, mode="sampled", normalize="mean", kind="huber",
         prior=None):
    cam, t_wc, x, patch, ch, g, obs, off = problem
    if normalize == "affine":
        patch = jpatches.affine_normalize(patch)
    elif normalize == "off":
        patch = patch + 0.25
    problem = (cam, t_wc, x, patch, ch, g, obs, off)
    jprior = None if prior is None else tuple(jnp.asarray(a) for a in prior)
    ref = jax.device_get(_xla(*problem, jprior, mode, normalize, kind))
    tprior = None if prior is None else (*map(torch.as_tensor, prior), 5.0)
    cam_t, t_t, x_t, p_t, ch_t, g_t, obs_t, off_t = port_problem(problem)
    out = tres.evaluate_compressed(cam_t, t_t, x_t, p_t, ch_t, g_t, obs_t,
                                   off_t, HUBER, mode, depth_prior=tprior,
                                   backend="torch", normalize=normalize,
                                   robust_kind=kind)
    return out, ref


def assert_matches_xla(out, ref):
    np.testing.assert_array_equal(to_np(out.valid), np.asarray(ref.valid))
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-5)
    assert int(out.n_residuals) == int(ref.n_residuals)
    assert_fields_close(out, ref, ("gtg", "gtr"), atol=1e-5, rtol=1e-4)
    assert_fields_close(out, ref, ("a", "jp", "rp"), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["sampled", "exact"])
@pytest.mark.parametrize("normalize", ["mean", "off", "affine"])
def test_gather_path_matches_xla(problem, mode, normalize):
    assert_matches_xla(*both(problem, mode, normalize))


@pytest.mark.parametrize("kind", ["cauchy", "tukey", "none"])
def test_gather_path_robust_kinds_match_xla(problem, kind):
    assert_matches_xla(*both(problem, kind=kind))


def test_gather_path_depth_prior_matches_xla(problem):
    out, ref = both(problem, prior=prior_arrays(12))
    assert_matches_xla(out, ref)
    assert float(np.abs(to_np(out.rp)).sum()) > 0


@pytest.mark.parametrize("kind", ["huber", "cauchy", "tukey", "none"])
def test_robust_weight_matches_jax(kind):
    s = np.concatenate([np.zeros(1), np.geomspace(1e-8, 10.0, 40)]).astype(
        np.float32)
    ref = jres.robust_weight(jnp.asarray(s), 0.3, kind)
    out = tres.robust_weight(torch.as_tensor(s), 0.3, kind)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    with pytest.raises(ValueError):
        tres.robust_weight(torch.as_tensor(s), 0.3, "l1")


def test_point_minor_geometry_and_prior_rows_match_jax(problem):
    cam, t_wc, x = problem[:3]
    ref = jax.jit(jres._observation_geometry_pm)(cam, t_wc, x)
    cam_t, t_t, x_t = port_problem(problem)[:3]
    out = tres._observation_geometry_pm(cam_t, t_t, x_t)
    for name, a, b in zip(("y", "uv", "in_front", "a", "r_cw"), out, ref):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    valid = ref[2]
    slot, q = prior_arrays(x.shape[0])
    jp_ref = jres._prior_terms_pm(ref[4], ref[0], valid,
                                  (jnp.asarray(slot), jnp.asarray(q), 5.0),
                                  jnp.float32)
    jp_out = tres._prior_terms_pm(out[4], out[0], out[2],
                                  (torch.as_tensor(slot), torch.as_tensor(q),
                                   5.0), torch.float32)
    for a, b in zip(jp_out, jp_ref):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_backend_and_mode_errors(problem):
    args = port_problem(problem)
    with pytest.raises(ValueError, match="backend"):
        tres.evaluate_compressed(*args, HUBER, backend="xla")
    with pytest.raises(ValueError, match="gradient_mode"):
        tres.evaluate_compressed(*args, HUBER, "bogus")
    with pytest.raises(ValueError, match="gradient_mode"):
        tres.evaluate_compressed(*args, HUBER, "exact", backend="cuda")
    with pytest.raises(ValueError, match="normalization"):
        tres.evaluate_compressed(*args, HUBER, backend="cuda",
                                 normalize="affine")


@pytest.mark.parametrize("mode", ["sampled", "exact", "bicubic"])
def test_gather_path_nan_point_is_masked(problem, mode):
    """A NaN point samples to NaN on the gather path. Its observations are
    invalid: their statistics are exact zeros and the cost is the JAX
    package's, finite (XLA selects the masked terms away; a multiply by
    the 0/1 mask would keep the NaN)."""
    cam, t_wc, x, patch, ch, g, obs, off = problem
    nan_problem = (cam, t_wc, x.at[3].set(jnp.nan), patch, ch, g, obs, off)
    out, ref = both(nan_problem, mode, prior=prior_arrays(12))
    assert not to_np(out.valid)[3].any()
    for name in ("gtg", "gtr", "jp", "rp"):
        got = to_np(getattr(out, name))
        assert np.isfinite(got).all(), name
        assert (got[..., 3] == 0).all(), name
    assert np.isfinite(float(ref.cost))
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-5)
