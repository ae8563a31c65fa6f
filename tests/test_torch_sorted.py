"""Sorted dispatch (K1's sort-reuse variant) on the CPU.

The port's `evaluate_compressed(backend="cuda")` with a `point_order` runs
the sorted kernel's plain version (`ops/patch_warp.sorted_patch_stats_
reference`): held BITWISE to the same evaluation without the order (the
contract tests/test_patch_stats.py pins for the TPU variant), and to the
JAX package's Pallas path in interpret mode fed its own `point_order`
(f32 tolerances of tests/test_torch_patch_warp.py). `lm_solve` with
PB_SORTED_DISPATCH=1 is held bitwise to the port's unsorted solve and to
the JAX package's sorted Pallas solve within tests/test_torch_lm.py's
tolerances. The CUDA kernel is held bitwise to K1 on a card by
tests/test_torch_cuda.py and chip_smoke.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photobundle_tpu.core import lm as jlm
from photobundle_tpu.core import residuals as jres
from photobundle_tpu.geometry import se3 as jse3
from photobundle_torch import convert
from photobundle_torch.core import lm as tlm
from photobundle_torch.core import residuals as tres
from photobundle_torch.ops import patch_warp as pw

from test_residuals import setup_problem
from torch_parity import (assert_fields_close, few_threads,  # noqa: F401
                         port_problem, to_np)

HUBER = 0.07
N_PTS = 23


@pytest.fixture(scope="module")
def problem():
    """tests/test_patch_stats.py's sorted-dispatch problem: 23 points, 3
    frames, ragged validity."""
    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(
        np.random.default_rng(0), n_pts=N_PTS, w=3)
    obs = obs.at[3, 1].set(False).at[7, :].set(False)
    return cam, t_wc, x + 0.015, patch, ch, g, obs, off


def keys():
    """A scrambled key, the identity and all-equal keys (heavy ties)."""
    return {"random": np.random.default_rng(5).integers(0, 50, N_PTS),
            "identity": np.arange(N_PTS),
            "equal": np.zeros(N_PTS, np.int64)}


@functools.partial(jax.jit, static_argnames=("normalize",))
def _pallas(cam, t_wc, x, patch, ch, g, obs, off, order, normalize):
    return jres.evaluate_compressed(cam, t_wc, x, patch, ch, g, obs, off,
                                    HUBER, "sampled", backend="pallas",
                                    interpret=True, normalize=normalize,
                                    point_order=order)


def port_eval(problem, order=None, normalize=True):
    cam, t_wc, x, patch, ch, g, obs, off = port_problem(problem)
    return tres.evaluate_compressed(cam, t_wc, x, patch, ch, g, obs, off,
                                    HUBER, "sampled", backend="cuda",
                                    normalize=normalize, point_order=order)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("key", sorted(keys()))
def test_sorted_dispatch_bitwise_matches_unsorted(problem, key, normalize):
    """Mirror of tests/test_patch_stats.py's test of the same name: the
    port's sorted evaluation equals its unsorted one bitwise, and the JAX
    Pallas path with its own point order within f32 tolerance."""
    base = port_eval(problem, normalize=normalize)
    order = tres.sorted_dispatch_order(torch.as_tensor(keys()[key]))
    out = port_eval(problem, order, normalize)
    for name in ("gtg", "gtr", "jp", "rp", "valid", "a"):
        assert torch.equal(getattr(out, name), getattr(base, name)), name
    assert float(out.cost) == float(base.cost)
    jorder = jres.sorted_dispatch_order(
        jnp.asarray(keys()[key], jnp.int32), N_PTS, 2)
    ref = jax.device_get(_pallas(*problem, jorder, normalize))
    np.testing.assert_array_equal(to_np(out.valid), np.asarray(ref.valid))
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-5)
    assert_fields_close(out, ref, ("gtg", "gtr"), atol=1e-4, rtol=1e-4)


def test_sorted_dispatch_order_invariants(problem):
    """Mirror of tests/test_patch_stats.py's order invariants in the port's
    form: feed and inverse are mutually inverse permutations, keys are
    non-decreasing along feed, and ties keep index order (a stable sort,
    as jnp.argsort's)."""
    key = torch.as_tensor(np.random.default_rng(0).integers(0, 9, 37))
    feed, inverse = tres.sorted_dispatch_order(key)
    assert feed.dtype == inverse.dtype == torch.int64
    assert torch.equal(feed[inverse], torch.arange(37))
    assert torch.equal(inverse[feed], torch.arange(37))
    assert bool((torch.diff(key[feed]) >= 0).all())
    np.testing.assert_array_equal(feed.numpy(),
                                  np.argsort(key.numpy(), kind="stable"))
    # The port's key: band-major image tiles of the middle frame; points
    # not observed there sort last.
    cam, t_wc, x, patch, ch, g, obs, off = port_problem(problem)
    h, wi = ch.shape[-2:]
    dkey = tres.dispatch_key(cam, t_wc, x, obs, (h, wi))
    last = -(-h // tres.DISPATCH_BAND) * wi
    mid = t_wc.shape[0] // 2
    assert bool((dkey[~obs[:, mid]] == last).all())
    assert bool(((dkey[obs[:, mid]] >= 0) & (dkey[obs[:, mid]] < last)).all())
    _, uv, _, _, _ = tres._observation_geometry_pm(cam, t_wc, x)
    seen = obs[:, mid]
    band = torch.floor(uv[mid, 1, seen]).long() // tres.DISPATCH_BAND
    assert torch.equal(dkey[seen] // wi, band)


def test_sorted_plain_version_scatters_back(rng):
    """The sorted kernel's plain version, by hand: rows in sorted order,
    each point's sums at its own slot; bitwise the unsorted sums."""
    planes = torch.as_tensor(rng.standard_normal((2, 1, 30, 40, 4)),
                             dtype=torch.float32)
    uv = torch.as_tensor(rng.uniform(2.0, 35.0, size=(9, 2, 2)),
                         dtype=torch.float32)
    valid = torch.as_tensor(rng.uniform(size=(9, 2)) > 0.3)
    patch = torch.as_tensor(rng.standard_normal((9, 1, 25)),
                            dtype=torch.float32)
    order = tres.sorted_dispatch_order(torch.as_tensor([3, 1, 4, 1, 5, 9, 2,
                                                        6, 5]))
    before = dict(pw.sorted_patch_stats.launches)
    for norm in ("off", "mean", "affine"):
        got = pw.sorted_patch_stats(planes, uv, valid, patch, 2, order, norm)
        assert torch.equal(got, pw.patch_stats(planes, uv, valid, patch, 2,
                                               norm)), norm
    assert pw.sorted_patch_stats.launches == before     # CPU: no kernel
    assert pw.sorted_blocks(65, 5) == 10 and pw.sorted_blocks(64, 5) == 5


@pytest.fixture(scope="module")
def lm_problem():
    """tests/test_torch_lm.py's well-conditioned problem (48 points, radius
    3, damped start)."""
    rng = np.random.default_rng(0)
    prob = setup_problem(rng, n_pts=48, w=4, radius=3)
    xi = rng.standard_normal((4, 6)).astype(np.float32) * 0.01
    xi[:2] = 0.0
    t0 = prob[1] @ jse3.se3_exp(jnp.asarray(xi))
    return (prob[0], t0, prob[2] + 0.01, *prob[3:])


LM_KW = dict(huber_delta=0.05, initial_lambda=1e-2, max_iterations=6,
             function_tolerance=0.0, parameter_tolerance=0.0)
FROZEN = np.array([True, True, False, False])


def test_lm_solve_sorted_matches_unsorted_and_jax(lm_problem, monkeypatch):
    cam, t, x, patch, ch, g, obs, off = port_problem(lm_problem)
    args = (cam, t, x, patch, ch, g, obs, torch.ones(48, dtype=torch.bool),
            torch.as_tensor(FROZEN), off)
    t_u, x_u, st_u = tlm.lm_solve(*args, backend="cuda", **LM_KW)
    monkeypatch.setenv("PB_SORTED_DISPATCH", "1")
    calls = []
    sorted_stats = pw.sorted_patch_stats_reference
    monkeypatch.setattr(pw, "sorted_patch_stats_reference",
                        lambda *a, **k: calls.append(1) or sorted_stats(*a,
                                                                        **k))
    t_s, x_s, st_s = tlm.lm_solve(*args, backend="cuda", **LM_KW)
    # The solve went through the sorted plain version, once per evaluation.
    assert len(calls) == int(st_s.iterations) + 1 == 7
    assert torch.equal(t_s, t_u) and torch.equal(x_s, x_u)
    for a, b in zip(st_s, st_u):           # NaN-aware, bitwise
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # The JAX package's sorted Pallas solve (interpret mode).
    monkeypatch.setattr(jlm, "evaluate_compressed", functools.partial(
        jres.evaluate_compressed, interpret=True))
    t_ref, _, ref = jax.device_get(jax.jit(
        lambda t0, x0: jlm.lm_solve(
            lm_problem[0], t0, x0, *lm_problem[3:7], jnp.ones(48, bool),
            jnp.asarray(FROZEN), lm_problem[7], backend="pallas",
            **LM_KW))(lm_problem[1], lm_problem[2]))
    out = convert.stats_to_numpy(st_s)
    assert int(out.iterations) == int(ref.iterations) == 6
    np.testing.assert_array_equal(out.accept_log, ref.accept_log)
    np.testing.assert_allclose(out.initial_cost, ref.initial_cost, rtol=1e-5)
    np.testing.assert_allclose(out.cost_log, ref.cost_log, rtol=1e-4)
    np.testing.assert_allclose(to_np(t_s), np.asarray(t_ref), atol=1e-4)


@pytest.mark.parametrize("kw", [dict(gradient_mode="bicubic"),
                                dict(normalize="affine"),
                                dict(backend="torch")])
def test_sorted_dispatch_only_where_the_jax_package_uses_it(lm_problem,
                                                            monkeypatch, kw):
    """PB_SORTED_DISPATCH=1 leaves bicubic sampling, affine normalization
    and the gather backend on their unsorted paths."""
    monkeypatch.setenv("PB_SORTED_DISPATCH", "1")
    monkeypatch.setattr(tres, "sorted_dispatch_order",
                        lambda key: pytest.fail("sorted dispatch was used"))
    monkeypatch.setattr(tlm, "sorted_dispatch_order",
                        lambda key: pytest.fail("sorted dispatch was used"))
    cam, t, x, patch, ch, g, obs, off = port_problem(lm_problem)
    kw = dict(dict(backend="cuda"), **kw)
    if kw.get("normalize") == "affine":
        from photobundle_torch.image import patches
        patch = patches.affine_normalize(patch)
    _, _, st = tlm.lm_solve(cam, t, x, patch, ch, g, obs,
                            torch.ones(48, dtype=torch.bool),
                            torch.as_tensor(FROZEN), off,
                            **dict(LM_KW, max_iterations=1), **kw)
    assert int(st.iterations) == 1
