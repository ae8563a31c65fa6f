"""The patch-grid warp (cfg.patchWarp) on the port against the JAX package.

- `patch_warp_ref_geometry` and `patch_warp_frame` (both modes, reference
  slots of -1 included) against the JAX functions.
- The dense oracle `evaluate` and the gather path
  `evaluate_compressed(backend="torch")` with `patch_warp` against the JAX
  package's `evaluate` and `xla` path; the port-only properties of
  tests/test_residuals.py:483-692 (bitwise neutrality at rho = 1, the
  unit factor in the reference frame, prescaled offsets, the clamp, the
  affine map's algebra).
- The kernel path `evaluate_compressed(backend="cuda")` with the scale
  warp, which on the CPU runs ops/patch_scaled.scaled_stats_reference (the
  plain version of kernel K3), against the JAX package's `pallas` path in
  interpret mode (the Pallas kernel K3, `_warp_kernel_scaled_packed`) and
  its einsum-resample oracle (K5's path), mirroring
  tests/test_patch_stats.py:276-415.
- `lm_solve` and the engine's window solve with `patch_warp` against the
  JAX package's.

Tolerances are the JAX tests': whitened gtg / gtr atol 1e-3 rtol 1e-4,
cost rtol 1e-5, bitwise where they pin bitwise. The CUDA kernel itself is
held against its plain version on a card by tests/test_torch_cuda.py."""

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
from photobundle_torch import convert
from photobundle_torch.core import lm as tlm
from photobundle_torch.core import residuals as tres
from photobundle_torch.core.engine import PhotometricBundleAdjustment as TPBA
from photobundle_torch.geometry import se3 as tse3
from photobundle_torch.ops import patch_scaled as ps

from synthetic import make_sequence, perturb_poses
from test_engine import small_cfg
from test_patch_stats import _scaled_setup
from test_residuals import _warp_problem, setup_problem
from test_torch_engine import without_observations_at_margins
from torch_parity import (EngineTrace, port_camera, port_config,
                          port_problem, to_np)

HUBER = 0.07


def warp_problem(rng, **kw):
    """tests/test_residuals.py's two-frame warp problem (frame 0 the
    identity, frame 1 advanced along +z by dz, every point at depth z0 in
    frame 0): the JAX problem and its reference slots (all 0)."""
    *prob, ref_slot = _warp_problem(rng, **kw)
    return tuple(prob), np.array(ref_slot)


def port_warp(mode, t, x, ref_slot):
    z_ref, r_wc = tres.patch_warp_ref_geometry(t, x, torch.as_tensor(ref_slot))
    return (mode, z_ref, r_wc)


def jax_warp(mode, t, x, ref_slot):
    z_ref, r_wc = jres.patch_warp_ref_geometry(t, x, jnp.asarray(ref_slot))
    return (mode, z_ref, r_wc)


@pytest.fixture(scope="module")
def rotating():
    """A three-frame problem of the textured sphere with rotating poses,
    and reference slots spread over the window, -1 included."""
    rng = np.random.default_rng(21)
    prob = setup_problem(rng, n_pts=16, w=3)
    xi = np.zeros((3, 6), np.float32)
    xi[1, 3:] = [0.02, -0.05, 0.1]
    xi[2, 3:] = [-0.04, 0.03, -0.2]
    t = prob[1] @ jse3.se3_exp(jnp.asarray(xi))
    slot = rng.integers(-1, 3, size=16).astype(np.int32)
    slot[:3] = [-1, 0, 2]
    return (prob[0], t, *prob[2:]), slot


# ---------------------------------------------------------------------------
# Warp geometry
# ---------------------------------------------------------------------------

def test_ref_geometry_matches_jax(rotating):
    prob, slot = rotating
    tprob = port_problem(prob)
    z_t, r_t = tres.patch_warp_ref_geometry(tprob[1], tprob[2],
                                            torch.as_tensor(slot))
    z_j, r_j = jres.patch_warp_ref_geometry(prob[1], prob[2],
                                            jnp.asarray(slot))
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-6)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=1e-7)
    assert (z_t.numpy()[slot < 0] == -1.0).all()
    assert (z_t.numpy()[slot >= 0] > 0).all()


@pytest.mark.parametrize("mode", ["scale", "affine"])
def test_warp_frame_matches_jax(rotating, mode):
    """rho / M of every frame against the JAX package's; reference slots
    of -1 get the identity (rho = 1, M = I) exactly."""
    prob, slot = rotating
    tprob = port_problem(prob)
    tw = port_warp(mode, tprob[1], tprob[2], slot)
    jw = jax_warp(mode, prob[1], prob[2], slot)
    for f in range(3):
        y_t = tse3.transform_points(tse3.se3_inverse(tprob[1][f]), tprob[2])
        y_j = jse3.transform_points(jse3.se3_inverse(prob[1][f]), prob[2])
        a = tres.patch_warp_frame(mode, tprob[0], tprob[1][f], y_t, *tw[1:])
        b = jres.patch_warp_frame(mode, prob[0], prob[1][f], y_j, *jw[1:])
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
        ident = 1.0 if mode == "scale" else np.eye(2, dtype=np.float32)
        assert (a.numpy()[slot < 0] == ident).all()
        if mode == "scale":
            # Exactly 1 in each point's own reference frame.
            assert (a.numpy()[slot == f] == 1.0).all()
    assert not np.allclose(a.numpy()[slot >= 0], ident)


def test_patch_warp_identity_bitwise_neutral():
    """dz = 0: rho == 1 exactly, so the warped evaluation reproduces the
    fixed-grid one bitwise (dense oracle and gather path); the affine map
    is the identity up to one rounding."""
    prob, rs = warp_problem(np.random.default_rng(0), dz=0.0,
                             frame1_only=False)
    cam, t, x, patch, ch, g, obs, off = port_problem(prob)
    kw = dict(huber_delta=HUBER, gradient_mode="sampled")
    pw = port_warp("scale", t, x, rs)
    a = tres.evaluate(cam, t, x, patch, ch, g, obs, off, **kw)
    b = tres.evaluate(cam, t, x, patch, ch, g, obs, off, patch_warp=pw, **kw)
    for name in ("r", "j_pose", "j_point"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert float(a.cost) == float(b.cost)
    ca = tres.evaluate_compressed(cam, t, x, patch, ch, g, obs, off, **kw)
    cb = tres.evaluate_compressed(cam, t, x, patch, ch, g, obs, off,
                                  patch_warp=pw, **kw)
    assert torch.equal(ca.gtg, cb.gtg) and torch.equal(ca.gtr, cb.gtr)
    assert float(ca.cost) == float(cb.cost)
    c = tres.evaluate(cam, t, x, patch, ch, g, obs, off,
                      patch_warp=port_warp("affine", t, x, rs), **kw)
    np.testing.assert_allclose(c.r.numpy(), a.r.numpy(), atol=1e-5)


def test_patch_warp_ref_frame_always_unit():
    prob, rs = warp_problem(np.random.default_rng(1), dz=0.0)
    cam, t, x = port_problem(prob)[:3]
    for x_cur in (x, x * 1.37):
        z_ref, r_wc = tres.patch_warp_ref_geometry(t, x_cur,
                                                   torch.as_tensor(rs))
        y0 = tse3.transform_points(tse3.se3_inverse(t[0]), x_cur)
        rho = tres.patch_warp_frame("scale", cam, t[0], y0, z_ref, r_wc)
        assert torch.equal(rho, torch.ones_like(rho))


@pytest.mark.parametrize("dz,rho", [(1.0, 2.0), (-2.0, 0.5)])
def test_patch_warp_scale_equals_prescaled_offsets(dz, rho):
    prob, rs = warp_problem(np.random.default_rng(2), dz=dz)
    cam, t, x, patch, ch, g, obs, off = port_problem(prob)
    kw = dict(huber_delta=HUBER, gradient_mode="sampled")
    a = tres.evaluate(cam, t, x, patch, ch, g, obs, off * rho, **kw)
    b = tres.evaluate(cam, t, x, patch, ch, g, obs, off,
                      patch_warp=port_warp("scale", t, x, rs), **kw)
    assert torch.equal(a.r, b.r) and torch.equal(a.j_pose, b.j_pose)
    assert float(a.cost) == float(b.cost)


@pytest.mark.parametrize("dz,bound", [(1.75, 2.0), (-14.0, 0.5)])
def test_patch_warp_scale_clamped_to_bounds(dz, bound):
    prob, rs = warp_problem(np.random.default_rng(3), dz=dz)
    cam, t, x, patch, ch, g, obs, off = port_problem(prob)
    kw = dict(huber_delta=HUBER, gradient_mode="sampled")
    a = tres.evaluate(cam, t, x, patch, ch, g, obs, off * bound, **kw)
    b = tres.evaluate(cam, t, x, patch, ch, g, obs, off,
                      patch_warp=port_warp("scale", t, x, rs), **kw)
    assert torch.equal(a.r, b.r)


def test_patch_warp_affine_matches_scale_on_axial_motion():
    prob, rs = warp_problem(np.random.default_rng(4), dz=1.0)
    cam, t, x, patch, ch, g, obs, off = port_problem(prob)
    kw = dict(huber_delta=HUBER, gradient_mode="sampled")
    a = tres.evaluate(cam, t, x, patch, ch, g, obs, off,
                      patch_warp=port_warp("scale", t, x, rs), **kw)
    b = tres.evaluate(cam, t, x, patch, ch, g, obs, off,
                      patch_warp=port_warp("affine", t, x, rs), **kw)
    np.testing.assert_allclose(b.r.numpy(), a.r.numpy(), atol=1e-5)
    assert float(b.cost) == pytest.approx(float(a.cost), rel=1e-5)


def test_patch_warp_affine_rotation_math():
    """A pure in-plane roll by theta: an on-axis point gets M = R(-theta)
    at unit scale, and the reference frame the identity."""
    from photobundle_torch.geometry.camera import Camera

    cam = Camera.create(fx=128.0, fy=128.0, cx=64.0, cy=48.0, baseline=0.5)
    theta = 0.3
    c, s = np.cos(theta), np.sin(theta)
    t = torch.eye(4).repeat(2, 1, 1)
    t[1, :3, :3] = torch.tensor([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    x = torch.tensor([[0.0, 0.0, 2.0]])
    rs = np.zeros(1, np.int32)
    _, z_ref, r_wc = port_warp("affine", t, x, rs)
    y1 = tse3.transform_points(tse3.se3_inverse(t[1]), x)
    m = tres.patch_warp_frame("affine", cam, t[1], y1, z_ref, r_wc)[0]
    np.testing.assert_allclose(m.numpy(), [[c, s], [-s, c]], atol=1e-5)
    y0 = tse3.transform_points(tse3.se3_inverse(t[0]), x)
    m0 = tres.patch_warp_frame("affine", cam, t[0], y0, z_ref, r_wc)[0]
    np.testing.assert_allclose(m0.numpy(), np.eye(2), atol=1e-6)


# ---------------------------------------------------------------------------
# Dense oracle and gather path vs the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["scale", "affine"])
def test_evaluate_with_warp_matches_jax(rotating, mode):
    """The dense oracle: residuals, Jacobians and cost, and `cost_only`."""
    prob, slot = rotating
    cam, t, x, patch, ch, g, obs, off = port_problem(prob)
    kw = dict(huber_delta=HUBER, gradient_mode="sampled")
    out = tres.evaluate(cam, t, x + 0.01, patch, ch, g, obs, off,
                        patch_warp=port_warp(mode, t, x + 0.01, slot), **kw)
    ref = jres.evaluate(*prob[:2], prob[2] + 0.01, *prob[3:],
                        patch_warp=jax_warp(mode, prob[1], prob[2] + 0.01,
                                            slot), **kw)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(out.r.numpy(), np.asarray(ref.r), atol=1e-5)
    np.testing.assert_allclose(out.j_pose.numpy(), np.asarray(ref.j_pose),
                               atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(out.j_point.numpy(), np.asarray(ref.j_point),
                               atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-5)
    cost, n_res = tres.cost_only(cam, t, x + 0.01, patch, ch, g, obs, off,
                                 patch_warp=port_warp(mode, t, x + 0.01,
                                                      slot), **kw)
    assert float(cost) == float(out.cost)
    assert int(n_res) == int(ref.n_residuals)


def whitened_close(out, ref, mask=None):
    """gtg / gtr at the JAX tests' tolerance, on `mask` (W, N) if given."""
    for name in ("gtg", "gtr"):
        a, b = to_np(getattr(out, name)), np.asarray(getattr(ref, name))
        if mask is not None:
            m = mask.astype(np.float32)
            m = m[:, None, None, :] if name == "gtg" else m[:, None, :]
            a, b = a * m, b * m
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("normalize", ["mean", "affine"])
@pytest.mark.parametrize("mode", ["scale", "affine"])
def test_gather_path_with_warp_matches_jax(rotating, mode, normalize):
    prob, slot = rotating
    cam, t, x, patch, ch, g, obs, off = port_problem(prob)
    from photobundle_torch.image import patches as tpatches
    patch = tpatches.normalize_patches(patch, normalize)
    kw = dict(huber_delta=HUBER, gradient_mode="sampled",
              normalize=normalize)
    out = tres.evaluate_compressed(
        cam, t, x + 0.01, patch, ch, g, obs, off, backend="torch",
        patch_warp=port_warp(mode, t, x + 0.01, slot), **kw)
    ref = jres.evaluate_compressed(
        prob[0], prob[1], prob[2] + 0.01, jnp.asarray(patch.numpy()),
        *prob[4:], backend="xla",
        patch_warp=jax_warp(mode, prob[1], prob[2] + 0.01, slot), **kw)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    whitened_close(out, ref)
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-5)


# ---------------------------------------------------------------------------
# The kernel path (K3's plain version) vs the JAX Pallas path (interpret)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("backend", "normalize"))
def _jax_scaled(cam, t, x, patch, ch, g, obs, off, z_ref, r_wc, backend,
                normalize="mean"):
    kw = dict(interpret=True) if backend == "pallas" else {}
    return jres.evaluate_compressed(cam, t, x, patch, ch, g, obs, off, HUBER,
                                    "sampled", backend=backend,
                                    normalize=normalize,
                                    patch_warp=("scale", z_ref, r_wc), **kw)


def jax_scaled(prob, pwt, backend, normalize="mean"):
    return jax.device_get(_jax_scaled(*prob, *pwt[1:], backend,
                                      normalize=normalize))


def port_scaled(prob, pwt, normalize="mean"):
    cam, t, x, patch, ch, g, obs, off = port_problem(prob)
    pw = ("scale", *(torch.tensor(np.asarray(a)) for a in pwt[1:]))
    return tres.evaluate_compressed(cam, t, x, patch, ch, g, obs, off, HUBER,
                                    "sampled", backend="cuda",
                                    normalize=normalize, patch_warp=pw)


def scaled_margin_near(cam, t, x, z_ref, shape, pr, tol=1e-5):
    """(N, W) observations whose projection lies within `tol` px of the
    kernel path's margin 1 + rho R or Wi - 2 - rho R (ROADMAP queue 3: XLA
    and PyTorch round the projection differently). Port tensors."""
    y, uv, _, _, _ = tres._observation_geometry_pm(cam, t, x)
    z_ref = z_ref[None]
    rho = torch.where(z_ref > 0, torch.clamp(
        z_ref / torch.clamp(y[:, 2], min=1e-6), 0.5, 2.0), 1.0)
    ext = rho * pr
    near = torch.zeros_like(ext, dtype=torch.bool)
    for coord, size in ((uv[:, 0], shape[1]), (uv[:, 1], shape[0])):
        for m in (1 + ext, (size - 2) - ext):
            near |= (coord - m).abs() < tol
    return near.T.numpy()


def near_scaled_margin(prob, pwt):
    """`scaled_margin_near` of a JAX problem and warp tuple."""
    cam, t, x, _, ch, _, _, off = port_problem(prob)
    pr = (int(round(off.shape[0] ** 0.5)) - 1) // 2
    return scaled_margin_near(cam, t, x, torch.tensor(np.asarray(pwt[1])),
                              ch.shape[-2:], pr)


@pytest.mark.parametrize("dz", [1.0, -2.0, 0.6])
def test_patch_warp_scale_pallas_matches_xla(dz):
    """The kernel path's valid set is a subset of the JAX gather path's
    and equals the JAX Pallas path's (observations within 1e-5 px of the
    margin cleared from the shared state); its statistics match both."""
    prob, rs = warp_problem(np.random.default_rng(5), dz=dz, n_pts=12,
                             frame1_only=False)
    pwt = jax_warp("scale", prob[1], prob[2], rs)
    near = near_scaled_margin(prob, pwt)
    prob = (*prob[:6], prob[6] & ~jnp.asarray(near), prob[7])
    out = port_scaled(prob, pwt)
    xla, pallas = jax_scaled(prob, pwt, "xla"), jax_scaled(prob, pwt,
                                                           "pallas")
    v_out = out.valid.numpy()
    assert not np.any(v_out & ~np.asarray(xla.valid))
    np.testing.assert_array_equal(v_out, np.asarray(pallas.valid))
    assert v_out.sum() >= 0.7 * np.asarray(xla.valid).sum()
    whitened_close(out, pallas)
    whitened_close(out, xla, v_out.T)
    np.testing.assert_allclose(float(out.cost), float(pallas.cost),
                               rtol=1e-5)


def test_patch_warp_scale_pallas_identity_matches_fixed():
    """rho == 1 everywhere: the warped kernel path agrees with the fixed
    grid's (K1's plain version) on the common valid set."""
    prob, rs = warp_problem(np.random.default_rng(6), dz=0.0,
                             frame1_only=False)
    cam, t, x, patch, ch, g, obs, off = port_problem(prob)
    kw = dict(huber_delta=HUBER, gradient_mode="sampled", backend="cuda")
    fixed = tres.evaluate_compressed(cam, t, x, patch, ch, g, obs, off, **kw)
    warped = tres.evaluate_compressed(cam, t, x, patch, ch, g, obs, off,
                                      patch_warp=port_warp("scale", t, x, rs),
                                      **kw)
    both = (fixed.valid & warped.valid).T.numpy()
    assert both.sum() > 0
    whitened_close(warped, jax.tree_util.tree_map(to_np, fixed), both)


def scaled_setup(rng, **kw):
    """tests/test_patch_stats.py's setup: z_ref perturbed so that rho
    spreads over (and past) the clamp range. (JAX problem, warp tuple)."""
    *prob, pwt = _scaled_setup(rng, **kw)
    return tuple(prob), pwt


def test_scaled_grouped_matches_scaled_einsum(monkeypatch):
    """K3's plain version against the fused Pallas kernel K3 and the
    einsum-resample oracle (K5's path with mean normalization): same
    valid set, statistics and cost."""
    prob, pwt = scaled_setup(np.random.default_rng(7))
    out = port_scaled(prob, pwt)
    fused = jax_scaled(prob, pwt, "pallas")
    monkeypatch.setenv("PB_GROUPED_STATS", "0")
    oracle = jax.device_get(jres.evaluate_compressed(
        *prob, HUBER, "sampled", backend="pallas", interpret=True,
        patch_warp=pwt))
    for ref in (fused, oracle):
        np.testing.assert_array_equal(out.valid.numpy(),
                                      np.asarray(ref.valid))
        whitened_close(out, ref)
        np.testing.assert_allclose(float(out.cost), float(ref.cost),
                                   rtol=1e-5)


def test_scaled_grouped_padding_isolation():
    """Statistics of the real points are unaffected by extra masked ones."""
    prob, pwt = scaled_setup(np.random.default_rng(8), n_pts=9)
    base = port_scaled(prob, pwt)
    cam, t, x, patch, ch, g, obs, off = prob
    prob2 = (cam, t, jnp.concatenate([x, x[:4] + 50.0]),
             jnp.concatenate([patch, patch[:4]]), ch, g,
             jnp.concatenate([obs, jnp.zeros((4, 3), bool)]), off)
    pwt2 = ("scale", jnp.concatenate([pwt[1], pwt[1][:4]]),
            jnp.concatenate([pwt[2], pwt[2][:4]]))
    ext = port_scaled(prob2, pwt2)
    np.testing.assert_allclose(float(ext.cost), float(base.cost), rtol=1e-6)
    assert torch.equal(ext.gtg[..., :9], base.gtg)
    assert torch.equal(ext.gtr[..., :9], base.gtr)
    assert float(ext.gtg[..., 9:].abs().sum()) == 0.0


def test_scaled_affine_matches_jax():
    """patchWarp=scale with affine normalization (the port's K5 mode):
    against the JAX Pallas path (K5 + XLA) and the gather path."""
    from photobundle_tpu.image import patches as jpatches

    prob, pwt = scaled_setup(np.random.default_rng(9))
    prob = (*prob[:3], jpatches.affine_normalize(prob[3]), *prob[4:])
    out = port_scaled(prob, pwt, normalize="affine")
    pallas = jax_scaled(prob, pwt, "pallas", normalize="affine")
    xla = jax_scaled(prob, pwt, "xla", normalize="affine")
    np.testing.assert_array_equal(out.valid.numpy(),
                                  np.asarray(pallas.valid))
    whitened_close(out, pallas)
    whitened_close(out, xla, out.valid.numpy().T)
    np.testing.assert_allclose(float(out.cost), float(pallas.cost),
                               rtol=1e-5)


def test_scaled_right_edge_exact():
    """Observations hugging the right edge of a KITTI-wide image: the
    plain sampler's taps equal the JAX gather path's warped samples
    (tests/test_patch_stats.py's regression of the TPU panel clamp)."""
    from photobundle_tpu.image import interp as jinterp
    from photobundle_tpu.image import patches as jpatches
    from photobundle_torch.ops import patch_warp as pw

    rng = np.random.default_rng(10)
    h, wi, pr = 48, 1226, 2
    channels = rng.standard_normal((1, 1, h, wi)).astype(np.float32)
    gx, gy = jinterp.image_gradients(jnp.asarray(channels))
    grads = np.array(jnp.stack([gx, gy], axis=-1))
    n = 8
    rho = np.linspace(0.6, 1.6, n).astype(np.float32)
    u = (wi - 2.0 - 2.0 * rho - 0.3).astype(np.float32)
    uv = np.stack([u, np.full((n,), 24.6, np.float32)], -1)[:, None, :]
    s_ref, g_ref, ok = jres._sample_patches(
        jnp.asarray(channels[0]), jnp.asarray(grads[0]), jnp.asarray(uv[:, 0]),
        jpatches.patch_offsets(pr), "sampled", scale=jnp.asarray(rho))
    assert bool(ok.all())
    planes = pw.build_planes(torch.as_tensor(channels),
                             torch.as_tensor(grads))
    s, gxs, gys = ps.scaled_patches_reference(
        planes, torch.as_tensor(uv), torch.as_tensor(rho[:, None]),
        torch.ones((n, 1), dtype=torch.bool), pr)
    for got, want in ((s, s_ref), (gxs, g_ref[..., 0]), (gys, g_ref[..., 1])):
        np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
    # The taps themselves: floor(u + rho (k - R)), never clamped here.
    ty, fy, tx, fx = ps.scaled_taps(torch.as_tensor(uv),
                                    torch.as_tensor(rho[:, None]),
                                    torch.ones((n, 1), dtype=torch.bool), pr,
                                    h, wi)
    pos = uv[:, 0, 0, None] + rho[:, None] * np.arange(-pr, pr + 1,
                                                       dtype=np.float32)
    np.testing.assert_array_equal(tx[:, 0].numpy(), np.floor(pos))


def test_invalid_observations_use_the_safe_point():
    """Invalid observations (NaN coordinates and rho) are placed at the
    launcher's safe interior point: finite taps, exact zero statistics."""
    w, h, wi, pr = 2, 20, 30, 2
    planes = torch.ones((w, 1, h, wi, 4))
    uv = torch.full((3, w, 2), float("nan"))
    rho = torch.full((3, w), float("nan"))
    valid = torch.zeros((3, w), dtype=torch.bool)
    uv[1, 0] = torch.tensor([10.5, 9.25])
    rho[1, 0] = 3.0                         # clamped to PATCH_SCALE_MAX
    valid[1, 0] = True
    ty, fy, tx, fx = ps.scaled_taps(uv, rho, valid, pr, h, wi)
    for a in (ty, fy, tx, fx):
        assert torch.isfinite(a.double()).all()
    assert tx[1, 0].tolist() == [6, 8, 10, 12, 14]
    stats = ps.scaled_stats(planes, uv, rho, valid, torch.zeros((3, 1, 25)),
                            pr, "off")
    assert torch.isfinite(stats).all()
    assert float(stats[:, 1:, :].abs().sum() + stats[:, 0, [0, 2]].abs().sum()
                 ) == 0.0


# ---------------------------------------------------------------------------
# lm_solve and the engine with the warp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["scale", "affine"])
def test_patch_warp_lm_converges(mode):
    """The port's lm_solve with the warp converges and moves perturbed
    poses back toward the truth (tests/test_residuals.py's test), on the
    gather path and, for 'scale', on the kernel path's plain version.
    Seed 0 is the JAX test's `rng` fixture."""
    rng = np.random.default_rng(0)
    prob = setup_problem(rng, n_pts=16, w=3)
    cam, t_wc, x, patch, ch, g, obs, off = port_problem(prob)
    ref_slot = torch.zeros(16, dtype=torch.int32)
    frozen = torch.tensor([True, False, False])
    t_pert = t_wc.clone()
    t_pert[1:, :3, 3] += torch.as_tensor(
        np.random.default_rng(3).normal(0, 5e-3, size=(2, 3)),
        dtype=torch.float32)
    for backend in (("torch", "cuda") if mode == "scale" else ("torch",)):
        t_out, _, stats = tlm.lm_solve(
            cam, t_pert, x, patch, ch, g, obs,
            torch.ones(16, dtype=torch.bool), frozen, off, huber_delta=HUBER,
            backend=backend, patch_warp=(mode, ref_slot), max_iterations=30)
        assert float(stats.final_cost) < float(stats.initial_cost), backend
        err0 = float(torch.linalg.norm(t_pert[1:, :3, 3] - t_wc[1:, :3, 3]))
        err1 = float(torch.linalg.norm(t_out[1:, :3, 3] - t_wc[1:, :3, 3]))
        assert err1 < err0, backend


@pytest.mark.parametrize("mode", ["scale", "affine"])
def test_lm_solve_with_warp_matches_jax(mode):
    """tests/test_torch_lm.py's well-conditioned problem (48 points,
    radius 3, damped start) solved with the warp by both packages: same
    iterations, accept log, costs within 1e-4, poses within 1e-4."""
    rng = np.random.default_rng(0)
    n, w = 48, 4
    prob = setup_problem(rng, n_pts=n, w=w, radius=3)
    xi = rng.standard_normal((w, 6)).astype(np.float32) * 0.01
    xi[:2] = 0.0
    t0 = prob[1] @ jse3.se3_exp(jnp.asarray(xi))
    prob = (prob[0], t0, prob[2] + 0.01, *prob[3:])
    slot = np.random.default_rng(1).integers(-1, w, size=n).astype(np.int32)
    frozen = np.array([True, True, False, False])
    kw = dict(huber_delta=0.05, initial_lambda=1e-2, max_iterations=6,
              function_tolerance=0.0, parameter_tolerance=0.0)
    t_ref, _, ref = jax.device_get(jax.jit(
        lambda t, x, s: jlm.lm_solve(
            prob[0], t, x, *prob[3:7], jnp.ones(n, bool), jnp.asarray(frozen),
            prob[7], backend="xla", patch_warp=(mode, s), **kw))(
        prob[1], prob[2], jnp.asarray(slot)))
    cam, t, x, patch, ch, g, obs, off = port_problem(prob)
    t_out, _, stats = tlm.lm_solve(
        cam, t, x, patch, ch, g, obs, torch.ones(n, dtype=torch.bool),
        torch.as_tensor(frozen), off, backend="torch",
        patch_warp=(mode, torch.as_tensor(slot)), **kw)
    out = convert.stats_to_numpy(stats)
    assert int(out.iterations) == int(ref.iterations) == 6
    np.testing.assert_array_equal(out.accept_log, ref.accept_log)
    np.testing.assert_allclose(out.initial_cost, ref.initial_cost, rtol=1e-5)
    np.testing.assert_allclose(out.cost_log, ref.cost_log, rtol=1e-4)
    np.testing.assert_allclose(to_np(t_out), np.asarray(t_ref), atol=1e-4)


@pytest.fixture(scope="module")
def warp_solve():
    """The JAX engine with patchWarp='scale' over a jittered sequence: its
    config, engine and the pre-solve state of its first window solve."""
    cam, images, depths, poses = make_sequence(np.random.default_rng(3),
                                               n_frames=6, shape=(96, 144))
    init = perturb_poses(np.random.default_rng(11), poses, trans_sigma=0.03,
                         rot_sigma=0.003, keep_first=2)
    cfg = small_cfg(maxIterations=8, functionTolerance=0.0,
                    parameterTolerance=0.0, patchWarp="scale")
    jpba = JPBA(cam, images[0].shape, cfg)
    trace = EngineTrace(jpba)
    for i in range(5):
        jpba.add_frame(images[i], depths[i], init[i])
    return cam, images[0].shape, cfg, jpba, trace.solves[0]["before"]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_engine_window_solve_with_warp_matches_jax(warp_solve, backend):
    """One window solve with patchWarp='scale' from the JAX engine's
    carried-over state (tests/test_torch_engine.py's comparison): the
    engine hands the warp the depth prior's ref_slot."""
    cam, shape, cfg, jpba, before = warp_solve
    tpba = TPBA(port_camera(cam), shape,
                port_config(cfg).replace(solverBackend=backend), device="cpu")
    assert tpba.backend == backend
    points_np, window_np = without_observations_at_margins(tpba, *before)
    if backend == "cuda":
        # The JAX engine runs its gather path here, whose per-sample
        # validity reaches one pixel beyond the kernel path's margin
        # 1 + rho R: clear a 2 px band around that margin from the shared
        # state, so that both solves see the same observations.
        tp, tw = convert.engine_state_from_numpy(points_np, window_np)
        same = tp.ref_frame[:, None] == tw.frame_ids[None, :]
        slot = torch.where(same.any(1), torch.argmax(same.int(), 1), -1)
        z_ref, _ = tres.patch_warp_ref_geometry(tw.t_wc, tp.x_world, slot)
        near = scaled_margin_near(tpba.camera, tw.t_wc, tp.x_world, z_ref,
                                  tw.channels.shape[-2:],
                                  tpba.cfg.patchRadius, tol=2.0)
        points_np = points_np._replace(obs=points_np.obs & ~near)
    jw, jp, want, _ = jpba._optimize(
        type(window_np)(*map(jnp.asarray, window_np)),
        type(points_np)(*map(jnp.asarray, points_np)))
    points, win = convert.engine_state_from_numpy(points_np, window_np)
    tw, tp, got, _ = tpba._optimize(win, points)
    assert int(got.iterations) == int(want.iterations) == 8
    np.testing.assert_array_equal(got.accept_log.numpy(),
                                  np.asarray(want.accept_log))
    assert int(got.n_residuals) == int(want.n_residuals)
    np.testing.assert_allclose(float(got.initial_cost),
                               float(want.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(got.final_cost), float(want.final_cost),
                               rtol=1e-4)
    assert float(got.final_cost) < float(got.initial_cost)
    np.testing.assert_allclose(tw.t_wc.numpy(), np.asarray(jw.t_wc),
                               atol=1e-4)
