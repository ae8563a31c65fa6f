"""Port vs JAX package: SE(3), camera, bilinear sampling, patches.

Same numpy inputs (from a seed) go through the JAX function and its
counterpart in photobundle_torch; f32 tolerances unless the JAX tests pin
an exact result."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photobundle_tpu.geometry import camera as jcam
from photobundle_tpu.geometry import se3 as jse3
from photobundle_tpu.image import interp as jinterp
from photobundle_tpu.image import patches as jpatches
from photobundle_torch.geometry import camera as tcam
from photobundle_torch.geometry import se3 as tse3
from photobundle_torch.image import interp as tinterp
from photobundle_torch.image import patches as tpatches

from torch_parity import to_np


def twists(rng, n=16):
    """Random twists, including the small-angle and near-pi branches."""
    xi = rng.standard_normal((n, 6)).astype(np.float32) * 0.5
    xi[0] = 0.0
    xi[1, 3:] = 1e-6
    xi[2, 3:] = np.array([3.05, 0.0, 0.0], np.float32)
    return xi


def poses(rng, n=16):
    return np.asarray(jax.jit(jse3.se3_exp)(jnp.asarray(twists(rng, n))))


SE3_CASES = {
    "hat": lambda m, rng: m.hat(rng.standard_normal((5, 3)).astype(np.float32)),
    "vee": lambda m, rng: m.vee(rng.standard_normal((5, 3, 3)).astype(np.float32)),
    "so3_exp": lambda m, rng: m.so3_exp(twists(rng)[:, 3:]),
    "so3_log": lambda m, rng: m.so3_log(poses(rng)[:, :3, :3]),
    "se3_exp": lambda m, rng: m.se3_exp(twists(rng)),
    "se3_log": lambda m, rng: m.se3_log(poses(rng)),
    "se3_inverse": lambda m, rng: m.se3_inverse(poses(rng)),
    "transform_points": lambda m, rng: m.transform_points(
        poses(rng, 4)[:, None], rng.standard_normal((4, 7, 3)).astype(np.float32)),
    "retract_right": lambda m, rng: m.retract_right(poses(rng), twists(rng) * 0.1),
    "rotation_geodesic_distance": lambda m, rng: m.rotation_geodesic_distance(
        poses(rng)[:, :3, :3], poses(rng)[::-1, :3, :3].copy()),
    "adjoint": lambda m, rng: m.adjoint(poses(rng)),
}


class _Jax:
    def __getattr__(self, name):
        fn = jax.jit(getattr(jse3, name))
        return lambda *a: fn(*(jnp.asarray(x) for x in a))


class _Torch:
    def __getattr__(self, name):
        fn = getattr(tse3, name)
        return lambda *a: fn(*(torch.as_tensor(np.array(x)) for x in a))


@pytest.mark.parametrize("name", sorted(SE3_CASES))
def test_se3_matches_jax(name):
    case = SE3_CASES[name]
    ref = case(_Jax(), np.random.default_rng(3))
    out = case(_Torch(), np.random.default_rng(3))
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=2e-5,
                               rtol=1e-5)


def band_twists(rng, n=256):
    """Twists at rotation angles 1e-5 to 1e-2 rad (log-uniform, random
    axes), translations of scale 0.5: through se3_log's NaN band (1e-4 to
    2.44e-4 rad, where f32 1 - cos theta rounds to 0) and the range above
    it where (1 - A/(2B)) / theta^2 cancels."""
    angle = np.exp(rng.uniform(np.log(1e-5), np.log(1e-2), n))
    axis = rng.standard_normal((n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    return np.concatenate([rng.standard_normal((n, 3)) * 0.5,
                           axis * angle[:, None]], axis=1).astype(np.float32)


def band_poses(rng, n=256):
    return np.asarray(jax.jit(jse3.se3_exp)(jnp.asarray(band_twists(rng, n))))


def band_pairs(rng, n=256):
    """Rotations R and R exp(w), w of `band_twists`' angles: 1e-5 to 1e-2
    rad apart."""
    r = band_poses(rng, n)[:, :3, :3]
    w = jax.jit(jse3.so3_exp)(jnp.asarray(band_twists(rng, n)[:, 3:]))
    return r, np.asarray(jnp.asarray(r) @ w)


# (case, abs tolerance): the twists of `band_twists` through each function
# whose small-angle arithmetic cancels.
BAND_CASES = {
    "so3_exp": (lambda m, rng: m.so3_exp(band_twists(rng)[:, 3:]), 1e-6),
    "so3_log": (lambda m, rng: m.so3_log(band_poses(rng)[:, :3, :3]), 1e-6),
    "se3_exp": (lambda m, rng: m.se3_exp(band_twists(rng)), 1e-6),
    "se3_log": (lambda m, rng: m.se3_log(band_poses(rng)), 1e-4),
    # arccos of (trace(Ra^T Rb) - 1) / 2 within a few ulps of 1: one ulp of
    # the trace (2^-22 at 3) moves it by 2^-23 and the angle by up to
    # 4.9e-4 rad, and the two packages' matrix products round the trace
    # apart. Held in the cosine domain, within two ulps of the trace.
    "rotation_geodesic_distance": (lambda m, rng: m.rotation_geodesic_distance(
        *band_pairs(rng)), 2.0 ** -22),
}
@pytest.mark.parametrize("name", sorted(BAND_CASES))
def test_se3_matches_jax_at_small_angles(name):
    """The port rounds sin and cos as the reference does (f64, then f32):
    with torch's f32 cos, se3_log was NaN on 167 of 20 000 twists where
    the reference's is not (1 - cos theta rounded to 0 up to 2.67e-4 rad
    against 2.44e-4) and 0.81 apart elsewhere. NaN rows equal, the rest
    within the tolerance."""
    case, atol = BAND_CASES[name]
    ref = np.asarray(case(_Jax(), np.random.default_rng(6)))
    out = to_np(case(_Torch(), np.random.default_rng(6)))
    if name == "rotation_geodesic_distance":
        ref, out = np.cos(ref.astype(np.float64)), np.cos(out.astype(np.float64))
    rows = len(ref)
    nan_ref = np.isnan(ref.reshape(rows, -1)).any(axis=1)
    nan_out = np.isnan(out.reshape(rows, -1)).any(axis=1)
    np.testing.assert_array_equal(nan_out, nan_ref)
    if name == "se3_log":      # the band is there, and rows above it
        assert 20 <= nan_ref.sum() < rows - 20
    np.testing.assert_allclose(out[~nan_ref], ref[~nan_ref], atol=atol,
                               rtol=0)


def _so3_log_guards():
    """so3_log's arccos and sin through its Taylor guard (theta < 1e-4)
    and its near-pi branch (theta > 3)."""
    rng = np.random.default_rng(7)
    angle = np.concatenate([np.exp(rng.uniform(np.log(1e-6), np.log(1e-3),
                                               128)),
                            rng.uniform(2.9, 3.14, 64)])
    axis = rng.standard_normal((len(angle), 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    r = np.array(jax.jit(jse3.so3_exp)(jnp.asarray(
        (axis * angle[:, None]).astype(np.float32))))
    return (jax.jit(jse3.so3_log)(jnp.asarray(r)),
            tse3.so3_log(torch.as_tensor(r)), 1e-6, 0.0)


def _cauchy():
    """Cauchy's log1p (Ceres' CauchyLoss) over s / delta^2 from 1e-10 to
    4e6: XLA's f32 log1p and torch's differ by an ulp on ~4 % of these."""
    from photobundle_tpu.core import residuals as jres
    from photobundle_torch.core import residuals as tres
    s = np.exp(np.random.default_rng(8).uniform(np.log(2.5e-13), np.log(1e4),
                                                4096)).astype(np.float32)
    ref = jax.jit(lambda v: jres.robust_weight(v, 0.05, "cauchy"))(
        jnp.asarray(s))
    out = tres.robust_weight(torch.as_tensor(s), 0.05, "cauchy")
    return np.stack([np.asarray(a) for a in ref]), torch.stack(out), 0.0, 1e-6


def _gaussian_taps():
    """The pyramid's Gaussian exp: the impulse response of the separable
    blur is tap_i * tap_j, each rounded once, so equal taps make it
    bitwise equal."""
    from photobundle_tpu.image import pyramid as jpyr
    from photobundle_torch.image import pyramid as tpyr
    img = np.zeros((4, 17, 17), np.float32)
    img[:, 8, 8] = 1.0
    sigmas = (0.5, 0.75, 1.5, 2.5)
    ref = [jax.jit(jpyr.gaussian_blur_sigma, static_argnums=1)(
        jnp.asarray(img[k]), s) for k, s in enumerate(sigmas)]
    out = [tpyr.gaussian_blur_sigma(torch.as_tensor(img[k]), s)
           for k, s in enumerate(sigmas)]
    return np.stack([np.asarray(a) for a in ref]), torch.stack(out), 0.0, 0.0


AUDIT_CASES = {"so3_log_guards": _so3_log_guards, "cauchy_log1p": _cauchy,
               "gaussian_exp": _gaussian_taps}


@pytest.mark.parametrize("name", sorted(AUDIT_CASES))
def test_transcendentals_match_jax(name):
    """The solve's and ingest's other transcendentals against the jitted
    JAX functions where they cancel or are rounded apart: NaN where the
    reference is NaN, values within the case's (atol, rtol)."""
    ref, out, atol, rtol = AUDIT_CASES[name]()
    ref, out = np.asarray(ref), to_np(out)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_allclose(out, ref, atol=atol, rtol=rtol)


def test_se3_exp_log_roundtrip_and_zero_twist_identity():
    xi = twists(np.random.default_rng(4))[3:]
    back = tse3.se3_log(tse3.se3_exp(torch.as_tensor(xi)))
    np.testing.assert_allclose(to_np(back), xi, atol=1e-4)
    # A zero update leaves a pose bitwise unchanged (the frozen-gauge path).
    t = torch.as_tensor(poses(np.random.default_rng(5)) * 40.0)
    t[..., 3, :] = torch.tensor([0.0, 0.0, 0.0, 1.0])
    assert torch.equal(tse3.retract_right(t, torch.zeros(t.shape[0], 6)), t)


def _cams():
    kw = dict(fx=250.5, fy=248.0, cx=159.5, cy=95.25, baseline=0.54)
    return jcam.Camera.create(**kw), tcam.Camera.create(**kw)


def test_camera_create_stores_f32_scalars():
    _, c = _cams()
    for v in c:
        assert v.dtype == torch.float32 and v.dim() == 0
    np.testing.assert_allclose(to_np(c.matrix()), np.asarray(_cams()[0].matrix()))
    js, ts = _cams()[0].scaled(0.5), c.scaled(0.5)
    np.testing.assert_allclose([to_np(v) for v in ts], [np.asarray(v) for v in js])


@pytest.mark.parametrize("fn", ["project", "project_jacobian", "backproject",
                                "disparity_to_depth"])
def test_camera_matches_jax(rng, fn):
    jc, tc = _cams()
    pts = rng.standard_normal((40, 3)).astype(np.float32) * 3.0
    pts[:, 2] = np.abs(pts[:, 2])
    pts[0, 2] = 0.0                      # on the camera plane: masked
    args = {
        "project": (pts,),
        "project_jacobian": (pts,),
        "backproject": (pts[:, :2] * 50.0 + 100.0, pts[:, 2] + 1.0),
        "disparity_to_depth": (pts[:, 0] * 10.0,),
    }[fn]
    ref = jax.jit(getattr(jcam, fn))(jc, *(jnp.asarray(a) for a in args))
    out = getattr(tcam, fn)(tc, *(torch.as_tensor(a) for a in args))
    ref = ref if isinstance(ref, tuple) else (ref,)
    out = out if isinstance(out, tuple) else (out,)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("fn", ["bilinear", "bilinear_with_grad"])
def test_interp_matches_jax(rng, fn):
    img = rng.standard_normal((2, 21, 33)).astype(np.float32)
    uv = rng.uniform([-2.0, -2.0], [35.0, 23.0], size=(6, 9, 2)).astype(np.float32)
    uv[0, 0] = [32.0, 20.0]              # exactly on the last pixel
    ref = jax.jit(getattr(jinterp, fn))(jnp.asarray(img), jnp.asarray(uv))
    out = getattr(tinterp, fn)(torch.as_tensor(img), torch.as_tensor(uv))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    # 2-D image form: values and validity.
    ref2 = jax.jit(getattr(jinterp, fn))(jnp.asarray(img[0]), jnp.asarray(uv))
    out2 = getattr(tinterp, fn)(torch.as_tensor(img[0]), torch.as_tensor(uv))
    np.testing.assert_allclose(to_np(out2[0]), np.asarray(ref2[0]), atol=1e-6)
    np.testing.assert_array_equal(to_np(out2[-1]), np.asarray(ref2[-1]))


def test_interp_nan_coordinate_is_masked_not_out_of_bounds():
    img = torch.arange(20.0).reshape(4, 5)
    vals, ok = tinterp.bilinear(img, torch.tensor([[float("nan"), 1.0],
                                                   [1.5, 2.0]]))
    assert not bool(ok[0]) and bool(ok[1])
    assert float(vals[1]) == pytest.approx(11.5)


def test_image_gradients_match_jax(rng):
    img = rng.standard_normal((3, 2, 17, 29)).astype(np.float32)
    ref = jinterp.image_gradients(jnp.asarray(img))
    out = tinterp.image_gradients(torch.as_tensor(img))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))


@pytest.mark.parametrize("radius", [1, 2, 3])
def test_patch_offsets_and_extract_match_jax(rng, radius):
    np.testing.assert_array_equal(to_np(tpatches.patch_offsets(radius)),
                                  np.asarray(jpatches.patch_offsets(radius)))
    img = rng.standard_normal((2, 30, 40)).astype(np.float32)
    centers = rng.uniform(0.0, 30.0, size=(11, 2)).astype(np.float32)
    off_j, off_t = jpatches.patch_offsets(radius), tpatches.patch_offsets(radius)
    ref = jax.jit(jpatches.extract_patches)(jnp.asarray(img), jnp.asarray(centers), off_j)
    out = tpatches.extract_patches(torch.as_tensor(img),
                                   torch.as_tensor(centers), off_t)
    np.testing.assert_allclose(to_np(out[0]), np.asarray(ref[0]), atol=1e-6)
    np.testing.assert_array_equal(to_np(out[1]), np.asarray(ref[1]))


@pytest.mark.parametrize("mode", ["mean", "affine", "off", True, False])
def test_patch_normalization_and_zncc_match_jax(rng, mode):
    p = rng.standard_normal((7, 2, 25)).astype(np.float32)
    q = rng.standard_normal((7, 2, 25)).astype(np.float32)
    q[0, 0] = 1.0                         # constant patch scores 0
    np.testing.assert_allclose(
        to_np(tpatches.normalize_patches(torch.as_tensor(p), mode)),
        np.asarray(jpatches.normalize_patches(jnp.asarray(p), mode)),
        atol=1e-6)
    np.testing.assert_allclose(
        to_np(tpatches.zncc(torch.as_tensor(p), torch.as_tensor(q))),
        np.asarray(jpatches.zncc(jnp.asarray(p), jnp.asarray(q))), atol=1e-6)
    assert tpatches.norm_mode(mode) == jpatches.norm_mode(mode)


def test_norm_mode_rejects_unknown():
    with pytest.raises(ValueError):
        tpatches.norm_mode("zncc")
