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
