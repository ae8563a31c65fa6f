"""Wide fixed-grid patches (R = 10 and 19) on the CPU: the port's kernel
path against the JAX package.

The port's K1 and K2 take the patch radii the JAX package's accelerator
path takes on the fixed grid (K1 to R = 19, K2 to R = 61), through a
runtime-radius instance above R = 9. On the CPU, `evaluate_compressed(
backend="cuda")` runs those kernels' plain versions
(`ops/patch_warp.patch_stats_reference`, `ops/patch_bicubic.
bicubic_stats_reference`); here they are held against the JAX package's
`evaluate_compressed(backend="xla")` (its gather path, jitted once per
shape) on the same numpy inputs. The problem keeps every observation well
inside both paths' margins (which differ by one pixel), so both take the
same observations. Tolerances: the statistics to 1e-4 relative (f32 sums
of up to 1521 products in another order, and XLA's bicubic takes each
sample's phase from uv + offset, which rounds), the cost to 1e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from photobundle_tpu.core import residuals as jres
from photobundle_tpu.geometry import camera as jcam
from photobundle_tpu.geometry import se3
from photobundle_tpu.image import interp, patches
from photobundle_torch.core import residuals as tres

from synthetic import make_sequence
from torch_parity import assert_fields_close, port_problem, to_np

HUBER = 0.07
SHAPE = (96, 144)


def wide_problem(radius, n_pts=10, w=3, seed=5):
    """tests/test_residuals.setup_problem's sphere problem with points far
    enough inside frame 0 for a (2R+1)^2 patch and the motion of the
    window: (cam, t_wc, x_world, patch, channels, grads, obs, offsets)."""
    rng = np.random.default_rng(seed)
    cam, images, depths, poses = make_sequence(rng, n_frames=w, shape=SHAPE,
                                               motion_scale=0.02)
    offsets = patches.patch_offsets(radius)
    channels = jnp.asarray(np.stack(images))[:, None]
    gx, gy = interp.image_gradients(channels)
    grads = jnp.stack([gx, gy], axis=-1)
    h, wi = SHAPE
    lo = radius + 8
    uv = rng.uniform([lo, lo], [wi - lo, h - lo],
                     size=(n_pts, 2)).astype(np.float32)
    z = np.stack([depths[0][int(v), int(u)] for u, v in uv])
    x_cam = jcam.backproject(cam, jnp.asarray(np.floor(uv)), jnp.asarray(z))
    x_world = se3.transform_points(jnp.asarray(poses[0]), x_cam)
    patch, ok = patches.extract_patches(channels[0], jnp.asarray(np.floor(uv)),
                                        offsets)
    assert bool(jnp.all(ok))
    patch = patches.mean_normalize(patch)
    obs = jnp.ones((n_pts, w), bool)
    return (cam, jnp.asarray(poses), x_world + 0.01, patch, channels, grads,
            obs, offsets)


@functools.partial(jax.jit, static_argnames=("mode", "normalize"))
def _xla(cam, t_wc, x, patch, ch, g, obs, off, mode, normalize):
    return jres.evaluate_compressed(cam, t_wc, x, patch, ch, g, obs, off,
                                    HUBER, mode, backend="xla",
                                    normalize=normalize)


@pytest.fixture(scope="module")
def problems():
    return {r: wide_problem(r) for r in (10, 19)}


@pytest.mark.parametrize("radius", [10, 19])
@pytest.mark.parametrize("mode,normalize", [("sampled", "mean"),
                                            ("sampled", "affine"),
                                            ("bicubic", "mean")])
def test_wide_patch_kernel_path_matches_jax(problems, radius, mode,
                                            normalize):
    """K1 (sampled: mean, and K4's affine mode) and K2 (bicubic) at a
    radius past the port's compile-time instances: the plain versions of
    their runtime-radius kernels match the JAX package."""
    cam, t_wc, x, patch, ch, g, obs, off = problems[radius]
    if normalize == "affine":
        patch = patches.affine_normalize(patch)
    problem = (cam, t_wc, x, patch, ch, g, obs, off)
    ref = jax.device_get(_xla(*problem, mode, normalize))
    out = tres.evaluate_compressed(*port_problem(problem), HUBER, mode,
                                   backend="cuda", normalize=normalize)
    np.testing.assert_array_equal(to_np(out.valid), np.asarray(ref.valid))
    assert int(out.n_residuals) == int(ref.n_residuals) > 0
    assert bool(np.asarray(ref.valid).all())
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-5)
    scale = {name: float(np.abs(np.asarray(getattr(ref, name))).max())
             for name in ("gtg", "gtr")}
    for name in ("gtg", "gtr"):
        assert_fields_close(out, ref, (name,), atol=1e-5 * scale[name],
                            rtol=1e-4)
