"""K1 and K2 with multi-channel descriptors, the port against the JAX package.

The descriptors of the upstream configuration's `descriptor` key with more
than one channel (image/descriptor.make_channels: IntensityAndGradient,
C = 3; BitPlanes, C = 8) go through the kernel path of both packages on
the same numpy inputs: on the CPU the port's `evaluate_compressed(
backend="cuda")` runs the kernels' plain versions
(ops/patch_warp.patch_stats_reference, ops/patch_bicubic.
bicubic_stats_reference), the JAX package's `evaluate_compressed(
backend="pallas", interpret=True)` its Pallas kernels in interpret mode
(K1: `_warp_kernel_packed`, or K4 with XLA's affine algebra; K2:
`_bicubic_kernel`). Tolerances are those of tests/test_patch_stats.py.

On the card, K1 and K2 at C > 1 give each (observation, channel) pair its
own thread and add the channel partials in channel order, so a C-channel
launch is bitwise the channel-ordered sum of C one-channel launches
(tests/test_torch_cuda.py, chip_smoke.py phase 20 (B)). Here the plain
versions are held to that composition within the same tolerances (their
torch sums need not run in channel order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photobundle_tpu.core import residuals as jres
from photobundle_tpu.geometry import camera as jcam
from photobundle_tpu.geometry import se3 as jse3
from photobundle_tpu.image import descriptor as jdesc
from photobundle_tpu.image import interp as jinterp
from photobundle_tpu.image import patches as jpatches
from photobundle_torch.core import residuals as tres
from photobundle_torch.ops import _common
from photobundle_torch.ops import patch_bicubic as pb
from photobundle_torch.ops import patch_warp as pw

from test_residuals import setup_problem
from torch_parity import few_threads, port_problem, to_np  # noqa: F401

HUBER = 0.07
# tests/test_patch_stats.py: the statistics within 1e-4, the A-chain
# within 1e-5, the cost within 1e-5 relative (f32 sums in another order).
# The affine mode's statistics within the tolerance tests/test_torch_
# affine.py holds its normal equations to (atol 1e-3 as
# tests/test_patch_stats.py's affine reassociation check, rtol 1e-3): the
# unit norm divides by n = |v - mean(v)|, and BitPlanes' smoothed sign
# channels are nearly constant over many patches, so the samples' ulp
# differences (XLA contracts the JAX kernel's bilinear taps into fused
# multiply-adds) reach the statistics amplified: in this test's affine
# case the port and the JAX package differ by 1.4e-4 relative at a
# statistic of 181, and each lies 2e-4 to 3e-4 from the same evaluation
# in f64.
STATS_TOL, A_TOL, COST_RTOL = 1e-4, 1e-5, 1e-5
AFFINE_STATS_TOL = 1e-3
# The wider patch radius held, one of K1's rolled-row instances (5..9).
WIDE_RADIUS = 5
# Ten points: the Pallas kernels unroll by the largest power of two
# dividing N, and interpret mode compiles every copy.
N_PTS = 10


@pytest.fixture(scope="module")
def problem():
    """tests/test_residuals.setup_problem on a 64x96 image (its points keep
    18 px from the borders: room for every patch radius held here)."""
    return setup_problem(np.random.default_rng(20), n_pts=N_PTS, w=3,
                         shape=(64, 96))


def descriptor_problem(problem, descriptor: str, norm: str, radius: int):
    """The problem with its frames turned into `descriptor`'s channels (C,
    with their gradients), each point's descriptor of patch radius
    `radius` extracted from frame 0 at its projection there and
    normalized (`norm`: mean or affine), the points moved off their true
    positions and one observation masked."""
    cam, t_wc, x, _, ch, _, obs, _ = problem
    off = jpatches.patch_offsets(radius)
    channels = jax.vmap(lambda im: jdesc.make_channels(im, descriptor))(
        ch[:, 0])                                          # (W, C, H, Wi)
    gx, gy = jinterp.image_gradients(channels)
    x_cam = jse3.transform_points(jse3.se3_inverse(t_wc[0]), x)
    uv, _ = jcam.project(cam, x_cam)
    patch, ok = jpatches.extract_patches(channels[0], jnp.round(uv), off)
    assert bool(jnp.all(ok))
    patch = (jpatches.mean_normalize(patch) if norm == "mean"
             else jpatches.affine_normalize(patch))
    return (cam, t_wc, x + 0.015, patch, channels,
            jnp.stack([gx, gy], axis=-1), obs.at[2, 1].set(False), off)


@functools.partial(jax.jit, static_argnames=("mode", "normalize"))
def _pallas(cam, t_wc, x, patch, ch, g, obs, off, mode, normalize):
    return jres.evaluate_compressed(cam, t_wc, x, patch, ch, g, obs, off,
                                    HUBER, mode, backend="pallas",
                                    interpret=True, normalize=normalize)


def both_paths(problem, mode: str, norm: str):
    """(the port's kernel path on the CPU, the JAX Pallas-interpret path)."""
    normalize = True if norm == "mean" else norm
    ref = jax.device_get(_pallas(*problem, mode, normalize))
    cam, t_wc, x, patch, ch, g, obs, off = port_problem(problem)
    out = tres.evaluate_compressed(cam, t_wc, x, patch, ch, g, obs, off,
                                   HUBER, mode, backend="cuda",
                                   normalize=normalize)
    return out, ref


def nm(x):
    """(W, ..., N) point-minor -> (N, W, ...) for mask indexing."""
    return np.moveaxis(to_np(x), -1, 0)


K1_CASES = {   # descriptor, normalization, patch radius
    "c3-mean-r2": ("IntensityAndGradient", "mean", 2),
    "c8-mean-r2": ("BitPlanes", "mean", 2),
    "c8-affine-r2": ("BitPlanes", "affine", 2),
    f"c8-mean-r{WIDE_RADIUS}": ("BitPlanes", "mean", WIDE_RADIUS),
}


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_path_matches_pallas_with_descriptor_channels(problem, case):
    """K1's plain version (every channel's sums, then their sum) against
    the JAX package's Pallas path at C = 3 and C = 8: same valid set and
    residual count, statistics, A-chain and cost within the tolerances."""
    descriptor, norm, radius = K1_CASES[case]
    prob = descriptor_problem(problem, descriptor, norm, radius)
    assert prob[4].shape[1] == (3 if descriptor == "IntensityAndGradient"
                                else 8)
    out, ref = both_paths(prob, "sampled", norm)
    np.testing.assert_array_equal(to_np(out.valid), np.asarray(ref.valid))
    assert int(out.n_residuals) == int(ref.n_residuals)
    np.testing.assert_allclose(float(out.cost), float(ref.cost),
                               rtol=COST_RTOL)
    tol = AFFINE_STATS_TOL if norm == "affine" else STATS_TOL
    for name in ("gtg", "gtr"):
        np.testing.assert_allclose(to_np(getattr(out, name)),
                                   np.asarray(getattr(ref, name)),
                                   atol=tol, rtol=tol, err_msg=name)
    np.testing.assert_allclose(to_np(out.a), np.asarray(ref.a), atol=A_TOL,
                               rtol=A_TOL, equal_nan=True)


def test_k2_path_matches_pallas_with_bitplanes(problem):
    """K2's plain version at C = 8 (BitPlanes) against the JAX package's
    bicubic kernel path, on the observations both take (the kernel paths'
    bicubic margins differ from the gather path's, not from each other)."""
    prob = descriptor_problem(problem, "BitPlanes", "mean", 2)
    out, ref = both_paths(prob, "bicubic", "mean")
    ov, rv = to_np(out.valid), np.asarray(ref.valid)
    both = ov & rv
    assert both.sum() >= 0.8 * rv.sum()
    for name in ("gtg", "gtr"):
        np.testing.assert_allclose(nm(getattr(out, name))[both],
                                   nm(getattr(ref, name))[both],
                                   atol=STATS_TOL, rtol=STATS_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(nm(out.a)[both], nm(ref.a)[both], atol=A_TOL,
                               rtol=A_TOL)
    if np.array_equal(ov, rv):
        np.testing.assert_allclose(float(out.cost), float(ref.cost),
                                   rtol=COST_RTOL)


def random_instance(kernel: str, radius: int, channels: int = 8):
    """Random planes (K1's texels or K2's values), coordinates inside the
    kernel's margins, a fifth of the observations invalid (one NaN), and
    descriptors: 3 frames of 33 points on a 30x44 image."""
    rng = np.random.default_rng(radius * 10 + channels)
    w, h, wi, n = 3, 30, 44, 33
    shape = (w, channels, h, wi) + ((4,) if kernel == "K1" else ())
    planes = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
    lo, hi = radius + 1, radius + 3
    uv = torch.as_tensor(rng.uniform([lo, lo], [wi - hi, h - hi],
                                     size=(n, w, 2)), dtype=torch.float32)
    valid = torch.as_tensor(rng.uniform(size=(n, w)) > 0.2)
    valid[5, 1] = False
    uv[5, 1] = float("nan")
    patch = torch.as_tensor(
        rng.standard_normal((n, channels, (2 * radius + 1) ** 2)),
        dtype=torch.float32)
    return planes, uv, valid, patch


PLAIN = {"K1": pw.patch_stats_reference, "K2": pb.bicubic_stats_reference}


@pytest.mark.parametrize("radius", [2, WIDE_RADIUS])
@pytest.mark.parametrize("norm", _common.NORMS)
@pytest.mark.parametrize("kernel", sorted(PLAIN))
def test_plain_versions_are_the_sum_of_their_channels(kernel, norm, radius):
    """What the card's kernels hold bitwise, their plain versions hold
    within the statistics' tolerance: a C-channel call equals the sum,
    from zeros in channel order, of C one-channel calls on each channel's
    planes and descriptor slice (the normalization is per channel), and
    invalid observations are exact zeros either way."""
    plain = PLAIN[kernel]
    planes, uv, valid, patch = random_instance(kernel, radius)
    got = plain(planes, uv, valid, patch, radius, norm)
    summed = torch.zeros_like(got)
    for ch in range(planes.shape[1]):
        summed = summed + plain(planes[:, ch:ch + 1].contiguous(), uv, valid,
                                patch[:, ch:ch + 1].contiguous(), radius,
                                norm)
    assert float(got.abs().sum()) > 0
    assert float(got[:, ~valid.T].abs().sum()) == 0.0
    assert float(summed[:, ~valid.T].abs().sum()) == 0.0
    np.testing.assert_allclose(got.numpy(), summed.numpy(), atol=STATS_TOL,
                               rtol=STATS_TOL)
