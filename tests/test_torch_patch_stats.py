"""K7, the fused sample + centre + statistics kernel, vs the JAX package.

On the CPU the port's `ops/patch_stats.patch_stats` runs its kernel's
plain version; it is held against the JAX package's
`ops/patch_stats.patch_stats` in Pallas interpret mode (jitted once per
shape), in both modes, at 1e-4: the two reduce the same f32 samples in
another order. Invalid observations carry NaN coordinates. The problem is
10 points x 2 frames on 40x300 images (see tests/test_torch_samples.py for
why 10), and at R = 62, the reference's widest patch, 2 points x 1 frame
on a 140x300 image. Every valid window lies inside the image: the JAX
kernel clamps a window into its zero-padded last panel where the port
clamps it inside the image (ROADMAP.md, known differences). The CUDA
kernel itself is held against its plain version on a card by
tests/test_torch_cuda.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photobundle_tpu.ops import patch_stats as jps
from photobundle_torch.ops import patch_bicubic as pb
from photobundle_torch.ops import patch_stats as k7
from photobundle_torch.ops import patch_warp as pw

from torch_parity import few_threads  # noqa: F401

N_PTS, W, H, WI = 10, 2, 40, 300
WIDEST = 62                               # ops/_common.STATS_MAX
# (radius, channels): the compile-time instances' unrolled and rolled
# rows, the runtime-radius instance, and the widest patch.
CASES = [(1, 1), (2, 2), (3, 1), (5, 1), (5, 2), (10, 1), (10, 2),
         (WIDEST, 1)]


def sizes(radius: int):
    """(points, frames, height, width) of a case's problem."""
    return (2, 1, 140, WI) if radius == WIDEST else (N_PTS, W, H, WI)


@functools.lru_cache(maxsize=None)
def inputs(radius: int, channels: int):
    """Values in [0, 1), gradients in [-0.5, 0.5), mean-normalized
    descriptors; NaN coordinates on invalid observations. Valid
    coordinates keep their (2R+2)-px window inside the image: x0 =
    floor(u) - R in [0, Wi - 2R - 2]."""
    n, w, h, wi = sizes(radius)
    rng = np.random.default_rng(100 + 10 * radius + channels)
    ps = 2 * radius + 1
    ch = rng.random((w, channels, h, wi), np.float32)
    grads = rng.random((w, channels, h, wi, 2), np.float32) - 0.5
    lo, hi = max(8.0, radius + 0.5), max(8.0, radius + 2.5)
    uv = rng.uniform([lo, lo], [wi - hi, h - hi],
                     size=(n, w, 2)).astype(np.float32)
    valid = rng.uniform(size=(n, w)) > 0.25
    if radius == WIDEST:
        valid[:] = True
    else:
        valid[1, 0] = False
    uv[~valid] = np.nan
    d = rng.standard_normal((n, channels, ps, ps)).astype(np.float32)
    d -= d.mean(axis=(2, 3), keepdims=True)
    return ch, grads, uv, valid, d


@functools.lru_cache(maxsize=None)
def jax_stats(radius: int, channels: int, cost_only: bool):
    ch, grads, uv, valid, d = inputs(radius, channels)
    panels = (jps.build_panels(jnp.asarray(ch), radius) if cost_only else
              jps.build_interleaved_panels(jnp.asarray(ch),
                                           jnp.asarray(grads), radius))
    return jax.device_get(jps.patch_stats(
        panels, jnp.asarray(uv), jnp.asarray(valid), jnp.asarray(d), radius,
        interpret=True, cost_only=cost_only))


def port_stats(radius: int, channels: int, cost_only: bool):
    ch, grads, uv, valid, d = inputs(radius, channels)
    planes = (pb.build_value_planes(torch.as_tensor(ch)) if cost_only else
              pw.build_planes(torch.as_tensor(ch), torch.as_tensor(grads)))
    return k7.patch_stats(planes, torch.as_tensor(uv), torch.as_tensor(valid),
                          torch.as_tensor(d), radius, cost_only=cost_only)


@pytest.mark.parametrize("cost_only", [False, True])
@pytest.mark.parametrize("radius,channels", CASES)
def test_matches_jax_patch_stats(radius, channels, cost_only):
    valid = inputs(radius, channels)[3]
    ref = jax_stats(radius, channels, cost_only)
    out = port_stats(radius, channels, cost_only)
    n, w = valid.shape
    shapes = [(n, w, 2, 2), (n, w, 2), (n, w)]
    for got, want, shape, name in zip(out, ref, shapes,
                                      ("gtg", "gtr", "rnorm2")):
        assert tuple(got.shape) == shape, name
        assert torch.isfinite(got).all(), name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4, err_msg=name)
        assert (got.numpy()[~valid] == 0).all(), name
    assert float(out[2].sum()) > 0
    if cost_only:
        assert float(out[0].abs().sum() + out[1].abs().sum()) == 0.0


@pytest.mark.parametrize("radius,channels", CASES)
def test_cost_only_rr_is_the_full_modes_bitwise(radius, channels):
    """cost_only samples the value from value planes by the same operations
    in the same order as the full mode: its Σr² is the full mode's,
    bitwise."""
    full = port_stats(radius, channels, False)
    cost = port_stats(radius, channels, True)
    assert torch.equal(full[2], cost[2])


def test_kernel_rows_layout_and_cpu_plain_version():
    """The kernel's (W * N, 8) frame-major rows [gxx, gxy, gyy, gxr, gyr,
    rr, 0, 0], unpacked by `patch_stats`; CPU tensors launch nothing."""
    ch, grads, uv, valid, d = inputs(2, 2)
    planes = pw.build_planes(torch.as_tensor(ch), torch.as_tensor(grads))
    args = (torch.as_tensor(uv), torch.as_tensor(valid), torch.as_tensor(d))
    before = dict(k7.patch_stats.launches)
    rows = k7.stats_rows(planes, *args, 2)
    gtg, gtr, rr = k7.patch_stats(planes, *args, 2)
    assert k7.patch_stats.launches == before
    assert set(before) == set(k7.MODES)
    assert rows.shape == (W * N_PTS, 8)
    assert float(rows[:, 6:].abs().sum()) == 0.0
    p, f = 4, 1
    row = rows[f * N_PTS + p]
    assert torch.equal(row[:6], torch.stack([gtg[p, f, 0, 0], gtg[p, f, 0, 1],
                                             gtg[p, f, 1, 1], gtr[p, f, 0],
                                             gtr[p, f, 1], rr[p, f]]))
    assert torch.equal(gtg[..., 0, 1], gtg[..., 1, 0])


def test_centring_order_is_k7s_own():
    """K7 centres s before subtracting d; with a descriptor whose mean is
    not zero its Σr² differs from K1's mean mode (which centres s - d) by
    P · mean(d)² per channel, and equals it for a mean-normalized one up
    to rounding."""
    ch, grads, uv, valid, d = inputs(2, 1)
    planes = pw.build_planes(torch.as_tensor(ch), torch.as_tensor(grads))
    uv_t, valid_t = torch.as_tensor(uv), torch.as_tensor(valid)
    d_t = torch.as_tensor(d)
    k1 = pw.patch_stats(planes, uv_t, valid_t, d_t.reshape(N_PTS, 1, 25), 2)
    _, _, rr = k7.patch_stats(planes, uv_t, valid_t, d_t, 2)
    np.testing.assert_allclose(rr.T.numpy(), k1[5].numpy(), rtol=1e-5,
                               atol=1e-6)
    _, _, rr_shift = k7.patch_stats(planes, uv_t, valid_t, d_t + 0.1, 2)
    np.testing.assert_allclose((rr_shift - rr)[valid].numpy(), 25 * 0.01,
                               rtol=1e-3)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    planes = torch.zeros((1, 1, 16, 16, 4))
    args = (torch.zeros((2, 1, 2)), torch.ones((2, 1), dtype=torch.bool),
            torch.zeros((2, 1, 5, 5)))
    with pytest.raises(ValueError, match="meta"):
        k7.patch_stats(planes.to("meta"), *args, 2)
    gtg, gtr, rr = k7.patch_stats(planes, *args, 2)
    assert gtg.shape == (2, 1, 2, 2) and float(rr.abs().sum()) == 0.0
