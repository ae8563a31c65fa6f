"""The port's stereo (image/stereo.py) and speckle filter (io/speckle.py).

- tests/test_stereo.py's cases on the port: known disparities recovered,
  flat regions rejected, sub-pixel accuracy, SGM, the X-Sobel prefilter.
- Parity with the JAX functions on the same images: `_box_filter` is a
  cumulative sum whose f32 rounding follows the summation order (XLA's and
  PyTorch's differ), so a pixel whose best and runner-up costs are within
  that rounding may decide differently. Tolerance (the one
  tests/test_native.py holds the native matcher to): validity differs on
  at most 0.5 % of the pixels, and where both accept the disparities agree
  within 5e-3 px.
- The speckle filter against the JAX package's, bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from photobundle_tpu.image import stereo as jstereo
from photobundle_tpu.native import speckle_filter_numpy as jspeckle
from photobundle_torch.image import stereo
from photobundle_torch.io.speckle import speckle_filter_numpy

from test_native import _stereo_pair
from test_stereo import shifted_pair

VALIDITY_SHARE, DISP_ATOL = 0.005, 5e-3


def bm(left, right, **kw):
    d, v = stereo.block_match(torch.as_tensor(left), torch.as_tensor(right),
                              **kw)
    return d.numpy(), v.numpy()


def sgm(left, right, **kw):
    d, v = stereo.semi_global_match(torch.as_tensor(left),
                                    torch.as_tensor(right), **kw)
    return d.numpy(), v.numpy()


def test_block_match_uniform_disparity(rng):
    d_true = 6
    left, right = shifted_pair(rng, d=d_true)
    disp, valid = bm(left, right, num_disparities=16, min_disparity=1,
                     sad_radius=3)
    assert valid.mean() > 0.5
    err = np.abs(disp[valid] - d_true)
    assert np.median(err) < 0.5
    assert (err < 1.0).mean() > 0.9


def test_block_match_flat_region_invalid():
    flat = np.full((60, 100), 0.5, np.float32)
    _, valid = bm(flat, flat, num_disparities=16)
    assert valid.mean() < 0.05


def test_block_match_subpixel(rng):
    h, w, d_true = 60, 120, 5.5
    base = scipy.ndimage.gaussian_filter(
        rng.uniform(0, 1, size=(h, w + 20)).astype(np.float32), 2.0)
    xs = np.arange(w)
    left = base[:, 10:10 + w]
    right = np.stack([np.interp(xs + 10 + d_true, np.arange(w + 20), row)
                      for row in base]).astype(np.float32)
    disp, valid = bm(left, right, num_disparities=16, min_disparity=1,
                     sad_radius=4, texture_threshold=0.002)
    assert valid.mean() > 0.3
    assert np.median(np.abs(disp[valid] - d_true)) < 0.35


def test_sgm_recovers_constant_disparity(rng):
    left, right = _stereo_pair(rng, h=64, w=96, disp=7.3)
    disp, valid = sgm(left, right, num_disparities=24, min_disparity=1,
                      sad_radius=2)
    assert valid.mean() > 0.3
    assert abs(np.median(disp[valid]) - 7.3) < 0.5
    assert np.abs(disp[valid] - 7.3).mean() < 0.35


def test_sgm_smoother_than_bm_in_low_texture(rng):
    left, right = _stereo_pair(rng, h=64, w=96, disp=6.0)
    left = 0.5 + (left - 0.5) * 0.15
    right = 0.5 + (right - 0.5) * 0.15
    kw = dict(num_disparities=24, min_disparity=1, sad_radius=2,
              texture_threshold=0.005)
    d_bm, v_bm = bm(left, right, **kw)
    d_sg, v_sg = sgm(left, right, **kw)
    err_bm = np.abs(d_bm[v_bm] - 6.0).mean() if v_bm.any() else np.inf
    err_sg = np.abs(d_sg[v_sg] - 6.0).mean() if v_sg.any() else np.inf
    assert err_sg <= err_bm + 0.05, (err_sg, err_bm)


def test_block_match_prefilter_illumination_robust(rng):
    d_true = 6
    left, right = shifted_pair(rng, d=d_true)
    right_il = np.clip(0.7 * right + 0.2, 0.0, 1.0).astype(np.float32)
    kw = dict(num_disparities=16, min_disparity=1, sad_radius=3)
    disp_pf, valid_pf = bm(left, right_il, prefilter_cap=0.12, **kw)
    assert valid_pf.mean() > 0.4
    err_pf = np.abs(disp_pf[valid_pf] - d_true)
    assert np.median(err_pf) < 0.5
    good_pf = (err_pf < 1.0).mean()
    assert good_pf > 0.85
    disp_raw, valid_raw = bm(left, right_il, **kw)
    good_raw = ((np.abs(disp_raw[valid_raw] - d_true) < 1.0).mean()
                if valid_raw.any() else 0.0)
    assert good_pf * valid_pf.mean() > 2.0 * good_raw * valid_raw.mean()


def assert_matches_jax(got, want):
    (d, v), (dj, vj) = got, (np.asarray(want[0]), np.asarray(want[1]))
    differ = (v != vj).mean()
    assert differ <= VALIDITY_SHARE, f"validity differs on {differ:.4f}"
    both = v & vj
    assert both.mean() > 0.25
    np.testing.assert_allclose(d[both], dj[both], atol=DISP_ATOL)
    assert (d[~v] == 0).all()


@pytest.mark.parametrize("prefilter_cap", [0.0, 0.12])
@pytest.mark.parametrize("matcher", ["block_match", "semi_global_match"])
def test_matches_jax(rng, matcher, prefilter_cap):
    """The same pair (a KITTI-like 9x9 window for BM, SGM's 5x5) through
    the JAX function and the port's."""
    left, right = _stereo_pair(rng, h=64, w=96, disp=7.3)
    right = np.clip(0.9 * right + 0.05, 0, 1).astype(np.float32)
    kw = dict(num_disparities=24, min_disparity=1, prefilter_cap=prefilter_cap,
              sad_radius=4 if matcher == "block_match" else 2)
    got = (bm if matcher == "block_match" else sgm)(left, right, **kw)
    want = getattr(jstereo, matcher)(jnp.asarray(left), jnp.asarray(right),
                                     **kw)
    assert_matches_jax(got, want)


def test_box_filter_and_prefilter_match_jax(rng):
    img = rng.uniform(0, 1, size=(3, 20, 31)).astype(np.float32)
    got = stereo._box_filter(torch.as_tensor(img), 2).numpy()
    np.testing.assert_allclose(got, np.asarray(jstereo._box_filter(
        jnp.asarray(img), 2)), rtol=1e-5, atol=1e-5)
    # The prefilter is elementwise: equal up to one f32 rounding.
    got = stereo.prefilter_xsobel(torch.as_tensor(img[0]), 0.12).numpy()
    np.testing.assert_allclose(got, np.asarray(jstereo.prefilter_xsobel(
        jnp.asarray(img[0]), 0.12)), atol=1e-6)


def test_argmin_takes_the_first_minimum():
    """jnp.argmin's tie rule, which the winner-take-all relies on."""
    cost = torch.tensor([[3.0, 1.0], [1.0, 1.0], [1.0, 2.0]])
    assert torch.argmin(cost, dim=0).tolist() == [1, 0]
    inf = torch.full((4, 2), torch.inf)
    assert torch.argmin(inf, dim=0).tolist() == [0, 0]


def test_speckle_filter_matches_jax(rng):
    """io/speckle.py is the JAX package's pure-Python filter: bitwise."""
    h, w = 48, 72
    disp = (10.0 + np.cumsum(rng.normal(0, 0.3, (h, w)), axis=1)
            ).astype(np.float32)
    valid = rng.random((h, w)) > 0.15
    disp[~valid] = 0.0
    d_t, v_t = speckle_filter_numpy(disp, valid, max_diff=0.8, min_region=20)
    d_j, v_j = jspeckle(disp, valid, max_diff=0.8, min_region=20)
    np.testing.assert_array_equal(v_t, v_j)
    np.testing.assert_array_equal(d_t, d_j)
    assert v_t.sum() < valid.sum()        # something was removed
