"""Stereo block matching and semi-global matching (disparity estimation).

Twin of photobundle_tpu/image/stereo.py on torch tensors, on whatever
device the images lie on (the engine's: the dataset moves them there).
The JAX package writes these as XLA programs, not Pallas kernels, so plain
tensor code is their port. For each candidate disparity: a shifted
absolute difference, box-filtered with a separable cumulative sum; a
(D, H, W) cost volume (128 x 370 x 1226 f32 is ~232 MB); winner-take-all,
a sub-pixel parabola, and StereoBM's uniqueness, texture and left-right
gates.

Rounding: `_box_filter` is a cumulative sum, so its f32 rounding follows
the summation order, which differs between XLA and PyTorch (and between
CPU and card): costs agree to a few ulps of the running sum, and a pixel
whose best and second-best disparities are that close may flip. Every
other step is elementwise or an exact min / first-index argmin, as in the
JAX package (`torch.argmin` returns the first minimal index, as
`jnp.argmin` does).
"""

from __future__ import annotations

import torch


def _edge_pad(img: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Pad `dim` by r on both sides, repeating the edge values."""
    n = img.shape[dim]
    idx = torch.clamp(torch.arange(-r, n + r, device=img.device), 0, n - 1)
    return torch.index_select(img, dim, idx)


def _box_filter(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable box sum over (2r+1)^2 windows, edge-padded. (..., H, W)."""
    k = 2 * radius + 1
    p = _edge_pad(_edge_pad(img, radius, -2), radius, -1)
    # window sum = cs[i + k] - cs[i] on a zero-led cumulative sum
    cs = torch.nn.functional.pad(torch.cumsum(p, dim=-1), (1, 0))
    out = cs[..., k:] - cs[..., :-k]
    cs = torch.nn.functional.pad(torch.cumsum(out, dim=-2), (0, 0, 1, 0))
    return cs[..., k:, :] - cs[..., :-k, :]


def prefilter_xsobel(img: torch.Tensor, cap: float) -> torch.Tensor:
    """cv::StereoBM's PREFILTER_XSOBEL: the horizontal 3x3 Sobel response,
    clamped to [-cap, cap] (image units; OpenCV's 8-bit default 31 is
    ~0.12 here)."""
    p = _edge_pad(_edge_pad(img, 1, -2), 1, -1)
    gx = ((p[:-2, 2:] + 2.0 * p[1:-1, 2:] + p[2:, 2:])
          - (p[:-2, :-2] + 2.0 * p[1:-1, :-2] + p[2:, :-2]))
    return torch.clamp(gx, -cap, cap)


def _shift_columns(vol: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Per-plane circular column shift of a (D, H, W) volume: plane d is
    `roll(vol[d], -shifts[d], axis=-1)` (entries wrap, as jnp.roll's)."""
    d, h, w = vol.shape
    col = (torch.arange(w, device=vol.device)[None, :]
           + shifts[:, None]) % w                                  # (D, W)
    return torch.gather(vol, 2, col[:, None, :].expand(d, h, w))


def _cost_volume(left, right, num_disparities, min_disparity, sad_radius,
                 masked):
    """(D, H, W) SAD costs; columns x < d + sad_radius (no correspondence)
    hold `masked`."""
    h, w = left.shape
    disps = torch.arange(min_disparity, min_disparity + num_disparities,
                         device=left.device)
    # roll(right, d, axis=1) for every d: shifted[d, :, x] = right[:, x - d]
    shifted = _shift_columns(right.expand(num_disparities, h, w), -disps)
    cost = _box_filter(torch.abs(left - shifted), sad_radius)
    col = torch.arange(w, device=left.device)
    ok = col[None, None, :] >= (disps + sad_radius)[:, None, None]
    return torch.where(ok, cost, masked)


def _lr_consistency(cost: torch.Tensor, best_l: torch.Tensor,
                    min_disparity: int, max_diff: float = 1.0):
    """Left-right consistency gate from ONE cost volume: the right view's
    cost at column xr is costL[d, xr + d + min_disparity], and a pixel
    passes when |dL(x) - dR(x - dL(x))| <= max_diff. cost (D, H, W),
    best_l (H, W) the winning disparity index."""
    d_count, h, w = cost.shape
    shifts = torch.arange(d_count, device=cost.device) + min_disparity
    best_r = torch.argmin(_shift_columns(cost, shifts), dim=0)   # (H, W)
    col = torch.arange(w, device=cost.device)[None, :]
    xr = torch.clamp(col - (best_l + min_disparity), 0, w - 1)
    d_r_at = torch.gather(best_r, 1, xr)
    return torch.abs(d_r_at - best_l) <= max_diff


def _textured(left, sad_radius, texture_threshold):
    """StereoBM's texture gate: the window's intensity deviation."""
    n_px = float((2 * sad_radius + 1) ** 2)
    mean = _box_filter(left, sad_radius) / n_px
    var = _box_filter(left * left, sad_radius) / n_px - mean * mean
    return torch.sqrt(torch.clamp(var, min=0.0)) > texture_threshold


def _subpixel(cost, best, num_disparities, min_disparity, finite_only):
    """Winner index -> disparity with the parabola through (c[-1], c0,
    c[+1]); with `finite_only` a neighbour at +inf leaves the integer."""
    d0 = torch.clamp(best, 1, num_disparities - 2)

    def take(idx):
        return torch.gather(cost, 0, idx[None])[0]

    cm, c0, cp = take(d0 - 1), take(d0), take(d0 + 1)
    if finite_only:
        all_finite = (torch.isfinite(cm) & torch.isfinite(c0)
                      & torch.isfinite(cp))
        denom = torch.where(all_finite, cm - 2 * c0 + cp, 1.0)
        use = all_finite & (torch.abs(denom) > 1e-9)
    else:
        denom = cm - 2 * c0 + cp
        use = torch.abs(denom) > 1e-9
    delta = torch.where(use, 0.5 * (cm - cp) / torch.where(denom == 0, 1.0,
                                                           denom), 0.0)
    delta = torch.clamp(delta, -0.5, 0.5)
    return ((best + min_disparity).to(torch.float32)
            + torch.where(best == d0, delta, 0.0))


def _unique(cost, best, cmin, uniqueness_ratio):
    """The best cost beats the runner-up (excluding its neighbours)."""
    d_idx = torch.arange(cost.shape[0], device=cost.device)[:, None, None]
    masked = torch.where(torch.abs(d_idx - best[None]) <= 1, torch.inf, cost)
    return cmin <= uniqueness_ratio * torch.amin(masked, dim=0)


def block_match(left: torch.Tensor, right: torch.Tensor,
                num_disparities: int = 64, min_disparity: int = 1,
                sad_radius: int = 4, uniqueness_ratio: float = 0.97,
                texture_threshold: float = 0.02, lr_check: bool = True,
                prefilter_cap: float = 0.0):
    """SAD block matching. left / right: (H, W) f32 in [0, 1], on any
    device. prefilter_cap > 0 matches (and gates texture on) the X-Sobel
    response. Returns (disparity (H, W) f32 with sub-pixel refinement, 0
    where invalid; valid (H, W) bool)."""
    if prefilter_cap > 0.0:
        left = prefilter_xsobel(left, prefilter_cap)
        right = prefilter_xsobel(right, prefilter_cap)
    cost = _cost_volume(left, right, num_disparities, min_disparity,
                        sad_radius, torch.inf)
    best = torch.argmin(cost, dim=0)
    cmin = torch.amin(cost, dim=0)
    disparity = _subpixel(cost, best, num_disparities, min_disparity, True)
    at_edge = (best == 0) | (best == num_disparities - 1)
    valid = (torch.isfinite(cmin)
             & _unique(cost, best, cmin, uniqueness_ratio)
             & _textured(left, sad_radius, texture_threshold) & ~at_edge)
    if lr_check:
        valid = valid & _lr_consistency(cost, best, min_disparity)
    return torch.where(valid, disparity, 0.0), valid


def _aggregate_dir_h(cost: torch.Tensor, p1: float, p2: float,
                     reverse: bool) -> torch.Tensor:
    """One horizontal SGM path over a (D, H, W) volume: a loop over the
    columns carrying the (D, H) path costs (the JAX package's lax.scan).
    The first column of the path keeps its raw cost."""
    d_count, h, w = cost.shape
    cols = range(w - 1, -1, -1) if reverse else range(w)
    out = torch.empty_like(cost)
    inf = torch.full((1, h), torch.inf, dtype=cost.dtype, device=cost.device)
    carry = None
    for x in cols:
        c = cost[:, :, x]
        if carry is None:
            carry = c
        else:
            prev_min = torch.amin(carry, dim=0, keepdim=True)
            lo = torch.cat([inf, carry[:-1]], dim=0)
            hi = torch.cat([carry[1:], inf], dim=0)
            best = torch.minimum(torch.minimum(carry, prev_min + p2),
                                 torch.minimum(lo + p1, hi + p1))
            carry = c + best - prev_min
        out[:, :, x] = carry
    return out


def semi_global_match(left: torch.Tensor, right: torch.Tensor,
                      num_disparities: int = 64, min_disparity: int = 1,
                      sad_radius: int = 2, p1: float = 0.03, p2: float = 0.4,
                      uniqueness_ratio: float = 0.97,
                      texture_threshold: float = 0.02, lr_check: bool = True,
                      prefilter_cap: float = 0.0):
    """Semi-global matching (cv::StereoSGBM's counterpart): SAD costs with
    a finite 1e4 sentinel at columns without a correspondence (an inf
    would poison every pixel behind it on a path), aggregated along the 4
    scanline directions with the P1/P2 smoothness model, then
    `block_match`'s winner-take-all, sub-pixel and gates on the summed
    volume. Returns (disparity, valid) as `block_match`."""
    if prefilter_cap > 0.0:
        left = prefilter_xsobel(left, prefilter_cap)
        right = prefilter_xsobel(right, prefilter_cap)
    cost = _cost_volume(left, right, num_disparities, min_disparity,
                        sad_radius, 1e4)
    agg = (_aggregate_dir_h(cost, p1, p2, reverse=False)
           + _aggregate_dir_h(cost, p1, p2, reverse=True))
    cost_t = cost.transpose(1, 2)
    agg_v = (_aggregate_dir_h(cost_t, p1, p2, reverse=False)
             + _aggregate_dir_h(cost_t, p1, p2, reverse=True))
    cost_sum = agg + agg_v.transpose(1, 2)
    best = torch.argmin(cost_sum, dim=0)
    cmin = torch.amin(cost_sum, dim=0)
    disparity = _subpixel(cost_sum, best, num_disparities, min_disparity,
                          False)
    # A winner whose raw cost is the sentinel has no correspondence.
    raw_at_best = torch.gather(cost, 0, best[None])[0]
    at_edge = (best == 0) | (best == num_disparities - 1)
    valid = ((raw_at_best < 1e3)
             & _unique(cost_sum, best, cmin, uniqueness_ratio)
             & _textured(left, sad_radius, texture_threshold) & ~at_edge)
    if lr_check:
        valid = valid & _lr_consistency(cost_sum, best, min_disparity)
    return torch.where(valid, disparity, 0.0), valid
