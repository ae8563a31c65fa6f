"""Photometric residuals and their factored Gauss-Newton statistics.

Twin of photobundle_tpu/core/residuals.py: the dense `evaluate` /
`cost_only` oracle (residuals and Jacobians per pixel) and the compressed
`evaluate_compressed` the solve runs. Residual model, for point p with
world position X, reference descriptor d, window frame f with pose
T_wc[f] and patch offsets {o_k}:

    y      = T_wc[f]^{-1} . X                      (camera-frame point)
    u      = pi(K y)                               (projected pixel)
    s_ck   = I_c(u + M_f o_k)                      (bilinear sample)
    r_ck   = (s_ck - mean_k s_ck) - d_ck           (brightness-normalized)

M_f is the identity (the reference's fixed grid) unless a patch-grid warp
is given (cfg.patchWarp, `patch_warp_frame`): rho_f I for 'scale', a 2x2
affine map for 'affine'. patchNormalization='affine' replaces the mean
removal by the ZNCC unit norm (`_normalize_sampled`).

Patches are fronto-parallel, so every pixel of a patch moves with the same
du/dtheta and the per-observation Jacobian factors as J = G @ A, with G
(D, 2) the centred sampled gradients and A (2, 9) = du/d[pose | point].
Gauss-Newton then needs only gtg = G^T G, gtr = G^T r and ||r||^2 per
observation. Huber (or cauchy / tukey) enters as IRLS whitening. An
optional inverse-depth prior adds one extra residual row per point on its
reference-frame observation.

Two backends:
- backend="torch": the gather path (twin of the JAX `xla` backend): per
  frame, sampling of the whole patch with per-sample bounds checks:
  bilinear over stacked value / gradient planes ('sampled'), the bilinear
  surface and its derivative ('exact'), or the Catmull-Rom surface and its
  derivative ('bicubic').
- backend="cuda": the fused kernel path (twin of the JAX `pallas` backend):
  ops/patch_warp.patch_stats (bilinear, 'sampled': K1, and K4 with affine
  normalization), ops/patch_bicubic.bicubic_stats ('bicubic': K2) or
  ops/patch_scaled.scaled_stats (patchWarp='scale': K3, and K5 with affine
  normalization) sample, normalize and reduce in one kernel on a card, or
  run their plain versions for CPU tensors. They copy the Pallas path's
  whole-patch margins. Bilinear: pr <= u <= W - 2 - pr, one pixel tighter
  than the gather path's. Bicubic: pr + 1 <= u <= W - 3 - pr, which is
  the gather path's own per-sample validity, so the two backends accept
  the same observations. Scaled: 1 + rho pr <= u <= W - 2 - rho pr,
  tighter than the gather path's per-sample validity.
  patchWarp='affine' has no kernel in either package and runs on the
  gather path.
  With a `point_order` (sorted dispatch, `sorted_dispatch_order`) the fixed
  grid's bilinear kernel visits the observations in that order
  (ops/patch_warp.sorted_patch_stats); its sums are bitwise the same.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import PATCH_SCALE_MAX, PATCH_SCALE_MIN
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..image import interp
from ..image import patches as patches_mod
from ..ops import patch_bicubic as pb_mod
from ..ops import patch_scaled as ps_mod
from ..ops import patch_warp as pw_mod


class Residuals(NamedTuple):
    """Per-pixel residuals and Jacobians of the dense oracle `evaluate`."""

    r: torch.Tensor        # (N, W, D) whitened residuals (zero where invalid)
    j_pose: torch.Tensor   # (N, W, D, 6) whitened d r / d pose twist
    j_point: torch.Tensor  # (N, W, D, 3) whitened d r / d X
    valid: torch.Tensor    # (N, W) observation validity
    cost: torch.Tensor     # () robust cost
    n_residuals: torch.Tensor  # () int32 number of valid observations


class CompressedResiduals(NamedTuple):
    """Rank-2-factored residual/Jacobian statistics, point axis LAST:

        gtg = w * G^T G   (2, 2)      J^T J = A^T gtg A
        gtr = w * G^T r   (2,)        J^T r = A^T gtr

    (w = robust IRLS weight x validity). The prior row does not share the
    A chain and is carried as an explicit whitened (jp, rp) pair."""

    a: torch.Tensor        # (W, 2, 9, N) du/d[pose(6) | point(3)]
    gtg: torch.Tensor      # (W, 2, 2, N) whitened gradient Gram
    gtr: torch.Tensor      # (W, 2, N)    whitened G^T r
    jp: torch.Tensor       # (W, 9, N)    whitened prior Jacobian row
    rp: torch.Tensor       # (W, N)       whitened prior residual
    valid: torch.Tensor    # (N, W)
    cost: torch.Tensor     # ()
    n_residuals: torch.Tensor  # () int32


ROBUST_KINDS = ("huber", "cauchy", "tukey", "none")
BACKENDS = ("torch", "cuda")


def robust_weight(r_norm2: torch.Tensor, delta: float, kind: str = "huber"):
    """IRLS weight w = rho'(s) and loss rho(s) on s = ||r||^2, in Ceres'
    conventions (HuberLoss, CauchyLoss, TukeyLoss, TrivialLoss):

      huber:  rho = s if s <= delta^2 else 2 delta sqrt(s) - delta^2
      cauchy: rho = delta^2 log(1 + s/delta^2)
      tukey:  rho = delta^2/3 (1 - (1 - s/delta^2)^3), capped at delta^2/3
      none:   rho = s
    """
    if kind == "none":
        return torch.ones_like(r_norm2), r_norm2
    b = delta * delta
    if kind == "huber":
        rn = torch.sqrt(torch.clamp(r_norm2, min=1e-20))
        w = torch.clamp(delta / rn, max=1.0)
        rho = torch.where(rn <= delta, r_norm2, 2.0 * delta * rn - b)
        return w, rho
    if kind == "cauchy":
        u = r_norm2 / b
        return 1.0 / (1.0 + u), b * torch.log1p(u)
    if kind == "tukey":
        t = torch.clamp(1.0 - r_norm2 / b, min=0.0)
        return t * t, (b / 3.0) * (1.0 - t * t * t)
    raise ValueError(f"unknown robust loss '{kind}' (want one of "
                     f"{ROBUST_KINDS})")


def _normalize_sampled(s, g, mode: str):
    """Patch normalization of warped samples, propagated exactly to the
    sampled gradients:

      mean:   c = s - s̄,                dc/dθ = G_c = g - ḡ
      affine: ŝ = c / n, n = sqrt(Σc²+ε²), dŝ/dθ = (G_c - ŝ(ŝᵀG_c)) / n

    s: (..., C, P); g: (..., C, P, 2) or None (cost-only pass)."""
    if mode == "off":
        return s, g
    s = s - torch.mean(s, dim=-1, keepdim=True)
    if g is not None:
        g = g - torch.mean(g, dim=-2, keepdim=True)
    if mode == "mean":
        return s, g
    eps = patches_mod.AFFINE_NORM_EPS
    n = torch.sqrt(torch.sum(s * s, dim=-1, keepdim=True) + eps * eps)
    s = s / n
    if g is not None:
        proj = torch.sum(s[..., None] * g, dim=-2, keepdim=True)
        g = (g - s[..., None] * proj) / n[..., None]
    return s, g


def _observation_geometry(cam, t_wc_f, x_world):
    """One frame's geometry for all points: camera point y (N, 3), pixel
    uv (N, 2), in_front (N,) and A = du/d[pose|point] (N, 2, 9). The tiny
    products are broadcast multiplies, as in the JAX package."""
    t_cw = se3.se3_inverse(t_wc_f)
    r_cw = t_cw[:3, :3]
    y = (x_world[:, None, :] * r_cw[None, :, :]).sum(-1) + t_cw[:3, 3]
    uv, in_front = cam_mod.project(cam, y)
    jproj = cam_mod.project_jacobian(cam, y)              # (N, 2, 3)
    # dy/d(pose twist) under T <- T @ exp(xi): [-I | hat(y)] -> (N, 3, 6)
    n = x_world.shape[0]
    eye = torch.eye(3, dtype=y.dtype, device=y.device)
    dy_dpose = torch.cat([(-eye).expand(n, 3, 3), se3.hat(y)], dim=-1)
    a_pose = (jproj[..., :, :, None] * dy_dpose[..., None, :, :]).sum(-2)
    a_point = (jproj[..., :, :, None] * r_cw[None, None, :, :]).sum(-2)
    return y, uv, in_front, torch.cat([a_pose, a_point], dim=-1)


def patch_warp_ref_geometry(t_wc, x_world, ref_slot):
    """Each point's reference-frame geometry for the patch-grid warp
    (cfg.patchWarp), at the CURRENT estimates: (z_ref (N,), r_wc_ref
    (N, 3, 3)), the point's depth in its reference frame and that
    camera's world rotation. z_ref is -1 where ref_slot < 0 (reference
    frame not in the window): the warp is the identity there.

    Both depths of the warp factor come from the current iterate, so the
    factor is exactly 1 in the reference frame (the JAX package's
    docstring gives the measured reason against the frozen stereo seed).
    z_ref is summed in the order `_observation_geometry_pm` sums the
    camera-frame depth, so the kernel path's reference-frame rho is 1.0
    exactly. `t_wc` is the full window (W, 4, 4)."""
    w = t_wc.shape[0]
    t_cw = se3.se3_inverse(t_wc)                           # (W, 4, 4)
    safe = torch.clamp(ref_slot, 0, w - 1).long()
    row2 = t_cw[safe, 2]                                   # (N, 4)
    z_ref = (row2[:, 0] * x_world[:, 0] + row2[:, 1] * x_world[:, 1]
             + row2[:, 2] * x_world[:, 2]) + row2[:, 3]
    z_ref = torch.where(ref_slot >= 0, z_ref, -1.0)
    return z_ref, t_wc[safe][:, :3, :3]


def patch_warp_frame(mode: str, cam, t_wc_f, y, z_ref, r_wc_ref):
    """Patch-grid warp of ONE window frame at the linearization point:
    (N,) scale rho for mode='scale', (N, 2, 2) map M for mode='affine';
    the identity wherever z_ref <= 0. y (N, 3) is the camera-frame point.

    The template offsets o are back-projected at depth z_ref onto a
    fronto-parallel plane of the reference camera, moved to frame f and
    projected:

        M_f = Jproj(y_f) @ (R_cw_f @ R_wc_ref)[:, :2] @ diag(z_ref / fx,
                                                             z_ref / fy)

    'scale' keeps the isotropic part, rho_f = z_ref / z_f. The overall
    scale (rho, or sqrt|det M|) is clamped to [PATCH_SCALE_MIN,
    PATCH_SCALE_MAX]; a near-singular M (sqrt|det| < 0.1 PATCH_SCALE_MIN)
    falls back to the identity. Jacobians hold the warp frozen at the
    linearization point (photobundle_tpu/core/residuals.py:212-264)."""
    z_f = torch.clamp(y[:, 2], min=1e-6)
    if mode == "scale":
        rho = torch.clamp(z_ref / z_f, PATCH_SCALE_MIN, PATCH_SCALE_MAX)
        return torch.where(z_ref > 0, rho, 1.0)
    if mode != "affine":
        raise ValueError(f"unknown patch warp mode '{mode}'")
    r_cw = se3.se3_inverse(t_wc_f)[:3, :3]
    rel = (r_cw[None, :, :, None] * r_wc_ref[:, None, :, :]).sum(-2)
    f_xy = torch.stack([cam.fx, cam.fy]).to(z_ref.dtype)
    dy = rel[:, :, :2] * (z_ref[:, None, None] / f_xy)     # (N, 3, 2)
    jproj = cam_mod.project_jacobian(cam, y)               # (N, 2, 3)
    m = (jproj[:, :, :, None] * dy[:, None, :, :]).sum(-2)  # (N, 2, 2)
    det = torch.abs(m[:, 0, 0] * m[:, 1, 1] - m[:, 0, 1] * m[:, 1, 0])
    s = torch.sqrt(torch.clamp(det, min=1e-12))
    m = m * (torch.clamp(s, PATCH_SCALE_MIN, PATCH_SCALE_MAX)
             / s)[:, None, None]
    eye = torch.eye(2, dtype=m.dtype, device=m.device)
    ok = (z_ref > 0) & (s > 0.1 * PATCH_SCALE_MIN)
    return torch.where(ok[:, None, None], m, eye)


def _sample_patches(channels_f, grads_f, uv, offsets, gradient_mode: str,
                    scale=None):
    """Sample one frame's patch values and gradients.

    channels_f (C, H, W), grads_f (C, H, W, 2), uv (N, 2), offsets (P, 2).
    scale: optional per-point patch-grid warp, (N,) isotropic scale or
    (N, 2, 2) map applied to the offsets. Returns s (N, C, P),
    g (N, C, P, 2), valid (N,)."""
    if scale is not None:
        if scale.ndim == 1:
            offsets = scale[:, None, None] * offsets      # (N, P, 2)
        else:
            offsets = (scale[:, None, :, :]
                       * offsets[None, :, None, :]).sum(-1)
    pts = uv[:, None, :] + offsets                        # (N, P, 2)
    if gradient_mode == "bicubic":
        # Ceres-parity mode: the Catmull-Rom surface and its exact gradient.
        s, g, ok = interp.bicubic_with_grad(channels_f, pts)
        s = torch.movedim(s, 0, 1)
        g = torch.movedim(g, 0, 1)
    elif gradient_mode == "exact":
        s, g, ok = interp.bilinear_with_grad(channels_f, pts)
        s = torch.movedim(s, 0, 1)
        g = torch.movedim(g, 0, 1)
    elif gradient_mode == "sampled":
        c = channels_f.shape[0]
        # One gather over C*3 planes: values + both gradient components.
        stacked = torch.cat([channels_f, grads_f[..., 0], grads_f[..., 1]],
                            dim=0)                        # (3C, H, W)
        vals, ok = interp.bilinear(stacked, pts)          # (3C, N, P)
        vals = torch.movedim(vals, 0, 1)                  # (N, 3C, P)
        s = vals[:, :c]
        g = torch.stack([vals[:, c:2 * c], vals[:, 2 * c:]], dim=-1)
    else:
        raise ValueError(f"unknown gradient_mode '{gradient_mode}' (want "
                         "'sampled', 'exact' or 'bicubic')")
    return s, g, torch.all(ok, dim=-1)


def _observation_geometry_pm(cam, t_wc, x_world):
    """Point-minor observation geometry for every window frame at once.

    Returns y (W, 3, N), uv (W, 2, N), in_front (W, N), a (W, 2, 9, N),
    r_cw (W, 3, 3). The A-chain is written in closed form (zero entries of
    jproj / hat dropped)."""
    t_cw = se3.se3_inverse(t_wc)                           # (W, 4, 4)
    r_cw = t_cw[:, :3, :3]
    tt = t_cw[:, :3, 3]
    xt = x_world.T                                         # (3, N)
    y = (r_cw[:, :, 0, None] * xt[0] + r_cw[:, :, 1, None] * xt[1]
         + r_cw[:, :, 2, None] * xt[2]) + tt[:, :, None]   # (W, 3, N)
    xc, yc, zc_raw = y[:, 0], y[:, 1], y[:, 2]             # (W, N)
    in_front = zc_raw > 1e-6
    zc = torch.clamp(zc_raw, min=1e-6)
    iz = 1.0 / zc
    iz2 = iz * iz
    u = cam.fx * (xc / zc) + cam.cx
    v = cam.fy * (yc / zc) + cam.cy
    uv = torch.stack([u, v], dim=1)                        # (W, 2, N)
    zero = torch.zeros_like(xc)
    j00 = cam.fx * iz
    j02 = -cam.fx * xc * iz2
    j11 = cam.fy * iz
    j12 = -cam.fy * yc * iz2
    # A = jproj @ [-I | hat(y) | R_cw]; hat(y) = [[0,-z,y],[z,0,-x],[-y,x,0]]
    r2 = r_cw[..., None]                                   # (W, 3, 3, 1)
    row0 = torch.stack([
        -j00, zero, -j02,
        -j02 * yc, -j00 * zc_raw + j02 * xc, j00 * yc,
        j00 * r2[:, 0, 0] + j02 * r2[:, 2, 0],
        j00 * r2[:, 0, 1] + j02 * r2[:, 2, 1],
        j00 * r2[:, 0, 2] + j02 * r2[:, 2, 2]], dim=1)     # (W, 9, N)
    row1 = torch.stack([
        zero, -j11, -j12,
        j11 * zc_raw - j12 * yc, j12 * xc, -j11 * xc,
        j11 * r2[:, 1, 0] + j12 * r2[:, 2, 0],
        j11 * r2[:, 1, 1] + j12 * r2[:, 2, 1],
        j11 * r2[:, 1, 2] + j12 * r2[:, 2, 2]], dim=1)
    a = torch.stack([row0, row1], dim=1)                   # (W, 2, 9, N)
    return y, uv, in_front, a, r_cw


def _prior_terms_pm(r_cw, y, valid, depth_prior, dtype):
    """Inverse-depth prior rows, point-minor: rp (W, N), jp (W, 9, N).
    dz/dpose = [-e_z | hat(y) row 2], dz/dX = R_cw row 2."""
    w = y.shape[0]
    ref_slot, q_seed, wd = depth_prior
    z = torch.clamp(y[:, 2], min=1e-6)                     # (W, N)
    f_idx = torch.arange(w, dtype=ref_slot.dtype, device=y.device)[:, None]
    m = ((ref_slot[None, :] == f_idx) & valid).to(dtype)
    rp = wd * (1.0 / z - q_seed[None]) * m
    coef = (-wd / (z * z)) * m
    xc, yc = y[:, 0], y[:, 1]
    zero = torch.zeros_like(z)
    r2 = r_cw[:, 2]                                        # (W, 3)
    jp = torch.stack([
        zero, zero, -coef,
        coef * (-yc), coef * xc, zero,
        coef * r2[:, 0, None], coef * r2[:, 1, None], coef * r2[:, 2, None]],
        dim=1)                                             # (W, 9, N)
    return rp, jp


def _prior_terms(f: int, t_wc_f, y, valid, depth_prior, dtype):
    """Inverse-depth prior row of window frame f, point-major: rp (N,),
    jp (N, 9). dz/dpose = [-e_z | hat(y) row 2], dz/dX = R_cw row 2."""
    n = y.shape[0]
    ref_slot, q_seed, wd = depth_prior
    z = torch.clamp(y[:, 2], min=1e-6)
    m = ((ref_slot == f) & valid).to(dtype)
    rp = wd * (1.0 / z - q_seed) * m
    coef = (-wd / (z * z)) * m
    r_cw = se3.se3_inverse(t_wc_f)[:3, :3]
    neg_ez = torch.zeros((n, 3), dtype=dtype, device=y.device)
    neg_ez[:, 2] = -1.0
    dz = torch.cat([neg_ez, se3.hat(y)[:, 2, :], r_cw[2].expand(n, 3)],
                   dim=-1)                                 # (N, 9)
    return rp, coef[:, None] * dz


def _frame_samples(cam, t_wc_f, x_world, channels_f, grads_f, offsets,
                   gradient_mode: str, patch_warp):
    """One window frame of the gather path: the geometry of
    `_observation_geometry` and the (optionally warped) patch samples.
    Returns y, in_front, a, s, g, in_bounds."""
    y, uv, in_front, a = _observation_geometry(cam, t_wc_f, x_world)
    scale = (patch_warp_frame(patch_warp[0], cam, t_wc_f, y, patch_warp[1],
                              patch_warp[2])
             if patch_warp is not None else None)
    s, g, in_bounds = _sample_patches(channels_f, grads_f, uv, offsets,
                                      gradient_mode, scale=scale)
    return y, in_front, a, s, g, in_bounds


def evaluate(cam, t_wc, x_world, patch, channels, grads, obs_mask, offsets,
             huber_delta: float, gradient_mode: str = "sampled",
             with_jacobians: bool = True, depth_prior: tuple | None = None,
             normalize=True, robust_kind: str = "huber",
             patch_warp: tuple | None = None) -> Residuals:
    """Every (point, window-frame) residual and Jacobian, per pixel: the
    dense oracle the compressed statistics are tested against (twin of the
    JAX package's `evaluate`).

    Arguments as `evaluate_compressed` (torch backend), plus
    with_jacobians: False for the cost-only pass (Jacobians are zeros).
    patch_warp: optional (mode, z_ref, r_wc_ref), mode 'scale' | 'affine',
    with (z_ref, r_wc_ref) from `patch_warp_ref_geometry` at the same
    (t_wc, x_world): frame f samples at u + M_f o_k, with the sampled
    gradients taken at the warped positions and the warp held frozen in
    the Jacobians. The depth prior adds one pseudo-pixel (D -> D + 1).
    Returns whitened r / J, exact zeros where invalid."""
    n, w = obs_mask.shape
    d = patch.shape[1] * patch.shape[2]
    use_prior = depth_prior is not None and depth_prior[2] > 0.0
    norm_mode = patches_mod.norm_mode(normalize)
    dtype, dev = x_world.dtype, x_world.device
    rs, js, valids = [], [], []
    for f in range(w):
        y, in_front, a, s, g, in_bounds = _frame_samples(
            cam, t_wc[f], x_world, channels[f], grads[f], offsets,
            gradient_mode, patch_warp)
        valid = obs_mask[:, f] & in_front & in_bounds      # (N,)
        s, g = _normalize_sampled(s, g if with_jacobians else None,
                                  norm_mode)
        r = (s - patch).reshape(n, d)                      # (N, D)
        if with_jacobians:
            j = g.reshape(n, d, 2) @ a                     # (N, D, 9)
        else:
            j = torch.zeros((n, d, 9), dtype=dtype, device=dev)
        if use_prior:
            rp, jp = _prior_terms(f, t_wc[f], y, valid, depth_prior, dtype)
            r = torch.cat([r, rp[:, None]], dim=1)
            if not with_jacobians:
                jp = torch.zeros_like(jp)
            j = torch.cat([j, jp[:, None, :]], dim=1)
        rs.append(r)
        js.append(j)
        valids.append(valid)
    r, j, valid = (torch.stack(t, dim=1) for t in (rs, js, valids))
    # Invalid observations are selected away (a NaN point samples NaN),
    # as `_whiten` does.
    vf = valid.to(dtype)
    r = torch.where(valid[..., None], r, 0.0)
    w_robust, rho = robust_weight(torch.sum(r * r, dim=-1), huber_delta,
                                  robust_kind)
    sw = torch.sqrt(w_robust) * vf
    r = r * sw[..., None]
    j = torch.where(valid[..., None, None], j * sw[..., None, None], 0.0)
    return Residuals(
        r=r, j_pose=j[..., :6], j_point=j[..., 6:], valid=valid,
        cost=0.5 * torch.sum(rho * vf),
        n_residuals=torch.sum(valid, dtype=torch.int32))


def cost_only(cam, t_wc, x_world, patch, channels, grads, obs_mask, offsets,
              huber_delta: float, gradient_mode: str = "sampled",
              depth_prior: tuple | None = None, normalize=True,
              robust_kind: str = "huber", patch_warp: tuple | None = None):
    """(robust cost, valid observation count) without Jacobians."""
    res = evaluate(cam, t_wc, x_world, patch, channels, grads, obs_mask,
                   offsets, huber_delta, gradient_mode, with_jacobians=False,
                   depth_prior=depth_prior, normalize=normalize,
                   robust_kind=robust_kind, patch_warp=patch_warp)
    return res.cost, res.n_residuals


CUDA_MODES = ("sampled", "bicubic")


def make_cuda_ctx(channels, grads, mode: str = "sampled"):
    """Sampling context of the cuda backend, (mode, planes): the
    (W, C, H, Wi, 4) texel planes of ops/patch_warp for mode='sampled',
    which the fixed-grid kernel (K1) and the warped-grid kernel
    (ops/patch_scaled, patchWarp='scale') both read; the value-only
    (W, C, H, Wi) planes of ops/patch_bicubic for mode='bicubic' (the
    kernel computes the surface gradients itself). Loop-invariant: build
    once per solve and pass to every evaluate_compressed call (twin of
    `make_pallas_ctx`, whose 'scaled' wide-panel layout has no counterpart
    here)."""
    if mode == "bicubic":
        return mode, pb_mod.build_value_planes(channels)
    if mode == "sampled":
        return mode, pw_mod.build_planes(channels, grads)
    raise ValueError(f"cuda backend implements gradient_mode "
                     f"{CUDA_MODES}, not '{mode}'")


# Rows per band of the sorted-dispatch key. The sorted kernel stages the
# union box of 64 consecutive sorted points' windows when it fits 1024
# float4 texels (csrc/patch_warp.cu): at 65 536 points on 370x1226 a run
# of 64 points in a 16-row band spans ~28 columns, a ~21x33 box.
DISPATCH_BAND = 16


def dispatch_key(cam, t_wc, x_world, obs_mask, image_shape):
    """Sort key of sorted dispatch, (N,) int64: each point's image tile in
    the middle window frame (slot W // 2), band-major,

        key = (floor(v) // DISPATCH_BAND) * Wi + floor(u),

    u, v clamped into the image; points behind that camera or not
    observed in it (obs_mask[:, W // 2] false) get ceil(H / DISPATCH_BAND)
    * Wi and sort last. Computed from the pose and points given (the
    solve's initial iterate, as lm_solve does), so it goes stale as the
    solve moves them: staleness costs locality, never correctness. The JAX
    package keys (122-px panel, window row) for its TPU layout
    (photobundle_tpu/core/lm.py:235-246)."""
    h, wi = image_shape
    mid = t_wc.shape[0] // 2
    t_cw = se3.se3_inverse(t_wc[mid])
    uv, in_front = cam_mod.project(cam, x_world @ t_cw[:3, :3].T
                                   + t_cw[:3, 3])
    ok = in_front & obs_mask[:, mid] & torch.isfinite(uv).all(dim=-1)
    uv = torch.where(ok[:, None], uv, 0.0)      # NaN never reaches a cast
    col = torch.clamp(torch.floor(uv[:, 0]), 0, wi - 1).long()
    row = torch.clamp(torch.floor(uv[:, 1]), 0, h - 1).long()
    last = -(-h // DISPATCH_BAND) * wi
    return torch.where(ok, (row // DISPATCH_BAND) * wi + col, last)


def sorted_dispatch_order(key):
    """(feed (N,), inverse (N,)) int64 from a stable sort of `key` (ties
    break by index, as `jnp.argsort` does): feed[rank] is the point at
    sorted rank `rank`, inverse[point] its rank (feed[inverse] = arange).
    Twin of the JAX package's `sorted_dispatch_order` without its TPU row
    layout (lane-packed groups)."""
    _, feed = torch.sort(key, stable=True)
    inverse = torch.empty_like(feed)
    inverse[feed] = torch.arange(feed.shape[0], device=feed.device)
    return feed, inverse


def _whiten(a, gtg, gtr, jp, rp, valid, rnorm2, huber_delta, robust_kind):
    """Robust IRLS weights applied to the (W, ..., N) statistics; `valid`
    (W, N). Invalid observations contribute exact zeros: they are selected
    away, not multiplied by 0, since the gather path samples a NaN
    coordinate to NaN (XLA turns the JAX package's multiply by the mask
    into the same select)."""
    vf = valid.to(gtg.dtype)
    rnorm2 = torch.where(valid, rnorm2, 0.0)
    w_robust, rho = robust_weight(rnorm2, huber_delta, robust_kind)
    wv = w_robust * vf        # J^T J / J^T r carry the squared whitening
    sw = torch.sqrt(w_robust) * vf
    v = valid[:, None, :]
    return CompressedResiduals(
        a=a,
        gtg=torch.where(v[:, None], gtg * wv[:, None, None, :], 0.0),
        gtr=torch.where(v, gtr * wv[:, None, :], 0.0),
        jp=torch.where(v, jp * sw[:, None, :], 0.0),
        rp=torch.where(valid, rp * sw, 0.0),
        valid=valid.T,
        cost=0.5 * torch.sum(rho * vf),
        n_residuals=torch.sum(valid, dtype=torch.int32),
    )


def _evaluate_compressed_cuda(cam, t_wc, x_world, patch, channels, grads,
                              obs_mask, huber_delta: float,
                              depth_prior: tuple | None, ctx,
                              normalize, robust_kind: str,
                              mode: str = "sampled",
                              patch_warp: tuple | None = None,
                              point_order=None) -> CompressedResiduals:
    """Kernel path (twin of the JAX package's `_evaluate_compressed_pallas`):
    the fused kernel returns the six un-whitened sums per observation; the
    prior row and the whitening are added here, outside it. Dispatch:

      fixed grid, bilinear        -> patch_stats   (K1; affine: K4), or
                                     sorted_patch_stats with a point_order
      fixed grid, bicubic         -> bicubic_stats (K2, every normalization)
      patchWarp='scale', bilinear -> scaled_stats  (K3; affine: K5)

    With the scale warp, rho = clip(z_ref / max(z_f, 1e-6)) point-minor (1
    where z_ref <= 0), and the kernel's own margin
    1 + rho R <= u <= W - 2 - rho R (the Pallas path's, residuals.py:744)."""
    n, w = obs_mask.shape
    pr = (int(round(patch.shape[2] ** 0.5)) - 1) // 2     # P = (2R+1)^2
    norm_mode = patches_mod.norm_mode(normalize)
    img_h, img_w = channels.shape[-2], channels.shape[-1]

    y_pm, uv, in_front, a, r_cw = _observation_geometry_pm(cam, t_wc,
                                                           x_world)
    rho = None
    if patch_warp is not None:
        if mode != "sampled" or patch_warp[0] != "scale":
            raise ValueError("cuda backend implements patchWarp='scale' "
                             "with gradient_mode='sampled' only; use "
                             "solverBackend=torch")
        z_ref = patch_warp[1][None]                        # (1, N)
        z_f = torch.clamp(y_pm[:, 2], min=1e-6)            # (W, N)
        rho = torch.where(z_ref > 0, torch.clamp(
            z_ref / z_f, PATCH_SCALE_MIN, PATCH_SCALE_MAX), 1.0)
        # The warped patch reaches rho*pr from its centre; the bilinear
        # taps need one more pixel on each side.
        ext = rho * pr
        in_bounds = ((uv[:, 0] >= 1 + ext) & (uv[:, 0] <= (img_w - 2) - ext)
                     & (uv[:, 1] >= 1 + ext)
                     & (uv[:, 1] <= (img_h - 2) - ext))
    else:
        # Whole-patch support, the Pallas margins: bilinear needs 2x2 taps
        # per sample, bicubic 4x4 (one more pixel on each side).
        lo, hi = (pr + 1, 3 + pr) if mode == "bicubic" else (pr, 2 + pr)
        in_bounds = ((uv[:, 0] >= lo) & (uv[:, 0] <= img_w - hi)
                     & (uv[:, 1] >= lo) & (uv[:, 1] <= img_h - hi))
    valid = obs_mask.T & in_front & in_bounds              # (W, N)
    if depth_prior is not None and depth_prior[2] > 0.0:
        rp, jp = _prior_terms_pm(r_cw, y_pm, valid, depth_prior, uv.dtype)
    else:
        rp = torch.zeros((w, n), dtype=uv.dtype, device=uv.device)
        jp = torch.zeros((w, 9, n), dtype=uv.dtype, device=uv.device)

    if ctx is None:
        ctx = make_cuda_ctx(channels, grads, mode)
    ctx_mode, planes = ctx
    if ctx_mode != mode:
        raise ValueError(f"cuda ctx built for mode '{ctx_mode}', evaluation "
                         f"requested '{mode}'")
    uv_nm = uv.permute(2, 0, 1).contiguous()               # (N, W, 2)
    valid_nm = valid.T.contiguous()
    patch = patch.contiguous()
    if rho is not None:
        stats = ps_mod.scaled_stats(planes, uv_nm, rho.T.contiguous(),
                                    valid_nm, patch, pr, norm=norm_mode)
    elif point_order is not None and mode == "sampled":
        stats = pw_mod.sorted_patch_stats(planes, uv_nm, valid_nm, patch, pr,
                                          point_order, norm=norm_mode)
    else:
        kernel = (pb_mod.bicubic_stats if mode == "bicubic"
                  else pw_mod.patch_stats)
        stats = kernel(planes, uv_nm, valid_nm, patch, pr, norm=norm_mode)
    g00, g01, g11, gxr, gyr, rr = stats                    # (W, N) each
    gtg = torch.stack([torch.stack([g00, g01], dim=1),
                       torch.stack([g01, g11], dim=1)], dim=1)  # (W,2,2,N)
    gtr = torch.stack([gxr, gyr], dim=1)                        # (W, 2, N)
    return _whiten(a, gtg, gtr, jp, rp, valid, rr + rp * rp, huber_delta,
                   robust_kind)


def _evaluate_compressed_torch(cam, t_wc, x_world, patch, channels, grads,
                               obs_mask, offsets, huber_delta: float,
                               gradient_mode: str, depth_prior: tuple | None,
                               normalize, robust_kind: str,
                               patch_warp: tuple | None = None
                               ) -> CompressedResiduals:
    """Gather path (twin of the JAX package's `xla` backend): one pass per
    window frame, then the point-minor layout."""
    n, w = obs_mask.shape
    use_prior = depth_prior is not None and depth_prior[2] > 0.0
    norm_mode = patches_mod.norm_mode(normalize)
    dtype, dev = x_world.dtype, x_world.device
    frames = []
    for f in range(w):
        y, in_front, a, s, g, in_bounds = _frame_samples(
            cam, t_wc[f], x_world, channels[f], grads[f], offsets,
            gradient_mode, patch_warp)
        valid = obs_mask[:, f] & in_front & in_bounds          # (N,)
        s, g = _normalize_sampled(s, g, norm_mode)
        r = (s - patch).reshape(n, -1)                         # (N, D)
        g_c = g.reshape(n, -1, 2)
        gtg = torch.einsum("ndi,ndj->nij", g_c, g_c)           # (N, 2, 2)
        gtr = torch.einsum("ndi,nd->ni", g_c, r)               # (N, 2)
        r_norm2 = torch.sum(r * r, dim=-1)                     # (N,)
        if use_prior:
            rp, jp = _prior_terms(f, t_wc[f], y, valid, depth_prior, dtype)
            r_norm2 = r_norm2 + rp * rp
        else:
            rp = torch.zeros((n,), dtype=dtype, device=dev)
            jp = torch.zeros((n, 9), dtype=dtype, device=dev)
        frames.append((a, gtg, gtr, jp, rp, valid, r_norm2))
    a, gtg, gtr, jp, rp, valid, r_norm2 = (torch.stack(t) for t in
                                           zip(*frames))
    # Frame-major (W, N, ...) -> point-minor (W, ..., N).
    return _whiten(torch.movedim(a, 1, -1), torch.movedim(gtg, 1, -1),
                   torch.movedim(gtr, 1, -1), torch.movedim(jp, 1, -1), rp,
                   valid, r_norm2, huber_delta, robust_kind)


def evaluate_compressed(cam, t_wc, x_world, patch, channels, grads, obs_mask,
                        offsets, huber_delta: float,
                        gradient_mode: str = "sampled",
                        depth_prior: tuple | None = None,
                        backend: str = "torch",
                        ctx=None,
                        normalize=True,
                        robust_kind: str = "huber",
                        patch_warp: tuple | None = None,
                        point_order=None) -> CompressedResiduals:
    """Factored Gauss-Newton statistics of all (point, window-frame)
    observations.

    Args:
      cam: Camera. t_wc: (W, 4, 4) window poses. x_world: (N, 3) points.
      patch: (N, C, P) reference descriptors. channels / grads:
        (W, C, H, Wi) / (W, C, H, Wi, 2) window images.
      obs_mask: (N, W) bool. offsets: (P, 2) patch offset grid.
      huber_delta: robust threshold on the per-observation residual norm.
      depth_prior: optional (ref_slot (N,) int, inv_depth_seed (N,),
        weight float): the inverse-depth prior row on each point's
        reference-frame observation.
      backend: 'torch' (gather path) or 'cuda' (fused kernels;
        gradient_mode 'sampled' or 'bicubic', any normalization, and
        patchWarp='scale' with 'sampled').
      ctx: for backend='cuda', the (mode, planes) of `make_cuda_ctx`,
        built once per solve (built here when None).
      normalize: 'mean' | 'affine' | 'off' (or True / False).
      patch_warp: optional (mode, z_ref, r_wc_ref), see `evaluate`.
      point_order: optional (feed, inverse) of `sorted_dispatch_order`:
        the cuda backend's fixed-grid bilinear kernel then visits the
        observations in that order (the same sums, bitwise); ignored by
        every other path, as the JAX package ignores its point_order.
    """
    if backend == "cuda":
        if gradient_mode not in CUDA_MODES:
            raise ValueError(f"cuda backend implements gradient_mode "
                             f"{CUDA_MODES}, not '{gradient_mode}'")
        return _evaluate_compressed_cuda(
            cam, t_wc, x_world, patch, channels, grads, obs_mask,
            huber_delta, depth_prior, ctx, normalize, robust_kind,
            mode=gradient_mode, patch_warp=patch_warp,
            point_order=point_order)
    if backend != "torch":
        raise ValueError(f"unknown backend '{backend}' (want one of "
                         f"{BACKENDS})")
    return _evaluate_compressed_torch(
        cam, t_wc, x_world, patch, channels, grads, obs_mask, offsets,
        huber_delta, gradient_mode, depth_prior, normalize, robust_kind,
        patch_warp)
