"""Photometric residuals as factored Gauss-Newton statistics.

Twin of photobundle_tpu/core/residuals.py (the compressed path; the dense
`evaluate` / `cost_only` oracle is not ported yet). Residual model, for
point p with world position X, reference descriptor d, window frame f with
pose T_wc[f] and patch offsets {o_k}:

    y      = T_wc[f]^{-1} . X                      (camera-frame point)
    u      = pi(K y)                               (projected pixel)
    s_ck   = I_c(u + o_k)                          (bilinear sample)
    r_ck   = (s_ck - mean_k s_ck) - d_ck           (brightness-normalized)

Patches are fronto-parallel, so every pixel of a patch moves with the same
du/dtheta and the per-observation Jacobian factors as J = G @ A, with G
(D, 2) the centred sampled gradients and A (2, 9) = du/d[pose | point].
Gauss-Newton then needs only gtg = G^T G, gtr = G^T r and ||r||^2 per
observation. Huber (or cauchy / tukey) enters as IRLS whitening. An
optional inverse-depth prior adds one extra residual row per point on its
reference-frame observation.

Two backends:
- backend="torch": the gather path (twin of the JAX `xla` backend): per
  frame, bilinear sampling of stacked value / gradient planes with
  per-sample bounds checks (a sample may sit on the last pixel column).
- backend="cuda": the fused kernel path (twin of the JAX `pallas` backend's
  grouped-stats branch): ops/patch_warp.patch_stats samples, subtracts,
  centres and reduces in one kernel on a card, or runs its plain version
  for CPU tensors. It copies the Pallas path's whole-patch margins,
  pr <= u <= W - 2 - pr, one pixel tighter than the gather path's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import camera as cam_mod
from ..geometry import se3
from ..image import interp
from ..image import patches as patches_mod
from ..ops import patch_warp as pw_mod


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

    s: (..., C, P); g: (..., C, P, 2)."""
    if mode == "off":
        return s, g
    s = s - torch.mean(s, dim=-1, keepdim=True)
    g = g - torch.mean(g, dim=-2, keepdim=True)
    if mode == "mean":
        return s, g
    eps = patches_mod.AFFINE_NORM_EPS
    n = torch.sqrt(torch.sum(s * s, dim=-1, keepdim=True) + eps * eps)
    s = s / n
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


def _sample_patches(channels_f, grads_f, uv, offsets, gradient_mode: str):
    """Sample one frame's patch values and gradients.

    channels_f (C, H, W), grads_f (C, H, W, 2), uv (N, 2), offsets (P, 2).
    Returns s (N, C, P), g (N, C, P, 2), valid (N,)."""
    pts = uv[:, None, :] + offsets                        # (N, P, 2)
    if gradient_mode == "exact":
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
        raise ValueError(f"gradient_mode '{gradient_mode}' is not ported "
                         "(want 'sampled' or 'exact')")
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


def make_cuda_ctx(channels, grads):
    """Sampling context of the cuda backend: the (W, C, H, Wi, 4) texel
    planes of ops/patch_warp. Loop-invariant: build once per solve and pass
    to every evaluate_compressed call (twin of `make_pallas_ctx`)."""
    return pw_mod.build_planes(channels, grads)


def _whiten(a, gtg, gtr, jp, rp, valid, rnorm2, huber_delta, robust_kind):
    """Robust IRLS weights applied to the (W, ..., N) statistics; `valid`
    (W, N). Invalid observations contribute exact zeros."""
    vf = valid.to(gtg.dtype)
    rnorm2 = rnorm2 * vf
    w_robust, rho = robust_weight(rnorm2, huber_delta, robust_kind)
    wv = w_robust * vf        # J^T J / J^T r carry the squared whitening
    sw = torch.sqrt(w_robust) * vf
    return CompressedResiduals(
        a=a,
        gtg=gtg * wv[:, None, None, :],
        gtr=gtr * wv[:, None, :],
        jp=jp * sw[:, None, :],
        rp=rp * sw,
        valid=valid.T,
        cost=0.5 * torch.sum(rho * vf),
        n_residuals=torch.sum(valid, dtype=torch.int32),
    )


def _evaluate_compressed_cuda(cam, t_wc, x_world, patch, channels, grads,
                              obs_mask, huber_delta: float,
                              depth_prior: tuple | None, ctx,
                              normalize, robust_kind: str
                              ) -> CompressedResiduals:
    """Kernel path (twin of the grouped-stats branch of the JAX package's
    `_evaluate_compressed_pallas`): the fused kernel returns the six
    un-whitened sums per observation; the prior row and the whitening are
    added here, outside it."""
    n, w = obs_mask.shape
    pr = (int(round(patch.shape[2] ** 0.5)) - 1) // 2     # P = (2R+1)^2
    norm_mode = patches_mod.norm_mode(normalize)
    if norm_mode not in ("mean", "off"):
        raise ValueError(f"cuda backend implements patch normalization "
                         f"'mean' or 'off', not '{norm_mode}'")
    img_h, img_w = channels.shape[-2], channels.shape[-1]
    lo, hi = pr, 2 + pr       # whole-patch bilinear support, Pallas margins

    y_pm, uv, in_front, a, r_cw = _observation_geometry_pm(cam, t_wc,
                                                           x_world)
    in_bounds = ((uv[:, 0] >= lo) & (uv[:, 0] <= img_w - hi)
                 & (uv[:, 1] >= lo) & (uv[:, 1] <= img_h - hi))
    valid = obs_mask.T & in_front & in_bounds              # (W, N)
    if depth_prior is not None and depth_prior[2] > 0.0:
        rp, jp = _prior_terms_pm(r_cw, y_pm, valid, depth_prior, uv.dtype)
    else:
        rp = torch.zeros((w, n), dtype=uv.dtype, device=uv.device)
        jp = torch.zeros((w, 9, n), dtype=uv.dtype, device=uv.device)

    if ctx is None:
        ctx = make_cuda_ctx(channels, grads)
    stats = pw_mod.patch_stats(
        ctx, uv.permute(2, 0, 1).contiguous(), valid.T.contiguous(),
        patch.contiguous(), pr, center=(norm_mode == "mean"))   # (6, W, N)
    g00, g01, g11, gxr, gyr, rr = stats
    gtg = torch.stack([torch.stack([g00, g01], dim=1),
                       torch.stack([g01, g11], dim=1)], dim=1)  # (W,2,2,N)
    gtr = torch.stack([gxr, gyr], dim=1)                        # (W, 2, N)
    return _whiten(a, gtg, gtr, jp, rp, valid, rr + rp * rp, huber_delta,
                   robust_kind)


def _evaluate_compressed_torch(cam, t_wc, x_world, patch, channels, grads,
                               obs_mask, offsets, huber_delta: float,
                               gradient_mode: str, depth_prior: tuple | None,
                               normalize, robust_kind: str
                               ) -> CompressedResiduals:
    """Gather path (twin of the JAX package's `xla` backend): one pass per
    window frame, then the point-minor layout."""
    n, w = obs_mask.shape
    use_prior = depth_prior is not None and depth_prior[2] > 0.0
    norm_mode = patches_mod.norm_mode(normalize)
    dtype, dev = x_world.dtype, x_world.device
    frames = []
    for f in range(w):
        y, uv, in_front, a = _observation_geometry(cam, t_wc[f], x_world)
        s, g, in_bounds = _sample_patches(channels[f], grads[f], uv, offsets,
                                          gradient_mode)
        valid = obs_mask[:, f] & in_front & in_bounds          # (N,)
        s, g = _normalize_sampled(s, g, norm_mode)
        r = (s - patch).reshape(n, -1)                         # (N, D)
        g_c = g.reshape(n, -1, 2)
        gtg = torch.einsum("ndi,ndj->nij", g_c, g_c)           # (N, 2, 2)
        gtr = torch.einsum("ndi,nd->ni", g_c, r)               # (N, 2)
        r_norm2 = torch.sum(r * r, dim=-1)                     # (N,)
        if use_prior:
            ref_slot, q_seed, wd = depth_prior
            z = torch.clamp(y[:, 2], min=1e-6)
            m = ((ref_slot == f) & valid).to(dtype)
            rp = wd * (1.0 / z - q_seed) * m                   # (N,)
            coef = (-wd / (z * z)) * m
            r_cw = se3.se3_inverse(t_wc[f])[:3, :3]
            e_z = torch.tensor([0.0, 0.0, -1.0], dtype=dtype, device=dev)
            dz_dpose = torch.cat([e_z.expand(n, 3), se3.hat(y)[:, 2, :]],
                                 dim=-1)                       # (N, 6)
            dz_dx = r_cw[2].expand(n, 3)                       # (N, 3)
            jp = coef[:, None] * torch.cat([dz_dpose, dz_dx], dim=-1)
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
                        robust_kind: str = "huber") -> CompressedResiduals:
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
      backend: 'torch' (gather path) or 'cuda' (fused kernel; gradient_mode
        'sampled' with 'mean'/'off' normalization only).
      ctx: for backend='cuda', the planes from `make_cuda_ctx`, built once
        per solve (built here when None).
    """
    if backend == "cuda":
        if gradient_mode != "sampled":
            raise ValueError(f"cuda backend implements gradient_mode "
                             f"'sampled', not '{gradient_mode}'")
        return _evaluate_compressed_cuda(
            cam, t_wc, x_world, patch, channels, grads, obs_mask,
            huber_delta, depth_prior, ctx, normalize, robust_kind)
    if backend != "torch":
        raise ValueError(f"unknown backend '{backend}' (want one of "
                         f"{BACKENDS})")
    return _evaluate_compressed_torch(
        cam, t_wc, x_world, patch, channels, grads, obs_mask, offsets,
        huber_delta, gradient_mode, depth_prior, normalize, robust_kind)
