"""SE(3) / SO(3) Lie-group operations, batched over leading dimensions.

Twin of photobundle_tpu/geometry/se3.py, function for function.

Conventions
-----------
- Poses are 4x4 row-major homogeneous matrices, `T_wc` = world-from-camera
  (the KITTI odometry convention).
- Twists are 6-vectors `[rho | omega]` (translation first, rotation second).
- `exp` uses the closed-form SE(3) exponential (Rodrigues + left Jacobian
  V) with branch-free small-angle Taylor guards (`torch.where`), so a
  batch never splits into host-side branches.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(m: torch.Tensor) -> torch.Tensor:
    """Inverse of `hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta2: torch.Tensor):
    """Branch-free (A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3)."""
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    return a, b, c


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential (Rodrigues): (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    a, b, _ = _sinc_coeffs(theta2)
    wh = hat(w)
    wh2 = wh @ wh
    return _eye3(w) + a[..., None, None] * wh + b[..., None, None] * wh2


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """SO(3) logarithm: (..., 3, 3) -> (..., 3). Safe for angles in [0, pi)."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w_raw = vee(r - r.transpose(-1, -2)) * 0.5       # = sin(theta) * axis
    sin_t = torch.sin(theta)
    # theta / sin(theta), Taylor-guarded near zero.
    scale = torch.where(theta < 1e-4, 1.0 + theta * theta / 6.0,
                        theta / torch.where(sin_t == 0, 1.0, sin_t))
    w_small = w_raw * scale[..., None]
    # Near theta = pi the sin-based formula degrades; recover the axis from
    # the symmetric part: aa^T = S / (1 - cos t) + I.
    near_pi = theta > 3.0
    s = 0.5 * (r + r.transpose(-1, -2)) - _eye3(r)
    denom = torch.where(torch.abs(1.0 - cos_t) < 1e-12, 1.0, 1.0 - cos_t)
    aat_diag = torch.clamp(
        torch.stack([s[..., 0, 0], s[..., 1, 1], s[..., 2, 2]], dim=-1)
        / denom[..., None] + 1.0, 0.0, 1.0)
    axis_abs = torch.sqrt(aat_diag)
    # Signs from the skew part (may vanish exactly at pi; fall back to +).
    sign = torch.where(w_raw >= 0, 1.0, -1.0)
    w_pi = axis_abs * sign * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_small)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential: twist (..., 6) [rho|omega] -> (..., 4, 4)."""
    rho, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    a, b, c = _sinc_coeffs(theta2)
    wh = hat(w)
    wh2 = wh @ wh
    eye = _eye3(xi)
    r = eye + a[..., None, None] * wh + b[..., None, None] * wh2
    v = eye + b[..., None, None] * wh + c[..., None, None] * wh2
    t = torch.einsum("...ij,...j->...i", v, rho)
    return _rt_to_mat(r, t)


def se3_log(t_mat: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm: (..., 4, 4) -> twist (..., 6) [rho|omega]."""
    r = t_mat[..., :3, :3]
    t = t_mat[..., :3, 3]
    w = so3_log(r)
    theta2 = torch.sum(w * w, dim=-1)
    a, b, _ = _sinc_coeffs(theta2)
    wh = hat(w)
    wh2 = wh @ wh
    # V^{-1} = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2  (standard closed form)
    coef = torch.where(
        theta2 < 1e-8,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - a / (2.0 * b)) / torch.where(theta2 == 0, 1.0, theta2),
    )
    v_inv = _eye3(t_mat) - 0.5 * wh + coef[..., None, None] * wh2
    rho = torch.einsum("...ij,...j->...i", v_inv, t)
    return torch.cat([rho, w], dim=-1)


def _rt_to_mat(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    batch = torch.broadcast_shapes(r.shape[:-2], t.shape[:-1])
    r = r.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([r, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=r.dtype,
                          device=r.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_inverse(t_mat: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform: (..., 4, 4) -> (..., 4, 4)."""
    r = t_mat[..., :3, :3]
    t = t_mat[..., :3, 3]
    rt = r.transpose(-1, -2)
    return _rt_to_mat(rt, -torch.einsum("...ij,...j->...i", rt, t))


def transform_points(t_mat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., 3) with broadcasting."""
    return (torch.einsum("...ij,...j->...i", t_mat[..., :3, :3], x)
            + t_mat[..., :3, 3])


def retract_right(t_mat: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Right-multiplicative retraction: T <- T @ exp(xi).

    The local parameterization the LM solver optimizes over; its Jacobians
    (core/residuals.py) are d(x_cam)/d(rho) = -I and
    d(x_cam)/d(omega) = [x_cam]_x for the inverse pose action.
    """
    return t_mat @ se3_exp(xi)


def rotation_geodesic_distance(ra: torch.Tensor,
                               rb: torch.Tensor) -> torch.Tensor:
    """Angle (rad) between rotations, batched."""
    rtr = ra.transpose(-1, -2) @ rb
    trace = rtr[..., 0, 0] + rtr[..., 1, 1] + rtr[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))


def adjoint(t_mat: torch.Tensor) -> torch.Tensor:
    """SE3 adjoint Ad_T (6x6, batched over leading dims) mapping twists
    between frames. Twist convention [rho | omega]."""
    r = t_mat[..., :3, :3]
    t = t_mat[..., :3, 3]
    z = torch.zeros_like(r)
    top = torch.cat([r, hat(t) @ r], dim=-1)             # d rho
    bot = torch.cat([z, r], dim=-1)                      # d omega
    return torch.cat([top, bot], dim=-2)
