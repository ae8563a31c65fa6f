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
- Every product of small matrices and vectors is written out over its
  contracted axis (`mm`, `mv`): elementwise operations, so each pose
  rounds alike whatever the leading axes hold. A matmul or einsum goes to
  cuBLAS, whose kernel (and rounding) changes with the batch count; the
  batched window solve (core/lm.py) needs window b of a batch to round as
  its own solve does.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for small matrices (..., m, k) x (..., k, n), broadcasting the
    leading axes: sum_j a[..., :, j] b[..., j, :] added in order j = 0, 1,
    ..."""
    out = a[..., :, 0, None] * b[..., None, 0, :]
    for j in range(1, a.shape[-1]):
        out = out + a[..., :, j, None] * b[..., None, j, :]
    return out


def mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a @ v for (..., m, k) x (..., k), broadcasting the leading axes, in
    `mm`'s order."""
    out = a[..., :, 0] * v[..., 0, None]
    for j in range(1, a.shape[-1]):
        out = out + a[..., :, j] * v[..., j, None]
    return out


def _norm2(w: torch.Tensor) -> torch.Tensor:
    """sum of squares over the last axis of 3, in order."""
    return ((w[..., 0] * w[..., 0] + w[..., 1] * w[..., 1])
            + w[..., 2] * w[..., 2])


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


def _sin_cos(theta: torch.Tensor):
    """sin and cos of `theta`, correctly rounded for f32 input: taken in
    f64 and rounded once. B = (1 - cos t)/t^2 and C = (t - sin t)/t^3
    cancel, so one ulp of cos or sin moves them by orders of magnitude at
    small angles. torch's f32 sin / cos (the CPU's and CUDA's alike) are
    not correctly rounded; the reference's (XLA's) are, but for a few
    arguments in 1e5, and rounding from f64 gives the same values on
    every device."""
    if theta.dtype != torch.float32:
        return torch.sin(theta), torch.cos(theta)
    t64 = theta.double()
    return torch.sin(t64).float(), torch.cos(t64).float()


def _sinc_coeffs(theta2: torch.Tensor):
    """Branch-free (A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3)."""
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    sin_t, cos_t = _sin_cos(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, sin_t / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - cos_t) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - sin_t) / (theta2 * theta))
    return a, b, c


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential (Rodrigues): (..., 3) -> (..., 3, 3)."""
    theta2 = _norm2(w)
    a, b, _ = _sinc_coeffs(theta2)
    wh = hat(w)
    wh2 = mm(wh, wh)
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
    theta2 = _norm2(w)
    a, b, c = _sinc_coeffs(theta2)
    wh = hat(w)
    wh2 = mm(wh, wh)
    eye = _eye3(xi)
    r = eye + a[..., None, None] * wh + b[..., None, None] * wh2
    v = eye + b[..., None, None] * wh + c[..., None, None] * wh2
    t = mv(v, rho)
    return _rt_to_mat(r, t)


def se3_log(t_mat: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm: (..., 4, 4) -> twist (..., 6) [rho|omega]."""
    r = t_mat[..., :3, :3]
    t = t_mat[..., :3, 3]
    w = so3_log(r)
    theta2 = _norm2(w)
    a, b, _ = _sinc_coeffs(theta2)
    wh = hat(w)
    wh2 = mm(wh, wh)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2  (standard closed form)
    coef = torch.where(
        theta2 < 1e-8,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - a / (2.0 * b)) / torch.where(theta2 == 0, 1.0, theta2),
    )
    v_inv = _eye3(t_mat) - 0.5 * wh + coef[..., None, None] * wh2
    rho = mv(v_inv, t)
    return torch.cat([rho, w], dim=-1)


def _rt_to_mat(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    batch = torch.broadcast_shapes(r.shape[:-2], t.shape[:-1])
    r = r.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([r, t[..., :, None]], dim=-1)
    # [0, 0, 0, 1] made on the device: no host copy (a CUDA graph capture
    # takes it, and it does not wait for the stream).
    kw = dict(dtype=r.dtype, device=r.device)
    bottom = torch.cat([torch.zeros(batch + (1, 3), **kw),
                        torch.ones(batch + (1, 1), **kw)], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def se3_inverse(t_mat: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform: (..., 4, 4) -> (..., 4, 4)."""
    r = t_mat[..., :3, :3]
    t = t_mat[..., :3, 3]
    rt = r.transpose(-1, -2)
    return _rt_to_mat(rt, -mv(rt, t))


def transform_points(t_mat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., 3) with broadcasting."""
    return mv(t_mat[..., :3, :3], x) + t_mat[..., :3, 3]


def _dot3(m: torch.Tensor, v: torch.Tensor, fuse_last: bool) -> torch.Tensor:
    """sum_j m[..., :, j] v[..., j] written out, broadcasting the leading
    axes: fma(m1, v1, m0 v0), then m2 v2 fused in (`fuse_last`) or added.
    Elementwise, so each row rounds as it does alone."""
    acc = torch.addcmul(m[..., :, 0] * v[..., 0:1], m[..., :, 1],
                        v[..., 1:2])
    if fuse_last:
        return torch.addcmul(acc, m[..., :, 2], v[..., 2:3])
    return acc + m[..., :, 2] * v[..., 2:3]


def se3_inverse_each(t_mat: torch.Tensor) -> torch.Tensor:
    """`se3_inverse` whose rounding does not depend on the leading axes.
    The einsum becomes a GEMV for one pose and a batched GEMM for many,
    and those round differently; this writes out the order the card's
    GEMV takes for one pose (chip_smoke phase 16 prints the match)."""
    rt = t_mat[..., :3, :3].transpose(-1, -2)
    return _rt_to_mat(rt, -_dot3(rt, t_mat[..., :3, 3], fuse_last=False))


def transform_points_each(t_mat: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """`transform_points` whose rounding does not depend on the leading
    axes: the order the card's GEMM takes for one pose's points (three
    fused multiply-adds), then the translation."""
    return _dot3(t_mat[..., :3, :3], x, fuse_last=True) + t_mat[..., :3, 3]


def retract_right(t_mat: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Right-multiplicative retraction: T <- T @ exp(xi).

    The local parameterization the LM solver optimizes over; its Jacobians
    (core/residuals.py) are d(x_cam)/d(rho) = -I and
    d(x_cam)/d(omega) = [x_cam]_x for the inverse pose action.
    """
    return mm(t_mat, se3_exp(xi))


def rotation_geodesic_distance(ra: torch.Tensor,
                               rb: torch.Tensor) -> torch.Tensor:
    """Angle (rad) between rotations, batched."""
    rtr = mm(ra.transpose(-1, -2), rb)
    trace = rtr[..., 0, 0] + rtr[..., 1, 1] + rtr[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))


def adjoint(t_mat: torch.Tensor) -> torch.Tensor:
    """SE3 adjoint Ad_T (6x6, batched over leading dims) mapping twists
    between frames. Twist convention [rho | omega]."""
    r = t_mat[..., :3, :3]
    t = t_mat[..., :3, 3]
    z = torch.zeros_like(r)
    top = torch.cat([r, mm(hat(t), r)], dim=-1)         # d rho
    bot = torch.cat([z, r], dim=-1)                      # d omega
    return torch.cat([top, bot], dim=-2)
