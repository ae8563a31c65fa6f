"""Gauss-Newton normal equations + Schur complement.

Twin of photobundle_tpu/core/schur.py. The normal equations are built
directly from the factored residual statistics (core/residuals.py), so the
whole points-first elimination is batched dense algebra:

    Hpp  (3, 3, N)    per-point blocks         -> batched closed-form inverse
    Hpc  (W, 3, 6, N) point-pose coupling      -> broadcast multiplies
    Hcc  (W, 6, 6)    pose diagonal blocks     -> one contraction over 2N
    S    (W, W, 6, 6) reduced camera system    -> one contraction over 3N
    solve 6W x 6W     dense Cholesky (W is the sliding window: tiny)

Every per-point tensor keeps the point axis LAST, the JAX package's layout,
so the two packages' tensors compare one for one. Invalid observations
contribute exact zeros. Damping follows Ceres' LEVENBERG_MARQUARDT:
H + lam * diag(H) with the diagonal clamped, applied consistently to the
eliminated point blocks and the reduced system.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .residuals import CompressedResiduals

_DIAG_MIN = 1e-6
_DIAG_MAX = 1e32


class NormalEq(NamedTuple):
    hpp: torch.Tensor    # (3, 3, N)
    hpc: torch.Tensor    # (W, 3, 6, N)
    hcc: torch.Tensor    # (W, 6, 6)
    bp: torch.Tensor     # (3, N)   right-hand side -J^T r (point part)
    bc: torch.Tensor     # (W, 6)   right-hand side -J^T r (pose part)


def build_normal_equations_compressed(res: CompressedResiduals) -> NormalEq:
    """Normal equations from the rank-2-factored statistics; per
    observation

        H_obs = A^T gtg A + jp jp^T          (9, 9)
        b_obs = -(A^T gtr + rp * jp)         (9,)

    partitioned into Hpp / Hpc / Hcc / bp / bc and summed over frames /
    points. Only the needed blocks are formed, never the full 9x9."""
    a, gtg, gtr = res.a, res.gtg, res.gtr          # (W,2,9,N) (W,2,2,N) (W,2,N)
    jp, rp = res.jp, res.rp                        # (W, 9, N) (W, N)
    # ga[w,b,j,n] = sum_a gtg[w,b,a,n] * a[w,a,j,n]
    ga = (gtg[:, :, 0][:, :, None] * a[:, 0][:, None]
          + gtg[:, :, 1][:, :, None] * a[:, 1][:, None])     # (W, 2, 9, N)
    # Pose diagonal blocks: one contraction over the point axis.
    rows_c = torch.cat([a[:, :, :6], jp[:, None, :6]], dim=1)
    cols_c = torch.cat([ga[:, :, :6], jp[:, None, :6]], dim=1)
    hcc = torch.einsum("wbin,wbjn->wij", rows_c, cols_c)     # (W, 6, 6)

    ap, gap, jpp = a[:, :, 6:], ga[:, :, 6:], jp[:, 6:]      # (W,2,3,N), (W,3,N)
    hpp = (torch.sum(ap[:, :, :, None] * gap[:, :, None], dim=(0, 1))
           + torch.sum(jpp[:, :, None] * jpp[:, None], dim=0))  # (3, 3, N)
    hpc = (torch.sum(ap[:, :, :, None] * ga[:, :, None, :6], dim=1)
           + jpp[:, :, None] * jp[:, None, :6])              # (W, 3, 6, N)

    b_obs = -(torch.sum(a * gtr[:, :, None], dim=1) + jp * rp[:, None])
    bp = torch.sum(b_obs[:, 6:], dim=0)                      # (3, N)
    bc = torch.sum(b_obs[:, :6], dim=-1)                     # (W, 6)
    return NormalEq(hpp=hpp, hpc=hpc, hcc=hcc, bp=bp, bc=bc)


def _damped(h: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """H + lam * clamp(diag(H)) * I for (..., k, k) blocks."""
    d = torch.clamp(torch.diagonal(h, dim1=-2, dim2=-1), _DIAG_MIN, _DIAG_MAX)
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
    return h + lam * d[..., None] * eye


def _damped_nlast(h: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Same for the (3, 3, N) point-minor layout."""
    eye = torch.eye(h.shape[0], dtype=h.dtype, device=h.device)[:, :, None]
    d = torch.stack([h[i, i] for i in range(h.shape[0])])      # (3, N)
    d = torch.clamp(d, _DIAG_MIN, _DIAG_MAX)
    return h + lam * d[:, None, :] * eye


def inv3x3_nlast(m: torch.Tensor, valid: torch.Tensor | None = None,
                 eps: float = 1e-12) -> torch.Tensor:
    """Closed-form (adjugate) inverse of (3, 3, N) blocks. Singular or
    invalid blocks return zeros, which makes their point update zero."""
    a, b, c = m[0, 0], m[0, 1], m[0, 2]
    d, e, f = m[1, 0], m[1, 1], m[1, 2]
    g, h, i = m[2, 0], m[2, 1], m[2, 2]
    ca = e * i - f * h
    cb = f * g - d * i
    cc = d * h - e * g
    det = a * ca + b * cb + c * cc
    ok = torch.abs(det) > eps
    if valid is not None:
        ok = ok & valid
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    adj = torch.stack(
        [
            torch.stack([ca, c * h - b * i, b * f - c * e]),
            torch.stack([cb, a * i - c * g, c * d - a * f]),
            torch.stack([cc, b * g - a * h, a * e - b * d]),
        ]
    )
    return adj * inv_det


class SchurSystem(NamedTuple):
    s: torch.Tensor          # (6W, 6W) reduced camera matrix (gauge-fixed)
    rhs: torch.Tensor        # (6W,)
    hpp_inv: torch.Tensor    # (3, 3, N) damped inverses (back-substitution)
    hpc_d: torch.Tensor      # (W, 3, 6, N) coupling (= hpc)
    bp: torch.Tensor         # (3, N)


def reduce_camera_system(eq: NormalEq, lam: torch.Tensor,
                         point_valid: torch.Tensor, frozen: torch.Tensor,
                         pose_coupling: torch.Tensor | None = None
                         ) -> SchurSystem:
    """Eliminate point blocks; assemble the reduced (6W, 6W) camera system.

    frozen: (W,) bool — gauge-fixed poses (identity rows/cols, zero rhs).
    point_valid: (N,) bool — points that may move.
    pose_coupling: optional (W, W, 6, 6) off-diagonal pose-pose blocks
        (the relative-motion prior).
    """
    w = eq.hcc.shape[0]
    hpp_inv = inv3x3_nlast(_damped_nlast(eq.hpp, lam), point_valid)
    # T[w, i, k, n] = sum_j W_p[i, j, n] Hpc[w, j, k, n]
    t = torch.sum(hpp_inv[None, :, :, None] * eq.hpc[:, None], dim=2)
    # S[f, g] -= sum_{j,n} Hpc[f, j, i, n] T[g, j, k, n]: one contraction
    # of size 3N.
    s = -torch.einsum("fjin,gjkn->fgik", eq.hpc, t)          # (W, W, 6, 6)
    idx = torch.arange(w, device=s.device)
    s[idx, idx] += _damped(eq.hcc, lam)
    if pose_coupling is not None:
        s = s + pose_coupling
    rhs = eq.bc - torch.einsum("fjin,jn->fi", t, eq.bp)      # (W, 6)

    # Gauge fixing: frozen pose blocks become identity rows/cols with zero
    # rhs, so their update is exactly zero.
    free = (~frozen).to(s.dtype)
    mask2 = free[:, None] * free[None, :]                    # (W, W)
    s = s * mask2[:, :, None, None]
    eye6 = torch.eye(6, dtype=s.dtype, device=s.device)
    s[idx, idx] += eye6[None] * frozen.to(s.dtype)[:, None, None]
    rhs = rhs * free[:, None]

    s_flat = s.permute(0, 2, 1, 3).reshape(6 * w, 6 * w)
    return SchurSystem(s=s_flat, rhs=rhs.reshape(-1), hpp_inv=hpp_inv,
                       hpc_d=eq.hpc, bp=eq.bp)


def solve_reduced(sys: SchurSystem):
    """Cholesky solve of the reduced system; returns (dc (W,6), dp (N,3)).

    The reduced matrix is SPD after damping + gauge fixing; a 1e-8 jitter
    guards f32 round-off. A factorization that fails yields NaN, as JAX's
    cho_factor does, so the LM step is rejected instead of raising (and
    without the device sync an error check would cost). Back-substitution
    recovers point updates: dp = W_p (bp - Hpc dc)."""
    w6 = sys.s.shape[0]
    s = sys.s + 1e-8 * torch.eye(w6, dtype=sys.s.dtype, device=sys.s.device)
    chol, info = torch.linalg.cholesky_ex(s)
    chol = torch.where(info == 0, chol, torch.nan)
    dc = torch.cholesky_solve(sys.rhs[:, None], chol).reshape(-1, 6)
    rhs_p = sys.bp - torch.sum(sys.hpc_d * dc[:, None, :, None],
                               dim=(0, 2))                    # (3, N)
    dp = torch.sum(sys.hpp_inv * rhs_p[None], dim=1)          # (3, N)
    return dc, dp.T


def predicted_reduction(eq: NormalEq, lam: torch.Tensor, dc: torch.Tensor,
                        dp: torch.Tensor) -> torch.Tensor:
    """LM model decrease 0.5 * dx^T (lam * D dx + b) for the gain ratio
    (Madsen/Nielsen form), over pose and point blocks. dp: (N, 3)."""
    d_c = torch.clamp(torch.diagonal(eq.hcc, dim1=-2, dim2=-1),
                      _DIAG_MIN, _DIAG_MAX)
    d_p = torch.clamp(torch.stack([eq.hpp[0, 0], eq.hpp[1, 1], eq.hpp[2, 2]]),
                      _DIAG_MIN, _DIAG_MAX)                   # (3, N)
    dpt = dp.T                                                # (3, N)
    term_c = torch.sum(dc * (lam * d_c * dc + eq.bc))
    term_p = torch.sum(dpt * (lam * d_p * dpt + eq.bp))
    return 0.5 * (term_c + term_p)
