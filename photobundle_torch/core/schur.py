"""Gauss-Newton normal equations + Schur complement.

Twin of photobundle_tpu/core/schur.py. The normal equations are built
directly from the factored residual statistics (core/residuals.py), so the
whole points-first elimination is batched dense algebra:

    Hpp  (3, 3, N)    per-point blocks         -> batched closed-form inverse
    Hpc  (W, 3, 6, N) point-pose coupling      -> broadcast multiplies
    Hcc  (W, 6, 6)    pose diagonal blocks     -> one contraction over 2N
    S    (W, W, 6, 6) reduced camera system    -> one contraction over 3N
    solve 6W x 6W     dense Cholesky (W is the sliding window: tiny)

`solve_dense_full` assembles and solves the whole (6W + 3N) system
densely: the tests' oracle for the Schur step, never on the solve's path.
`build_normal_equations` (from the dense `evaluate` output) and `inv3x3`
(the (..., 3, 3) layout) are oracles for tests and tiny problems too.

Every per-point tensor keeps the point axis LAST, the JAX package's layout,
so the two packages' tensors compare one for one. Invalid observations
contribute exact zeros. Damping follows Ceres' LEVENBERG_MARQUARDT:
H + lam * diag(H) with the diagonal clamped, applied consistently to the
eliminated point blocks and the reduced system.

The solve's functions (`build_normal_equations_compressed` through
`predicted_reduction`) also take B windows on a leading batch axis, lam
(B,), the twin of jax.vmap over the JAX package's: every sum of more than
three terms runs in `ops/ordered_sum.row_dot`'s order, fixed by its
length, the reduced systems are solved by `ops/chol_solve` (one block
per system), and the rest is elementwise, so window b's results are
bitwise those of its own call. On the CPU the sums' plain versions are
torch's sums over the same axes (`sum_over`) and, for the contractions
(hcc, s_off, rhs_off), MKL's products window by window (`contract`): a
window rounds as the single-window solve's torch operations round it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.chol_solve import chol_solve
from ..ops.ordered_sum import contract, row_sum, sum_over
from .residuals import CompressedResiduals, Residuals

_DIAG_MIN = 1e-6
_DIAG_MAX = 1e32


class NormalEq(NamedTuple):
    hpp: torch.Tensor    # (3, 3, N)
    hpc: torch.Tensor    # (W, 3, 6, N)
    hcc: torch.Tensor    # (W, 6, 6)
    bp: torch.Tensor     # (3, N)   right-hand side -J^T r (point part)
    bc: torch.Tensor     # (W, 6)   right-hand side -J^T r (pose part)


class NormalEqDense(NamedTuple):
    """The same blocks point-major (the JAX package's dense layout)."""

    hpp: torch.Tensor    # (N, 3, 3)
    hpc: torch.Tensor    # (N, W, 3, 6)
    hcc: torch.Tensor    # (W, 6, 6)
    bp: torch.Tensor     # (N, 3)
    bc: torch.Tensor     # (W, 6)


def to_point_major(eq: NormalEq) -> NormalEqDense:
    return NormalEqDense(hpp=eq.hpp.permute(2, 0, 1),
                         hpc=eq.hpc.permute(3, 0, 1, 2), hcc=eq.hcc,
                         bp=eq.bp.T, bc=eq.bc)


def to_point_minor(eq: NormalEqDense) -> NormalEq:
    return NormalEq(hpp=eq.hpp.permute(1, 2, 0),
                    hpc=eq.hpc.permute(1, 2, 3, 0), hcc=eq.hcc,
                    bp=eq.bp.T, bc=eq.bc)


def build_normal_equations(res: Residuals) -> NormalEqDense:
    """Oracle path from the dense (N, W, D, .) residual tensor of
    `residuals.evaluate`: tests and tiny problems only. Each einsum is a
    batched matmul; masked entries are exact zeros."""
    jp, jc, r = res.j_point, res.j_pose, res.r
    hpp = torch.einsum("nwdi,nwdj->nij", jp, jp)
    hpc = torch.einsum("nwdi,nwdj->nwij", jp, jc)
    hcc = torch.einsum("nwdi,nwdj->wij", jc, jc)
    bp = -torch.einsum("nwdi,nwd->ni", jp, r)
    bc = -torch.einsum("nwdi,nwd->wi", jc, r)
    return NormalEqDense(hpp=hpp, hpc=hpc, hcc=hcc, bp=bp, bc=bc)


def build_normal_equations_compressed(res: CompressedResiduals) -> NormalEq:
    """Normal equations from the rank-2-factored statistics; per
    observation

        H_obs = A^T gtg A + jp jp^T          (9, 9)
        b_obs = -(A^T gtr + rp * jp)         (9,)

    partitioned into Hpp / Hpc / Hcc / bp / bc and summed over frames /
    points. Only the needed blocks are formed, never the full 9x9."""
    a, gtg, gtr = res.a, res.gtg, res.gtr          # (W,2,9,N) (W,2,2,N) (W,2,N)
    jp, rp = res.jp, res.rp                        # (W, 9, N) (W, N)
    a0, a1 = a[..., 0, :, :], a[..., 1, :, :]      # (W, 9, N)
    # ga[w,b,j,n] = sum_a gtg[w,b,a,n] * a[w,a,j,n]
    ga = (gtg[..., :, 0, None, :] * a0[..., None, :, :]
          + gtg[..., :, 1, None, :] * a1[..., None, :, :])  # (W, 2, 9, N)
    g0, g1 = ga[..., 0, :, :], ga[..., 1, :, :]
    # Pose diagonal blocks: one contraction over the rows (a_0, a_1, jp)
    # and the point axis.
    rows_c = torch.stack([a0[..., :6, :], a1[..., :6, :], jp[..., :6, :]],
                         dim=-2).flatten(-2)               # (W, 6, 3N)
    cols_c = torch.stack([g0[..., :6, :], g1[..., :6, :], jp[..., :6, :]],
                         dim=-2).flatten(-2)
    hcc = contract(rows_c, cols_c)                         # (W, 6, 6)

    # Point blocks: per point, a contraction over the 2W rows (w, a_b),
    # then one over the W prior rows, added as the JAX package adds them.
    ap, gap, jpp = a[..., 6:, :], ga[..., 6:, :], jp[..., 6:, :]
    hpp = (sum_over(ap[..., :, None, :] * gap[..., None, :, :], (-5, -4))
           + sum_over(jpp[..., :, None, :] * jpp[..., None, :, :],
                      (-4,)))                              # (3, 3, N)
    hpc = ((a0[..., 6:, None, :] * g0[..., None, :6, :]
            + a1[..., 6:, None, :] * g1[..., None, :6, :])
           + jp[..., 6:, None, :] * jp[..., None, :6, :])  # (W, 3, 6, N)

    b_obs = -(torch.sum(a * gtr[..., None, :], dim=-3)
              + jp * rp[..., None, :])                     # (W, 9, N)
    bp = sum_over(b_obs[..., 6:, :], (-3,))                # (3, N)
    bc = sum_over(b_obs[..., :6, :], (-1,))                # (W, 6)
    return NormalEq(hpp=hpp, hpc=hpc, hcc=hcc, bp=bp, bc=bc)


def _lead(lam, k: int) -> torch.Tensor:
    """lam ((), or one per window of a leading batch axis) with k trailing
    axes to broadcast against a window's blocks."""
    lam = torch.as_tensor(lam)
    return lam.reshape(*lam.shape, *(1,) * k)


def _damped(h: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """H + lam * clamp(diag(H)) * I for (W, k, k) blocks (any leading
    axes, lam per leading batch entry)."""
    d = torch.clamp(torch.diagonal(h, dim1=-2, dim2=-1), _DIAG_MIN, _DIAG_MAX)
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
    return h + _lead(lam, 3) * d[..., None] * eye


def _damped_nlast(h: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Same for the (3, 3, N) point-minor layout."""
    eye = torch.eye(h.shape[-2], dtype=h.dtype, device=h.device)[:, :, None]
    d = torch.stack([h[..., i, i, :] for i in range(h.shape[-2])],
                    dim=-2)                                # (3, N)
    d = torch.clamp(d, _DIAG_MIN, _DIAG_MAX)
    return h + _lead(lam, 3) * d[..., :, None, :] * eye


def inv3x3(m: torch.Tensor, valid: torch.Tensor | None = None,
           eps: float = 1e-12) -> torch.Tensor:
    """Batched closed-form (adjugate) 3x3 inverse, (..., 3, 3) layout: the
    oracle of `inv3x3_nlast`. Singular or invalid blocks return zeros."""
    return inv3x3_nlast(m[..., None], None if valid is None
                        else valid[..., None], eps)[..., 0]


def inv3x3_nlast(m: torch.Tensor, valid: torch.Tensor | None = None,
                 eps: float = 1e-12) -> torch.Tensor:
    """Closed-form (adjugate) inverse of (..., 3, 3, N) blocks (any
    leading batch axes). Singular or invalid blocks return zeros, which
    makes their point update zero."""
    a, b, c = m[..., 0, 0, :], m[..., 0, 1, :], m[..., 0, 2, :]
    d, e, f = m[..., 1, 0, :], m[..., 1, 1, :], m[..., 1, 2, :]
    g, h, i = m[..., 2, 0, :], m[..., 2, 1, :], m[..., 2, 2, :]
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
            torch.stack([ca, c * h - b * i, b * f - c * e], dim=-2),
            torch.stack([cb, a * i - c * g, c * d - a * f], dim=-2),
            torch.stack([cc, b * g - a * h, a * e - b * d], dim=-2),
        ], dim=-3
    )
    return adj * inv_det[..., None, None, :]


class SchurSystem(NamedTuple):
    s: torch.Tensor          # (6W, 6W) reduced camera matrix (gauge-fixed)
    rhs: torch.Tensor        # (6W,)
    hpp_inv: torch.Tensor    # (3, 3, N) damped inverses (back-substitution)
    hpc_d: torch.Tensor      # (W, 3, 6, N) coupling (= hpc)
    bp: torch.Tensor         # (3, N)


class PointTerms(NamedTuple):
    """The point-summed parts of the reduced system (`point_terms`)."""
    hpp_inv: torch.Tensor    # (3, 3, N) damped inverses W_p
    s_off: torch.Tensor      # (W, W, 6, 6) sum_n Hpc W_p Hpc^T
    rhs_off: torch.Tensor    # (W, 6) sum_n Hpc W_p bp


def point_terms(eq: NormalEq, lam: torch.Tensor,
                point_valid: torch.Tensor) -> PointTerms:
    """Eliminate point blocks: the terms of S and rhs that sum over points.
    Under a points mesh a rank's are the sums over its own points; the
    caller sums s_off and rhs_off over the axis (core/lm.py's body packs
    them with hcc and bc) before `reduce_camera_system`."""
    hpp_inv = inv3x3_nlast(_damped_nlast(eq.hpp, lam), point_valid)
    # T[w, i, k, n] = sum_j W_p[i, j, n] Hpc[w, j, k, n], j in order
    hpc = eq.hpc
    t = ((hpp_inv[..., None, :, 0, None, :] * hpc[..., :, 0, None, :, :]
          + hpp_inv[..., None, :, 1, None, :] * hpc[..., :, 1, None, :, :])
         + hpp_inv[..., None, :, 2, None, :] * hpc[..., :, 2, None, :, :])
    # S[f, g] -= sum_{j,n} Hpc[f, j, i, n] T[g, j, k, n]: one contraction
    # of size 3N per entry, rows (f, i) against (g, k).
    w = hpc.shape[-4]
    hpc_r = hpc.transpose(-3, -2).flatten(-2).flatten(-3, -2)  # (6W, 3N)
    t_r = t.transpose(-3, -2).flatten(-2).flatten(-3, -2)
    # Each a product of one matrix, as the single window's einsum was.
    hpc_r, t_r = hpc_r[..., None, :, :], t_r[..., None, :, :]
    s_off = contract(hpc_r, t_r)[..., 0, :, :].unflatten(
        -1, (w, 6)).unflatten(-3, (w, 6)).transpose(-3, -2)  # (W, W, 6, 6)
    rhs_off = contract(t_r, eq.bp.flatten(-2)[..., None, None, :]
                       )                                   # (1, 6W, 1)
    return PointTerms(hpp_inv=hpp_inv, s_off=s_off,
                      rhs_off=rhs_off.reshape(*rhs_off.shape[:-3], w, 6))


def reduce_camera_system(eq: NormalEq, lam: torch.Tensor,
                         point_valid: torch.Tensor, frozen: torch.Tensor,
                         pose_coupling: torch.Tensor | None = None,
                         terms: PointTerms | None = None) -> SchurSystem:
    """Eliminate point blocks; assemble the reduced (6W, 6W) camera system.

    frozen: (W,) bool — gauge-fixed poses (identity rows/cols, zero rhs).
    point_valid: (N,) bool — points that may move.
    pose_coupling: optional (W, W, 6, 6) off-diagonal pose-pose blocks
        (the relative-motion prior); replicated, never summed over points.
    terms: the `point_terms` of (eq, lam, point_valid), already summed
        over a points mesh (default: computed here, unsharded).
    Leading batch axes carry through; the diagonal blocks are those of the
    window axis.
    """
    w = eq.hcc.shape[-3]
    if terms is None:
        terms = point_terms(eq, lam, point_valid)
    s = -terms.s_off
    # The window axes' diagonal blocks, (6, 6, W) views.
    s.diagonal(0, -4, -3).add_(_damped(eq.hcc, lam).movedim(-3, -1))
    if pose_coupling is not None:
        s = s + pose_coupling
    rhs = eq.bc - terms.rhs_off                              # (W, 6)

    # Gauge fixing: frozen pose blocks become identity rows/cols with zero
    # rhs, so their update is exactly zero.
    free = (~frozen).to(s.dtype)
    mask2 = free[..., :, None] * free[..., None, :]          # (W, W)
    s = s * mask2[..., None, None]
    eye6 = torch.eye(6, dtype=s.dtype, device=s.device)
    s.diagonal(0, -4, -3).add_(
        (eye6 * frozen.to(s.dtype)[..., None, None]).movedim(-3, -1))
    rhs = rhs * free[..., None]

    s_flat = s.transpose(-3, -2).reshape(*s.shape[:-4], 6 * w, 6 * w)
    return SchurSystem(s=s_flat, rhs=rhs.flatten(-2),
                       hpp_inv=terms.hpp_inv, hpc_d=eq.hpc, bp=eq.bp)


def solve_reduced(sys: SchurSystem):
    """Cholesky solve of the reduced system; returns (dc (W,6), dp (N,3)).

    The reduced matrix is SPD after damping + gauge fixing; a 1e-8 jitter
    guards f32 round-off. A factorization that fails yields NaN, as JAX's
    cho_factor does, so the LM step is rejected instead of raising (and
    without the device sync an error check would cost): ops/chol_solve,
    one system per window of a leading batch axis. Back-substitution
    recovers point updates: dp = W_p (bp - Hpc dc)."""
    w6 = sys.s.shape[-1]
    s = sys.s + 1e-8 * torch.eye(w6, dtype=sys.s.dtype, device=sys.s.device)
    dc = chol_solve(s, sys.rhs)                               # (6W,)
    dc = dc.unflatten(-1, (-1, 6))                            # (W, 6)
    rhs_p = sys.bp - sum_over(sys.hpc_d * dc[..., :, None, :, None],
                              (-4, -2))                       # (3, N)
    hi = sys.hpp_inv
    dp = ((hi[..., :, 0, :] * rhs_p[..., 0, None, :]
           + hi[..., :, 1, :] * rhs_p[..., 1, None, :])
          + hi[..., :, 2, :] * rhs_p[..., 2, None, :])         # (3, N)
    return dc, dp.transpose(-1, -2)


def predicted_point_term(eq: NormalEq, lam: torch.Tensor,
                         dp: torch.Tensor) -> torch.Tensor:
    """The point blocks' part of `predicted_reduction` (before its 0.5),
    a sum over the points (a rank's own under a points mesh). dp: (N, 3)."""
    hpp = eq.hpp
    d_p = torch.clamp(torch.stack([hpp[..., 0, 0, :], hpp[..., 1, 1, :],
                                   hpp[..., 2, 2, :]], dim=-2),
                      _DIAG_MIN, _DIAG_MAX)                   # (3, N)
    dpt = dp.transpose(-1, -2)                                # (3, N)
    return row_sum(dpt * (_lead(lam, 2) * d_p * dpt + eq.bp), 2)


def predicted_reduction(eq: NormalEq, lam: torch.Tensor, dc: torch.Tensor,
                        dp: torch.Tensor,
                        term_p: torch.Tensor | None = None) -> torch.Tensor:
    """LM model decrease 0.5 * dx^T (lam * D dx + b) for the gain ratio
    (Madsen/Nielsen form), over pose and point blocks. dp: (N, 3). term_p:
    the point term (`predicted_point_term`), already summed over a points
    mesh (default: computed here, unsharded); the pose term uses the
    replicated blocks."""
    d_c = torch.clamp(torch.diagonal(eq.hcc, dim1=-2, dim2=-1),
                      _DIAG_MIN, _DIAG_MAX)
    if term_p is None:
        term_p = predicted_point_term(eq, lam, dp)
    term_c = row_sum(dc * (_lead(lam, 2) * d_c * dc + eq.bc), 2)
    return 0.5 * (term_c + term_p)


def solve_dense_full(eq, lam: torch.Tensor, point_valid: torch.Tensor,
                     frozen: torch.Tensor):
    """Reference oracle (twin of the JAX package's `solve_dense_full`):
    assemble the FULL damped (6W + 3N) system, with identity rows and
    columns for frozen poses and invalid points and a 1e-8 jitter, and
    solve it densely. O((6W + 3N)^3): tests only. Takes either layout;
    returns (dc (W, 6), dp (N, 3))."""
    if isinstance(eq, NormalEq):
        eq = to_point_major(eq)
    n, w = eq.hpp.shape[0], eq.hcc.shape[0]
    dim = 6 * w + 3 * n
    dtype, dev = eq.hcc.dtype, eq.hcc.device
    h = torch.zeros((dim, dim), dtype=dtype, device=dev)
    k6 = torch.arange(6, device=dev)
    k3 = torch.arange(3, device=dev)
    pose = 6 * torch.arange(w, device=dev)[:, None] + k6          # (W, 6)
    point = 6 * w + 3 * torch.arange(n, device=dev)[:, None] + k3  # (N, 3)
    h[pose[:, :, None], pose[:, None, :]] = _damped(eq.hcc, lam)
    h[point[:, :, None], point[:, None, :]] = _damped(eq.hpp, lam)
    rows = point[:, None, :, None]                                 # (N,1,3,1)
    cols = pose[None, :, None, :]                                  # (1,W,1,6)
    h[rows, cols] = eq.hpc
    h[cols, rows] = eq.hpc                  # the transposed blocks
    b = torch.cat([eq.bc.reshape(-1), eq.bp.reshape(-1)])
    # Freeze gauge poses and invalid points by identity rows/cols.
    fixed = torch.cat([frozen.repeat_interleave(6),
                       (~point_valid).repeat_interleave(3)])
    free = (~fixed).to(dtype)
    h = h * free[:, None] * free[None, :] + torch.diag(fixed.to(dtype))
    sol = torch.linalg.solve(
        h + 1e-8 * torch.eye(dim, dtype=dtype, device=dev), b * free)
    return sol[:6 * w].reshape(w, 6), sol[6 * w:].reshape(n, 3)
