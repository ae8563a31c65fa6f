"""Levenberg-Marquardt trust-region loop over the Schur-reduced system.

Twin of photobundle_tpu/core/lm.py on one device. One LM iteration:
assemble the normal equations from the statistics carried for the current
point, Schur-eliminate points, solve the reduced camera system, retract,
evaluate the candidate once (its statistics double as the next
iteration's system when accepted), and accept/reject branch-free with
`torch.where`. The loop itself is a host `while` that reads the
termination code back once per iteration; everything else stays on the
device.

Lambda policy: Nielsen's adaptive damping (the policy Ceres uses):
  accept: lam *= max(1/3, 1 - (2*rho - 1)^3); nu = 2
  reject: lam *= nu; nu *= 2
with rho = actual / predicted decrease.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..geometry import se3
from ..image import patches as patches_mod
from . import schur
from .residuals import (CompressedResiduals, dispatch_key,
                        evaluate_compressed, grouped_stats_from_env,
                        make_cuda_ctx, patch_warp_ref_geometry,
                        sorted_dispatch_order)


class LMStats(NamedTuple):
    initial_cost: torch.Tensor     # ()
    final_cost: torch.Tensor       # ()
    iterations: torch.Tensor       # () accepted + rejected iterations run
    accepted_steps: torch.Tensor   # ()
    termination: torch.Tensor      # () code, see TERMINATION_NAMES
    cost_log: torch.Tensor         # (max_iter,) cost after each iteration
    lambda_log: torch.Tensor       # (max_iter,)
    step_log: torch.Tensor         # (max_iter,) step norms
    accept_log: torch.Tensor       # (max_iter,) bool
    n_residuals: torch.Tensor      # () valid observation count
    obs_per_frame: torch.Tensor    # (W,) valid observations per window slot
                                   #     at the initial point


TERMINATION_NAMES = {
    1: "max_iterations",
    2: "function_tolerance",
    3: "parameter_tolerance",
    4: "lambda_overflow",
    5: "gradient_tolerance",
}


def _rot_weight(pose_prior) -> float:
    """The absolute prior's rotation weight: pose_prior[2] when given and
    non-negative, else the translation weight."""
    if len(pose_prior) < 3 or pose_prior[2] is None or pose_prior[2] < 0:
        return float(pose_prior[1])
    return float(pose_prior[2])


def _twist_weights(wa_t: float, wa_r: float, like: torch.Tensor):
    return torch.tensor([wa_t] * 3 + [wa_r] * 3, dtype=like.dtype,
                        device=like.device)


def prior_cost(t, *, motion_prior_weight: float = 0.0, rel0=None,
               pose_prior=None):
    """0.5*||r||^2 of the pose-prior terms (relative-motion + absolute),
    exactly as lm_solve's objective counts them.

    rel0: (W-1, 4, 4) relative-pose anchor (required when
    motion_prior_weight > 0). pose_prior: (T_vo, w_trans[, w_rot]).
    """
    c = torch.zeros((), dtype=t.dtype, device=t.device)
    wm = float(motion_prior_weight)
    if wm > 0.0 and rel0 is not None:
        rel = se3.se3_inverse(t[:-1]) @ t[1:]
        r = wm * se3.se3_log(se3.se3_inverse(rel0) @ rel)
        c = c + 0.5 * torch.sum(r * r)
    if pose_prior is not None:
        wa_t, wa_r = float(pose_prior[1]), _rot_weight(pose_prior)
        if wa_t > 0.0 or wa_r > 0.0:
            r = _twist_weights(wa_t, wa_r, t) * se3.se3_log(
                se3.se3_inverse(pose_prior[0]) @ t)
            c = c + 0.5 * torch.sum(r * r)
    return c


def _select(accept, new, old):
    return type(old)(*(torch.where(accept, a, b) for a, b in zip(new, old)))


def lm_solve(
    cam,
    t_wc: torch.Tensor,          # (W, 4, 4) initial window poses
    x_world: torch.Tensor,       # (N, 3) initial points
    patch: torch.Tensor,         # (N, C, P)
    channels: torch.Tensor,      # (W, C, H, Wi)
    grads: torch.Tensor,         # (W, C, H, Wi, 2)
    obs_mask: torch.Tensor,      # (N, W)
    point_valid: torch.Tensor,   # (N,)
    frozen: torch.Tensor,        # (W,) gauge-fixed poses
    offsets: torch.Tensor,       # (P, 2)
    *,
    huber_delta: float,
    robust_kind: str = "huber",
    gradient_mode: str = "sampled",
    backend: str = "torch",
    normalize=True,
    depth_prior: tuple | None = None,
    patch_warp: tuple | None = None,
    motion_prior_weight: float = 0.0,
    motion_prior_anchor: torch.Tensor | None = None,
    pose_prior: tuple | None = None,
    max_iterations: int = 50,
    initial_lambda: float = 1e-4,
    min_lambda: float = 1e-10,
    max_lambda: float = 1e8,
    function_tolerance: float = 1e-6,
    parameter_tolerance: float = 1e-8,
    gradient_tolerance: float = 0.0,
    min_obs_per_frame: int = 1,
):
    """Run LM to convergence. Returns (t_wc, x_world, LMStats).

    backend: 'torch' (gather path) or 'cuda' (the fused statistics kernel
    of the sampling mode, K1 for 'sampled', K2 for 'bicubic' and K3 for
    patch_warp 'scale', for tensors on a card; its plain version for CPU
    tensors).
    patch_warp: optional (mode, ref_slot (N,) int), mode 'scale' | 'affine'
    (cfg.patchWarp): each point's patch grid is warped by the factor of
    `residuals.patch_warp_frame`, recomputed from the iterate at every
    evaluation (candidates included) with the full window poses, so it
    stays exactly 1 in the point's reference frame. ref_slot < 0 (no
    reference frame in the window) is the fixed grid.

    Sorted dispatch: with PB_SORTED_DISPATCH=1 in the environment (read at
    each call), the cuda backend on the fixed grid with bilinear sampling
    ('sampled') and mean or off normalization (where the JAX package uses
    it) feeds its kernel in the order of `residuals.dispatch_key`, computed
    once from the initial iterate (ops/patch_warp.sorted_patch_stats). The
    statistics are bitwise those of the unsorted kernel.

    Unfused statistics: with PB_GROUPED_STATS=0 in the environment (read
    at each call, as the JAX package reads it), the cuda backend on the
    fixed grid with bilinear sampling and mean or off normalization samples
    through K4's row-store kernel and reduces in plain tensor ops
    (residuals.evaluate_compressed's `grouped_stats`); sorted dispatch
    does not apply there."""
    dtype, dev = t_wc.dtype, t_wc.device
    obs_mask = obs_mask & point_valid[:, None]
    # The cuda backend's planes (by gradient mode; the warped grid reads
    # the 'sampled' planes) are loop-invariant: build once.
    eval_ctx = (make_cuda_ctx(channels, grads, gradient_mode)
                if backend == "cuda" else None)
    grouped_stats = grouped_stats_from_env()
    point_order = None
    if (os.environ.get("PB_SORTED_DISPATCH", "0") == "1" and grouped_stats
            and backend == "cuda" and gradient_mode == "sampled"
            and patch_warp is None
            and patches_mod.norm_mode(normalize) in ("mean", "off")):
        point_order = sorted_dispatch_order(dispatch_key(
            cam, t_wc, x_world, obs_mask, channels.shape[-2:]))

    def eval_stats(t, x) -> CompressedResiduals:
        pw = None
        if patch_warp is not None:
            pw = (patch_warp[0],
                  *patch_warp_ref_geometry(t, x, patch_warp[1]))
        return evaluate_compressed(cam, t, x, patch, channels, grads,
                                   obs_mask, offsets, huber_delta,
                                   gradient_mode, depth_prior=depth_prior,
                                   backend=backend, ctx=eval_ctx,
                                   normalize=normalize,
                                   robust_kind=robust_kind, patch_warp=pw,
                                   point_order=point_order,
                                   grouped_stats=grouped_stats)

    # Relative-pose motion prior: anchors each consecutive window pair's
    # relative pose to its initialization,
    #   r_f = w_m * log(rel0_f^{-1} (T_{f-1}^{-1} T_f)),   f = 1..W-1,
    # with dr/dxi_f = w_m I and dr/dxi_{f-1} = -w_m Ad(rel_f^{-1}).
    wm = float(motion_prior_weight)
    use_motion = wm > 0.0
    w_sz = t_wc.shape[0]
    rel0 = None
    if use_motion:
        rel0 = (motion_prior_anchor if motion_prior_anchor is not None
                else se3.se3_inverse(t_wc[:-1]) @ t_wc[1:])
    # Absolute pose prior r_f = w6 * log(T_vo_f^{-1} T_f), dr/dxi_f = w6 I,
    # with separate translation and rotation weights.
    wa_t = 0.0 if pose_prior is None else float(pose_prior[1])
    wa_r = 0.0 if pose_prior is None else _rot_weight(pose_prior)
    use_abs = wa_t > 0.0 or wa_r > 0.0
    use_any_prior = use_motion or use_abs
    w6 = _twist_weights(wa_t, wa_r, t_wc)

    def prior_cost_terms(t):
        return prior_cost(t, motion_prior_weight=wm if use_motion else 0.0,
                          rel0=rel0,
                          pose_prior=pose_prior if use_abs else None)

    def prior_system(t):
        """(hcc_diag (W,6,6), coupling (W,W,6,6) | None, bc (W,6))."""
        eye6 = torch.eye(6, dtype=dtype, device=dev)
        hd = torch.zeros((w_sz, 6, 6), dtype=dtype, device=dev)
        bc = torch.zeros((w_sz, 6), dtype=dtype, device=dev)
        coup = None
        if use_motion:
            rel = se3.se3_inverse(t[:-1]) @ t[1:]
            r = wm * se3.se3_log(se3.se3_inverse(rel0) @ rel)     # (W-1, 6)
            ad = se3.adjoint(se3.se3_inverse(rel))                # (W-1, 6, 6)
            idx = torch.arange(w_sz - 1, device=dev)
            hd[idx + 1] += wm * wm * eye6[None]
            hd[idx] += wm * wm * torch.einsum("fki,fkj->fij", ad, ad)
            coup = torch.zeros((w_sz, w_sz, 6, 6), dtype=dtype, device=dev)
            coup[idx, idx + 1] += -wm * wm * ad.transpose(-1, -2)
            coup[idx + 1, idx] += -wm * wm * ad
            bc[idx + 1] += -wm * r
            bc[idx] += wm * torch.einsum("fki,fk->fi", ad, r)
        if use_abs:
            hd = hd + torch.diag(w6 * w6)[None]
            r_abs = w6 * se3.se3_log(se3.se3_inverse(pose_prior[0]) @ t)
            bc = bc - w6 * r_abs
        return hd, coup, bc

    res = eval_stats(t_wc, x_world)
    init_cost = res.cost + prior_cost_terms(t_wc)
    n_res = res.n_residuals
    obs_per_frame0 = torch.sum(res.valid, dim=0, dtype=torch.int32)

    t_cur, x_cur, cost = t_wc, x_world, init_cost
    lam = torch.tensor(initial_lambda, dtype=dtype, device=dev)
    nu = torch.tensor(2.0, dtype=dtype, device=dev)
    accepted = torch.zeros((), dtype=torch.int32, device=dev)
    term = torch.zeros((), dtype=torch.int32, device=dev)
    cost_log = torch.full((max_iterations,), torch.nan, dtype=dtype,
                          device=dev)
    lambda_log = torch.full_like(cost_log, torch.nan)
    step_log = torch.full_like(cost_log, torch.nan)
    accept_log = torch.zeros((max_iterations,), dtype=torch.bool, device=dev)
    min_obs = max(1, min_obs_per_frame)

    it = 0
    while it < max_iterations and int(term) == 0:
        # The carried statistics are those of the current point (evaluated
        # when it was the accepted candidate).
        eq = schur.build_normal_equations_compressed(res)
        coupling = None
        if use_any_prior:
            hd, coupling, bc_p = prior_system(t_cur)
            eq = eq._replace(hcc=eq.hcc + hd, bc=eq.bc + bc_p)
        # Freeze poses with too little support in addition to the gauge.
        obs_per_frame = torch.sum(res.valid, dim=0, dtype=torch.int32)
        frz = frozen | (obs_per_frame < min_obs)

        sys_parts = schur.reduce_camera_system(eq, lam, point_valid, frz,
                                               pose_coupling=coupling)
        dc, dp = schur.solve_reduced(sys_parts)

        t_new = se3.retract_right(t_cur, dc)
        x_new = x_cur + dp
        res_new = eval_stats(t_new, x_new)
        new_cost = res_new.cost + prior_cost_terms(t_new)

        pred = torch.clamp(schur.predicted_reduction(eq, lam, dc, dp),
                           min=1e-20)
        actual = cost - new_cost
        rho = actual / pred
        accept = (rho > 0) & torch.isfinite(new_cost)

        # Nielsen damping update.
        lam_acc = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3,
                                    min=1.0 / 3.0)
        lam_new = torch.where(accept,
                              torch.clamp(lam_acc, min_lambda, max_lambda),
                              torch.clamp(lam * nu, max=max_lambda * 10.0))
        nu_new = torch.where(accept, 2.0, nu * 2.0)

        step_norm = torch.sqrt(torch.sum(dp * dp) + torch.sum(dc * dc))
        param_norm2 = (torch.sum(x_cur ** 2)
                       + torch.sum(se3.se3_log(t_cur) ** 2))

        cost_out = torch.where(accept, new_cost, cost)
        # Termination tests (only on accepted steps, Ceres-style).
        ftol_hit = accept & (actual <= function_tolerance * cost)
        xtol_hit = accept & (step_norm <= parameter_tolerance * (
            torch.sqrt(param_norm2) + parameter_tolerance))
        lam_hit = ~accept & (lam >= max_lambda)
        # Gradient stop: ||J^T r||_2 over free poses + valid points.
        g2 = (torch.sum((eq.bc * (~frz).to(dtype)[:, None]) ** 2)
              + torch.sum((eq.bp * point_valid.to(dtype)[None, :]) ** 2))
        gtol_hit = ((torch.sqrt(g2) <= gradient_tolerance)
                    & (gradient_tolerance > 0))
        zero = torch.zeros_like(term)
        term = torch.where(gtol_hit, 5, torch.where(
            ftol_hit, 2, torch.where(xtol_hit, 3,
                                     torch.where(lam_hit, 4, zero))))

        cost_log[it] = cost_out
        lambda_log[it] = lam
        step_log[it] = step_norm
        accept_log[it] = accept
        t_cur = torch.where(accept, t_new, t_cur)
        x_cur = torch.where(accept, x_new, x_cur)
        res = _select(accept, res_new, res)
        cost = cost_out
        lam, nu = lam_new, nu_new
        accepted = accepted + accept.to(torch.int32)
        it += 1

    stats = LMStats(
        initial_cost=init_cost,
        final_cost=cost,
        iterations=torch.tensor(it, dtype=torch.int32, device=dev),
        accepted_steps=accepted,
        termination=torch.where(term == 0, 1, term),
        cost_log=cost_log,
        lambda_log=lambda_log,
        step_log=step_log,
        accept_log=accept_log,
        n_residuals=n_res,
        obs_per_frame=obs_per_frame0,
    )
    return t_cur, x_cur, stats
