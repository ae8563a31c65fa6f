"""Levenberg-Marquardt trust-region loop over the Schur-reduced system.

Twin of photobundle_tpu/core/lm.py on one device. One LM iteration:
assemble the normal equations from the statistics carried for the current
point, Schur-eliminate points, solve the reduced camera system, retract,
evaluate the candidate once (its statistics double as the next
iteration's system when accepted), and accept/reject branch-free with
`torch.where`.

The loop has the JAX loop's pieces (its `jax.lax.while_loop`, one traced
program): `program` returns a start (the initial evaluation and the
initial `LMState`) and a `body(state) -> state` that reads nothing back
to the host and builds no tensor from host data. A body on a finished
state (it = max_iterations, or a termination code set) returns every
field unchanged, so extra bodies after the end are no-ops and the host
reads the termination code only once per LM_READBACK bodies (`_drive`).

On a card, `lm_solve` runs start and body as two CUDA graphs, captured
once per problem key (shapes, dtypes, strides, device and every Python
option, as `jax.jit` keys its programs) and cached (least recently used,
GRAPH_CACHE_SIZE keys): each call copies its tensors into the graphs'
static inputs, replays the start once and the body until the solve has
ended, and returns copies of the final state. A cold key first runs start
and body once eagerly on a side stream (kernel libraries, their shared
memory attributes, cuBLAS and cuSOLVER handles are set up there, never
during a capture) and throws their results away. A capture that fails
raises; nothing falls back to the eager loop, which runs on the CPU and,
when the caller passes capture=False, on the card.

Launch counts (ops/_common): a kernel wrapper counts a launch when it is
called, which a capture does once; each graph records the launches it
captured (the capture's own counts are taken back) and each replay adds
them. `runs` counts what ran: start evaluations and bodies (eager, warm-up
or replayed), warm-ups, captures and host reads of the termination code.
A kernel launched once per evaluation thus launched runs["starts"] +
runs["bodies"] times: per solve, its replays + 1, plus 2 per cold key.

Sharded solves (parallel/sharded.py) pass a `ShardCtx`: its hooks are
the collectives of a device mesh on torch.distributed, one rank per
device, each rank running this program on its shard (the JAX package's
shard_map). The identity context (`points_only_ctx(None)`, the default)
leaves the program exactly as it is unsharded. A context whose groups are
all NCCL groups is captured with the rest of the body (collectives in the
same order on every rank, their warm-up included); gloo groups carry card
tensors through the host and cannot be captured, so on a card a solve
with gloo groups runs the eager loop unless capture=True is asked for,
which raises. Every host decision (`_drive`'s termination read) reads
replicated values: each rank sees the same reduced buffers, so all ranks
replay the same number of bodies.

The program is written over a leading batch axis: B solves of one
configuration (`lm_solve_batched`, the batched engine's, core/batched.py)
run one start and one body whose every operation carries the B windows,
the twin of jax.vmap over the JAX package's loop, and `lm_solve` is the
batch of one. Each evaluation launches the configuration's kernel (K1,
sorted K1, K2, K3/K5 or K4's row store) once over its batch axis; no
operation rounds by B (sums in `ops/ordered_sum.row_dot`'s order, the
reduced systems by `ops/chol_solve`, one block per window, the pose
products written out), so each window's results are bitwise its own
solve's, and the body's launches do not grow with B.

Lambda policy: Nielsen's adaptive damping (the policy Ceres uses):
  accept: lam *= max(1/3, 1 - (2*rho - 1)^3); nu = 2
  reject: lam *= nu; nu *= 2
with rho = actual / predicted decrease.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from ..geometry import se3
from ..geometry.camera import Camera
from ..image import patches as patches_mod
from ..ops import _common
from ..ops.ordered_sum import row_sum
from . import schur
from .residuals import (CompressedResiduals, dispatch_key,
                        evaluate_compressed, grouped_stats_from_env,
                        make_cuda_ctx, patch_warp_ref_geometry,
                        sorted_dispatch_order)

# Bodies between two host reads of the termination code. Results do not
# depend on it (a body on a finished state is a no-op); time does: a read
# idles the card until the host launches the next replay (~0.1 ms), a
# body run past the end costs ~1 ms. chip_smoke.py phase 4 sweeps 1, 2,
# 4 and 8 over an 8-iteration solve and solves that end after 28 and 50
# iterations: 4 took the least time in all (97.92 ms against 98.39 for
# 2, 101.57 for 8 and 103.35 for 1, H100). It divides 8, so a solve of 8
# fixed iterations runs no body in vain.
LM_READBACK = 4
# Problem keys whose captured graphs are kept on the card.
GRAPH_CACHE_SIZE = 8


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


def _same(*tensors):
    """The identity hook: its tensors unchanged (one alone, else a
    tuple)."""
    return tensors[0] if len(tensors) == 1 else tensors


class ShardCtx(NamedTuple):
    """Cross-shard hooks for a ('frames', 'points') mesh (the JAX
    package's ShardCtx): window images sharded over 'frames' (a rank holds
    W / n_frames frames), point tensors over 'points'. The distributed
    Schur assembly is then:

        hpp, bp          summed over 'frames'   (point blocks: all frames)
        hcc, bc          summed over 'points', gathered over 'frames'
        hpc              gathered over 'frames' (the frame axis, dim 1
                         after the batch axis), point-minor
                         (B, W_local, 3, 6, N_local) -> (B, W, 3, 6, N_local)
        S, rhs           summed over 'points'
        cost / n_res     summed over both axes

    and the reduced 6W x 6W solve is replicated on every rank. Each hook
    takes one or more tensors and returns them (one alone, else a tuple)
    summed, or gathered along the frame axis (dim 1: the program's tensors
    carry the batch axis first); the collectives pack the tensors of one
    call into one buffer per dtype (parallel/sharded.Collective).
    Hooks are hashable (they join the graph key). A points-only mesh is
    the context with identity frames hooks (`points_only_ctx`)."""

    reduce_points: Callable     # sum over the points axis
    reduce_frames: Callable     # sum over the frames axis
    reduce_obs: Callable        # sum over both axes (per-observation sums)
    gather_frames: Callable     # gather over the frames axis, dim 1
    frame_offset: int           # global slot index of local frame 0


def points_only_ctx(reduce_fn: Callable | None) -> ShardCtx:
    """The 1-D (points-sharded, or with None unsharded) context."""
    r = reduce_fn if reduce_fn is not None else _same
    return ShardCtx(reduce_points=r, reduce_frames=_same, reduce_obs=r,
                    gather_frames=_same, frame_offset=0)


UNSHARDED = points_only_ctx(None)


def capturable(ctx: ShardCtx | None) -> bool:
    """Whether a solve under `ctx` can be captured in a CUDA graph: every
    hook is the identity or a collective that says it can be (NCCL)."""
    return ctx is None or all(getattr(h, "capturable", True)
                              for h in ctx[:4])


class LMState(NamedTuple):
    """The loop state (the JAX package's `_LoopState`), device tensors
    only, each with the leading batch axis B of `program` (shapes below
    after it). Logs hold NaN (False) past the last iteration."""

    t_wc: torch.Tensor             # (W, 4, 4)
    x_world: torch.Tensor          # (N, 3)
    res: CompressedResiduals       # statistics at (t_wc, x_world)
    cost: torch.Tensor             # ()
    lam: torch.Tensor              # ()
    nu: torch.Tensor               # ()
    it: torch.Tensor               # () int32 iterations run
    accepted: torch.Tensor         # () int32
    term: torch.Tensor             # () int32, 0 while running
    cost_log: torch.Tensor         # (max_iter,)
    lambda_log: torch.Tensor       # (max_iter,)
    step_log: torch.Tensor         # (max_iter,)
    accept_log: torch.Tensor       # (max_iter,) bool


class LMStart(NamedTuple):
    """What the start evaluation adds to LMStats beside the state."""

    initial_cost: torch.Tensor
    n_residuals: torch.Tensor
    obs_per_frame: torch.Tensor


class LMProblem(NamedTuple):
    """The tensors of a solve (`setup`); None where a term is absent."""

    cam: tuple
    t_wc: torch.Tensor
    x_world: torch.Tensor
    patch: torch.Tensor
    channels: torch.Tensor
    grads: torch.Tensor
    obs_mask: torch.Tensor
    point_valid: torch.Tensor
    frozen: torch.Tensor
    offsets: torch.Tensor
    depth_prior: tuple | None      # (ref_slot (N,), inv_depth_seed (N,))
    warp_ref_slot: torch.Tensor | None
    motion_anchor: torch.Tensor | None
    pose_prior_t: torch.Tensor | None
    point_order: tuple | None      # (feed, inverse), sorted dispatch


class LMConfig(NamedTuple):
    """The Python values of a solve (`setup`): hashable, part of a graph
    key, since a capture bakes them into its kernels."""

    huber_delta: float
    robust_kind: str
    gradient_mode: str
    backend: str
    normalize: str
    depth_weight: float | None
    patch_warp: str | None
    motion_prior_weight: float
    pose_prior_weights: tuple      # (translation, rotation)
    max_iterations: int
    initial_lambda: float
    min_lambda: float
    max_lambda: float
    function_tolerance: float
    parameter_tolerance: float
    gradient_tolerance: float
    min_obs_per_frame: int
    grouped_stats: bool
    shard: ShardCtx | None         # None: unsharded


runs = {}


def reset_runs() -> None:
    """Zero `runs`: start evaluations and bodies run (warm-ups included),
    warm-ups and captures of cold graph keys, and host reads of the
    termination code."""
    runs.update(dict.fromkeys(
        ("starts", "bodies", "warm_ups", "captures", "readbacks"), 0))


reset_runs()


def _rot_weight(pose_prior) -> float:
    """The absolute prior's rotation weight: pose_prior[2] when given and
    non-negative, else the translation weight."""
    if len(pose_prior) < 3 or pose_prior[2] is None or pose_prior[2] < 0:
        return float(pose_prior[1])
    return float(pose_prior[2])


def _twist_weights(wa_t: float, wa_r: float, like: torch.Tensor):
    """[wa_t]*3 + [wa_r]*3 on `like`'s device, made there (no host copy:
    a capture takes it)."""
    kw = dict(dtype=like.dtype, device=like.device)
    return torch.cat([torch.full((3,), wa_t, **kw),
                      torch.full((3,), wa_r, **kw)])


def prior_cost(t, *, motion_prior_weight: float = 0.0, rel0=None,
               pose_prior=None):
    """0.5*||r||^2 of the pose-prior terms (relative-motion + absolute),
    exactly as lm_solve's objective counts them; one per window of t's
    leading batch axes (..., W, 4, 4).

    rel0: (W-1, 4, 4) relative-pose anchor (required when
    motion_prior_weight > 0). pose_prior: (T_vo, w_trans[, w_rot]).
    """
    c = torch.zeros(t.shape[:-3], dtype=t.dtype, device=t.device)
    wm = float(motion_prior_weight)
    if wm > 0.0 and rel0 is not None:
        rel = se3.mm(se3.se3_inverse(t[..., :-1, :, :]), t[..., 1:, :, :])
        r = wm * se3.se3_log(se3.mm(se3.se3_inverse(rel0), rel))
        c = c + 0.5 * row_sum(r * r, 2)
    if pose_prior is not None:
        wa_t, wa_r = float(pose_prior[1]), _rot_weight(pose_prior)
        if wa_t > 0.0 or wa_r > 0.0:
            r = _twist_weights(wa_t, wa_r, t) * se3.se3_log(
                se3.mm(se3.se3_inverse(pose_prior[0]), t))
            c = c + 0.5 * row_sum(r * r, 2)
    return c


def _where(cond, new, old):
    """torch.where with `cond` (one value per window of the leading batch
    axis) broadcast over the trailing axes of `new`."""
    cond = cond.reshape(*cond.shape, *(1,) * (new.dim() - cond.dim()))
    return torch.where(cond, new, old)


def _select(take, new, old):
    return type(old)(*(_where(take, a, b) for a, b in zip(new, old)))


def _equal(x: torch.Tensor, y: torch.Tensor) -> bool:
    """x and y hold the same values: one tensor, or equal (a host read
    on a card, so a caller that shares its camera and offsets costs
    none)."""
    return x is y or (x.shape == y.shape and bool(torch.equal(x, y)))


def stack_problems(problems) -> LMProblem:
    """B windows' problems (`setup`, one configuration: equal shapes, the
    same camera and patch offsets) as one with a leading batch axis on
    every tensor but the camera and the offsets, which the body shares.
    Raises ValueError where the windows' cameras or offsets differ."""
    first = problems[0]
    for q in problems[1:]:
        if not (_equal(q.offsets, first.offsets)
                and all(_equal(u, v) for u, v in zip(q.cam, first.cam))):
            raise ValueError("the windows of a batch must share one camera "
                             "and one patch offset grid")

    def stack(*fields):
        if fields[0] is None:
            return None
        if isinstance(fields[0], tuple):
            return tuple(stack(*f) for f in zip(*fields))
        return torch.stack(fields)
    return first._replace(**{
        name: stack(*(getattr(q, name) for q in problems))
        for name in LMProblem._fields if name not in ("cam", "offsets")})


def setup(
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
    shard_ctx: ShardCtx | None = None,
) -> tuple[LMProblem, LMConfig]:
    """A solve's (LMProblem, LMConfig) from lm_solve's arguments.

    backend: 'torch' (gather path) or 'cuda' (the fused statistics kernel
    of the sampling mode, K1 for 'sampled', K2 for 'bicubic' and K3 for
    patch_warp 'scale', for tensors on a card; its plain version for CPU
    tensors).
    depth_prior: optional (ref_slot (N,) int, inv_depth_seed (N,), weight).
    patch_warp: optional (mode, ref_slot (N,) int), mode 'scale' | 'affine'
    (cfg.patchWarp): each point's patch grid is warped by the factor of
    `residuals.patch_warp_frame`, recomputed from the iterate at every
    evaluation (candidates included) with the full window poses, so it
    stays exactly 1 in the point's reference frame. ref_slot < 0 (no
    reference frame in the window) is the fixed grid.
    motion_prior_anchor: (W-1, 4, 4) relative poses the motion prior pulls
    toward (default: the initial window's).
    pose_prior: optional (T_vo (W, 4, 4), w_trans[, w_rot]).

    Sorted dispatch: with PB_SORTED_DISPATCH=1 in the environment (read at
    each call), the cuda backend on the fixed grid with bilinear sampling
    ('sampled') and mean or off normalization (where the JAX package uses
    it) feeds its kernel in the order of `residuals.dispatch_key`, computed
    here, once, from the initial iterate (ops/patch_warp.sorted_patch_stats).
    The statistics are bitwise those of the unsorted kernel.

    Unfused statistics: with PB_GROUPED_STATS=0 in the environment (read
    at each call, as the JAX package reads it), the cuda backend on the
    fixed grid with bilinear sampling and mean or off normalization samples
    through K4's row-store kernel and reduces in plain tensor ops
    (residuals.evaluate_compressed's `grouped_stats`); sorted dispatch
    does not apply there.

    Sharding (the JAX package's hooks): `shard_ctx` is the context of a
    points-sharded solve (`points_only_ctx`) or of a ('frames', 'points')
    mesh; None is the unsharded solve. Under frames sharding
    t_wc and frozen stay the full replicated (W, ...) window while
    channels / grads hold the rank's W_local frames and obs_mask is
    (N_local, W_local); depth_prior's ref_slot holds global slots."""
    frames_sharded = (shard_ctx is not None
                      and channels.shape[0] != t_wc.shape[0])
    norm = patches_mod.norm_mode(normalize)
    grouped_stats = grouped_stats_from_env()
    point_order = None
    if (os.environ.get("PB_SORTED_DISPATCH", "0") == "1" and grouped_stats
            and backend == "cuda" and gradient_mode == "sampled"
            and patch_warp is None and norm in ("mean", "off")
            and not frames_sharded):
        point_order = sorted_dispatch_order(dispatch_key(
            cam, t_wc, x_world, obs_mask & point_valid[:, None],
            channels.shape[-2:]))
    wm = float(motion_prior_weight)
    weights = ((0.0, 0.0) if pose_prior is None
               else (float(pose_prior[1]), _rot_weight(pose_prior)))
    problem = LMProblem(
        cam=tuple(cam), t_wc=t_wc, x_world=x_world, patch=patch,
        channels=channels, grads=grads, obs_mask=obs_mask,
        point_valid=point_valid, frozen=frozen, offsets=offsets,
        depth_prior=None if depth_prior is None else tuple(depth_prior[:2]),
        warp_ref_slot=None if patch_warp is None else patch_warp[1],
        motion_anchor=motion_prior_anchor if wm > 0.0 else None,
        pose_prior_t=None if pose_prior is None else pose_prior[0],
        point_order=point_order)
    config = LMConfig(
        huber_delta=float(huber_delta), robust_kind=robust_kind,
        gradient_mode=gradient_mode, backend=backend, normalize=norm,
        depth_weight=None if depth_prior is None else float(depth_prior[2]),
        patch_warp=None if patch_warp is None else patch_warp[0],
        motion_prior_weight=wm, pose_prior_weights=weights,
        max_iterations=int(max_iterations),
        initial_lambda=float(initial_lambda), min_lambda=float(min_lambda),
        max_lambda=float(max_lambda),
        function_tolerance=float(function_tolerance),
        parameter_tolerance=float(parameter_tolerance),
        gradient_tolerance=float(gradient_tolerance),
        min_obs_per_frame=int(min_obs_per_frame),
        grouped_stats=grouped_stats, shard=shard_ctx)
    return problem, config


def program(p: LMProblem, c: LMConfig):
    """(start, body) of B solves of one configuration: start() ->
    (LMState, LMStart) runs the initial evaluation; body(LMState) ->
    LMState one LM iteration of every window, a no-op on a window that has
    ended. `p` carries the windows on a leading batch axis
    (`stack_problems`); a problem of one window without it (`setup`'s) is
    the batch of one. Every tensor of the state and of LMStart has the
    leading axis: each window keeps its own lam, nu, iteration count,
    termination and logs. Both read the tensors of `p` when they run (a
    graph's static inputs), and body reads what the last start computed
    (the loop invariants: sampling planes, masks, prior anchors).

    The twin of jax.vmap over the JAX package's loop: each operation runs
    once for all windows. Each evaluation launches the configuration's
    kernel (K1, sorted K1, K2, K3/K5 or K4's row store) once over its
    batch axis; every sum of more than three terms runs in
    `ops/ordered_sum.row_dot`'s order, the reduced systems are solved by
    `ops/chol_solve`, one block per window, and the pose products are
    written out (geometry/se3), so each window's results are bitwise
    those of a batch of one: `lm_solve` is that batch."""
    if p.t_wc.dim() == 3:
        p = stack_problems([p])
    cam = Camera(*p.cam)
    max_it = c.max_iterations
    wm = c.motion_prior_weight
    use_motion = wm > 0.0
    wa_t, wa_r = c.pose_prior_weights
    use_abs = wa_t > 0.0 or wa_r > 0.0
    use_any_prior = use_motion or use_abs
    pose_prior = (p.pose_prior_t, wa_t, wa_r) if use_abs else None
    sc = UNSHARDED if c.shard is None else c.shard
    w_local = p.channels.shape[-4]
    frames_sharded = c.shard is not None and w_local != p.t_wc.shape[-3]
    off = sc.frame_offset if frames_sharded else 0
    inv = {}                     # the loop invariants, set by start()

    def eval_stats(t, x):
        # The warp's reference geometry comes from the full replicated
        # poses (a point's reference frame may live on another frame
        # shard); the evaluation sees the rank's frames.
        pw = None
        if c.patch_warp is not None:
            pw = (c.patch_warp,
                  *patch_warp_ref_geometry(t, x, p.warp_ref_slot))
        if frames_sharded:
            t = t[..., off:off + w_local, :, :]
        return evaluate_compressed(
            cam, t, x, p.patch, p.channels, p.grads, inv["obs"], p.offsets,
            c.huber_delta, c.gradient_mode, depth_prior=inv["depth_prior"],
            backend=c.backend, ctx=inv["ctx"], normalize=c.normalize,
            robust_kind=c.robust_kind, patch_warp=pw,
            point_order=p.point_order, grouped_stats=c.grouped_stats)

    def prior_cost_terms(t):
        return prior_cost(t, motion_prior_weight=wm, rel0=inv["rel0"],
                          pose_prior=pose_prior)

    # Relative-pose motion prior: anchors each consecutive window pair's
    # relative pose to its initialization,
    #   r_f = w_m * log(rel0_f^{-1} (T_{f-1}^{-1} T_f)),   f = 1..W-1,
    # with dr/dxi_f = w_m I and dr/dxi_{f-1} = -w_m Ad(rel_f^{-1}).
    # Absolute pose prior r_f = w6 * log(T_vo_f^{-1} T_f), dr/dxi_f = w6 I,
    # with separate translation and rotation weights.
    def prior_system(t):
        """(hcc_diag (W,6,6), coupling (W,W,6,6) | None, bc (W,6))."""
        dtype, dev = t.dtype, t.device
        lead, w_sz = t.shape[:-3], t.shape[-3]
        eye6 = torch.eye(6, dtype=dtype, device=dev)
        hd = torch.zeros((*lead, w_sz, 6, 6), dtype=dtype, device=dev)
        bc = torch.zeros((*lead, w_sz, 6), dtype=dtype, device=dev)
        coup = None
        if use_motion:
            rel = se3.mm(se3.se3_inverse(t[..., :-1, :, :]), t[..., 1:, :, :])
            r = wm * se3.se3_log(se3.mm(se3.se3_inverse(inv["rel0"]), rel))
            ad = se3.adjoint(se3.se3_inverse(rel))             # (W-1,6,6)
            ad_t = ad.transpose(-1, -2)
            hd[..., 1:, :, :] += wm * wm * eye6
            hd[..., :-1, :, :] += wm * wm * se3.mm(ad_t, ad)
            coup = torch.zeros((*lead, w_sz, w_sz, 6, 6), dtype=dtype,
                               device=dev)
            # The blocks (f, f + 1) and (f + 1, f): the window axes' first
            # diagonals.
            coup.diagonal(1, -4, -3).add_((-wm * wm * ad_t).movedim(-3, -1))
            coup.diagonal(-1, -4, -3).add_((-wm * wm * ad).movedim(-3, -1))
            bc[..., 1:, :] += -wm * r
            bc[..., :-1, :] += wm * se3.mv(ad_t, r)
        if use_abs:
            w6 = inv["w6"]
            hd = hd + torch.diag(w6 * w6)
            r_abs = w6 * se3.se3_log(se3.mm(se3.se3_inverse(p.pose_prior_t),
                                            t))
            bc = bc - w6 * r_abs
        return hd, coup, bc

    def start():
        t_wc, x_world = p.t_wc, p.x_world
        dtype, dev = t_wc.dtype, t_wc.device
        lead = t_wc.shape[:-3]
        # The cuda backend's planes (by gradient mode; the warped grid
        # reads the 'sampled' planes) are loop-invariant: built here, for
        # all windows at once.
        inv["ctx"] = (make_cuda_ctx(p.channels, p.grads, c.gradient_mode)
                      if c.backend == "cuda" else None)
        inv["obs"] = p.obs_mask & p.point_valid[..., None]
        inv["depth_prior"] = None
        if p.depth_prior is not None:
            # ref_slot holds global window slots; under frames sharding
            # the evaluation compares them with local frame indices, so
            # slots owned by other shards never match.
            ref_slot = (p.depth_prior[0] - off if frames_sharded
                        else p.depth_prior[0])
            inv["depth_prior"] = (ref_slot, p.depth_prior[1],
                                  c.depth_weight)
        inv["rel0"] = None
        if use_motion:
            inv["rel0"] = (p.motion_anchor if p.motion_anchor is not None
                           else se3.mm(se3.se3_inverse(t_wc[..., :-1, :, :]),
                                       t_wc[..., 1:, :, :]))
        inv["w6"] = _twist_weights(wa_t, wa_r, t_wc)
        inv["slots"] = torch.arange(max_it, dtype=torch.int32, device=dev)
        res = eval_stats(t_wc, x_world)
        cost, n_res = sc.reduce_obs(res.cost, res.n_residuals)
        init_cost = cost + prior_cost_terms(t_wc)
        obs_per_frame = sc.gather_frames(sc.reduce_points(
            torch.sum(res.valid, dim=-2, dtype=torch.int32)))
        zero = torch.zeros(lead, dtype=torch.int32, device=dev)
        nan = torch.full((*lead, max_it), torch.nan, dtype=dtype, device=dev)
        # Fresh tensors throughout: a graph's body writes the state in
        # place, and LMStart and the inputs must not change with it.
        state = LMState(
            t_wc=t_wc.clone(), x_world=x_world.clone(), res=res,
            cost=init_cost.clone(),
            lam=torch.full(lead, c.initial_lambda, dtype=dtype, device=dev),
            nu=torch.full(lead, 2.0, dtype=dtype, device=dev),
            it=zero, accepted=zero.clone(), term=zero.clone(),
            cost_log=nan, lambda_log=nan.clone(), step_log=nan.clone(),
            accept_log=torch.zeros((*lead, max_it), dtype=torch.bool,
                                   device=dev))
        return state, LMStart(
            initial_cost=init_cost, n_residuals=n_res.clone(),
            obs_per_frame=obs_per_frame)

    def body(st: LMState) -> LMState:
        running = (st.it < max_it) & (st.term == 0)          # (B,)
        dtype = st.cost.dtype
        # The carried statistics are those of the current point (evaluated
        # when it was the accepted candidate).
        res = st.res
        eq = schur.build_normal_equations_compressed(res)
        # Global assembly (see ShardCtx); with the identity context the
        # blocks pass through unchanged. Gathers over 'frames' come before
        # sums over 'points' (the two commute), so the point-summed Schur
        # terms travel in one buffer with hcc, bc and the per-frame
        # observation counts (as floats: exact below 2^24).
        hpp, bp = sc.reduce_frames(eq.hpp, eq.bp)
        hcc, bc, hpc, obs_per_frame = sc.gather_frames(
            eq.hcc, eq.bc, eq.hpc, torch.sum(res.valid, dim=-2, dtype=dtype))
        eq = schur.NormalEq(hpp=hpp, hpc=hpc, hcc=hcc, bp=bp, bc=bc)
        terms = schur.point_terms(eq, st.lam, p.point_valid)
        hcc, bc, obs_per_frame, s_off, rhs_off = sc.reduce_points(
            eq.hcc, eq.bc, obs_per_frame, terms.s_off, terms.rhs_off)
        eq = eq._replace(hcc=hcc, bc=bc)
        terms = terms._replace(s_off=s_off, rhs_off=rhs_off)
        coupling = None
        if use_any_prior:
            # Added after the reductions: the priors are replicated pose
            # math.
            hd, coupling, bc_p = prior_system(st.t_wc)
            eq = eq._replace(hcc=eq.hcc + hd, bc=eq.bc + bc_p)
        # Freeze poses with too little support in addition to the gauge.
        frz = p.frozen | (obs_per_frame < max(1, c.min_obs_per_frame))

        sys_parts = schur.reduce_camera_system(
            eq, st.lam, p.point_valid, frz, pose_coupling=coupling,
            terms=terms)
        dc, dp = schur.solve_reduced(sys_parts)

        t_new = se3.retract_right(st.t_wc, dc)
        x_new = st.x_world + dp
        res_new = eval_stats(t_new, x_new)
        new_cost = sc.reduce_obs(res_new.cost) + prior_cost_terms(t_new)

        # The point terms of the model decrease and of the step, parameter
        # and gradient norms sum over the rank's points, so they are
        # reduced (one buffer); the pose terms are replicated.
        term_p, dp2, x2, bp2 = sc.reduce_points(
            schur.predicted_point_term(eq, st.lam, dp), row_sum(dp * dp, 2),
            row_sum(st.x_world ** 2, 2),
            row_sum((eq.bp * p.point_valid.to(dtype)[..., None, :]) ** 2,
                    2))
        pred = torch.clamp(schur.predicted_reduction(
            eq, st.lam, dc, dp, term_p=term_p), min=1e-20)
        actual = st.cost - new_cost
        rho = actual / pred
        accept = (rho > 0) & torch.isfinite(new_cost)

        # Nielsen damping update.
        lam_acc = st.lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3,
                                       min=1.0 / 3.0)
        lam_new = torch.where(
            accept, torch.clamp(lam_acc, c.min_lambda, c.max_lambda),
            torch.clamp(st.lam * st.nu, max=c.max_lambda * 10.0))
        nu_new = torch.where(accept, 2.0, st.nu * 2.0)

        step_norm = torch.sqrt(dp2 + row_sum(dc * dc, 2))
        param_norm2 = x2 + row_sum(se3.se3_log(st.t_wc) ** 2, 2)

        cost_out = torch.where(accept, new_cost, st.cost)
        # Termination tests (only on accepted steps, Ceres-style).
        ftol_hit = accept & (actual <= c.function_tolerance * st.cost)
        xtol_hit = accept & (step_norm <= c.parameter_tolerance * (
            torch.sqrt(param_norm2) + c.parameter_tolerance))
        lam_hit = ~accept & (st.lam >= c.max_lambda)
        # Gradient stop: ||J^T r||_2 over free poses + valid points.
        g2 = row_sum((eq.bc * (~frz).to(dtype)[..., None]) ** 2, 2) + bp2
        gtol_hit = ((torch.sqrt(g2) <= c.gradient_tolerance)
                    & (c.gradient_tolerance > 0))
        zero = torch.zeros_like(st.term)
        term = torch.where(gtol_hit, 5, torch.where(
            ftol_hit, 2, torch.where(xtol_hit, 3,
                                     torch.where(lam_hit, 4, zero))))

        # A finished window passes through unchanged: nothing is accepted,
        # no log slot is written, `it` stays.
        take = accept & running
        slot = (inv["slots"] == st.it[..., None]) & running[..., None]
        return LMState(
            t_wc=_where(take, t_new, st.t_wc),
            x_world=_where(take, x_new, st.x_world),
            res=_select(take, res_new, res),
            cost=torch.where(running, cost_out, st.cost),
            lam=torch.where(running, lam_new, st.lam),
            nu=torch.where(running, nu_new, st.nu),
            it=st.it + running.to(torch.int32),
            accepted=st.accepted + take.to(torch.int32),
            term=torch.where(running, term, st.term),
            cost_log=torch.where(slot, cost_out[..., None], st.cost_log),
            lambda_log=torch.where(slot, st.lam[..., None], st.lambda_log),
            step_log=torch.where(slot, step_norm[..., None], st.step_log),
            accept_log=torch.where(slot, accept[..., None], st.accept_log))

    return start, body


def stacked(trees) -> tuple:
    """B NamedTuples of tensors (nested ones too) -> one, every tensor
    stacked on a new leading axis."""
    return type(trees[0])(*(
        stacked(f) if isinstance(f[0], tuple) else torch.stack(f)
        for f in zip(*trees)))


def _all_ended(state: LMState) -> bool:
    """The host read of the termination codes: every window has ended."""
    return bool(torch.all(state.term != 0))


def _drive(step, ended, max_iterations: int) -> None:
    """Run `step` (one body) until the solve has ended: at most
    max_iterations times, calling `ended()` (one host read) after every
    LM_READBACK steps but never after the last allowed one. The host
    counts the steps, so `it` need not be read: a solve of fixed length
    reads nothing back."""
    done = 0
    while done < max_iterations:
        k = min(LM_READBACK, max_iterations - done)
        for _ in range(k):
            step()
        done += k
        if done < max_iterations:
            runs["readbacks"] += 1
            if ended():
                return


def _stats(state: LMState, start: LMStart) -> LMStats:
    return LMStats(
        initial_cost=start.initial_cost,
        final_cost=state.cost,
        iterations=state.it,
        accepted_steps=state.accepted,
        termination=torch.where(state.term == 0, 1, state.term),
        cost_log=state.cost_log,
        lambda_log=state.lambda_log,
        step_log=state.step_log,
        accept_log=state.accept_log,
        n_residuals=start.n_residuals,
        obs_per_frame=start.obs_per_frame)


@dataclass(frozen=True)
class _TensorSpec:
    shape: tuple
    stride: tuple
    dtype: torch.dtype
    device: torch.device


def _leaves(tree, out):
    """The tensors of a nested tuple, depth first; returns its spec: the
    same structure with each tensor replaced by `_TensorSpec` (hashable,
    with every Python value kept)."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
        return _TensorSpec(tuple(tree.shape), tuple(tree.stride()),
                           tree.dtype, tree.device)
    if isinstance(tree, tuple):
        return (type(tree), tuple(_leaves(t, out) for t in tree))
    return tree


def _rebuild(spec, leaves):
    """Inverse of `_leaves`: the structure of `spec` over the tensors of
    the iterator `leaves`."""
    if isinstance(spec, _TensorSpec):
        return next(leaves)
    if isinstance(spec, tuple):
        typ, items = spec
        items = [_rebuild(s, leaves) for s in items]
        return typ(*items) if hasattr(typ, "_fields") else typ(items)
    return spec


def _flat(tree) -> list:
    out = []
    _leaves(tree, out)
    return out


def _capture(fn, what: str):
    """(graph, fn's result, {(wrapper, mode): launches} it captured): fn
    captured into a new CUDA graph on a side stream. The wrappers'
    counts taken during the capture are taken back (nothing ran)."""
    before = _common.launch_counts()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out = fn()
    except Exception as e:
        raise RuntimeError(f"capturing the LM {what} as a CUDA graph "
                           f"failed at the operation named below: {e}") from e
    finally:
        after = _common.launch_counts()
        _common.set_launch_counts(before)
    runs["captures"] += 1
    return graph, out, {k: n - before.get(k, 0) for k, n in after.items()
                        if n != before.get(k, 0)}


class _Graphs:
    """One problem key's captured start and body, and their static
    inputs (copies of the first call's tensors, same strides)."""

    def __init__(self, spec, leaves: list, config: LMConfig):
        self.inputs = [t.clone() for t in leaves]
        start, body = program(_rebuild(spec, iter(self.inputs)), config)
        dev = leaves[0].device
        # Warm-up on a side stream: what runs once per process or per
        # kernel (library load, shared-memory attributes, library
        # handles) happens here, before any capture. Its results are
        # dropped: the program is pure.
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body(start()[0])
        torch.cuda.current_stream(dev).wait_stream(side)
        runs["warm_ups"] += 1
        runs["starts"] += 1
        runs["bodies"] += 1
        self.start, (self.state, self.begun), self.start_launches = (
            _capture(start, "start evaluation"))

        def step():
            new = body(self.state)
            for dst, src in zip(_flat(self.state), _flat(new)):
                dst.copy_(src)

        self.body, _, self.body_launches = _capture(step, "body")

    def run(self, leaves: list, max_iterations: int):
        for dst, src in zip(self.inputs, leaves):
            dst.copy_(src)
        self.start.replay()
        runs["starts"] += 1
        _common.add_launches(self.start_launches)

        def step():
            self.body.replay()
            runs["bodies"] += 1
            _common.add_launches(self.body_launches)

        _drive(step, lambda: _all_ended(self.state), max_iterations)
        # Copies of what the solve returns (the next call of this key
        # overwrites the static state); the carried statistics stay.
        st = self.state
        return (st.t_wc.clone(), st.x_world.clone(),
                LMStats(*(t.clone() for t in _stats(st, self.begun))))


_GRAPHS: OrderedDict = OrderedDict()


def clear_graph_cache() -> None:
    """Drop every captured graph (their device memory returns to the
    caching allocator)."""
    _GRAPHS.clear()


def _run_captured(problem: LMProblem, config: LMConfig):
    leaves = []
    key = (config, _leaves(problem, leaves))
    dev = leaves[0].device
    with torch.cuda.device(dev):
        graphs = _GRAPHS.get(key)
        if graphs is None:
            graphs = _Graphs(key[1], leaves, config)
            _GRAPHS[key] = graphs
            while len(_GRAPHS) > GRAPH_CACHE_SIZE:
                _GRAPHS.popitem(last=False)
        _GRAPHS.move_to_end(key)
        return graphs.run(leaves, config.max_iterations)


def _run_eager(problem: LMProblem, config: LMConfig):
    start, body = program(problem, config)
    state, begun = start()
    runs["starts"] += 1
    cur = [state]

    def step():
        cur[0] = body(cur[0])
        runs["bodies"] += 1

    _drive(step, lambda: _all_ended(cur[0]), config.max_iterations)
    return cur[0].t_wc, cur[0].x_world, _stats(cur[0], begun)


def lm_solve(*args, capture: bool | None = None, **options):
    """Run LM to convergence. Returns (t_wc, x_world, LMStats).

    Arguments: those of `setup` (cam, t_wc, x_world, patch, channels,
    grads, obs_mask, point_valid, frozen, offsets, then the options by
    keyword, `shard_ctx` for a sharded solve). The batch of one of
    `program`'s body, its leading axis taken off the results. capture:
    None (default) replays the solve's CUDA graphs for tensors on a card
    (where its collectives can be captured: no gloo group) and runs the
    eager host loop on the CPU; False runs the eager loop on a card too
    (the same body, to hold the graphs against it); True requires tensors
    on a card."""
    problem, config = setup(*args, **options)
    run = _runner(problem.t_wc.device, config, capture)
    t_wc, x_world, stats = run(stack_problems([problem]), config)
    return t_wc[0], x_world[0], LMStats(*(t[0] for t in stats))


def _runner(device: torch.device, config: LMConfig, capture: bool | None):
    """The captured or the eager loop, by `capture` (see `lm_solve`)."""
    on_card = device.type == "cuda"
    if capture is None:
        capture = on_card and capturable(config.shard)
    if capture and not on_card:
        raise ValueError(f"capture=True needs tensors on a card, not "
                         f"{device}")
    if capture and not capturable(config.shard):
        raise ValueError("a solve with gloo collectives cannot be captured "
                         "in a CUDA graph; pass capture=False (or use "
                         "NCCL groups)")
    return _run_captured if capture else _run_eager


def lm_solve_batched(requests: list, capture: bool | None = None):
    """B solves of one configuration as one program (`program` on their
    problems stacked), the twin of the JAX package's vmapped solve.
    Returns (t_wc (B, W, 4, 4), x_world (B, N, 3), LMStats with a leading
    B axis); window b's results are bitwise those of `lm_solve` on its
    request.

    requests: B (args, options) pairs, each what `lm_solve` takes for one
    window; shapes and options must agree. capture: as `lm_solve`'s. On a
    card the start and the body replay as two CUDA graphs per problem key
    (the B problems' shapes and options), the configuration's kernel
    launched once per evaluation for all the windows, and the host reads
    whether every window has ended once per LM_READBACK bodies."""
    setups = [setup(*args, **options) for args, options in requests]
    config = setups[0][1]
    if any(c != config for _, c in setups):
        raise ValueError("the solves of a batch must share every option")
    problem = stack_problems([p for p, _ in setups])
    run = _runner(problem.t_wc.device, config, capture)
    return run(problem, config)
