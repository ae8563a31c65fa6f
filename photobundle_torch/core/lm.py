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

B solves of one configuration run as one program (`lm_solve_batched`,
`batched_program`; the batched engine's, core/batched.py): start and
body run every window's own start and body, written as generators
(`program_steps`) that yield their kernel launch (residuals.KernelCall:
K1, sorted K1, K2, K3/K5 or K4's row store, by configuration), so that
one launch of that kernel's batch axis serves all B windows per
evaluation (the twin of jax.vmap over each pallas_call); everything else
is the single solve's, so each window's results are bitwise its own
solve's.

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
from . import schur
from .residuals import (CompressedResiduals, dispatch_key,
                        evaluate_compressed_steps, grouped_stats_from_env,
                        launch_batched, make_cuda_ctx,
                        patch_warp_ref_geometry, run_steps,
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
        hpc              gathered over 'frames' (dim 0), point-minor
                         (W_local, 3, 6, N_local) -> (W, 3, 6, N_local)
        S, rhs           summed over 'points'
        cost / n_res     summed over both axes

    and the reduced 6W x 6W solve is replicated on every rank. Each hook
    takes one or more tensors and returns them (one alone, else a tuple)
    summed, or gathered along dim 0; the collectives pack the tensors of
    one call into one buffer per dtype (parallel/sharded.Collective).
    Hooks are hashable (they join the graph key). A points-only mesh is
    the context with identity frames hooks (`points_only_ctx`)."""

    reduce_points: Callable     # sum over the points axis
    reduce_frames: Callable     # sum over the frames axis
    reduce_obs: Callable        # sum over both axes (per-observation sums)
    gather_frames: Callable     # gather over the frames axis, dim 0
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
    only. Logs hold NaN (False) past the last iteration."""

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


def _select(take, new, old):
    return type(old)(*(torch.where(take, a, b) for a, b in zip(new, old)))


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
    """(start, body) of one solve: start() -> (LMState, LMStart) runs the
    initial evaluation; body(LMState) -> LMState one LM iteration, a no-op
    on a finished state. Both read the tensors of `p` when they run (a
    graph's static inputs), and body reads what the last start computed
    (the loop invariants: sampling planes, masks, prior anchors). They run
    `program_steps`' generators, each kernel launch on this window."""
    start_steps, body_steps = program_steps(p, c)
    return (lambda: run_steps(start_steps()),
            lambda st: run_steps(body_steps(st)))


def program_steps(p: LMProblem, c: LMConfig):
    """`program`'s start and body as generator functions: each yields the
    kernel launch of its evaluation (residuals.KernelCall, for the cuda
    backend), is sent its result, and returns what `program`'s returns.
    `start_steps(ctx)` takes a prebuilt sampling context of the cuda
    backend (`batched_program` passes window b's view
    of planes built for all its windows); by default it builds its own."""
    cam = Camera(*p.cam)
    max_it = c.max_iterations
    wm = c.motion_prior_weight
    use_motion = wm > 0.0
    wa_t, wa_r = c.pose_prior_weights
    use_abs = wa_t > 0.0 or wa_r > 0.0
    use_any_prior = use_motion or use_abs
    pose_prior = (p.pose_prior_t, wa_t, wa_r) if use_abs else None
    sc = UNSHARDED if c.shard is None else c.shard
    w_local = p.channels.shape[0]
    frames_sharded = c.shard is not None and w_local != p.t_wc.shape[0]
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
            t = t[off:off + w_local]
        return (yield from evaluate_compressed_steps(
            cam, t, x, p.patch, p.channels, p.grads, inv["obs"], p.offsets,
            c.huber_delta, c.gradient_mode, depth_prior=inv["depth_prior"],
            backend=c.backend, ctx=inv["ctx"], normalize=c.normalize,
            robust_kind=c.robust_kind, patch_warp=pw,
            point_order=p.point_order, grouped_stats=c.grouped_stats))

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
        w_sz = t.shape[0]
        eye6 = torch.eye(6, dtype=dtype, device=dev)
        hd = torch.zeros((w_sz, 6, 6), dtype=dtype, device=dev)
        bc = torch.zeros((w_sz, 6), dtype=dtype, device=dev)
        coup = None
        if use_motion:
            rel = se3.se3_inverse(t[:-1]) @ t[1:]
            r = wm * se3.se3_log(se3.se3_inverse(inv["rel0"]) @ rel)
            ad = se3.adjoint(se3.se3_inverse(rel))                # (W-1,6,6)
            idx = torch.arange(w_sz - 1, device=dev)
            hd[idx + 1] += wm * wm * eye6[None]
            hd[idx] += wm * wm * torch.einsum("fki,fkj->fij", ad, ad)
            coup = torch.zeros((w_sz, w_sz, 6, 6), dtype=dtype, device=dev)
            coup[idx, idx + 1] += -wm * wm * ad.transpose(-1, -2)
            coup[idx + 1, idx] += -wm * wm * ad
            bc[idx + 1] += -wm * r
            bc[idx] += wm * torch.einsum("fki,fk->fi", ad, r)
        if use_abs:
            w6 = inv["w6"]
            hd = hd + torch.diag(w6 * w6)[None]
            r_abs = w6 * se3.se3_log(se3.se3_inverse(p.pose_prior_t) @ t)
            bc = bc - w6 * r_abs
        return hd, coup, bc

    def start(ctx=None):
        t_wc, x_world = p.t_wc, p.x_world
        dtype, dev = t_wc.dtype, t_wc.device
        # The cuda backend's planes (by gradient mode; the warped grid
        # reads the 'sampled' planes) are loop-invariant: built here.
        if ctx is None and c.backend == "cuda":
            ctx = make_cuda_ctx(p.channels, p.grads, c.gradient_mode)
        inv["ctx"] = ctx
        inv["obs"] = p.obs_mask & p.point_valid[:, None]
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
                           else se3.se3_inverse(t_wc[:-1]) @ t_wc[1:])
        inv["w6"] = _twist_weights(wa_t, wa_r, t_wc)
        inv["slots"] = torch.arange(max_it, dtype=torch.int32, device=dev)
        res = yield from eval_stats(t_wc, x_world)
        cost, n_res = sc.reduce_obs(res.cost, res.n_residuals)
        init_cost = cost + prior_cost_terms(t_wc)
        obs_per_frame = sc.gather_frames(sc.reduce_points(
            torch.sum(res.valid, dim=0, dtype=torch.int32)))
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        nan = torch.full((max_it,), torch.nan, dtype=dtype, device=dev)
        # Fresh tensors throughout: a graph's body writes the state in
        # place, and LMStart and the inputs must not change with it.
        state = LMState(
            t_wc=t_wc.clone(), x_world=x_world.clone(), res=res,
            cost=init_cost.clone(),
            lam=torch.full((), c.initial_lambda, dtype=dtype, device=dev),
            nu=torch.full((), 2.0, dtype=dtype, device=dev),
            it=zero, accepted=zero.clone(), term=zero.clone(),
            cost_log=nan, lambda_log=nan.clone(), step_log=nan.clone(),
            accept_log=torch.zeros((max_it,), dtype=torch.bool, device=dev))
        return state, LMStart(
            initial_cost=init_cost, n_residuals=n_res.clone(),
            obs_per_frame=obs_per_frame)

    def body(st: LMState) -> LMState:
        running = (st.it < max_it) & (st.term == 0)
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
            eq.hcc, eq.bc, eq.hpc, torch.sum(res.valid, dim=0, dtype=dtype))
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
        res_new = yield from eval_stats(t_new, x_new)
        new_cost = sc.reduce_obs(res_new.cost) + prior_cost_terms(t_new)

        # The point terms of the model decrease and of the step, parameter
        # and gradient norms sum over the rank's points, so they are
        # reduced (one buffer); the pose terms are replicated.
        term_p, dp2, x2, bp2 = sc.reduce_points(
            schur.predicted_point_term(eq, st.lam, dp), torch.sum(dp * dp),
            torch.sum(st.x_world ** 2),
            torch.sum((eq.bp * p.point_valid.to(dtype)[None, :]) ** 2))
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

        step_norm = torch.sqrt(dp2 + torch.sum(dc * dc))
        param_norm2 = x2 + torch.sum(se3.se3_log(st.t_wc) ** 2)

        cost_out = torch.where(accept, new_cost, st.cost)
        # Termination tests (only on accepted steps, Ceres-style).
        ftol_hit = accept & (actual <= c.function_tolerance * st.cost)
        xtol_hit = accept & (step_norm <= c.parameter_tolerance * (
            torch.sqrt(param_norm2) + c.parameter_tolerance))
        lam_hit = ~accept & (st.lam >= c.max_lambda)
        # Gradient stop: ||J^T r||_2 over free poses + valid points.
        g2 = torch.sum((eq.bc * (~frz).to(dtype)[:, None]) ** 2) + bp2
        gtol_hit = ((torch.sqrt(g2) <= c.gradient_tolerance)
                    & (c.gradient_tolerance > 0))
        zero = torch.zeros_like(st.term)
        term = torch.where(gtol_hit, 5, torch.where(
            ftol_hit, 2, torch.where(xtol_hit, 3,
                                     torch.where(lam_hit, 4, zero))))

        # A finished state passes through unchanged: nothing is accepted,
        # no log slot is written, `it` stays.
        take = accept & running
        slot = (inv["slots"] == st.it) & running
        return LMState(
            t_wc=torch.where(take, t_new, st.t_wc),
            x_world=torch.where(take, x_new, st.x_world),
            res=_select(take, res_new, res),
            cost=torch.where(running, cost_out, st.cost),
            lam=torch.where(running, lam_new, st.lam),
            nu=torch.where(running, nu_new, st.nu),
            it=st.it + running.to(torch.int32),
            accepted=st.accepted + take.to(torch.int32),
            term=torch.where(running, term, st.term),
            cost_log=torch.where(slot, cost_out, st.cost_log),
            lambda_log=torch.where(slot, st.lam, st.lambda_log),
            step_log=torch.where(slot, step_norm, st.step_log),
            accept_log=torch.where(slot, accept, st.accept_log))

    return start, body


def stacked(trees) -> tuple:
    """B NamedTuples of tensors (nested ones too) -> one, every tensor
    stacked on a new leading axis."""
    return type(trees[0])(*(
        stacked(f) if isinstance(f[0], tuple) else torch.stack(f)
        for f in zip(*trees)))


def _lockstep(steps: list, planes):
    """Run B windows' generators of evaluation steps together (the start
    or the body of each window's `program_steps`). They ask for their
    kernel launches in lockstep (one configuration): each round of them is
    one launch of that kernel's batch axis over `planes` (the windows'
    sampling planes stacked, (B, ...)), of which window b's calls read
    planes[b] (`residuals.launch_batched`, which raises if the windows ask
    for different kernels, radii or modes), and each window is sent a copy
    of its slice of the result, bitwise what its own launch returns.
    Returns the windows' results."""
    results, ended = [None] * len(steps), [False] * len(steps)

    def advance(k, sums):
        try:
            return steps[k].send(sums)
        except StopIteration as done:
            results[k], ended[k] = done.value, True
            return None

    calls = [advance(k, None) for k in range(len(steps))]
    while not all(ended):
        if any(ended):
            raise RuntimeError("the windows of a batched solve left "
                               "lockstep")
        out = launch_batched(calls, planes)
        calls = [advance(k, out[k].clone()) for k in range(len(steps))]
    return results


def batched_program(problems: tuple, c: LMConfig):
    """(start, body) of B solves of one configuration as one program: the
    state is the tuple of the windows' `LMState`s (start returns it and
    the tuple of their `LMStart`s); start and body run every window's own
    start and body (`program_steps`, the single solve's operations in its
    order, on tensors of the single solve's layouts), with the
    configuration's kernel (K1, sorted K1, K2, K3/K5 or K4's row store)
    launched once per evaluation for all the windows over its batch axis
    (`_lockstep`). Each window keeps its own lam, nu, iteration count,
    termination and logs, and an ended window passes through a body
    unchanged, so every window's results are bitwise those of its own
    solve. The cuda backend's sampling planes (texel or value planes, by
    gradient mode) are built for all windows at once; window b's view of
    them is its sampling context."""
    steps = [program_steps(p, c) for p in problems]
    kept = {}

    def start():
        planes = None
        if c.backend == "cuda":
            planes = make_cuda_ctx(torch.stack([p.channels for p in problems]),
                                   torch.stack([p.grads for p in problems]),
                                   c.gradient_mode)[1]
        kept["planes"] = planes
        out = _lockstep([start_steps(None if planes is None
                                     else (c.gradient_mode, planes[k]))
                         for k, (start_steps, _) in enumerate(steps)], planes)
        states, begun = zip(*out)
        return states, begun

    def body(states: tuple) -> tuple:
        return tuple(_lockstep([body_steps(st) for st, (_, body_steps)
                                in zip(states, steps)], kept["planes"]))

    return start, body


def _all_ended(states: tuple) -> bool:
    """The host read of a batched solve: every window has ended."""
    return bool(torch.all(torch.stack([st.term for st in states]) != 0))


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
    inputs (copies of the first call's tensors, same strides). `make`
    builds (start, body) from the problem (`program`, or
    `batched_program` from a tuple of B problems)."""

    def __init__(self, spec, leaves: list, make):
        self.inputs = [t.clone() for t in leaves]
        start, body = make(_rebuild(spec, iter(self.inputs)))
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
        self.out_spec = _leaves((self.state, self.begun), [])

    def run(self, leaves: list, max_iterations: int, ended):
        for dst, src in zip(self.inputs, leaves):
            dst.copy_(src)
        self.start.replay()
        runs["starts"] += 1
        _common.add_launches(self.start_launches)

        def step():
            self.body.replay()
            runs["bodies"] += 1
            _common.add_launches(self.body_launches)

        _drive(step, lambda: ended(self.state), max_iterations)
        # Copies: the next call of this key overwrites the static state.
        out = [t.clone() for t in _flat((self.state, self.begun))]
        return _rebuild(self.out_spec, iter(out))


_GRAPHS: OrderedDict = OrderedDict()


def clear_graph_cache() -> None:
    """Drop every captured graph (their device memory returns to the
    caching allocator)."""
    _GRAPHS.clear()


def _program(problem, config: LMConfig):
    """(start, body, the host read of the end) of one solve's problem or
    of a tuple of B problems (`batched_program`)."""
    if isinstance(problem, LMProblem):
        return (*program(problem, config), lambda st: bool(st.term))
    return (*batched_program(problem, config), _all_ended)


def _run_captured(problem, config: LMConfig):
    leaves = []
    key = (config, _leaves(problem, leaves))
    dev = leaves[0].device
    ended = _program(problem, config)[2]
    with torch.cuda.device(dev):
        graphs = _GRAPHS.get(key)
        if graphs is None:
            graphs = _Graphs(key[1], leaves,
                             lambda p: _program(p, config)[:2])
            _GRAPHS[key] = graphs
            while len(_GRAPHS) > GRAPH_CACHE_SIZE:
                _GRAPHS.popitem(last=False)
        _GRAPHS.move_to_end(key)
        return graphs.run(leaves, config.max_iterations, ended)


def _run_eager(problem, config: LMConfig):
    start, body, ended = _program(problem, config)
    state, begun = start()
    runs["starts"] += 1
    cur = [state]

    def step():
        cur[0] = body(cur[0])
        runs["bodies"] += 1

    _drive(step, lambda: ended(cur[0]), config.max_iterations)
    return cur[0], begun


def lm_solve(*args, capture: bool | None = None, **options):
    """Run LM to convergence. Returns (t_wc, x_world, LMStats).

    Arguments: those of `setup` (cam, t_wc, x_world, patch, channels,
    grads, obs_mask, point_valid, frozen, offsets, then the options by
    keyword, `shard_ctx` for a sharded solve). capture:
    None (default) replays the solve's CUDA graphs for tensors on a card
    (where its collectives can be captured: no gloo group) and runs the
    eager host loop on the CPU; False runs the eager loop on a card too
    (the same body, to hold the graphs against it); True requires tensors
    on a card."""
    problem, config = setup(*args, **options)
    run = _runner(problem.t_wc.device, config, capture)
    state, begun = run(problem, config)
    return state.t_wc, state.x_world, _stats(state, begun)


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
    """B solves of one configuration as one program (`batched_program`),
    the twin of the JAX package's vmapped solve. Returns (t_wc (B, W, 4,
    4), x_world (B, N, 3), LMStats with a leading B axis); window b's
    results are bitwise those of `lm_solve` on its request.

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
    problems = tuple(p for p, _ in setups)
    run = _runner(problems[0].t_wc.device, config, capture)
    states, begun = run(problems, config)
    state, begun = stacked(states), stacked(begun)
    return state.t_wc, state.x_world, _stats(state, begun)
