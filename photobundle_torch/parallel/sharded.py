"""Sharded LM solves and engine solves over torch.distributed meshes.

Twin of photobundle_tpu/parallel/sharded.py, where every shard_map spec
lives; here a JAX `in_specs` / `out_specs` pair becomes an explicit
contiguous copy of the rank's shard on the way in and a gather of the
sharded leaves back to the full tensor on the way out, and a psum or an
all_gather inside the solve becomes a `Collective` hook of the
`core/lm.ShardCtx`. This module is the ONE place that says which leaves
are sharded; the engine (core/engine.py) and the batched engine
(core/batched.py) both wrap their `_optimize` through it.

Layouts:
  - 'points': every (N, ...) point tensor (positions, descriptors, obs
    masks, validity, prior slots and seeds) is split over the points axis
    in contiguous blocks of rows; window images and poses are replicated.
    Per LM iteration the Schur assembly sums (hcc, bc), the point-summed
    parts of (S, rhs), the cost and a few scalars over the axis; the
    reduced 6W x 6W solve is replicated, so the accept/reject branch and
    the pose update are bitwise identical on every rank; point updates
    stay local.
  - ('frames', 'points'): additionally the window's image leaves
    (channels, grads, saliency, depth, depth_ok) are split over 'frames'
    in contiguous slots (a rank holds W / n_frames frames); poses, frame
    ids and the count stay replicated. Per iteration: hpp, bp summed over
    'frames'; hcc, bc summed over 'points' and gathered over 'frames'; the
    point-minor coupling hpc gathered over 'frames' on the frame axis
    (dim 1, after the LM program's batch axis).
  - ('windows', 'points'): the batched engine's B windows split over
    'windows' (B / n_windows each, no cross-talk), points within each
    window over 'points'; results gathered over both.

Shards are handed over as contiguous copies, never views: where a tensor
starts can decide how a reduction over it rounds. Each collective packs
the tensors of one hook call into one flat buffer per dtype; a sum is
element-wise, so packing changes no value, and every rank receives the
same reduced buffer.

NCCL groups are captured with the solve's CUDA graphs; gloo groups run the
eager loop (core/lm.py). Nothing here catches a collective's failure.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..core import lm, state
from .mesh import (FRAMES_AXIS, POINTS_AXIS, WINDOWS_AXIS, axis_rank,
                   axis_size, mesh_of)

IMAGE_LEAVES = ("channels", "grads", "saliency", "depth", "depth_ok")

@dataclass(frozen=True)
class Collective:
    """A ShardCtx hook: the sum ('sum') or the gather along `dim`
    ('gather', ranks in group order) of one or more tensors over `group`.
    The tensors of a call travel as one flat buffer per dtype (bool as
    uint8, for gathers only); the results are fresh contiguous tensors.
    Equal (and hashed) by group identity, kind and dim, so it can join a
    CUDA graph's key."""

    group: object
    kind: str
    dim: int = 0

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def capturable(self) -> bool:
        return dist.get_backend(self.group) == "nccl"

    def __call__(self, *tensors):
        out = self.apply(*tensors)
        return out[0] if len(out) == 1 else tuple(out)

    def apply(self, *tensors) -> list:
        out = [None] * len(tensors)
        dtypes = list(dict.fromkeys(t.dtype for t in tensors))
        for dtype in dtypes:
            idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
            wire = torch.uint8 if dtype == torch.bool else dtype
            if wire != dtype and self.kind == "sum":
                raise TypeError("a sum over ranks takes no bool tensors")
            flat = torch.cat([tensors[i].reshape(-1).to(wire) for i in idx])
            if self.kind == "sum":
                dist.all_reduce(flat, group=self.group)
                rows, lead = flat[None], 1
            elif self.kind == "gather":
                lead = self.size
                rows = flat.new_empty(lead * flat.numel())
                dist.all_gather_into_tensor(rows, flat, group=self.group)
                rows = rows.view(lead, flat.numel())
            else:
                raise ValueError(f"unknown collective {self.kind!r}")
            at = 0
            for i in idx:
                t = tensors[i]
                k = t.numel()
                part = rows[:, at:at + k]
                if self.kind == "sum":
                    part = part.reshape(t.shape)
                else:            # rank-major blocks, then along `dim`
                    part = part.reshape(lead, *t.shape).movedim(
                        0, self.dim).flatten(self.dim, self.dim + 1)
                out[i] = part.to(dtype).clone(
                    memory_format=torch.contiguous_format)
                at += k
        return out


def make_frames_mesh(frames: int = 1, points: int = 1):
    """('frames', 'points') mesh for large-window solves: window images
    split over 'frames', so a rank holds W / n_frames frames."""
    return mesh_of((frames, points), (FRAMES_AXIS, POINTS_AXIS))


def check_point_capacity(n_points: int, mesh, axis: str = POINTS_AXIS
                         ) -> None:
    """Capacity padding rule: the point table must divide the points axis
    (inactive slots are dead weight but keep shapes static). Raises before
    any collective."""
    n_shards = axis_size(mesh, axis)
    if n_points % n_shards != 0:
        raise ValueError(f"point capacity {n_points} not divisible by "
                         f"{axis} axis {n_shards}")


def points_ctx(mesh, axis: str = POINTS_AXIS) -> lm.ShardCtx:
    """The points-only context: sums over the axis' group."""
    return lm.points_only_ctx(Collective(mesh.get_group(axis), "sum"))


def frames_shard_ctx(mesh, w_local: int) -> lm.ShardCtx:
    """The ('frames', 'points') reduction wiring: ONE definition shared by
    the standalone frames-sharded solver and the engine's meshFrames path
    (gather axis, frame_offset formula)."""
    return lm.ShardCtx(
        reduce_points=Collective(mesh.get_group(POINTS_AXIS), "sum"),
        reduce_frames=Collective(mesh.get_group(FRAMES_AXIS), "sum"),
        # The mesh spans the world (parallel/mesh.mesh_of).
        reduce_obs=Collective(dist.group.WORLD, "sum"),
        gather_frames=Collective(mesh.get_group(FRAMES_AXIS), "gather",
                                 dim=1),
        frame_offset=axis_rank(mesh, FRAMES_AXIS) * w_local)


def _block(n: int, rank: int, shards: int) -> slice:
    m = n // shards
    return slice(rank * m, (rank + 1) * m)


def shard_rows(t: torch.Tensor, mesh, axis: str = POINTS_AXIS,
               dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of `t` along `dim` over `axis`, as a
    contiguous copy."""
    sl = _block(t.shape[dim], axis_rank(mesh, axis), axis_size(mesh, axis))
    return t[(slice(None),) * dim + (sl,)].clone()


def _point_rows(points: state.PointTable, mesh) -> state.PointTable:
    return type(points)(*(shard_rows(f, mesh) for f in points))


# ---------------------------------------------------------------------- #
# library-level solvers (the JAX package's, same arguments)
# ---------------------------------------------------------------------- #
class ShardedLMSolver:
    """Points-sharded raw LM solve with the arguments of core.lm.lm_solve:
    the library-level entry for callers that manage their own tensors
    (tools/demo_multiprocess.py, tools/bench_multihost.py). Every rank
    calls it with the full replicated tensors; it solves on the rank's
    point rows and returns (t_wc, x_world (N, 3) gathered, LMStats), the
    same on every rank. The engine goes through wrap_engine_optimize
    instead (same axis, same hook). capture: as lm_solve's."""

    def __init__(self, mesh, cam, offsets, *, n_points: int,
                 huber_delta: float, robust_kind: str = "huber",
                 gradient_mode: str = "sampled", backend: str = "torch",
                 normalize=True, max_iterations: int = 50,
                 initial_lambda: float = 1e-4,
                 function_tolerance: float = 1e-6,
                 parameter_tolerance: float = 1e-8, capture=None):
        if POINTS_AXIS not in mesh.mesh_dim_names:
            raise ValueError(f"mesh must have a '{POINTS_AXIS}' axis")
        check_point_capacity(n_points, mesh)
        self.mesh, self.cam, self.offsets = mesh, cam, offsets
        self.capture = capture
        self.ctx = points_ctx(mesh)
        self._gather = Collective(mesh.get_group(POINTS_AXIS), "gather")
        self.options = dict(
            huber_delta=huber_delta, robust_kind=robust_kind,
            gradient_mode=gradient_mode, backend=backend,
            normalize=normalize, max_iterations=max_iterations,
            initial_lambda=initial_lambda,
            function_tolerance=function_tolerance,
            parameter_tolerance=parameter_tolerance)

    def __call__(self, t_wc, x_world, patch, channels, grads, obs_mask,
                 point_valid, frozen):
        rows = lambda a: shard_rows(a, self.mesh)  # noqa: E731
        t, x, stats = lm.lm_solve(
            self.cam, t_wc, rows(x_world), rows(patch), channels, grads,
            rows(obs_mask), rows(point_valid), frozen, self.offsets,
            shard_ctx=self.ctx, capture=self.capture, **self.options)
        return t, self._gather(x), stats


def make_frames_sharded_solver(mesh, cam, offsets, *, n_points: int,
                               window_size: int, huber_delta: float,
                               robust_kind: str = "huber",
                               gradient_mode: str = "sampled",
                               backend: str = "torch", normalize=True,
                               depth_prior_weight: float = 0.0,
                               motion_prior_weight: float = 0.0,
                               max_iterations: int = 50,
                               initial_lambda: float = 1e-4,
                               function_tolerance: float = 1e-6,
                               parameter_tolerance: float = 1e-8,
                               capture=None):
    """Large-window LM solve over the ('frames', 'points') mesh. Per rank:
    channels / grads of W / n_frames frames, N / n_points points.

    Signature: solver(t_wc (W,4,4), x (N,3), patch, channels (W,...),
    grads, obs (N,W), point_valid (N,), frozen (W,)[, ref_slot (N,),
    inv_depth_seed (N,)]) -> (t_wc, x (N, 3), LMStats), the trailing two
    only when depth_prior_weight > 0; full replicated tensors in and out
    on every rank."""
    check_point_capacity(n_points, mesh)
    n_frames = axis_size(mesh, FRAMES_AXIS)
    if window_size % n_frames != 0:
        raise ValueError(f"window size {window_size} not divisible by "
                         f"frames axis {n_frames}")
    w_local = window_size // n_frames
    ctx = frames_shard_ctx(mesh, w_local)
    gather = Collective(mesh.get_group(POINTS_AXIS), "gather")
    use_prior = depth_prior_weight > 0.0
    options = dict(huber_delta=huber_delta, robust_kind=robust_kind,
                   gradient_mode=gradient_mode, backend=backend,
                   normalize=normalize,
                   motion_prior_weight=motion_prior_weight,
                   max_iterations=max_iterations,
                   initial_lambda=initial_lambda,
                   function_tolerance=function_tolerance,
                   parameter_tolerance=parameter_tolerance)

    def solve(t_wc, x_world, patch, channels, grads, obs_mask, point_valid,
              frozen, ref_slot=None, seed=None):
        rows = lambda a: shard_rows(a, mesh)  # noqa: E731
        frames = lambda a, dim=0: shard_rows(a, mesh, FRAMES_AXIS, dim)  # noqa: E731
        depth_prior = ((rows(ref_slot), rows(seed), depth_prior_weight)
                       if use_prior else None)
        t, x, stats = lm.lm_solve(
            cam, t_wc, rows(x_world), rows(patch), frames(channels),
            frames(grads), frames(rows(obs_mask), 1), rows(point_valid),
            frozen, offsets, depth_prior=depth_prior, shard_ctx=ctx,
            capture=capture, **options)
        return t, gather(x), stats

    return solve


def make_batched_sharded_solver(mesh, cam, offsets, *, n_points: int,
                                huber_delta: float,
                                robust_kind: str = "huber",
                                gradient_mode: str = "sampled",
                                backend: str = "torch",
                                max_iterations: int = 20, capture=None):
    """Batched raw multi-window lm_solve over a ('windows', 'points')
    mesh: inputs gain a leading B axis, B divisible by the 'windows' axis;
    a rank's windows group solves its B / n_windows windows as one
    program (lm.lm_solve_batched), each window's points split over
    'points'. Returns (t_wc (B,W,4,4), x (B,N,3), LMStats with a leading
    B axis), the same on every rank."""
    check_point_capacity(n_points, mesh)
    n_win = axis_size(mesh, WINDOWS_AXIS)
    ctx = points_ctx(mesh)
    gather_points = Collective(mesh.get_group(POINTS_AXIS), "gather")
    gather_windows = Collective(mesh.get_group(WINDOWS_AXIS), "gather")
    options = dict(huber_delta=huber_delta, robust_kind=robust_kind,
                   gradient_mode=gradient_mode, backend=backend,
                   max_iterations=max_iterations, shard_ctx=ctx)

    def solve(t_wc, x_world, patch, channels, grads, obs_mask, point_valid,
              frozen):
        b = t_wc.shape[0]
        if b % n_win != 0:
            raise ValueError(f"batch {b} not divisible by the windows "
                             f"axis {n_win}")
        mine = range(b)[_block(b, axis_rank(mesh, WINDOWS_AXIS), n_win)]
        rows = lambda a: shard_rows(a, mesh)  # noqa: E731
        requests = [((cam, t_wc[k].clone(), rows(x_world[k]),
                      rows(patch[k]), channels[k].clone(), grads[k].clone(),
                      rows(obs_mask[k]), rows(point_valid[k]),
                      frozen[k].clone(), offsets), options) for k in mine]
        t, x, stats = lm.lm_solve_batched(requests, capture=capture)
        x = torch.stack(gather_points.apply(*x.unbind(0)))
        t, x, *stats = gather_windows.apply(t, x, *stats)
        return t, x, lm.LMStats(*stats)

    return solve


# ---------------------------------------------------------------------- #
# engine wiring
# ---------------------------------------------------------------------- #
def wrap_engine_optimize(optimize, mesh, *, axis: str = POINTS_AXIS):
    """Points-shard the engine's `_optimize(window, points, shard_ctx)`:
    window replicated, point-table leaves split on their rows, the solve
    under the points context; returns (window, points, stats,
    point_valid) with x_world and point_valid gathered back, the same on
    every rank."""
    ctx = points_ctx(mesh, axis)
    gather = Collective(mesh.get_group(axis), "gather")

    def run(window, points):
        window, local, stats, valid = optimize(
            window, _point_rows(points, mesh), shard_ctx=ctx)
        x, valid = gather(local.x_world, valid)
        return window, points._replace(x_world=x), stats, valid

    return run


def wrap_engine_optimize_frames(optimize, mesh):
    """Engine solve over the ('frames', 'points') mesh: the window arrives
    as it rests (image leaves of the rank's W_local slots, poses and ids
    replicated), point-table leaves split over 'points', the solve under
    `frames_shard_ctx`; x_world and point_valid gathered back."""
    gather = Collective(mesh.get_group(POINTS_AXIS), "gather")

    def run(window, points):
        ctx = frames_shard_ctx(mesh, window.channels.shape[0])
        window, local, stats, valid = optimize(
            window, _point_rows(points, mesh), shard_ctx=ctx)
        x, valid = gather(local.x_world, valid)
        return window, points._replace(x_world=x), stats, valid

    return run


def wrap_batched_optimize(optimize, mesh):
    """The batched engine's `_optimize(window, points, shard_ctx)` over a
    ('windows', 'points') mesh, on the stacked (B, ...) state: a windows
    group takes its B / n_windows windows, each window's point rows split
    over 'points'; t_wc, x_world, the stats and point_valid of all B
    windows are gathered back on every rank."""
    ctx = points_ctx(mesh)
    gather_points = Collective(mesh.get_group(POINTS_AXIS), "gather")
    gather_windows = Collective(mesh.get_group(WINDOWS_AXIS), "gather")

    def run(window, points):
        mine = lambda a: shard_rows(a, mesh, WINDOWS_AXIS)  # noqa: E731
        local_window = type(window)(*(mine(f) for f in window))
        local_points = type(points)(*(
            shard_rows(mine(f), mesh, POINTS_AXIS, 1) for f in points))
        out_window, out_points, stats, valid = optimize(
            local_window, local_points, shard_ctx=ctx)
        parts = gather_points.apply(*out_points.x_world.unbind(0),
                                    *valid.unbind(0))
        b = valid.shape[0]
        x, valid = torch.stack(parts[:b]), torch.stack(parts[b:])
        t, x, valid, *stats = gather_windows.apply(out_window.t_wc, x, valid,
                                                   *stats)
        return (window._replace(t_wc=t), points._replace(x_world=x),
                lm.LMStats(*stats), valid)

    return run


# ---------------------------------------------------------------------- #
# the frames layout's window ring
# ---------------------------------------------------------------------- #
def frames_window(window: state.Window, mesh) -> state.Window:
    """The resting frames layout of a full window: the rank's contiguous
    W / n_frames slots of each image leaf (copies), the rest replicated."""
    return window._replace(**{
        name: shard_rows(getattr(window, name), mesh, FRAMES_AXIS)
        for name in IMAGE_LEAVES})


def gather_window(window: state.Window, mesh) -> state.Window:
    """The full window from its frames layout (every rank takes part)."""
    leaves = Collective(mesh.get_group(FRAMES_AXIS), "gather").apply(
        *(getattr(window, name) for name in IMAGE_LEAVES))
    return window._replace(**dict(zip(IMAGE_LEAVES, leaves)))


def push_frame_frames(win: state.Window, channels, grads, saliency, t_wc,
                      frame_id: int, depth, depth_ok,
                      points: state.PointTable, count: int, mesh):
    """`state.push_frame` for the frames layout. Every rank computed the
    new frame; the rank owning its slot stores it. When the ring is full
    it slides: each rank's oldest slot moves to its left neighbour (one
    gather of the ranks' oldest slots over 'frames'), the first rank's is
    dropped and the last rank's newest slot takes the new frame. Poses,
    ids, the count and the point table's obs columns slide as
    `state.push_frame` slides them (replicated)."""
    w = win.t_wc.shape[0]
    w_local = win.channels.shape[0]
    rank, n_frames = axis_rank(mesh, FRAMES_AXIS), axis_size(mesh,
                                                             FRAMES_AXIS)
    new = dict(channels=channels, grads=grads, saliency=saliency,
               depth=depth, depth_ok=depth_ok)
    images = {}
    if count >= w:
        heads = Collective(mesh.get_group(FRAMES_AXIS), "gather").apply(
            *(getattr(win, name)[:1] for name in IMAGE_LEAVES))
        for name, head in zip(IMAGE_LEAVES, heads):
            arr = torch.roll(getattr(win, name), -1, dims=0)
            arr[w_local - 1] = head[rank + 1] if rank + 1 < n_frames \
                else new[name]
            images[name] = arr
    else:
        owner, slot = divmod(count, w_local)
        for name in IMAGE_LEAVES:
            arr = getattr(win, name).clone()
            if owner == rank:
                arr[slot] = new[name]
            images[name] = arr
    window, points = state.push_replicated(win, t_wc, frame_id, points,
                                           count)
    return window._replace(**images), points
