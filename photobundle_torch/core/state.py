"""Static-shape BA state: fixed-capacity point table + window ring buffer.

Twin of photobundle_tpu/core/state.py. Every "dynamic" behaviour
(selection, culling, window slide) is a masked update at a fixed shape, so
the engine's state is a tuple of tensors that stays on the device.
Layout (N = cfg.maxNumPoints, W = cfg.slidingWindowSize, C = channels,
P = patch pixels):

    PointTable
        x_world   (N, 3)    point positions, world frame
        patch     (N, C, P) normalized reference descriptor patch
        ref_frame (N,)      global frame id of the reference frame
        last_seen (N,)      ingest ordinal of the newest observation
        active    (N,)      slot occupancy
        obs       (N, W)    visibility against window *slots*
        inv_depth_seed (N,) 1/z at creation (stereo prior anchor)

    Window (slot 0 = oldest, slot W-1 = newest)
        channels  (W, C, H, W_img)   descriptor channels at refinement level
        grads     (W, C, H, W_img, 2)
        saliency  (W, H, W_img)
        t_wc      (W, 4, 4)          world-from-camera poses
        t_vo      (W, 4, 4)          raw VO input poses (never refined)
        frame_ids (W,)               global frame ids (-1 = empty slot)
        depth     (W, H, W_img)      metric depth (for new-point init)
        depth_ok  (W, H, W_img)      depth validity
        count     ()                 number of occupied slots

The JAX package decides with `lax.cond` on the device-side count whether
the ring slides; here the caller passes its host mirror of that count, so
no step reads the device.

The batched engine (core/batched.py) stacks B such states along a leading
axis (x_world (B, N, 3), channels (B, W, C, H, W_img), count (B,), ...);
`push_frame`, `push_replicated` and `cull_points` take either, and do to
each sequence's slice what they do to a single state. The sequences fill
in lockstep, so one host count serves them all.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import PBAConfig


class PointTable(NamedTuple):
    x_world: torch.Tensor
    patch: torch.Tensor
    ref_frame: torch.Tensor
    last_seen: torch.Tensor
    active: torch.Tensor
    obs: torch.Tensor
    inv_depth_seed: torch.Tensor

    def num_active(self) -> torch.Tensor:
        return torch.sum(self.active, dtype=torch.int32)


class Window(NamedTuple):
    channels: torch.Tensor
    grads: torch.Tensor
    saliency: torch.Tensor
    t_wc: torch.Tensor
    t_vo: torch.Tensor
    frame_ids: torch.Tensor
    depth: torch.Tensor
    depth_ok: torch.Tensor
    count: torch.Tensor

    @property
    def size(self) -> int:
        return self.channels.shape[0]


def init_point_table(cfg: PBAConfig, device="cpu",
                     dtype=torch.float32) -> PointTable:
    n = cfg.maxNumPoints
    c = cfg.num_channels
    p = cfg.patch_size * cfg.patch_size
    w = cfg.slidingWindowSize
    return PointTable(
        x_world=torch.zeros((n, 3), dtype=dtype, device=device),
        patch=torch.zeros((n, c, p), dtype=dtype, device=device),
        ref_frame=torch.full((n,), -1, dtype=torch.int32, device=device),
        last_seen=torch.full((n,), -1, dtype=torch.int32, device=device),
        active=torch.zeros((n,), dtype=torch.bool, device=device),
        obs=torch.zeros((n, w), dtype=torch.bool, device=device),
        inv_depth_seed=torch.ones((n,), dtype=dtype, device=device),
    )


def init_window(cfg: PBAConfig, image_shape, device="cpu",
                dtype=torch.float32) -> Window:
    h, wimg = image_shape
    w = cfg.slidingWindowSize
    c = cfg.num_channels
    eye = torch.eye(4, dtype=dtype, device=device).expand(w, 4, 4)
    return Window(
        channels=torch.zeros((w, c, h, wimg), dtype=dtype, device=device),
        grads=torch.zeros((w, c, h, wimg, 2), dtype=dtype, device=device),
        saliency=torch.zeros((w, h, wimg), dtype=dtype, device=device),
        t_wc=eye.clone(),
        t_vo=eye.clone(),
        frame_ids=torch.full((w,), -1, dtype=torch.int32, device=device),
        depth=torch.zeros((w, h, wimg), dtype=dtype, device=device),
        depth_ok=torch.zeros((w, h, wimg), dtype=torch.bool, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def _push_slot(arr, value, count: int, w: int, dim: int = 0):
    """`arr` with `value` in the slot a push fills: slot `count` while the
    ring fills, else the newest slot after dropping the oldest. `dim` is
    the slot axis (1 under a batch axis; `value` then has the batch axis
    and no slot axis)."""
    full = count >= w
    arr = torch.roll(arr, -1, dims=dim) if full else arr.clone()
    slot = arr.select(dim, w - 1 if full else min(count, w - 1))
    # A Python scalar is filled in: assigned through an index into a 0-d
    # slot, it is copied from the host, and that waits for the stream.
    if isinstance(value, torch.Tensor):
        slot.copy_(value)
    else:
        slot.fill_(value)
    return arr


def push_replicated(win: Window, t_wc, frame_id: int, points: PointTable,
                    count: int):
    """The push of the leaves every rank of a frames-sharded mesh holds
    whole (poses, frame ids, the count, the point table's obs columns);
    the image leaves are left as they are (`push_frame` fills them, or
    parallel/sharded.push_frame_frames for the frames layout). Under a
    batch axis t_wc is (B, 4, 4), one pose per sequence."""
    dim = win.t_wc.ndim - 3                  # the slot axis
    w = win.t_wc.shape[dim]
    new_win = win._replace(
        t_wc=_push_slot(win.t_wc, t_wc, count, w, dim),
        # The incoming pose is the caller's raw VO estimate; t_wc gets
        # refined by window solves while t_vo keeps the original.
        t_vo=_push_slot(win.t_vo, t_wc, count, w, dim),
        frame_ids=_push_slot(win.frame_ids, frame_id, count, w, dim),
        count=torch.clamp(win.count + 1, max=w),
    )
    obs = points.obs
    if count >= w:
        obs = torch.roll(obs, -1, dims=-1)
        obs[..., w - 1] = False
    return new_win, points._replace(obs=obs)


def push_frame(win: Window, channels, grads, saliency, t_wc, frame_id: int,
               depth, depth_ok, points: PointTable, count: int):
    """Append a frame to the newest slot; if the ring is full, slide (drop
    the oldest). `count` is the host's mirror of `win.count`.

    Sliding shifts slot indices down by one, so the point table's per-slot
    observation mask rolls with it (slot 0's column is discarded and the new
    slot W-1 column cleared). Returns new tensors; the inputs are not
    modified. A batched state takes the B frames' leaves stacked."""
    dim = win.t_wc.ndim - 3
    w = win.t_wc.shape[dim]
    new_win, points = push_replicated(win, t_wc, frame_id, points, count)
    new_win = new_win._replace(
        channels=_push_slot(win.channels, channels, count, w, dim),
        grads=_push_slot(win.grads, grads, count, w, dim),
        saliency=_push_slot(win.saliency, saliency, count, w, dim),
        depth=_push_slot(win.depth, depth, count, w, dim),
        depth_ok=_push_slot(win.depth_ok, depth_ok, count, w, dim),
    )
    return new_win, points


def cull_points(points: PointTable, oldest_frame_id: torch.Tensor,
                min_obs: int = 1) -> PointTable:
    """Deactivate points whose reference frame has left the window, or that
    have no remaining window observations. oldest_frame_id: () or, under
    a batch axis, (B,), one per sequence."""
    n_obs = torch.sum(points.obs, dim=-1)
    keep = (points.active & (points.ref_frame >= oldest_frame_id[..., None])
            & (n_obs >= min_obs))
    return points._replace(active=keep, obs=points.obs & keep[..., None])
