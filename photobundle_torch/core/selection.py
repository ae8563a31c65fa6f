"""New-point selection: saliency NMS + masked admission into the point table.

Twin of photobundle_tpu/core/selection.py, at fixed shapes and without a
device read:

  1. NMS on the quantized saliency map (`max_pool2d`).
  2. Blocks around tracked projections are masked: tracked projections are
     scattered into an occupancy image and dilated by maskBlockRadius.
  3. Candidate score = saliency where all gates pass; the best
     K = maxPointsPerFrame candidates are taken by stable sorts
     (descending), so equal scores keep the lower pixel index first, as
     `lax.top_k` does (`torch.topk` promises no tie order).
  4. Admission: candidates are scattered into inactive table slots, free
     slots first in index order (a stable argsort of `active`); overflow
     and invalid candidates go to a spare row that is dropped.

The selected point set equals the JAX package's exactly: a one-point
difference would reshuffle every later window.

A batched point table (B, N, ...) takes B frames' maps (saliency (B, H,
W), channels (B, C, H, W), poses (B, 4, 4), ...) at once: every step runs
over the batch axis, each row with its own sort, occupancy image and drop
cell, so each sequence selects what it would alone. A single frame is
the batch of one, with its axis added and taken away again.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import camera as cam_mod
from ..geometry import se3
from ..image import patches as patches_mod
from ..image import saliency as saliency_mod
from .state import PointTable


class SelectionResult(NamedTuple):
    points: PointTable
    num_added: torch.Tensor       # (...,)
    num_candidates: torch.Tensor  # (...,) candidates that passed all gates


def _tracked_occupancy(shape, uv: torch.Tensor, tracked: torch.Tensor,
                       radius: int) -> torch.Tensor:
    """(B, H, W) bool maps, True within `radius` of any tracked projection
    of the row. uv (B, N, 2), tracked (B, N)."""
    h, w = shape
    b = uv.shape[0]
    ix = torch.clamp(torch.round(uv[..., 0]).long(), 0, w - 1)
    iy = torch.clamp(torch.round(uv[..., 1]).long(), 0, h - 1)
    # Row b's image is cells b H W ...; untracked points write to a spare
    # cell past the B images, then dropped (a view for every B).
    base = torch.arange(b, device=uv.device)[:, None] * (h * w)
    lin = torch.where(tracked, base + iy * w + ix, b * h * w)
    occ = torch.zeros((b * h * w + 1,), dtype=torch.float32,
                      device=uv.device)
    occ = occ.index_fill_(0, lin.reshape(-1), 1.0)[:b * h * w]
    occ = occ.reshape(b, h, w)
    if radius > 0:
        occ = saliency_mod.window_max(occ, radius)
    return occ > 0


def _window_min_max(depth, depth_ok, radius: int):
    """Min and max of the valid depths in each (2r+1)^2 window ('SAME').
    depth, depth_ok: (..., H, W)."""
    lo = torch.where(depth_ok, depth, torch.inf)
    hi = torch.where(depth_ok, depth, -torch.inf)
    mx = saliency_mod.window_max(torch.stack([-lo, hi]), radius)
    return -mx[0], mx[1]


def _scatter_drop(arr: torch.Tensor, dest: torch.Tensor, values):
    """arr (B, N, ...) with row dest[b, k] of batch row b set to
    values[b, k] (a tensor (B, K, ...) or a Python scalar); an index == N
    is dropped (the JAX package's scatter mode='drop'): it writes to a
    spare row past the B N rows, cut off again. The result is contiguous,
    row b at the offset it has in a stack of B single tables."""
    b, n = arr.shape[:2]
    tail = arr.shape[2:]
    flat = torch.cat([arr.reshape(b * n, *tail), arr[0, :1]])
    base = torch.arange(b, device=dest.device)[:, None] * n
    rows = torch.where(dest < n, base + dest, b * n).reshape(-1)
    if isinstance(values, torch.Tensor):
        flat.index_put_((rows,), values.reshape(-1, *values.shape[2:]))
    else:
        flat.index_fill_(0, rows, values)
    return flat[:b * n].reshape(b, n, *tail)


def select_new_points(
    points: PointTable,
    cam,
    t_wc: torch.Tensor,          # (..., 4, 4) pose of the new frame
    channels: torch.Tensor,      # (..., C, H, W) descriptor channels
    saliency_map: torch.Tensor,  # (..., H, W)
    depth: torch.Tensor,         # (..., H, W) metric depth
    depth_ok: torch.Tensor,      # (..., H, W)
    tracked_uv: torch.Tensor,    # (..., N, 2) projections of tracked points
    tracked: torch.Tensor,       # (..., N)
    frame_id: int,
    slot: int,                   # window slot of the new frame
    offsets: torch.Tensor,       # (P, 2)
    *,
    max_new: int,
    nms_radius: int,
    min_saliency: float,
    mask_radius: int,
    min_depth: float,
    max_depth: float,
    border: int,
    edge_radius: int = 0,
    edge_threshold: float = 0.0,
    normalize=True,              # cfg.resolve_normalization()
    age_id: int | None = None,   # ingest-ordinal clock for last_seen
) -> SelectionResult:
    lead = saliency_map.shape[:-2]
    h, w = saliency_map.shape[-2:]
    n = points.x_world.shape[-2]
    dev = saliency_map.device

    def rows(x, tail: int):
        """x with its leading axes as one batch axis (B, then `tail` axes)."""
        return x.reshape(-1, *x.shape[x.ndim - tail:])

    points = PointTable(*(rows(f, f.ndim - len(lead)) for f in points))
    t_wc, channels = rows(t_wc, 2), rows(channels, 3)
    saliency_map, depth, depth_ok = (rows(saliency_map, 2), rows(depth, 2),
                                     rows(depth_ok, 2))
    tracked_uv, tracked = rows(tracked_uv, 2), rows(tracked, 1)

    # Quantize saliency before any ranking, so that selection is stable
    # under 1-ulp perturbations of the gradient arithmetic.
    saliency_map = torch.floor(saliency_map * 16384.0) * (1.0 / 16384.0)

    nms = saliency_mod.non_max_suppression(saliency_map, nms_radius,
                                           min_saliency)
    occupied = _tracked_occupancy((h, w), tracked_uv, tracked, mask_radius)

    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    in_border = ((xs >= border) & (xs < w - border)
                 & (ys >= border) & (ys < h - border))
    gate = (nms & ~occupied & depth_ok & in_border
            & (depth >= min_depth) & (depth <= max_depth))
    if edge_threshold > 0 and edge_radius > 0:
        # Depth-edge gate: reject candidates whose valid-depth spread under
        # the patch support exceeds a fraction of the centre depth.
        dmin, dmax = _window_min_max(depth, depth_ok, edge_radius)
        gate = gate & ((dmax - dmin)
                       <= edge_threshold * torch.clamp(depth, min=1e-3))
    score = torch.where(gate, saliency_map, -torch.inf).reshape(-1, h * w)

    # Each row's pixels by descending score, ties by pixel index: a stable
    # sort of all rows' scores, then a stable sort of the result by row.
    # Two sorts of one flat axis run the same kernels whatever B (a
    # per-row sort switches to a segmented sort from two rows on).
    order = torch.sort(score.reshape(-1), descending=True, stable=True)[1]
    row = torch.div(order, h * w, rounding_mode="floor").to(torch.int32)
    order = order[torch.sort(row, stable=True)[1]].reshape(-1, h * w)
    top_idx = order[:, :max_new] % (h * w)                       # (B, K)
    top_scores = torch.gather(score, 1, top_idx)
    cand_ok = torch.isfinite(top_scores)
    uv = torch.stack([(top_idx % w).to(torch.float32),
                      (top_idx // w).to(torch.float32)], dim=-1)  # (B, K, 2)

    z = torch.gather(depth.reshape(-1, h * w), 1, top_idx)
    x_world = se3.transform_points_each(t_wc[:, None],
                                        cam_mod.backproject(cam, uv, z))

    patch, patch_ok = patches_mod.extract_patches(channels, uv, offsets)
    patch = patches_mod.normalize_patches(patch, normalize)
    cand_ok = cand_ok & patch_ok

    # Admission: free slots first, in index order.
    free_slots = torch.argsort(points.active.to(torch.uint8), dim=-1,
                               stable=True)
    num_free = n - torch.sum(points.active, dim=-1, dtype=torch.int32)
    k_idx = torch.arange(max_new, device=dev)
    write_ok = cand_ok & (k_idx < num_free[:, None])
    dest = torch.where(write_ok,
                       free_slots[:, torch.clamp(k_idx, max=n - 1)], n)

    obs_row = torch.arange(points.obs.shape[-1], device=dev) == slot
    new_points = PointTable(
        x_world=_scatter_drop(points.x_world, dest, x_world),
        patch=_scatter_drop(points.patch, dest, patch),
        ref_frame=_scatter_drop(points.ref_frame, dest, frame_id),
        last_seen=_scatter_drop(points.last_seen, dest,
                                frame_id if age_id is None else age_id),
        active=_scatter_drop(points.active, dest, True),
        obs=_scatter_drop(points.obs, dest, obs_row.expand(*dest.shape, -1)),
        inv_depth_seed=_scatter_drop(points.inv_depth_seed, dest,
                                     1.0 / torch.clamp(z, min=1e-6)),
    )
    return SelectionResult(
        points=PointTable(*(f.reshape(*lead, *f.shape[1:])
                            for f in new_points)),
        num_added=torch.sum(write_ok, dim=-1,
                            dtype=torch.int32).reshape(lead),
        num_candidates=torch.sum(cand_ok, dim=-1,
                                 dtype=torch.int32).reshape(lead),
    )
