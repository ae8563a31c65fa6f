"""New-point selection: saliency NMS + masked admission into the point table.

Twin of photobundle_tpu/core/selection.py, at fixed shapes and without a
device read:

  1. NMS on the quantized saliency map (`max_pool2d`).
  2. Blocks around tracked projections are masked: tracked projections are
     scattered into an occupancy image and dilated by maskBlockRadius.
  3. Candidate score = saliency where all gates pass; the best
     K = maxPointsPerFrame candidates are taken by a stable descending
     sort, so equal scores keep the lower pixel index first, as
     `lax.top_k` does (`torch.topk` promises no tie order).
  4. Admission: candidates are scattered into inactive table slots, free
     slots first in index order (a stable argsort of `active`); overflow
     and invalid candidates go to a spare row that is dropped.

The selected point set equals the JAX package's exactly: a one-point
difference would reshuffle every later window.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..geometry import camera as cam_mod
from ..geometry import se3
from ..image import patches as patches_mod
from ..image import saliency as saliency_mod
from .state import PointTable


class SelectionResult(NamedTuple):
    points: PointTable
    num_added: torch.Tensor       # ()
    num_candidates: torch.Tensor  # () candidates that passed all gates


def _tracked_occupancy(shape, uv: torch.Tensor, tracked: torch.Tensor,
                       radius: int) -> torch.Tensor:
    """(H, W) bool map, True within `radius` of any tracked projection."""
    h, w = shape
    ix = torch.clamp(torch.round(uv[:, 0]).long(), 0, w - 1)
    iy = torch.clamp(torch.round(uv[:, 1]).long(), 0, h - 1)
    # Untracked points write to a spare cell past the image, then dropped.
    lin = torch.where(tracked, iy * w + ix, h * w)
    occ = torch.zeros((h * w + 1,), dtype=torch.float32, device=uv.device)
    occ[lin] = 1.0
    occ = occ[:h * w].reshape(h, w)
    if radius > 0:
        occ = saliency_mod.window_max(occ, radius)
    return occ > 0


def _window_min_max(depth, depth_ok, radius: int):
    """Min and max of the valid depths in each (2r+1)^2 window ('SAME')."""
    k = 2 * radius + 1
    lo = torch.where(depth_ok, depth, torch.inf)
    hi = torch.where(depth_ok, depth, -torch.inf)
    both = torch.stack([-lo, hi])[:, None]                   # (2, 1, H, W)
    mx = F.max_pool2d(both, k, stride=1, padding=radius)[:, 0]
    return -mx[0], mx[1]


def _scatter_drop(arr: torch.Tensor, dest: torch.Tensor, values):
    """arr with rows `dest` set to `values`; a row index == len(arr) is
    dropped (the JAX package's scatter mode='drop')."""
    ext = torch.cat([arr, arr[:1]])
    ext[dest] = values
    return ext[:arr.shape[0]]


def select_new_points(
    points: PointTable,
    cam,
    t_wc: torch.Tensor,          # (4, 4) pose of the new frame
    channels: torch.Tensor,      # (C, H, W) descriptor channels of the frame
    saliency_map: torch.Tensor,  # (H, W)
    depth: torch.Tensor,         # (H, W) metric depth
    depth_ok: torch.Tensor,      # (H, W)
    tracked_uv: torch.Tensor,    # (N, 2) projections of tracked points
    tracked: torch.Tensor,       # (N,)
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
    h, w = saliency_map.shape
    n = points.capacity
    dev = saliency_map.device

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
    score = torch.where(gate, saliency_map, -torch.inf).reshape(-1)

    top_scores, top_idx = torch.sort(score, descending=True, stable=True)
    top_scores, top_idx = top_scores[:max_new], top_idx[:max_new]   # (K,)
    cand_ok = torch.isfinite(top_scores)
    uv = torch.stack([(top_idx % w).to(torch.float32),
                      (top_idx // w).to(torch.float32)], dim=-1)     # (K, 2)

    z = depth.reshape(-1)[top_idx]
    x_world = se3.transform_points(t_wc, cam_mod.backproject(cam, uv, z))

    patch, patch_ok = patches_mod.extract_patches(channels, uv, offsets)
    patch = patches_mod.normalize_patches(patch, normalize)
    cand_ok = cand_ok & patch_ok

    # Admission: free slots first, in index order.
    free_slots = torch.argsort(points.active.to(torch.uint8), stable=True)
    num_free = n - points.num_active()
    k_idx = torch.arange(max_new, device=dev)
    write_ok = cand_ok & (k_idx < num_free)
    dest = torch.where(write_ok, free_slots[torch.clamp(k_idx, max=n - 1)],
                       n)

    obs_row = torch.zeros(points.obs.shape[1], dtype=torch.bool, device=dev)
    obs_row[slot] = True
    new_points = PointTable(
        x_world=_scatter_drop(points.x_world, dest, x_world),
        patch=_scatter_drop(points.patch, dest, patch),
        ref_frame=_scatter_drop(points.ref_frame, dest, frame_id),
        last_seen=_scatter_drop(points.last_seen, dest,
                                frame_id if age_id is None else age_id),
        active=_scatter_drop(points.active, dest, True),
        obs=_scatter_drop(points.obs, dest, obs_row),
        inv_depth_seed=_scatter_drop(points.inv_depth_seed, dest,
                                     1.0 / torch.clamp(z, min=1e-6)),
    )
    return SelectionResult(
        points=new_points,
        num_added=torch.sum(write_ok, dtype=torch.int32),
        num_candidates=torch.sum(cand_ok, dtype=torch.int32),
    )
