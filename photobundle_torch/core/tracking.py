"""Visibility tracking: project scene points into a new frame and gate by ZNCC.

Twin of photobundle_tpu/core/tracking.py: the whole point table is
projected, sampled and scored against the new frame in a few batched ops,
with the optional geometric occlusion gate. A batched point table (B, N,
...) is tracked into B new frames (poses (B, 4, 4), channels (B, C, H,
W)) at once, each sequence's points into its own frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import camera as cam_mod
from ..geometry import se3
from ..image import interp
from ..image import patches as patches_mod
from .state import PointTable


class TrackResult(NamedTuple):
    points: PointTable
    uv: torch.Tensor        # (..., N, 2) projections into the new frame
    tracked: torch.Tensor   # (..., N) newly recorded observations
    score: torch.Tensor     # (..., N) ZNCC scores (garbage where invalid)


def track_into_frame(
    points: PointTable,
    cam,
    t_wc_new: torch.Tensor,      # (..., 4, 4) new frame pose (T_wc)
    channels_new: torch.Tensor,  # (..., C, H, W) new frame descriptor channels
    frame_id: int,               # global id of the new frame
    slot: int,                   # window slot index of the new frame
    offsets: torch.Tensor,       # (P, 2)
    *,
    min_score: float,
    max_frame_distance: int,
    age_id: int | None = None,   # ingest-ordinal clock for the age gate;
                                 # defaults to frame_id
    border_margin: float = 1.0,
    depth_new: torch.Tensor | None = None,     # (..., H, W) new frame depth
    depth_ok_new: torch.Tensor | None = None,  # (..., H, W)
    occlusion_threshold: float = 0.0,
) -> TrackResult:
    """Score all table points against the new frame; set obs[..., slot].

    occlusion_threshold > 0 adds a geometric visibility gate: a point whose
    predicted camera depth exceeds the frame's observed stereo depth at its
    projection by more than the relative threshold is behind a nearer
    surface and records no observation."""
    batch = t_wc_new.ndim - 2
    # The batch-exact forms: a batch of poses rounds as each pose alone.
    t_cw = se3.se3_inverse_each(t_wc_new)[..., None, :, :]
    x_cam = se3.transform_points_each(t_cw, points.x_world)      # (..., N, 3)
    uv, in_front = cam_mod.project(cam, x_cam)

    sampled, in_bounds = patches_mod.extract_patches(channels_new, uv, offsets)
    score = patches_mod.zncc(points.patch, sampled)

    age_clock = frame_id if age_id is None else age_id
    age = age_clock - points.last_seen
    h, w = channels_new.shape[-2:]
    u, v = uv[..., 0], uv[..., 1]
    in_img = ((u >= border_margin) & (u <= w - 1 - border_margin)
              & (v >= border_margin) & (v <= h - 1 - border_margin))
    tracked = (points.active & in_front & in_bounds & in_img
               & (score >= min_score) & (age <= max_frame_distance))
    if occlusion_threshold > 0 and depth_new is not None:
        z_obs, z_valid = interp.bilinear(depth_new, uv, batch=batch)
        ok_obs, _ = interp.bilinear(depth_ok_new.to(depth_new.dtype), uv,
                                    batch=batch)
        # Only gate where the frame has confident depth (fully valid 2x2
        # support); the gate never drops visibility for lack of stereo.
        has_depth = z_valid & (ok_obs > 0.999)
        occluded = has_depth & (
            x_cam[..., 2] > z_obs * (1.0 + occlusion_threshold))
        tracked = tracked & ~occluded
    obs = points.obs.clone()
    obs[..., slot] = tracked
    last_seen = torch.where(tracked, age_clock, points.last_seen)
    return TrackResult(points=points._replace(obs=obs, last_seen=last_seen),
                       uv=uv, tracked=tracked, score=score)
