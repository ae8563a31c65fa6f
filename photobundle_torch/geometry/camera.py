"""Pinhole camera model: calibration, projection, and analytic Jacobians.

Twin of photobundle_tpu/geometry/camera.py. All functions broadcast over
leading batch dims and are float32 by default.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Camera(NamedTuple):
    """Pinhole intrinsics + stereo baseline (meters), each a 0-d tensor
    (f32 by default) on the device the problem lives on."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    baseline: torch.Tensor  # stereo baseline in meters (0.0 for monocular)

    @staticmethod
    def create(fx, fy, cx, cy, baseline=0.0, dtype=torch.float32,
               device="cpu") -> "Camera":
        return Camera(*(torch.as_tensor(v, dtype=dtype, device=device)
                        for v in (fx, fy, cx, cy, baseline)))

    def matrix(self) -> torch.Tensor:
        """3x3 intrinsic matrix K."""
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack(
            [
                torch.stack([self.fx, z, self.cx], -1),
                torch.stack([z, self.fy, self.cy], -1),
                torch.stack([z, z, o], -1),
            ],
            -2,
        )

    def scaled(self, s: float) -> "Camera":
        """Intrinsics for a pyramid level scaled by factor `s` (<1 = coarser),
        half-pixel-centered: c' = (c + 0.5) * s - 0.5."""
        s = torch.as_tensor(s, dtype=self.fx.dtype, device=self.fx.device)
        return Camera(
            fx=self.fx * s,
            fy=self.fy * s,
            cx=(self.cx + 0.5) * s - 0.5,
            cy=(self.cy + 0.5) * s - 0.5,
            baseline=self.baseline,
        )

    def to(self, device) -> "Camera":
        return Camera(*(v.to(device) for v in self))


def project(cam: Camera, x_cam: torch.Tensor, eps: float = 1e-6):
    """Project camera-frame points (..., 3) -> pixel coords (..., 2) [x, y].

    Returns (uv, valid_z); z is clamped away from zero so values stay
    finite, and invalid projections are masked by the caller.
    """
    x, y, z = x_cam[..., 0], x_cam[..., 1], x_cam[..., 2]
    valid = z > eps
    zc = torch.clamp(z, min=eps)
    u = cam.fx * (x / zc) + cam.cx
    v = cam.fy * (y / zc) + cam.cy
    return torch.stack([u, v], dim=-1), valid


def project_jacobian(cam: Camera, x_cam: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """d(u,v)/d(x_cam): (..., 3) -> (..., 2, 3), analytic.

    [ fx/z    0    -fx x/z^2 ]
    [  0    fy/z   -fy y/z^2 ]
    """
    x, y, z = x_cam[..., 0], x_cam[..., 1], x_cam[..., 2]
    zc = torch.clamp(z, min=eps)
    iz = 1.0 / zc
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    row0 = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], dim=-1)
    row1 = torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def backproject(cam: Camera, uv: torch.Tensor,
                depth: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) + depth (...,) -> camera-frame points (..., 3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def disparity_to_depth(cam: Camera, disparity: torch.Tensor,
                       min_disparity: float = 1e-3):
    """Z = fx * b / d. Invalid (d <= min) -> depth 0 and valid=False."""
    valid = disparity > min_disparity
    d = torch.clamp(disparity, min=min_disparity)
    depth = cam.fx * cam.baseline / d
    return torch.where(valid, depth, 0.0), valid
