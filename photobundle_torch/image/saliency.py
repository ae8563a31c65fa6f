"""Saliency maps and non-maximum suppression for point selection.

Twin of photobundle_tpu/image/saliency.py. The JAX package's
`lax.reduce_window` max becomes `max_pool2d` with 'SAME' padding (its
implicit padding is -inf, the reduce_window's init value).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import interp


def gradient_magnitude(img: torch.Tensor) -> torch.Tensor:
    """|grad I| saliency. img: (..., H, W)."""
    gx, gy = interp.image_gradients(img)
    return torch.abs(gx) + torch.abs(gy)


def channel_saliency(channels: torch.Tensor) -> torch.Tensor:
    """Descriptor-frame saliency = sum of per-channel gradient magnitudes.
    channels: (C, H, W) -> (H, W)."""
    return torch.sum(gradient_magnitude(channels), dim=0)


def window_max(s: torch.Tensor, radius: int) -> torch.Tensor:
    """Max over the (2r+1)^2 window centred on each pixel ('SAME' size,
    out-of-image cells ignored). s: (..., H, W) float; the leading axes
    go to the pool's batch axis."""
    k = 2 * radius + 1
    h, w = s.shape[-2:]
    pooled = F.max_pool2d(s.reshape(-1, 1, h, w), k, stride=1,
                          padding=radius)
    return pooled.reshape(s.shape)


def non_max_suppression(s: torch.Tensor, radius: int,
                        threshold: float) -> torch.Tensor:
    """Boolean map of local maxima of s within a (2r+1)^2 window that
    also reach `threshold`. s: (..., H, W)."""
    return (s >= window_max(s, radius)) & (s >= threshold)
