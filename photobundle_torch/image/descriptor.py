"""Multi-channel descriptor frames: Intensity / IntensityAndGradient / BitPlanes.

Twin of photobundle_tpu/image/descriptor.py. A descriptor level is

    channels:  (..., C, H, W) float — what residuals sample (C = 1, 3, 8)
    grads:     (..., C, H, W, 2)    — central-difference gradients of each
                                      channel, for gradientMode='sampled'
    saliency:  (..., H, W)          — selection map

Leading axes (`...`) are a batch of images: the batched engine builds B
sequences' levels in one pass, and each is the level of its image alone.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import (
    DESCRIPTOR_BITPLANES,
    DESCRIPTOR_INTENSITY,
    DESCRIPTOR_INTENSITY_AND_GRADIENT,
)
from . import interp, pyramid, saliency


class DescriptorLevel(NamedTuple):
    channels: torch.Tensor   # (..., C, H, W)
    grads: torch.Tensor      # (..., C, H, W, 2): d/dx, d/dy last
    saliency: torch.Tensor   # (..., H, W)


# The 8 census neighbors in raster order (dy, dx), excluding the center —
# the 3x3 ring of the BitPlanes descriptor.
_CENSUS_OFFSETS = (
    (-1, -1), (-1, 0), (-1, 1),
    (0, -1),           (0, 1),
    (1, -1), (1, 0), (1, 1),
)


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift with edge replication so comparisons stay in range.
    img: (..., H, W)."""
    h, w = img.shape[-2:]
    ys = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img.index_select(-2, ys).index_select(-1, xs)


def _bitplanes_channels(img: torch.Tensor, sigma_pre: float,
                        sigma_post: float) -> torch.Tensor:
    """8 smoothed census sign channels: sign(I(x) - I(x + d)) in {-1, +1},
    Gaussian-smoothed — a locally contrast-invariant descriptor."""
    base = pyramid.gaussian_blur_sigma(img, sigma_pre)
    planes = [torch.where(base > _shift2d(base, dy, dx), 1.0, -1.0)
              .to(img.dtype) for dy, dx in _CENSUS_OFFSETS]
    return pyramid.gaussian_blur_sigma(torch.stack(planes, dim=-3),
                                       sigma_post)


def make_channels(img: torch.Tensor, descriptor: str,
                  sigma_pre: float = 0.5,
                  sigma_post: float = 0.75) -> torch.Tensor:
    """img: (..., H, W) -> (..., C, H, W) descriptor channels."""
    if descriptor == DESCRIPTOR_INTENSITY:
        return img[..., None, :, :]
    if descriptor == DESCRIPTOR_INTENSITY_AND_GRADIENT:
        gx, gy = interp.image_gradients(img)
        return torch.stack([img, gx, gy], dim=-3)
    if descriptor == DESCRIPTOR_BITPLANES:
        return _bitplanes_channels(img, sigma_pre, sigma_post)
    raise ValueError(f"unknown descriptor '{descriptor}'")


def build_descriptor_level(img: torch.Tensor, descriptor: str,
                           sigma_pre: float = 0.5, sigma_post: float = 0.75,
                           gradient_sigma: float = 0.0) -> DescriptorLevel:
    """One pyramid level -> DescriptorLevel. img: (..., H, W).

    gradient_sigma > 0 takes the gradient planes of a Gaussian-blurred copy
    of the channels (gradient-of-Gaussian); the value channels stay sharp.
    Selection saliency always comes from the intensity image, whatever the
    descriptor (as in the reference)."""
    ch = make_channels(img, descriptor, sigma_pre, sigma_post)
    gsrc = (pyramid.gaussian_blur_sigma(ch, gradient_sigma)
            if gradient_sigma > 0 else ch)
    gx, gy = interp.image_gradients(gsrc)
    return DescriptorLevel(channels=ch, grads=torch.stack([gx, gy], dim=-1),
                           saliency=saliency.gradient_magnitude(img))
