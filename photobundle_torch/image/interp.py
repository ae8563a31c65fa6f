"""Bilinear image sampling with analytic spatial gradients.

Twin of photobundle_tpu/image/interp.py (bicubic sampling is not ported
yet). Two gradient modes:
- 'exact': the true derivative of the bilinear surface
  (`bilinear_with_grad`).
- 'sampled': bilinearly interpolate precomputed central-difference
  gradient images (`bilinear` over stacked planes); the solver default.

Sampling is a gather on the flattened image. Out-of-bounds coordinates are
clamped and reported through a validity mask, so values stay finite for
finite coordinates. Integer indices are clamped once more after the float
-> int cast: a NaN coordinate then reads pixel 0 (its weights stay NaN and
the caller masks it) instead of indexing out of bounds.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _gather2d(img: torch.Tensor, iy: torch.Tensor,
              ix: torch.Tensor) -> torch.Tensor:
    """img: (H, W) or (C, H, W); iy/ix: in-bounds integer tensors of one
    shape S. Returns (S,) or (C,) + S values."""
    w = img.shape[-1]
    lin = iy * w + ix
    if img.ndim == 2:
        return img.reshape(-1)[lin]
    flat = img.reshape(img.shape[0], -1)
    return flat[:, lin.reshape(-1)].reshape(img.shape[0], *iy.shape)


def _cell(xc: torch.Tensor, size: int):
    """Lower / upper integer taps of clamped coordinates, as int64."""
    i0 = torch.clamp(torch.floor(xc).long(), 0, size - 1)
    return i0, torch.clamp(i0 + 1, max=size - 1)


def bilinear(img: torch.Tensor, uv: torch.Tensor, eps_margin: float = 0.0):
    """Bilinear sample. img: (H, W) or (C, H, W); uv: (..., 2) as [x, y].

    Returns (values, valid):
      values: (...,) for 2D img, (C, ...) for 3D img
      valid:  (...,) bool — True where the full 2x2 support is inside the
              image (and `eps_margin` pixels away from the border).
    """
    h, w = img.shape[-2], img.shape[-1]
    x = uv[..., 0]
    y = uv[..., 1]
    valid = ((x >= eps_margin) & (x <= w - 1 - eps_margin)
             & (y >= eps_margin) & (y <= h - 1 - eps_margin))
    xc = torch.clamp(x, 0.0, w - 1.000001)
    yc = torch.clamp(y, 0.0, h - 1.000001)
    x0, x1 = _cell(xc, w)
    y0, y1 = _cell(yc, h)
    fx = xc - x0.to(img.dtype)
    fy = yc - y0.to(img.dtype)

    v00 = _gather2d(img, y0, x0)
    v01 = _gather2d(img, y0, x1)
    v10 = _gather2d(img, y1, x0)
    v11 = _gather2d(img, y1, x1)

    w00 = (1.0 - fx) * (1.0 - fy)
    w01 = fx * (1.0 - fy)
    w10 = (1.0 - fx) * fy
    w11 = fx * fy
    values = v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11
    return values, valid


def bilinear_with_grad(img: torch.Tensor, uv: torch.Tensor):
    """Bilinear sample + the exact gradient of the bilinear surface.

    Returns (values, grad, valid) where grad[..., 0] = d/dx, grad[..., 1] =
    d/dy (shape (C, ..., 2) for 3D img).
    """
    h, w = img.shape[-2], img.shape[-1]
    x = uv[..., 0]
    y = uv[..., 1]
    valid = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    xc = torch.clamp(x, 0.0, w - 1.000001)
    yc = torch.clamp(y, 0.0, h - 1.000001)
    x0, x1 = _cell(xc, w)
    y0, y1 = _cell(yc, h)
    fx = xc - x0.to(img.dtype)
    fy = yc - y0.to(img.dtype)

    v00 = _gather2d(img, y0, x0)
    v01 = _gather2d(img, y0, x1)
    v10 = _gather2d(img, y1, x0)
    v11 = _gather2d(img, y1, x1)

    values = (v00 * (1.0 - fx) * (1.0 - fy)
              + v01 * fx * (1.0 - fy)
              + v10 * (1.0 - fx) * fy
              + v11 * fx * fy)
    gx = (v01 - v00) * (1.0 - fy) + (v11 - v10) * fy
    gy = (v10 - v00) * (1.0 - fx) + (v11 - v01) * fx
    return values, torch.stack([gx, gy], dim=-1), valid


def image_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients (gx, gy), replicated borders.
    img: (..., H, W)."""
    left = torch.cat([img[..., :, :1], img[..., :, :-1]], dim=-1)
    right = torch.cat([img[..., :, 1:], img[..., :, -1:]], dim=-1)
    up = torch.cat([img[..., :1, :], img[..., :-1, :]], dim=-2)
    down = torch.cat([img[..., 1:, :], img[..., -1:, :]], dim=-2)
    return 0.5 * (right - left), 0.5 * (down - up)
