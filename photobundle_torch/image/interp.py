"""Bilinear image sampling with analytic spatial gradients.

Twin of photobundle_tpu/image/interp.py. Three gradient modes:
- 'exact': the true derivative of the bilinear surface
  (`bilinear_with_grad`).
- 'sampled': bilinearly interpolate precomputed central-difference
  gradient images (`bilinear` over stacked planes); the solver default.
- 'bicubic': the Catmull-Rom surface and its exact derivative
  (`bicubic_with_grad`), Ceres' BiCubicInterpolator semantics.

Sampling is a gather on the flattened image. Out-of-bounds coordinates are
clamped and reported through a validity mask, so values stay finite for
finite coordinates. Integer indices are clamped once more after the float
-> int cast: a NaN coordinate then reads pixel 0 (its weights stay NaN and
the caller masks it) instead of indexing out of bounds.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _gather2d(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
              batch: int = 0) -> torch.Tensor:
    """img: (*L, H, W) or (*L, C, H, W), its first `batch` axes L a batch;
    iy/ix: in-bounds integer tensors of one shape (*L, *S), row l of them
    indexing image l. Returns (*L, *S) or (*L, C, *S) values."""
    lead = img.shape[:batch]
    chans = img.shape[batch:-2]
    h, w = img.shape[-2:]
    flat = img.reshape(*lead, -1, h * w)                  # (*L, C or 1, HW)
    lin = (iy * w + ix).reshape(*lead, 1, -1)             # (*L, 1, M)
    values = torch.take_along_dim(flat, lin, dim=-1)      # (*L, C or 1, M)
    return values.reshape(*lead, *chans, *iy.shape[batch:])


def _cell(xc: torch.Tensor, size: int):
    """Lower / upper integer taps of clamped coordinates, as int64."""
    i0 = torch.clamp(torch.floor(xc).long(), 0, size - 1)
    return i0, torch.clamp(i0 + 1, max=size - 1)


def bilinear(img: torch.Tensor, uv: torch.Tensor, eps_margin: float = 0.0,
             batch: int = 0):
    """Bilinear sample. img: (H, W) or (C, H, W); uv: (..., 2) as [x, y].
    With `batch` > 0 the first `batch` axes of img and uv are a batch L:
    img (*L, H, W) or (*L, C, H, W), uv (*L, ..., 2), and row l of uv
    samples image l alone.

    Returns (values, valid):
      values: (*L, ...) for an image without channels, (*L, C, ...) with
      valid:  (*L, ...) bool — True where the full 2x2 support is inside
              the image (and `eps_margin` pixels away from the border).
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

    v00 = _gather2d(img, y0, x0, batch)
    v01 = _gather2d(img, y0, x1, batch)
    v10 = _gather2d(img, y1, x0, batch)
    v11 = _gather2d(img, y1, x1, batch)
    if batch and img.ndim - batch == 3:
        # The channel axis sits after the batch axes: the weights of one
        # sample broadcast over it.
        fx, fy = fx.unsqueeze(batch), fy.unsqueeze(batch)

    w00 = (1.0 - fx) * (1.0 - fy)
    w01 = fx * (1.0 - fy)
    w10 = (1.0 - fx) * fy
    w11 = fx * fy
    values = v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11
    return values, valid


def bilinear_with_grad(img: torch.Tensor, uv: torch.Tensor, batch: int = 0):
    """Bilinear sample + the exact gradient of the bilinear surface.

    Returns (values, grad, valid) where grad[..., 0] = d/dx, grad[..., 1] =
    d/dy (shape (C, ..., 2) for 3D img). `batch` as `bilinear`'s: with
    leading batch axes L, (*L, C, ..., 2).
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

    v00 = _gather2d(img, y0, x0, batch)
    v01 = _gather2d(img, y0, x1, batch)
    v10 = _gather2d(img, y1, x0, batch)
    v11 = _gather2d(img, y1, x1, batch)
    if batch and img.ndim - batch == 3:
        fx, fy = fx.unsqueeze(batch), fy.unsqueeze(batch)

    values = (v00 * (1.0 - fx) * (1.0 - fy)
              + v01 * fx * (1.0 - fy)
              + v10 * (1.0 - fx) * fy
              + v11 * fx * fy)
    gx = (v01 - v00) * (1.0 - fy) + (v11 - v10) * fy
    gy = (v10 - v00) * (1.0 - fx) + (v11 - v01) * fx
    return values, torch.stack([gx, gy], dim=-1), valid


def catmull_rom_weights(t: torch.Tensor):
    """Catmull-Rom weights for taps at offsets (-1, 0, 1, 2), t in [0, 1):
    the cubic Hermite spline Ceres' BiCubicInterpolator evaluates."""
    t2 = t * t
    t3 = t2 * t
    return (0.5 * (-t3 + 2.0 * t2 - t),
            0.5 * (3.0 * t3 - 5.0 * t2 + 2.0),
            0.5 * (-3.0 * t3 + 4.0 * t2 + t),
            0.5 * (t3 - t2))


def catmull_rom_dweights(t: torch.Tensor):
    """d/dt of `catmull_rom_weights` (analytic spatial gradients)."""
    t2 = t * t
    return (0.5 * (-3.0 * t2 + 4.0 * t - 1.0),
            0.5 * (9.0 * t2 - 10.0 * t),
            0.5 * (-9.0 * t2 + 8.0 * t + 1.0),
            0.5 * (3.0 * t2 - 2.0 * t))


def bicubic_with_grad(img: torch.Tensor, uv: torch.Tensor, batch: int = 0):
    """Catmull-Rom bicubic sample + analytic surface gradient.

    img: (H, W) or (C, H, W); uv (..., 2) as [x, y]; `batch` leading batch
    axes as `bilinear`'s. Returns (values, grad (..., 2), valid) like
    `bilinear_with_grad`. `valid` is True where
    the full 4x4 support is interior (1 <= x <= W - 3); out-of-range
    coordinates are clamped (finite values, masked downstream). Rows are
    interpolated first (value and d/dx), then combined over columns, in
    the JAX package's tap order."""
    h, w = img.shape[-2], img.shape[-1]
    x = uv[..., 0]
    y = uv[..., 1]
    valid = (x >= 1) & (x <= w - 3) & (y >= 1) & (y <= h - 3)
    # The upper clamp is formed in f32, as (W - 3) - 1e-5 is there.
    xc = torch.clamp(x, 1.0, float(np.float32(w - 3) - np.float32(1e-5)))
    yc = torch.clamp(y, 1.0, float(np.float32(h - 3) - np.float32(1e-5)))
    x0 = torch.floor(xc).long()
    y0 = torch.floor(yc).long()
    tx = xc - x0.to(img.dtype)
    ty = yc - y0.to(img.dtype)
    if batch and img.ndim - batch == 3:
        tx, ty = tx.unsqueeze(batch), ty.unsqueeze(batch)
    wx, dwx = catmull_rom_weights(tx), catmull_rom_dweights(tx)
    wy, dwy = catmull_rom_weights(ty), catmull_rom_dweights(ty)

    rows, drows = [], []
    for j in range(4):
        yj = torch.clamp(y0 + (j - 1), 0, h - 1)
        taps = [_gather2d(img, yj, torch.clamp(x0 + (i - 1), 0, w - 1),
                          batch) for i in range(4)]
        rows.append(sum(a * p for a, p in zip(wx, taps)))
        drows.append(sum(d * p for d, p in zip(dwx, taps)))
    values = sum(a * r for a, r in zip(wy, rows))
    gx = sum(a * r for a, r in zip(wy, drows))
    gy = sum(d * r for d, r in zip(dwy, rows))
    return values, torch.stack([gx, gy], dim=-1), valid


def image_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients (gx, gy), replicated borders.
    img: (..., H, W)."""
    left = torch.cat([img[..., :, :1], img[..., :, :-1]], dim=-1)
    right = torch.cat([img[..., :, 1:], img[..., :, -1:]], dim=-1)
    up = torch.cat([img[..., :1, :], img[..., :-1, :]], dim=-2)
    down = torch.cat([img[..., 1:, :], img[..., -1:, :]], dim=-2)
    return 0.5 * (right - left), 0.5 * (down - up)
