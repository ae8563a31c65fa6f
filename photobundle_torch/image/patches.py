"""Patch extraction, brightness normalization, and ZNCC scoring.

Twin of photobundle_tpu/image/patches.py. Patches are fronto-parallel: a
patch at projected center u is sampled at {u + o : o in offsets}, an
integer offset grid of side 2*patchRadius + 1.
"""

from __future__ import annotations

import torch

from . import interp


def patch_offsets(radius: int, dtype=torch.float32,
                  device="cpu") -> torch.Tensor:
    """Integer offset grid, row-major: ((2r+1)^2, 2) as [dx, dy]."""
    r = torch.arange(-radius, radius + 1, dtype=dtype, device=device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1)


def extract_patches(img: torch.Tensor, centers: torch.Tensor,
                    offsets: torch.Tensor):
    """Sample patches at float centers.

    img (*L, C, H, W), centers (*L, ..., 2) as [x, y], offsets (P, 2): the
    leading axes L of img (none for one image) are a batch, and row l of
    centers samples image l.
    Returns (patches (*L, ..., C, P), valid (*L, ...)) — valid iff every
    sample of the patch has full bilinear support inside the image.
    """
    batch = img.ndim - 3
    pts = centers[..., None, :] + offsets                 # (*L, ..., P, 2)
    values, valid = interp.bilinear(img, pts, batch=batch)  # (*L, C, ..., P)
    return torch.movedim(values, batch, -2), torch.all(valid, dim=-1)


def mean_normalize(patches: torch.Tensor) -> torch.Tensor:
    """Remove the per-(channel, patch) mean. patches: (..., C, P)."""
    return patches - torch.mean(patches, dim=-1, keepdim=True)


# Smoothing floor for affine normalization: n = sqrt(sum c^2 + EPS^2)
# keeps the division and its Jacobian finite on textureless patches.
AFFINE_NORM_EPS = 1e-4


def affine_normalize(patches: torch.Tensor,
                     eps: float = AFFINE_NORM_EPS) -> torch.Tensor:
    """ZNCC-style per-(channel, patch) normalization: remove the mean and
    divide by the smoothed centered norm. patches: (..., C, P)."""
    c = patches - torch.mean(patches, dim=-1, keepdim=True)
    n = torch.sqrt(torch.sum(c * c, dim=-1, keepdim=True) + eps * eps)
    return c / n


def norm_mode(normalize) -> str:
    """Canonicalize the normalization knob: bools map to 'mean'/'off';
    strings pass through validated."""
    if normalize is True:
        return "mean"
    if normalize is False or normalize is None:
        return "off"
    if normalize not in ("mean", "affine", "off"):
        raise ValueError(f"unknown patch normalization '{normalize}'")
    return normalize


def normalize_patches(patches: torch.Tensor, mode) -> torch.Tensor:
    """Apply the configured per-patch normalization to stored descriptors."""
    mode = norm_mode(mode)
    if mode == "mean":
        return mean_normalize(patches)
    if mode == "affine":
        return affine_normalize(patches)
    return patches


def zncc(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Zero-mean normalized cross-correlation over the last axis, averaged
    over channels. a, b: (..., C, P) -> (...,). Constant patches score 0."""
    am = a - torch.mean(a, dim=-1, keepdim=True)
    bm = b - torch.mean(b, dim=-1, keepdim=True)
    num = torch.sum(am * bm, dim=-1)
    den = torch.sqrt(torch.sum(am * am, dim=-1) * torch.sum(bm * bm, dim=-1))
    return torch.mean(num / torch.clamp(den, min=eps), dim=-1)
