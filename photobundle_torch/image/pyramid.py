"""Gaussian image pyramids and smoothing.

Twin of photobundle_tpu/image/pyramid.py: separable [1 4 6 4 1]/16 blur and
2x2 average-pool decimation. The separable convolution is written as
shifted adds over an edge-padded copy, in the JAX package's tap order,
never as `conv2d` (which cuDNN would run in TF32 on a card).
"""

from __future__ import annotations

from typing import Tuple

import torch

_BINOMIAL5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _edge_pad(img: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Replicate the first / last slice along `dim` r times on each side."""
    n = img.shape[dim]
    first = img.narrow(dim, 0, 1)
    last = img.narrow(dim, n - 1, 1)
    reps = [1] * img.ndim
    reps[dim] = r
    return torch.cat([first.repeat(reps), img, last.repeat(reps)], dim=dim)


def _sep_conv(img: torch.Tensor, k) -> torch.Tensor:
    """Separable 2D correlation with edge padding over the last two axes:
    rows first, then columns. img (..., H, W); k a sequence of f32 taps."""
    r = (len(k) - 1) // 2
    h, w = img.shape[-2], img.shape[-1]
    p = _edge_pad(img, r, img.ndim - 1)
    out = torch.zeros_like(img)
    for i, ki in enumerate(k):
        out = out + ki * p[..., :, i:i + w]
    p = _edge_pad(out, r, img.ndim - 2)
    out2 = torch.zeros_like(img)
    for i, ki in enumerate(k):
        out2 = out2 + ki * p[..., i:i + h, :]
    return out2


def gaussian_blur5(img: torch.Tensor) -> torch.Tensor:
    """5-tap binomial blur (sigma ~= 1.0). img: (..., H, W)."""
    return _sep_conv(img, _BINOMIAL5)


def gaussian_kernel(sigma: float, radius: int | None = None) -> torch.Tensor:
    """Normalized f32 Gaussian taps, truncated at ~3 sigma."""
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    # Rounded as the reference's taps: x times the f32 reciprocal of
    # sigma, exp correctly rounded (from f64), the taps summed in order.
    xs = torch.arange(-radius, radius + 1, dtype=torch.float32)
    inv = torch.reciprocal(torch.tensor(sigma, dtype=torch.float32))
    k = torch.exp((-0.5 * (xs * inv) ** 2).double()).float()
    total = torch.zeros((), dtype=torch.float32)
    for v in k:
        total = total + v
    return k / total


def gaussian_blur_sigma(img: torch.Tensor, sigma: float,
                        radius: int | None = None) -> torch.Tensor:
    """Gaussian blur with explicit sigma, truncated at ~3 sigma."""
    if sigma <= 0:
        return img
    # Taps as Python floats (each an exact f32 value): a scalar multiply
    # launches no host-to-device copy per tap.
    return _sep_conv(img, gaussian_kernel(sigma, radius).tolist())


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average-pool decimation. Odd trailing row/col dropped. (..., H, W)."""
    h2, w2 = img.shape[-2] // 2, img.shape[-1] // 2
    x = img[..., :h2 * 2, :w2 * 2]
    x = x.reshape(*img.shape[:-2], h2, 2, w2, 2)
    return x.mean(dim=(-3, -1))


def build_pyramid(img: torch.Tensor, num_levels: int) -> Tuple[torch.Tensor, ...]:
    """Blur-then-decimate pyramid; level 0 = full resolution. (..., H, W)."""
    levels = [img]
    for _ in range(num_levels - 1):
        levels.append(downsample2(gaussian_blur5(levels[-1])))
    return tuple(levels)
