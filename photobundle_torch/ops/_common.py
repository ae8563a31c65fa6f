"""What the patch kernels' wrappers share: the patch radii and
normalization modes the kernels are instantiated for, the launch counters,
and the plain statistics epilogue (the twin of csrc/patch_epilogue.cuh)."""

from __future__ import annotations

import torch

from ..image.patches import AFFINE_NORM_EPS

RADII = (1, 2, 3, 4)      # patch radii the kernels are instantiated for
NORMS = ("off", "mean", "affine")   # kernel codes 0, 1, 2


def norm_code(norm: str) -> int:
    """The kernels' integer code of a normalization mode."""
    if norm not in NORMS:
        raise ValueError(f"unknown patch normalization '{norm}' (want one "
                         f"of {NORMS})")
    return NORMS.index(norm)


def reset_launches(wrapper) -> None:
    """Zero a kernel wrapper's `launches`: its kernel launches by
    normalization mode, {norm: count}."""
    wrapper.launches = dict.fromkeys(NORMS, 0)


def count_launch(wrapper, norm: str) -> None:
    wrapper.launches[norm] += 1


def stats_from_samples(s, gx, gy, patch, valid, norm: str = "mean"):
    """The plain statistics epilogue shared by the kernels' plain versions.

    s, gx, gy (N, W, C, P): samples; patch (N, C, P); valid (N, W).
    Returns (6, W, N) rows [g00, g01, g11, gxr, gyr, rr], summed over
    channels, in the dtype of `s`, exact zeros for invalid observations:

      off:    r = s - d
      mean:   r = (s - d) - mean(s - d), g = g - mean(g)
      affine: c = s - mean(s), G_c = g - mean(g), n = sqrt(Σc² + ε²),
              ŝ = c / n, G = (G_c - ŝ(ŝᵀG_c)) / n, r = ŝ - d
    """
    norm_code(norm)
    inv_p = 1.0 / float(s.shape[-1])

    def centred(a):
        return a - a.sum(-1, keepdim=True) * inv_p

    d = patch[:, None]
    if norm == "affine":
        c, gx, gy = centred(s), centred(gx), centred(gy)
        n = torch.sqrt((c * c).sum(-1, keepdim=True)
                       + AFFINE_NORM_EPS * AFFINE_NORM_EPS)
        sh = c / n
        gx = (gx - sh * (sh * gx).sum(-1, keepdim=True)) / n
        gy = (gy - sh * (sh * gy).sum(-1, keepdim=True)) / n
        r = sh - d
    else:
        r = s - d
        if norm == "mean":
            r, gx, gy = centred(r), centred(gx), centred(gy)
    per_channel = torch.stack(
        [(gx * gx).sum(-1), (gx * gy).sum(-1), (gy * gy).sum(-1),
         (gx * r).sum(-1), (gy * r).sum(-1), (r * r).sum(-1)])  # (6,N,W,C)
    out = per_channel.sum(-1).permute(0, 2, 1)             # (6, W, N)
    return torch.where(valid.T[None], out, 0.0).contiguous()
