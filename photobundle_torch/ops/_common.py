"""What the patch kernels' wrappers share: the patch radii and
normalization modes the kernels are instantiated for, the launch counters,
the input checks, and the plain statistics epilogue (the twin of
csrc/patch_epilogue.cuh)."""

from __future__ import annotations

import torch

from ..image.patches import AFFINE_NORM_EPS

# Patch radii the kernels take, the radii of the reference's accelerator
# path (K8 runs at R = 2 alone, ops/patch_ablate.RADIUS):
#   K1 (every normalization, K4's affine mode included), its sorted entry
#   and the sample store (K4's row store, K6): FIXED_RADII, where the JAX
#   package's fixed-grid panel has a positive lane stride
#   (photobundle_tpu/ops/patch_warp.py `lane_stride`: a (2R+2)-px window
#   of three lanes per pixel in a 128-lane panel);
#   K2: 1..BICUBIC_MAX, where its value panel has one (`value_lane_stride`:
#   a (2R+4)-px window in 128 lanes);
#   K3 (K5): WARPED_RADII, the reference's warped-grid limit;
#   K7: 1..STATS_MAX, where the JAX patch_stats' panel stride is positive
#   (photobundle_tpu/ops/patch_stats.py `panel_stride`: a (2R+2)-px window
#   in a 128-lane panel).
# These kernels have compile-time instances for 1..9 (pb::kMaxSolveRadius
# in csrc/patch_epilogue.cuh) and one runtime-radius instance above.
FIXED_RADII = tuple(range(1, 20))
BICUBIC_MAX = 61
STATS_MAX = 62
WARPED_RADII = tuple(range(1, 10))
NORMS = ("off", "mean", "affine")   # kernel codes 0, 1, 2
# Channels one launch of K1 (with its sorted entry) or K2 takes: a block
# of their C > 1 designs holds every channel of its observations
# (kMaxChannels in csrc/patch_warp.cu and csrc/patch_bicubic.cu).
MAX_CHANNELS = 32


def norm_code(norm: str) -> int:
    """The kernels' integer code of a normalization mode."""
    if norm not in NORMS:
        raise ValueError(f"unknown patch normalization '{norm}' (want one "
                         f"of {NORMS})")
    return NORMS.index(norm)


_WRAPPERS = []     # every wrapper with a launch counter


def reset_launches(wrapper, modes=None) -> None:
    """Zero a kernel wrapper's `launches`: its kernel launches by mode,
    {mode: count}. The modes are the normalization modes unless `modes`
    names others; a later call without `modes` keeps the wrapper's own."""
    if modes is None:
        modes = getattr(wrapper, "launches", None) or NORMS
    wrapper.launches = dict.fromkeys(modes, 0)
    if wrapper not in _WRAPPERS:
        _WRAPPERS.append(wrapper)


def count_launch(wrapper, mode: str) -> None:
    wrapper.launches[mode] += 1


def launch_counts() -> dict:
    """{(wrapper, mode): launches} of every counted wrapper."""
    return {(w, m): n for w in _WRAPPERS for m, n in w.launches.items()}


def set_launch_counts(counts: dict) -> None:
    """Put back counts taken by `launch_counts`."""
    for (w, m), n in counts.items():
        w.launches[m] = n


def add_launches(counts: dict) -> None:
    """Add {(wrapper, mode): launches}: a CUDA graph replay's, the
    launches it captured (core/lm.py)."""
    for (w, m), n in counts.items():
        w.launches[m] += n


def check_tensors(what: str, device, want: dict) -> None:
    """Raise ValueError unless every tensor of `want`, {name: (tensor,
    dtype, shape)}, lies on `device` with that dtype and shape and is
    contiguous: what a kernel's wrapper checks before a launch."""
    for name, (t, dtype, shape) in want.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} on {t.device}, planes on "
                             f"{device}")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} must be {dtype} "
                             f"{tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def check_channels(what: str, c: int) -> None:
    """Raise ValueError unless 1 <= c <= MAX_CHANNELS."""
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"{what} takes 1..{MAX_CHANNELS} channels, not {c}")


# Windows one launch of a kernel's batch axis takes: the grid's y extent.
MAX_BATCH = 65535


def check_batch(what: str, lead: tuple) -> None:
    """Raise ValueError unless `lead`, the leading batch axis of a
    launch's tensors, is () (one window) or (B,) with 1 <= B <=
    MAX_BATCH (csrc/patch_batch.cuh: window b is the grid's block row
    b)."""
    if len(lead) > 1 or (lead and not 1 <= lead[0] <= MAX_BATCH):
        raise ValueError(f"{what} takes one window or a batch axis of "
                         f"1..{MAX_BATCH} windows, not leading shape "
                         f"{lead}")


def stats_from_samples(s, gx, gy, patch, valid, norm: str = "mean"):
    """The plain statistics epilogue shared by the kernels' plain versions.

    s, gx, gy (N, W, C, P): samples; patch (N, C, P), or (N, W, C, P)
    one per observation; valid (N, W).
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

    d = patch[:, None] if patch.dim() == 3 else patch
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
