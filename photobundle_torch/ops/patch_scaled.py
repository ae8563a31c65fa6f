"""Warped-grid patch sampling + Gauss-Newton statistics (kernels K3, K5).

Twin of photobundle_tpu/ops/patch_warp.py's warped-grid kernels:
`_warp_kernel_scaled_packed` (K3, launched by
`warp_patches_grouped_scaled`; cfg.patchWarp='scale' with mean or no
normalization) and `_gather_kernel_scaled` (K5, launched by
`warp_patches_scaled`, whose raw windows the JAX package resamples and
normalizes in XLA; patchWarp='scale' with patchNormalization='affine').
The port runs both as one kernel with K1's contract (ops/patch_warp.py)
and K1's float4 texel planes (`patch_warp.build_planes`):

    per observation (point n, window frame f) with scale rho[n, f],
    clamped to [PATCH_SCALE_MIN, PATCH_SCALE_MAX]: bilinear-sample value,
    d/dx and d/dy on the grid uv[n, f] + rho * (k - R), k = 0..2R per
    axis (each patch row and column with its own floor and phase, rows
    blended first, then columns, as the TPU kernel does); normalize each
    channel's patch (`norm`: off, mean or affine) and subtract the
    descriptor; reduce to [Σgx², Σgx·gy, Σgy², Σgx·r, Σgy·r, Σr²], summed
    over channels.

`scaled_stats` launches the CUDA kernel (csrc/patch_scaled.cu) for tensors
on a card and runs `scaled_stats_reference`, the plain PyTorch version of
the same contract, for tensors on the CPU. A CUDA tensor gets the kernel or
an exception. `scaled_patches_reference` is the plain sampler alone (its
(s, gx, gy) patches), so that sampling and statistics are tested apart.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import PATCH_SCALE_MAX, PATCH_SCALE_MIN
from . import _build
from ._common import (RADII, count_launch, norm_code, reset_launches,
                      stats_from_samples)


def scaled_taps(uv: torch.Tensor, rho: torch.Tensor, valid: torch.Tensor,
                patch_radius: int, h: int, wi: int):
    """Per-row and per-column floor taps and phases of the scaled grid, as
    the kernel computes them: position u + rho * (k - R), a product and a
    sum each rounded once; taps clamped to [0, H - 2] / [0, Wi - 2],
    phases to [0, 1]. Invalid observations (coordinates possibly NaN) are
    placed at the TPU launcher's safe interior point with rho = 1.

    Returns (ty, fy, tx, fx), each (N, W, 2R+1): ty/tx int64."""
    safe = float(PATCH_SCALE_MAX * patch_radius + 2)
    x = torch.where(valid, uv[..., 0], safe)
    y = torch.where(valid, uv[..., 1], safe)
    r = torch.where(valid, torch.clamp(rho, PATCH_SCALE_MIN, PATCH_SCALE_MAX),
                    1.0)
    ks = torch.arange(-patch_radius, patch_radius + 1, dtype=uv.dtype,
                      device=uv.device)
    step = r[..., None] * ks                               # (N, W, ps)

    def axis(u, hi):
        pos = u[..., None] + step
        t = torch.clamp(torch.floor(pos).long(), 0, hi)
        return t, torch.clamp(pos - t.to(pos.dtype), 0.0, 1.0)

    ty, fy = axis(y, h - 2)
    tx, fx = axis(x, wi - 2)
    return ty, fy, tx, fx


def scaled_patches_reference(planes: torch.Tensor, uv: torch.Tensor,
                             rho: torch.Tensor, valid: torch.Tensor,
                             patch_radius: int):
    """Plain sampler of the kernel: (s, gx, gy), each (N, W, C, P), for
    planes (W, C, H, Wi, 4) from `patch_warp.build_planes`, uv (N, W, 2),
    rho (N, W), valid (N, W). Rows are blended first with each row's
    phase fy, r0 (1 - fy) + r1 fy, then columns, (1 - fx) F + fx N, in the
    TPU kernel's order (patch_warp.py:821, :839)."""
    w, c, h, wi, _ = planes.shape
    n = uv.shape[0]
    ps = 2 * patch_radius + 1
    ty, fy, tx, fx = scaled_taps(uv, rho, valid, patch_radius, h, wi)
    lin = ty[..., :, None] * wi + tx[..., None, :]         # (N, W, ps, ps)
    frame = torch.arange(w, device=planes.device)[None, :, None, None]
    flat = planes.reshape(w, c, h * wi, 4)

    def texels(offset):       # advanced indices first: (N, W, ps, ps, C, 4)
        return flat[frame, :, lin + offset]

    gy0 = (1.0 - fy)[..., :, None, None, None]
    gy1 = fy[..., :, None, None, None]
    far = texels(0) * gy0 + texels(wi) * gy1               # floor column F
    near = texels(1) * gy0 + texels(wi + 1) * gy1          # next column N
    gx1 = fx[..., None, :, None, None]
    out = (1.0 - gx1) * far + gx1 * near                   # (N,W,ps,ps,C,4)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(n, w, c, ps * ps, 4)
    return out[..., 0], out[..., 1], out[..., 2]


def scaled_stats_reference(planes: torch.Tensor, uv: torch.Tensor,
                           rho: torch.Tensor, valid: torch.Tensor,
                           patch: torch.Tensor, patch_radius: int,
                           norm: str = "mean") -> torch.Tensor:
    """Plain PyTorch version of the kernel, same contract.

    planes (W, C, H, Wi, 4) f32 from `patch_warp.build_planes`; uv
    (N, W, 2) f32; rho (N, W) f32; valid (N, W) bool; patch (N, C, P) f32
    with P = (2R+1)^2; norm one of ops/_common.NORMS. Returns (6, W, N)
    f32 rows [g00, g01, g11, gxr, gyr, rr], un-whitened, exact zeros for
    invalid observations."""
    s, gx, gy = scaled_patches_reference(planes, uv, rho, valid,
                                         patch_radius)
    return stats_from_samples(s, gx, gy, patch, valid, norm)


def _check(planes, uv, rho, valid, patch, patch_radius: int):
    if patch_radius not in RADII:
        raise ValueError(f"scaled_stats kernel is built for patch radius in "
                         f"{RADII}, not {patch_radius}")
    w, c, h, wi, four = planes.shape
    n = uv.shape[0]
    ps = 2 * patch_radius + 1
    want = {"planes": (planes, torch.float32, (w, c, h, wi, 4)),
            "uv": (uv, torch.float32, (n, w, 2)),
            "rho": (rho, torch.float32, (n, w)),
            "valid": (valid, torch.bool, (n, w)),
            "patch": (patch, torch.float32, (n, c, ps * ps))}
    for name, (t, dtype, shape) in want.items():
        if t.device != planes.device:
            raise ValueError(f"scaled_stats: {name} on {t.device}, planes on "
                             f"{planes.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"scaled_stats: {name} must be {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"scaled_stats: {name} must be contiguous")
    if planes.data_ptr() % 16 or uv.data_ptr() % 8:
        raise ValueError("scaled_stats: planes must be 16-byte and uv "
                         "8-byte aligned (float4 / float2 loads)")
    if h < 2 or wi < 2:
        raise ValueError(f"scaled_stats: image {h}x{wi} is smaller than a "
                         f"bilinear tap")


def _kernel():
    built = _build.library("patch_scaled")
    fn = built.lib.pb_scaled_stats         # ctypes caches the attribute
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = built.lib.pb_scaled_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return built.lib


def scaled_stats(planes: torch.Tensor, uv: torch.Tensor, rho: torch.Tensor,
                 valid: torch.Tensor, patch: torch.Tensor, patch_radius: int,
                 norm: str = "mean") -> torch.Tensor:
    """The six Gauss-Newton sums per observation, (6, W, N) f32.

    Same arguments and result as `scaled_stats_reference`. CPU tensors run
    that plain version; CUDA tensors launch the kernel on the current
    stream without synchronising (and raise if it cannot launch).
    `scaled_stats.launches` counts kernel launches by normalization mode
    (norm='affine' is the port's K5, the others K3)."""
    code = norm_code(norm)
    if planes.device.type == "cpu":
        return scaled_stats_reference(planes, uv, rho, valid, patch,
                                      patch_radius, norm)
    if planes.device.type != "cuda":
        raise ValueError(f"scaled_stats runs on cpu or cuda tensors, not "
                         f"{planes.device}")
    _check(planes, uv, rho, valid, patch, patch_radius)
    w, c, h, wi, _ = planes.shape
    n = uv.shape[0]
    out = torch.empty((6, w, n), dtype=torch.float32, device=planes.device)
    if n * w == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = lib.pb_scaled_stats(
            planes.data_ptr(), uv.data_ptr(), rho.data_ptr(),
            valid.data_ptr(), patch.data_ptr(), out.data_ptr(), n, w, c, h,
            wi, patch_radius, code, stream)
    if err != 0:
        msg = lib.pb_scaled_error_string(err).decode()
        raise RuntimeError(f"scaled_stats kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    count_launch(scaled_stats, norm)
    return out


reset_launches(scaled_stats)
