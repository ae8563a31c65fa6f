"""Fused Catmull-Rom patch sampling + Gauss-Newton statistics (kernel K2).

Twin of photobundle_tpu/ops/patch_warp.py's bicubic kernel
(`_bicubic_kernel`, launched by `warp_patches_bicubic`), whose
(value, d/dx, d/dy) patches the JAX package reduces to the Gauss-Newton
statistics in XLA (core/residuals.py, the bicubic branch of
`_evaluate_compressed_pallas`). The port fuses that reduction into the
kernel, so its contract is the bilinear kernel's (ops/patch_warp.py):

    per observation (point n, window frame f): sample the Catmull-Rom
    surface and its exact d/dx, d/dy on the integer patch grid at
    uv[n, f] (one subpixel phase per patch); normalize each channel's
    patch (`norm`: off, mean or affine, ops/_common.NORMS) and subtract
    the descriptor; reduce to [Σgx², Σgx·gy, Σgy², Σgx·r, Σgy·r, Σr²],
    summed over channels.

With norm='affine' it computes what the JAX package computes from K2's
patches in XLA for patchNormalization='affine' (core/residuals.py:816-850).

`bicubic_stats` launches the CUDA kernel (csrc/patch_bicubic.cu) for
tensors on a card and runs `bicubic_stats_reference`, the plain PyTorch
version of the same contract, for tensors on the CPU. A CUDA tensor gets
the kernel or an exception.

`bicubic_patches_reference` is the plain twin of the TPU sampler alone
(its (s, gx, gy) patches, window clamping included), in the kernel's f32
arithmetic; the plain version reduces its patches, and the tests hold it
against `interp.bicubic_with_grad` and the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from ..image import interp
from . import _build
from ._common import (RADII, count_launch, norm_code, reset_launches,
                      stats_from_samples)


def build_value_planes(channels: torch.Tensor) -> torch.Tensor:
    """(W, C, H, Wi) channel values -> the kernel's contiguous f32 planes.
    The surface gradients come from the values, so no gradient planes are
    read. Loop-invariant across LM iterations: build once per solve (the
    twin of the JAX package's `build_value_panels`)."""
    return channels.to(torch.float32).contiguous()


def _safe_uv(uv: torch.Tensor, valid: torch.Tensor, patch_radius: int):
    """Invalid (possibly NaN) coordinates replaced by an interior point
    before any floor or int cast, as the TPU launcher does."""
    return torch.where(valid[..., None], uv, float(patch_radius + 2))


def bicubic_patches_reference(planes: torch.Tensor, uv: torch.Tensor,
                              valid: torch.Tensor, patch_radius: int):
    """Plain twin of `warp_patches_bicubic`: (s, gx, gy), each
    (N, W, C, P) f32, for planes (W, C, H, Wi), uv (N, W, 2), valid (N, W).

    Same window as the TPU kernel: a (ps+3)^2 window whose origin is
    clamped inside the image, one phase per patch, rows filtered along x
    first (value and d/dx), then combined along y, in its tap order."""
    w, c, h, wi = planes.shape
    n = uv.shape[0]
    ps = 2 * patch_radius + 1
    win = ps + 3
    q = _safe_uv(uv, valid, patch_radius)
    xf, yf = torch.floor(q[..., 0]), torch.floor(q[..., 1])
    tx, ty = q[..., 0] - xf, q[..., 1] - yf
    x0 = torch.clamp(xf.long() - patch_radius - 1, 0, wi - win)
    y0 = torch.clamp(yf.long() - patch_radius - 1, 0, h - win)
    k = torch.arange(win, device=planes.device)
    lin = ((y0[..., None, None] + k[:, None]) * wi
           + x0[..., None, None] + k)                      # (N, W, win, win)
    frame = torch.arange(w, device=planes.device)[None, :, None, None]
    # Advanced indices split by a slice: their broadcast dims come first.
    wnd = planes.reshape(w, c, h * wi)[frame, :, lin]      # (N,W,win,win,C)
    wnd = wnd.permute(0, 1, 4, 2, 3)                       # (N,W,C,win,win)

    def col(t):
        return t[:, :, None, None, None]

    wx = [col(a) for a in interp.catmull_rom_weights(tx)]
    dwx = [col(a) for a in interp.catmull_rom_dweights(tx)]
    wy = [col(a) for a in interp.catmull_rom_weights(ty)]
    dwy = [col(a) for a in interp.catmull_rom_dweights(ty)]
    rv = sum(wx[j] * wnd[..., :, j:j + ps] for j in range(4))   # (.., win, ps)
    rd = sum(dwx[j] * wnd[..., :, j:j + ps] for j in range(4))
    v = sum(wy[j] * rv[..., j:j + ps, :] for j in range(4))     # (.., ps, ps)
    gx = sum(wy[j] * rd[..., j:j + ps, :] for j in range(4))
    gy = sum(dwy[j] * rv[..., j:j + ps, :] for j in range(4))
    return tuple(a.reshape(n, w, c, ps * ps) for a in (v, gx, gy))


def bicubic_stats_reference(planes: torch.Tensor, uv: torch.Tensor,
                            valid: torch.Tensor, patch: torch.Tensor,
                            patch_radius: int, norm: str = "mean"
                            ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same contract.

    planes (W, C, H, Wi) from `build_value_planes`; uv (N, W, 2) f32;
    valid (N, W) bool; patch (N, C, P) f32 with P = (2R+1)^2; norm one of
    ops/_common.NORMS. Returns (6, W, N) f32 rows [g00, g01, g11, gxr,
    gyr, rr], un-whitened, exact zeros for invalid observations. Samples
    through `bicubic_patches_reference`, which repeats the kernel's f32
    arithmetic: one phase per patch, the same weights and tap order (the
    kernel is built without multiply-add contraction, ops/_build.py)."""
    s, gx, gy = bicubic_patches_reference(planes, uv, valid, patch_radius)
    return stats_from_samples(s, gx, gy, patch, valid, norm)


def _check(planes, uv, valid, patch, patch_radius: int):
    if patch_radius not in RADII:
        raise ValueError(f"bicubic_stats kernel is built for patch radius in "
                         f"{RADII}, not {patch_radius}")
    w, c, h, wi = planes.shape
    n = uv.shape[0]
    ps = 2 * patch_radius + 1
    want = {"planes": (planes, torch.float32, (w, c, h, wi)),
            "uv": (uv, torch.float32, (n, w, 2)),
            "valid": (valid, torch.bool, (n, w)),
            "patch": (patch, torch.float32, (n, c, ps * ps))}
    for name, (t, dtype, shape) in want.items():
        if t.device != planes.device:
            raise ValueError(f"bicubic_stats: {name} on {t.device}, planes "
                             f"on {planes.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"bicubic_stats: {name} must be {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"bicubic_stats: {name} must be contiguous")
    if uv.data_ptr() % 8:
        raise ValueError("bicubic_stats: uv must be 8-byte aligned (float2 "
                         "loads)")
    if h < ps + 3 or wi < ps + 3:
        raise ValueError(f"bicubic_stats: image {h}x{wi} is smaller than "
                         f"the sampling window")


def _kernel():
    built = _build.library("patch_bicubic")
    fn = built.lib.pb_bicubic_stats        # ctypes caches the attribute
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = built.lib.pb_bicubic_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return built.lib


def bicubic_stats(planes: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
                  patch: torch.Tensor, patch_radius: int,
                  norm: str = "mean") -> torch.Tensor:
    """The six Gauss-Newton sums per observation, (6, W, N) f32.

    Same arguments and result as `bicubic_stats_reference`. CPU tensors
    run that plain version; CUDA tensors launch the kernel on the current
    stream without synchronising (and raise if it cannot launch).
    `bicubic_stats.launches` counts kernel launches by normalization
    mode."""
    code = norm_code(norm)
    if planes.device.type == "cpu":
        return bicubic_stats_reference(planes, uv, valid, patch,
                                       patch_radius, norm)
    if planes.device.type != "cuda":
        raise ValueError(f"bicubic_stats runs on cpu or cuda tensors, not "
                         f"{planes.device}")
    _check(planes, uv, valid, patch, patch_radius)
    w, c, h, wi = planes.shape
    n = uv.shape[0]
    out = torch.empty((6, w, n), dtype=torch.float32, device=planes.device)
    if n * w == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = lib.pb_bicubic_stats(
            planes.data_ptr(), uv.data_ptr(), valid.data_ptr(),
            patch.data_ptr(), out.data_ptr(), n, w, c, h, wi, patch_radius,
            code, stream)
    if err != 0:
        msg = lib.pb_bicubic_error_string(err).decode()
        raise RuntimeError(f"bicubic_stats kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    count_launch(bicubic_stats, norm)
    return out


reset_launches(bicubic_stats)
