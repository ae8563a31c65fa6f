"""Fused patch sampling + centring + Gauss-Newton statistics: kernel K7.

Twin of photobundle_tpu/ops/patch_stats.py::patch_stats (:170-276) and
its kernel `_stats_kernel` (:96-165), the JAX package's first fused
kernel, kept there as the measured fusion baseline:

    per observation (point n, window frame f): bilinear-sample value s,
    d/dx gx and d/dy gy on the integer patch grid at uv[n, f]; centre each
    of the three on its own patch mean; r = s_c - d; reduce to
    [Σgx², Σgx·gy, Σgy², Σgx·r, Σgy·r, Σr²], summed over channels.

`cost_only=True` samples the value alone, from value planes (a quarter of
the bytes, the twin of the TPU's value-only panels), and returns Σr² alone;
it equals the full mode's Σr², bitwise. K7 centres s before subtracting the
descriptor, where K1's mean mode centres s - d (ops/_common.NORMS), so its
arithmetic is its own (csrc/patch_stats.cu), and its plain version,
`patch_stats_reference`, repeats it. The TPU panel helpers of the JAX
module (`build_panels`, `panel_stride`, `num_panels`) are TPU layout and
have no counterpart: the kernel reads `patch_warp.build_planes`' planes,
or `patch_bicubic.build_value_planes`' for cost_only.

`patch_stats` launches the CUDA kernel for tensors on a card and runs
`patch_stats_reference` for tensors on the CPU; a CUDA tensor gets the
kernel or an exception. The kernel takes patch radii 1..STATS_MAX (62),
the JAX kernel's own range (its panel stride 128 - (2R+2) must be
positive); `design` says which of its designs runs at a radius, and
`stats_rows_one_thread` runs its first design at any radius, bitwise the
others. No caller of the port's solve uses it, as none of the JAX
package's does: it is the fusion baseline beside K1.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import patch_warp as pw
from ._common import STATS_MAX, check_tensors, count_launch, reset_launches

MODES = ("full", "cost_only")


def patch_stats_reference(planes: torch.Tensor, uv: torch.Tensor,
                          valid: torch.Tensor, descriptors: torch.Tensor,
                          patch_radius: int, cost_only: bool = False
                          ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (W * N, 8) f32 frame-major
    rows [gxx, gxy, gyy, gxr, gyr, rr, 0, 0] (cost_only: rr alone), exact
    zeros for invalid observations. planes (W, C, H, Wi, 4) from
    `patch_warp.build_planes`, or value planes (W, C, H, Wi) for
    cost_only; uv (N, W, 2) f32; valid (N, W) bool; descriptors
    (N, C, ps, ps) f32, mean-normalized."""
    n, w = valid.shape
    c = planes.shape[1]
    p = (2 * patch_radius + 1) ** 2
    a, fx, fy = pw.gather_windows(planes, uv, valid, patch_radius)
    s = pw.bilinear(a, fx, fy, patch_radius)    # (N, W, C, ps, ps[, 4])
    inv_p = 1.0 / p

    def plane(k):          # one sampled plane, contiguous (N, W, C, P)
        t = s if cost_only else s[..., k]
        return t.reshape(n, w, c, p).contiguous()

    def centred(t):
        return t - t.sum(-1, keepdim=True) * inv_p

    r = centred(plane(0)) - descriptors.reshape(n, 1, c, p)
    rr = (r * r).sum(-1).sum(-1)                                   # (N, W)
    zero = torch.zeros_like(rr)
    if cost_only:
        sums = [zero] * 5 + [rr]
    else:
        gx, gy = centred(plane(1)), centred(plane(2))
        sums = [(gx * gx).sum(-1).sum(-1), (gx * gy).sum(-1).sum(-1),
                (gy * gy).sum(-1).sum(-1), (gx * r).sum(-1).sum(-1),
                (gy * r).sum(-1).sum(-1), rr]
    out = torch.stack(sums + [zero, zero], dim=-1)                 # (N, W, 8)
    out = torch.where(valid[..., None], out, 0.0)
    return out.transpose(0, 1).reshape(w * n, 8)


def _kernel():
    built = _build.library("patch_stats")
    fn = built.lib.pb_k7_stats              # ctypes caches the attribute
    if fn.argtypes is None:
        for fn in (built.lib.pb_k7_stats, built.lib.pb_k7_stats_one_thread):
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        built.lib.pb_k7_design.argtypes = [ctypes.c_int] * 2
        err = built.lib.pb_k7_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return built.lib


def _launch(wrapper, entry: str, planes, uv, valid, descriptors,
            patch_radius: int, cost_only: bool):
    if planes.device.type == "cpu":
        return patch_stats_reference(planes, uv, valid, descriptors,
                                     patch_radius, cost_only)
    if planes.device.type != "cuda":
        raise ValueError(f"patch_stats runs on cpu or cuda tensors, not "
                         f"{planes.device}")
    if not 1 <= patch_radius <= STATS_MAX:
        raise ValueError(f"patch_stats kernel takes patch radius "
                         f"1..{STATS_MAX} (the reference's panel stride "
                         f"128 - (2R+2) must be positive), not "
                         f"{patch_radius}")
    n, w = valid.shape
    c, h, wi = planes.shape[1:4]
    ps = 2 * patch_radius + 1
    texel = () if cost_only else (4,)
    check_tensors("patch_stats", planes.device, {
        "planes": (planes, torch.float32, (w, c, h, wi, *texel)),
        "uv": (uv, torch.float32, (n, w, 2)),
        "valid": (valid, torch.bool, (n, w)),
        "descriptors": (descriptors, torch.float32, (n, c, ps, ps))})
    pw.check_texels("patch_stats", planes, uv, patch_radius)
    out = torch.empty((w * n, 8), dtype=torch.float32, device=planes.device)
    if n * w == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = getattr(lib, entry)(
            planes.data_ptr(), uv.data_ptr(), valid.data_ptr(),
            descriptors.data_ptr(), out.data_ptr(), n, w, c, h, wi,
            patch_radius, int(cost_only), stream)
    if err != 0:
        msg = lib.pb_k7_error_string(err).decode()
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA "
                           f"error {err} ({msg})")
    count_launch(wrapper, MODES[int(cost_only)])
    return out


def stats_rows(planes: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
               descriptors: torch.Tensor, patch_radius: int,
               cost_only: bool = False) -> torch.Tensor:
    """The kernel's (W * N, 8) rows: the kernel for CUDA tensors (on the
    current stream, without synchronising; raises if it cannot launch),
    `patch_stats_reference` for CPU tensors. `patch_stats.launches`
    counts kernel launches by mode ('full', 'cost_only')."""
    return _launch(patch_stats, "pb_k7_stats", planes, uv, valid,
                   descriptors, patch_radius, cost_only)


def stats_rows_one_thread(planes: torch.Tensor, uv: torch.Tensor,
                          valid: torch.Tensor, descriptors: torch.Tensor,
                          patch_radius: int, cost_only: bool = False
                          ) -> torch.Tensor:
    """`stats_rows` through the kernel's first design (one thread per
    observation, sampling on both passes) with a run-time radius, at any
    radius it takes: the same rows, bitwise (the same samples and sums in
    the same order), for holding its other designs to it. Not on any
    path; `.launches` counts its own launches."""
    return _launch(stats_rows_one_thread, "pb_k7_stats_one_thread", planes,
                   uv, valid, descriptors, patch_radius, cost_only)


DESIGNS = ("sampled every pass", "register tile", "runtime radius",
           "tiled", "staged")


def design(patch_radius: int, cost_only: bool = False) -> str:
    """The design the kernel runs at a patch radius and mode (DESIGNS;
    csrc/patch_stats.cu says which is measured faster where). Builds the
    library where it is missing (needs nvcc)."""
    code = _kernel().pb_k7_design(patch_radius, int(cost_only))
    if code < 0:
        raise ValueError(f"patch_stats takes no patch radius "
                         f"{patch_radius}")
    return DESIGNS[code]


def patch_stats(planes: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
                descriptors: torch.Tensor, patch_radius: int,
                cost_only: bool = False):
    """Fused sample + centre + Gauss-Newton statistics for all observations.

    Arguments as `patch_stats_reference`. Returns (gtg (N, W, 2, 2),
    gtr (N, W, 2), rnorm2 (N, W)), un-whitened, zeros at invalid
    observations (cost_only: gtg and gtr are zeros)."""
    n, w = valid.shape
    out = stats_rows(planes, uv, valid, descriptors, patch_radius, cost_only)
    out = out.reshape(w, n, 8).transpose(0, 1)                     # (N, W, 8)
    gtg = torch.stack([torch.stack([out[..., 0], out[..., 1]], dim=-1),
                       torch.stack([out[..., 1], out[..., 2]], dim=-1)],
                      dim=-2)
    return gtg, out[..., 3:5], out[..., 5]


reset_launches(patch_stats, MODES)
reset_launches(stats_rows_one_thread, MODES)
