"""Fused patch sampling + Gauss-Newton statistics: the solve's one kernel.

Twin of photobundle_tpu/ops/patch_warp.py's main-path kernel
(`_warp_kernel_packed` with `_packed_epilogue`, launched by
`warp_patches_grouped` and reduced by `core/residuals._grouped_stats`).
The port keeps the kernel's contract and drops its TPU layout (128-lane
panels, lane interleave, G-observation lane packing, segment-mean matmul):

    per observation (point n, window frame f): bilinear-sample value, d/dx
    and d/dy on the integer patch grid at uv[n, f]; normalize each
    channel's patch (`norm`, one of ops/_common.NORMS) and subtract the
    descriptor; reduce to [Σgx², Σgx·gy, Σgy², Σgx·r, Σgy·r, Σr²], summed
    over channels.

The normalization modes (`_common.stats_from_samples`, and on the card
csrc/patch_epilogue.cuh, shared by every patch kernel of the port):
'off'; 'mean', each plane centred on its patch mean, r = (v - d) - mean;
'affine', the ZNCC unit norm with its exact Jacobian, which makes this
kernel the port's twin of K4 (`_warp_kernel`, whose (s, gx, gy) the JAX
package normalizes and reduces in XLA, core/residuals.py:830-850).

`patch_stats` launches the CUDA kernel (csrc/patch_warp.cu) for tensors on
a card and runs `patch_stats_reference`, the plain PyTorch version of the
same contract, for tensors on the CPU. There is no fallback from one to
the other: a CUDA tensor gets the kernel or an exception.

`sorted_patch_stats` is the twin of K1's `sort_reuse=True` variant
(photobundle_tpu/ops/patch_warp.py:393-411, the kernel behind
PB_SORTED_DISPATCH=1): the same sums, bitwise, with the observations
visited in a sorted point order (`core/residuals.sorted_dispatch_order`),
so that a block of neighbouring points can stage their shared window in
shared memory once (the second entry of csrc/patch_warp.cu).

Both kernels take patch radii `_common.FIXED_RADII` (1..19, the JAX
package's fixed-grid limit); to R = 3, K1 stages each block's windows in
shared memory, and above R = 9 both run one instance with a runtime
radius. With more than one channel (the IntensityAndGradient and
BitPlanes descriptors, C = 3 and 8; at most `_common.MAX_CHANNELS`) K1
gives each (observation, channel) pair its own thread and adds the C
channel sums in channel order: its sums are bitwise the channel-ordered
sum of C one-channel launches (csrc/patch_warp.cu).

Both kernels also take a leading batch axis of B windows of the same
shapes, the twin of the grid axis that `jax.vmap` adds to the Pallas call
(photobundle_tpu/ops/patch_warp.py:577): one launch for all B windows,
each window's sums bitwise those of its own unbatched launch (the sorted
kernel's windows each in their own order). The batched solve (core/lm.py
`lm_solve_batched`) launches the one its configuration runs once per
evaluation for all its windows.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._common import (FIXED_RADII, check_batch, check_channels, check_tensors,
                      count_launch, norm_code, reset_launches,
                      stats_from_samples)


def build_planes(channels: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """(W, C, H, Wi) values + (W, C, H, Wi, 2) gradients -> the kernel's
    (W, C, H, Wi, 4) f32 texels (value, d/dx, d/dy, 0). Loop-invariant
    across LM iterations: build once per solve (the twin of the JAX
    package's `make_pallas_ctx`)."""
    zero = torch.zeros_like(channels)
    return torch.stack([channels, grads[..., 0], grads[..., 1], zero],
                       dim=-1).to(torch.float32).contiguous()


def gather_windows(planes: torch.Tensor, uv: torch.Tensor,
                   valid: torch.Tensor, patch_radius: int, frame=None):
    """Each observation's (2R+2)^2 window of texels and its subpixel phase,
    as the kernels compute them: (a (N, W, C, win, win, *T), fx (N, W),
    fy (N, W)) for planes (W, C, H, Wi, *T) (T = (4,) for `build_planes`'
    texels, () for value planes). Invalid coordinates (possibly NaN) are
    zeroed before any floor or int cast, and the window is clamped inside
    the image. `frame` (N, W) int64 names the frame each window is read
    from (default: the observation's own)."""
    w, c, h, wi = planes.shape[:4]
    win = 2 * patch_radius + 2
    x = torch.where(valid, uv[..., 0], 0.0)
    y = torch.where(valid, uv[..., 1], 0.0)
    flx, fly = torch.floor(x), torch.floor(y)
    fx, fy = x - flx, y - fly
    x0 = torch.clamp(flx.long() - patch_radius, 0, wi - win)
    y0 = torch.clamp(fly.long() - patch_radius, 0, h - win)
    k = torch.arange(win, device=planes.device)
    lin = ((y0[..., None, None] + k[:, None]) * wi
           + x0[..., None, None] + k)                      # (N, W, win, win)
    if frame is None:
        frame = torch.arange(w, device=planes.device)[None, :]
    # Advanced indices split by a slice: their broadcast dims come first.
    a = planes.reshape(w, c, h * wi, *planes.shape[4:])[
        frame[..., None, None], :, lin]
    return a.movedim(4, 2), fx, fy                         # (N,W,C,win,win,*T)


def bilinear(a: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
             patch_radius: int) -> torch.Tensor:
    """Bilinear samples (N, W, C, ps, ps, *T) on the integer patch grid of
    windows a (N, W, C, win, win, *T) at phases fx, fy (N, W), in the tap
    order of the TPU kernel (patch_warp.py:430-431), which every kernel of
    the port shares (csrc/patch_bilinear.cuh)."""
    ps = 2 * patch_radius + 1
    one_fy = 1.0 - fy
    wts = [(1.0 - fx) * one_fy, fx * one_fy, (1.0 - fx) * fy, fx * fy]
    tail = (1,) * (a.dim() - 2)
    w00, w01, w10, w11 = (t.reshape(t.shape + tail) for t in wts)
    return (w00 * a[:, :, :, :ps, :ps] + w01 * a[:, :, :, :ps, 1:]
            + w10 * a[:, :, :, 1:, :ps] + w11 * a[:, :, :, 1:, 1:])


def patch_stats_reference(planes: torch.Tensor, uv: torch.Tensor,
                          valid: torch.Tensor, patch: torch.Tensor,
                          patch_radius: int, norm: str = "mean"
                          ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same contract.

    planes (W, C, H, Wi, 4) from `build_planes`; uv (N, W, 2) f32;
    valid (N, W) bool; patch (N, C, P) f32 with P = (2R+1)^2 (or (N, W,
    C, P), one descriptor per observation); norm one of
    ops/_common.NORMS. Returns (6, W, N) f32 rows [g00, g01, g11, gxr,
    gyr, rr], un-whitened, exact zeros for invalid observations. With a
    leading batch axis (planes (B, W, C, H, Wi, 4), uv (B, N, W, 2), valid
    (B, N, W), patch (B, N, C, P)) it returns (B, 6, W, N), each window's
    rows as its unbatched call gives them."""
    if planes.dim() == 6:
        # The B windows as one of B * W frames, each observation reading
        # its own window's frame: the same gathers and per-row sums, so
        # each window's rows are bitwise its unbatched call's.
        b, w = planes.shape[:2]
        n = valid.shape[1]

        def fold(t):                         # (B, N, W, ...) -> (N, BW, ...)
            return t.transpose(0, 1).clone(
                memory_format=torch.contiguous_format).view(
                n, b * w, *t.shape[3:])

        rows = patch_stats_reference(
            planes.reshape(b * w, *planes.shape[2:]), fold(uv), fold(valid),
            fold(patch[:, :, None].expand(b, n, w, *patch.shape[2:])),
            patch_radius, norm)
        return rows.view(6, b, w, n).transpose(0, 1).clone(
            memory_format=torch.contiguous_format)
    n, w = valid.shape
    c = planes.shape[1]
    ps = 2 * patch_radius + 1
    a, fx, fy = gather_windows(planes, uv, valid, patch_radius)
    s = bilinear(a, fx, fy, patch_radius).reshape(n, w, c, ps * ps, 4)
    return stats_from_samples(s[..., 0], s[..., 1], s[..., 2], patch, valid,
                              norm)


def _check(planes, uv, valid, patch, patch_radius: int):
    # The radii of the JAX package's fixed-grid kernel: its (2R+2)-px
    # window, three lanes per pixel, must leave a 128-lane panel a positive
    # stride (photobundle_tpu/ops/patch_warp.py `lane_stride`).
    if patch_radius not in FIXED_RADII:
        win = 2 * patch_radius + 2
        raise ValueError(
            f"patch_stats kernel takes patch radius {FIXED_RADII[0]}.."
            f"{FIXED_RADII[-1]}, not {patch_radius}: a window of {win} px "
            f"(3*{win} lanes) does not fit the reference's 128-lane panel "
            f"with a positive stride")
    lead = tuple(planes.shape[:-5])          # () or (B,): the batch axis
    w, c, h, wi, four = planes.shape[-5:]
    n = uv.shape[-3] if uv.dim() >= 3 else -1
    ps = 2 * patch_radius + 1
    check_tensors("patch_stats", planes.device, {
        "planes": (planes, torch.float32, (*lead, w, c, h, wi, 4)),
        "uv": (uv, torch.float32, (*lead, n, w, 2)),
        "valid": (valid, torch.bool, (*lead, n, w)),
        "patch": (patch, torch.float32, (*lead, n, c, ps * ps))})
    check_batch("patch_stats", lead)
    check_channels("patch_stats", c)
    # Window b's slices start b whole windows on: aligned as the first.
    check_texels("patch_stats", planes[0] if lead else planes,
                 uv[0] if lead else uv, patch_radius)


def check_texels(what: str, planes, uv, patch_radius: int) -> None:
    """The float4 / float2 alignment the bilinear kernels load with, and an
    image no smaller than the sampling window."""
    h, wi = planes.shape[2:4]
    if planes.data_ptr() % 16 or uv.data_ptr() % 8:
        raise ValueError(f"{what}: planes must be 16-byte and uv 8-byte "
                         f"aligned (float4 / float2 loads)")
    if h < 2 * patch_radius + 2 or wi < 2 * patch_radius + 2:
        raise ValueError(f"{what}: image {h}x{wi} is smaller than the "
                         f"sampling window")


def _kernel():
    built = _build.library("patch_warp")
    fn = built.lib.pb_patch_stats          # ctypes caches the attribute
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fs = built.lib.pb_patch_stats_sorted
        fs.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fs.restype = ctypes.c_int
        err = built.lib.pb_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return built.lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.pb_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({msg})")


def patch_stats(planes: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
                patch: torch.Tensor, patch_radius: int,
                norm: str = "mean") -> torch.Tensor:
    """The six Gauss-Newton sums per observation, (6, W, N) f32, or
    (B, 6, W, N) for B windows on a leading batch axis.

    Same arguments and result as `patch_stats_reference`. CPU tensors run
    that plain version; CUDA tensors launch the kernel on the current
    stream without synchronising (and raise if it cannot launch), one
    launch for all B windows. `patch_stats.launches` counts kernel
    launches by normalization mode."""
    code = norm_code(norm)
    if planes.device.type == "cpu":
        return patch_stats_reference(planes, uv, valid, patch, patch_radius,
                                     norm)
    if planes.device.type != "cuda":
        raise ValueError(f"patch_stats runs on cpu or cuda tensors, not "
                         f"{planes.device}")
    _check(planes, uv, valid, patch, patch_radius)
    lead = tuple(planes.shape[:-5])
    b = lead[0] if lead else 1
    w, c, h, wi, _ = planes.shape[-5:]
    n = uv.shape[-3]
    out = torch.empty((*lead, 6, w, n), dtype=torch.float32,
                      device=planes.device)
    if n * w == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = lib.pb_patch_stats(
            planes.data_ptr(), uv.data_ptr(), valid.data_ptr(),
            patch.data_ptr(), out.data_ptr(), b, n, w, c, h, wi,
            patch_radius, code, stream)
    _raise_on(lib, err, "patch_stats")
    count_launch(patch_stats, norm)
    return out


# Observations per block of the sorted kernel: a block takes this many
# consecutive sorted ranks of one frame (kThreads in csrc/patch_warp.cu).
SORTED_RUN = 64


def sorted_blocks(n: int, w: int) -> int:
    """Blocks of one sorted launch over N points and W frames (the length
    of `sorted_patch_stats`'s `staged` flags, frame-major)."""
    return w * ((n + SORTED_RUN - 1) // SORTED_RUN)


def sorted_patch_stats_reference(planes, uv, valid, patch,
                                 patch_radius: int, order,
                                 norm: str = "mean") -> torch.Tensor:
    """Plain version of the sorted kernel: `patch_stats_reference` on the
    rows in sorted order, scattered back to each point's slot. Same
    arguments as `sorted_patch_stats`; with a leading batch axis, each
    window's rows as its unbatched call gives them."""
    feed, inverse = order
    if planes.dim() == 6:
        # Each window's rows gathered in its own order, K1's batched plain
        # version over all of them, each window scattered back.
        def sort(t):
            return torch.take_along_dim(
                t, feed.reshape(*feed.shape, *(1,) * (t.dim() - 2)), dim=1)
        rows = patch_stats_reference(planes, sort(uv), sort(valid),
                                     sort(patch), patch_radius, norm)
        return torch.take_along_dim(rows, inverse[:, None, None, :], dim=-1)
    rows = patch_stats_reference(planes, uv[feed], valid[feed], patch[feed],
                                 patch_radius, norm)
    return rows[:, :, inverse].contiguous()


def sorted_patch_stats(planes: torch.Tensor, uv: torch.Tensor,
                       valid: torch.Tensor, patch: torch.Tensor,
                       patch_radius: int, order, norm: str = "mean",
                       staged: torch.Tensor | None = None) -> torch.Tensor:
    """`patch_stats` with the observations visited in a sorted point
    order; the result is the same (6, W, N), bitwise, or (B, 6, W, N) for
    B windows on a leading batch axis (one launch, each window in its own
    order).

    order = (feed (N,) int64, inverse (N,) int64) from
    `core/residuals.sorted_dispatch_order`: sorted rank -> point and back;
    (B, N) each with a batch axis. `staged`, for CUDA tensors only: None,
    or a uint8 tensor of `sorted_blocks(N, W)` ((B, sorted_blocks(N, W))
    with a batch axis) that receives each block's branch (SortedBranch
    in csrc/patch_warp.cu: 1 its union box staged in shared memory, 2 its
    observations' own windows, 0 gathered from global memory). CPU
    tensors run `sorted_patch_stats_reference`; CUDA tensors launch the kernel on the
    current stream (and raise if it cannot launch).
    `sorted_patch_stats.launches` counts kernel launches by
    normalization mode."""
    feed, inverse = order
    code = norm_code(norm)
    if planes.device.type == "cpu":
        return sorted_patch_stats_reference(planes, uv, valid, patch,
                                            patch_radius, order, norm)
    if planes.device.type != "cuda":
        raise ValueError(f"sorted_patch_stats runs on cpu or cuda tensors, "
                         f"not {planes.device}")
    _check(planes, uv, valid, patch, patch_radius)
    lead = tuple(planes.shape[:-5])
    w, c, h, wi, _ = planes.shape[-5:]
    n = uv.shape[-3]
    for name, t in (("feed", feed), ("inverse", inverse)):
        if (t.device != planes.device or t.dtype != torch.int64
                or tuple(t.shape) != (*lead, n) or not t.is_contiguous()):
            raise ValueError(f"sorted_patch_stats: {name} must be a "
                             f"contiguous int64 {(*lead, n)} tensor on "
                             f"{planes.device}")
    blocks = (*lead, sorted_blocks(n, w))
    if staged is not None and (staged.device != planes.device
                               or staged.dtype != torch.uint8
                               or tuple(staged.shape) != blocks
                               or not staged.is_contiguous()):
        raise ValueError(f"sorted_patch_stats: staged must be a contiguous "
                         f"uint8 {blocks} tensor on {planes.device}")
    out = torch.empty((*lead, 6, w, n), dtype=torch.float32,
                      device=planes.device)
    if n * w == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = lib.pb_patch_stats_sorted(
            planes.data_ptr(), uv.data_ptr(), valid.data_ptr(),
            patch.data_ptr(), feed.data_ptr(), out.data_ptr(),
            None if staged is None else staged.data_ptr(),
            lead[0] if lead else 1, n, w, c, h, wi, patch_radius, code,
            stream)
    _raise_on(lib, err, "sorted_patch_stats")
    count_launch(sorted_patch_stats, norm)
    return out


reset_launches(patch_stats)
reset_launches(sorted_patch_stats)
