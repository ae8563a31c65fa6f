"""Bilinear patch samples (value, d/dx, d/dy) per observation: K4's sample
store and K6.

Twin of photobundle_tpu/ops/patch_warp.py::warp_patches (:1018-1158) and
its kernels `_warp_kernel` (K4, variant 'rows') and `_warp_kernel_block`
(K6, variants 'block' and 'raw'). Where the port's other kernels reduce
their samples in the kernel, this one stores them, for the unfused solve
path (PB_GROUPED_STATS=0, core/residuals.py) and the store-layout
benchmark (photobundle_torch/tools/bench_warp_kernel.py).

One kernel (csrc/patch_samples.cu) takes the store layout as a template
parameter, the TPU kernels' layouts:

    rows   (C, ps, N*W, 3ps)    one patch row per store (K4);
    block  (C, N*W, ps, 3ps)    one tile per observation (K6);
    raw    (C, N*W, win, 3win)  the integer window, no bilinear combine
                                (K6, raw=True); `warp_patches` combines it
                                in plain tensor ops, in the JAX order of
                                patch_warp.py:1145-1150.

Observations are frame-major (f * N + p); lane 3*x + k holds plane k
(value, d/dx, d/dy) at patch column x. `unpack` turns each layout into
(s, gx, gy), each (N, W, C, P), with one permute-copy that puts the plane
axis first (patch_warp.py:1122-1124 and :1151-1153 take three strided
copies): that relayout is part of what each variant costs.

Variant 'packed' is the JAX package's G-observation lane packing, a TPU
layout; here it takes the 'block' store, and its samples are the same,
bitwise, as the JAX package's 'packed' gives 'rows'' samples.

The kernel takes patch radii `_common.FIXED_RADII` (1..19), the JAX
package's fixed-grid limit, in every layout. A block spreads its
observations' samples over its threads in the order of the stored tensor
and writes each warp's 384 contiguous bytes together (coalesced stores;
csrc/patch_samples.cu says what was measured).

The samples are K1's (`patch_warp.gather_windows` and `bilinear`, and
csrc/patch_bilinear.cuh on the card), so every variant's samples are
bitwise alike. Invalid observations store zeros; the TPU kernels store
the samples of a clamped window there.

`warp_patches` launches the kernel for tensors on a card and runs
`store_reference`, its plain version, for tensors on the CPU. A CUDA
tensor gets the kernel or an exception.

`store` and `warp_patches` also take a leading batch axis of B windows of
the same shapes, the twin of the grid axis that `jax.vmap` adds to K4's
Pallas call (photobundle_tpu/ops/patch_warp.py:1112): one launch for all
B windows, each window's store bitwise its own unbatched launch's. The
batched solve (core/lm.py `lm_solve_batched`) launches the row store once
per evaluation for all its windows under PB_GROUPED_STATS=0.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import patch_warp as pw
from ._common import (FIXED_RADII, check_batch, check_tensors, count_launch,
                      reset_launches)

LAYOUTS = ("rows", "block", "raw")                 # kernel codes 0, 1, 2
VARIANTS = ("rows", "packed", "block", "raw")
RADII = FIXED_RADII                        # the patch radii the kernel takes


def layout_of(variant: str) -> str:
    """The store layout a `warp_patches` variant runs ('packed' takes the
    'block' store)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown warp_patches variant '{variant}' (want one "
                         f"of {VARIANTS})")
    return "block" if variant == "packed" else variant


def store_reference(planes: torch.Tensor, uv: torch.Tensor,
                    valid: torch.Tensor, patch_radius: int,
                    layout: str = "rows") -> torch.Tensor:
    """Plain PyTorch version of the kernel: the stored tensor of `layout`
    (see the module docstring) for planes (W, C, H, Wi, 4) from
    `patch_warp.build_planes`, uv (N, W, 2) f32, valid (N, W) bool; with a
    leading batch axis on each, (B, <layout>), each window's store as its
    unbatched call gives it."""
    if planes.dim() == 6:
        return torch.stack([store_reference(*window, patch_radius, layout)
                            for window in zip(planes, uv, valid)])
    n, w = valid.shape
    c = planes.shape[1]
    a, fx, fy = pw.gather_windows(planes, uv, valid, patch_radius)
    if layout != "raw":
        a = pw.bilinear(a, fx, fy, patch_radius)
    t = torch.where(valid[:, :, None, None, None, None], a[..., :3], 0.0)
    k = t.shape[3]                          # tile rows: ps, or win for raw
    if layout == "rows":       # (N, W, C, y, x, 3) -> (C, y, W, N, x, 3)
        t = t.permute(2, 3, 1, 0, 4, 5)
        return t.reshape(c, k, w * n, 3 * k)
    t = t.permute(2, 1, 0, 3, 4, 5)          # -> (C, W, N, y, x, 3)
    return t.reshape(c, w * n, k, 3 * k)


def _kernel():
    built = _build.library("patch_samples")
    fn = built.lib.pb_warp_samples          # ctypes caches the attribute
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = built.lib.pb_samples_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return built.lib


def store(planes: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
          patch_radius: int, layout: str = "rows") -> torch.Tensor:
    """The stored tensor of `layout`, (B, <layout>) for B windows on a
    leading batch axis: the kernel for CUDA tensors (on the current
    stream, without synchronising; raises if it cannot launch; one launch
    for all B windows), `store_reference` for CPU tensors.
    `warp_patches.launches` counts kernel launches by layout."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown store layout '{layout}' (want one of "
                         f"{LAYOUTS})")
    if planes.device.type == "cpu":
        return store_reference(planes, uv, valid, patch_radius, layout)
    if planes.device.type != "cuda":
        raise ValueError(f"warp_patches runs on cpu or cuda tensors, not "
                         f"{planes.device}")
    if patch_radius not in RADII:
        raise ValueError(f"warp_patches kernel takes patch radius "
                         f"{RADII[0]}..{RADII[-1]}, not {patch_radius}")
    lead = tuple(planes.shape[:-5])          # () or (B,): the batch axis
    w, c, h, wi = planes.shape[len(lead):len(lead) + 4]
    n = uv.shape[-3] if uv.dim() >= 3 else -1
    check_tensors("warp_patches", planes.device, {
        "planes": (planes, torch.float32, (*lead, w, c, h, wi, 4)),
        "uv": (uv, torch.float32, (*lead, n, w, 2)),
        "valid": (valid, torch.bool, (*lead, n, w))})
    check_batch("warp_patches", lead)
    # Window b's slices start b whole windows on: aligned as the first.
    pw.check_texels("warp_patches", planes[0] if lead else planes,
                    uv[0] if lead else uv, patch_radius)
    k = 2 * patch_radius + (2 if layout == "raw" else 1)
    shape = ((c, k, w * n, 3 * k) if layout == "rows"
             else (c, w * n, k, 3 * k))
    out = torch.empty((*lead, *shape), dtype=torch.float32,
                      device=planes.device)
    if n * w == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = lib.pb_warp_samples(planes.data_ptr(), uv.data_ptr(),
                                  valid.data_ptr(), out.data_ptr(),
                                  lead[0] if lead else 1, n, w, c, h, wi,
                                  patch_radius, LAYOUTS.index(layout),
                                  stream)
    if err != 0:
        msg = lib.pb_samples_error_string(err).decode()
        raise RuntimeError(f"warp_patches kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    count_launch(warp_patches, layout)
    return out


def warp_patches(planes: torch.Tensor, uv: torch.Tensor,
                 valid: torch.Tensor, patch_radius: int,
                 variant: str = "rows"):
    """Bilinear-sample (value, d/dx, d/dy) patches at all observations.

    planes (W, C, H, Wi, 4) from `patch_warp.build_planes`; uv (N, W, 2)
    f32; valid (N, W) bool (invalid observations sample to zeros); variant
    'rows' | 'packed' | 'block' | 'raw' (the store layout, see the module
    docstring). Returns (s, gx, gy), each (N, W, C, P) with P = (2R+1)^2,
    the same for every variant; with a leading batch axis on every
    argument, each (B, N, W, C, P) from one store for all B windows."""
    layout = layout_of(variant)
    out = store(planes, uv, valid, patch_radius, layout)
    if planes.dim() == 6:
        return tuple(torch.stack(t) for t in zip(*(
            unpack(*window, patch_radius, layout)
            for window in zip(out, uv, valid))))
    return unpack(out, uv, valid, patch_radius, layout)


def unpack(out: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
           patch_radius: int, layout: str):
    """A stored tensor of `layout` -> (s, gx, gy), each (N, W, C, P): the
    JAX package's relayout (and for 'raw' its bilinear combine) after the
    kernel, as one permute-copy to (plane, N, W, C, PSy, PSx) unbound
    along the plane axis (three contiguous views). The 'rows' layout also
    takes a leading batch axis (valid (B, N, W), out (B, <layout>)):
    each (B, N, W, C, P), in the same one copy."""
    lead = valid.shape[:-2]
    n, w = valid.shape[-2:]
    ps = 2 * patch_radius + 1
    c = out.shape[len(lead)]
    if layout == "rows":
        # (C, PSy, W, N, PSx, 3) -> (3, N, W, C, PSy, PSx). Lane = 3*x + k.
        nl = len(lead)
        out = out.reshape(*lead, c, ps, w, n, ps, 3).permute(
            nl + 5, *range(nl), nl + 3, nl + 2, nl, nl + 1, nl + 4)
        return out.contiguous().reshape(3, *lead, n, w, c,
                                        ps * ps).unbind(0)
    if lead:
        raise ValueError(f"unpack takes a batch axis in the 'rows' layout "
                         f"alone, not '{layout}'")
    if layout == "raw":
        # The bilinear combine as dense tensor ops, weights per
        # observation, frame-major like the stored layout.
        x = torch.where(valid, uv[..., 0], 0.0)
        y = torch.where(valid, uv[..., 1], 0.0)
        fxm = (x - torch.floor(x)).T.reshape(1, n * w, 1, 1)
        fym = (y - torch.floor(y)).T.reshape(1, n * w, 1, 1)
        out = ((1 - fxm) * (1 - fym) * out[..., :ps, :3 * ps]
               + fxm * (1 - fym) * out[..., :ps, 3:]
               + (1 - fxm) * fym * out[..., 1:, :3 * ps]
               + fxm * fym * out[..., 1:, 3:])
    # (C, W, N, PSy, PSx, 3) -> (3, N, W, C, PSy, PSx).
    out = out.reshape(c, w, n, ps, ps, 3).permute(5, 2, 1, 0, 3, 4)
    return out.contiguous().reshape(3, n, w, c, ps * ps).unbind(0)


reset_launches(warp_patches, LAYOUTS)
