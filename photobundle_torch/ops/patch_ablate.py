"""K1 with its stages switched off: the ablation kernel K8.

Twin of tools/ablate_packed_kernel.py::ablate_kernel, the JAX package's
TPU copy of K1 with op classes stubbed out, run to attribute K1's time to
its stages. Here it is K1's mean-mode kernel at R = 2
(csrc/patch_ablate.cu) with two switches, each output a definite function
with a plain version (`ablate_reference`):

  stage   'loads'    Σ (x + y) + z over each window's raw texels;
          'combine'  Σ (s + gx) + gy over the bilinear samples;
          'subtract' Σ ((s - d) + gx) + gy;
          'center'   K1's means of s - d, gx and gy, then
                     Σ ((s - d) - m) + (gx - mx) + (gy - my);
          'full'     K1's six sums (`patch_warp.patch_stats(norm="mean")`).
          The partial stages' one sum lands in row 0 of K1's (6, W, N)
          output, rows 1-5 zeros; every sum runs in the kernel's order
          (channels, then patch rows, then columns), so plain version and
          kernel agree bitwise (both round every operation once).
  window  'own'      each observation's window, as K1;
          'shared'   every thread of a block reads its block's first
                     observation's window (frame, origin and weights;
                     that observation's coordinate where it is valid,
                     (0, 0) otherwise), staged once: the ceiling of one
                     window's copy a block.
  threads per block (64, 128, 256), the twin of the TPU's gchunk; it
          changes the 'shared' output (which observation leads a block)
          and nothing else.

The kernel is K1's staged design at R = 2 (csrc/patch_stage.cuh): a
block stages its observations' windows in shared memory with coalesced
16-byte copies before each thread's stage reads them, so 'loads' times
that copy and full/own at 64 threads is K1's own kernel.

The TPU's lane-roll, select, superwindow and matmul knobs answer its lane
layout and have no counterpart; sorted dispatch
(`patch_warp.sorted_patch_stats`) measures shared windows on real data.
Invalid observations give zeros. `ablate_stats` launches the kernel for
tensors on a card and runs `ablate_reference` for tensors on the CPU; a
CUDA tensor gets the kernel or an exception.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import patch_warp as pw
from ._common import count_launch, reset_launches, stats_from_samples

STAGES = ("loads", "combine", "subtract", "center", "full")
WINDOWS = ("own", "shared")
THREADS = (64, 128, 256)
RADIUS = 2                                   # the kernel's patch radius
MODES = tuple(f"{s}/{w}" for s in STAGES for w in WINDOWS)


def _check_switches(stage: str, window: str, threads: int) -> None:
    if stage not in STAGES or window not in WINDOWS or threads not in THREADS:
        raise ValueError(f"ablate_stats: stage in {STAGES}, window in "
                         f"{WINDOWS}, threads in {THREADS}; got {stage}, "
                         f"{window}, {threads}")


def window_sources(valid: torch.Tensor, window: str, threads: int):
    """(point, frame) (N, W) int64 of the observation whose window each
    observation reads: its own, or its block's first one (frame-major
    blocks of `threads` observations)."""
    n, w = valid.shape
    dev = valid.device
    p = torch.arange(n, device=dev)[:, None].expand(n, w)
    f = torch.arange(w, device=dev)[None, :].expand(n, w)
    if window == "own":
        return p, f
    first = (f * n + p) // threads * threads
    return first % n, first // n


def ablate_reference(planes: torch.Tensor, uv: torch.Tensor,
                     valid: torch.Tensor, patch: torch.Tensor,
                     stage: str = "full", window: str = "own",
                     threads: int = 64) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (6, W, N) f32. planes
    (W, C, H, Wi, 4) from `patch_warp.build_planes`; uv (N, W, 2) f32;
    valid (N, W) bool; patch (N, C, 25) f32 (R = 2)."""
    _check_switches(stage, window, threads)
    n, w = valid.shape
    c = planes.shape[1]
    ps, p = 2 * RADIUS + 1, (2 * RADIUS + 1) ** 2
    sp, sf = window_sources(valid, window, threads)
    a, fx, fy = pw.gather_windows(planes, uv[sp, sf], valid[sp, sf], RADIUS,
                                  frame=sf)                 # (N,W,C,6,6,4)
    if stage == "full":
        s = pw.bilinear(a, fx, fy, RADIUS).reshape(n, w, c, p, 4)
        return stats_from_samples(s[..., 0], s[..., 1], s[..., 2], patch,
                                  valid, "mean")
    acc = torch.zeros((n, w), dtype=torch.float32, device=planes.device)
    if stage == "loads":
        for ch in range(c):
            for ky in range(ps + 1):
                for kx in range(ps + 1):
                    t = a[:, :, ch, ky, kx]
                    acc = acc + ((t[..., 0] + t[..., 1]) + t[..., 2])
    else:
        s = pw.bilinear(a, fx, fy, RADIUS)                  # (N,W,C,5,5,4)
        d = patch.reshape(n, 1, c, p)
        inv_p = 1.0 / p        # in f32: the kernel's 1.f / 25.f, exactly
        cells = [(ky * ps + kx, s[:, :, :, ky, kx]) for ky in range(ps)
                 for kx in range(ps)]
        for ch in range(c):
            if stage == "center":
                mv = mx = my = torch.zeros_like(acc)
                for k, t in cells:
                    mv = mv + (t[:, :, ch, 0] - d[:, :, ch, k])
                    mx = mx + t[:, :, ch, 1]
                    my = my + t[:, :, ch, 2]
                mv, mx, my = mv * inv_p, mx * inv_p, my * inv_p
                for k, t in cells:
                    acc = acc + ((((t[:, :, ch, 0] - d[:, :, ch, k]) - mv)
                                  + (t[:, :, ch, 1] - mx))
                                 + (t[:, :, ch, 2] - my))
                continue
            for k, t in cells:
                v = t[:, :, ch, 0]
                if stage == "subtract":
                    v = v - d[:, :, ch, k]
                acc = acc + ((v + t[:, :, ch, 1]) + t[:, :, ch, 2])
    out = torch.zeros((6, w, n), dtype=torch.float32, device=planes.device)
    out[0] = torch.where(valid, acc, 0.0).T
    return out


def _kernel():
    built = _build.library("patch_ablate")
    fn = built.lib.pb_ablate_stats          # ctypes caches the attribute
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = built.lib.pb_ablate_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return built.lib


def ablate_stats(planes: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
                 patch: torch.Tensor, stage: str = "full",
                 window: str = "own", threads: int = 64) -> torch.Tensor:
    """The ablated kernel's (6, W, N) output: same arguments and result as
    `ablate_reference`. CUDA tensors launch the kernel on the current
    stream without synchronising (and raise if it cannot launch);
    `ablate_stats.launches` counts launches by 'stage/window'."""
    _check_switches(stage, window, threads)
    if planes.device.type == "cpu":
        return ablate_reference(planes, uv, valid, patch, stage, window,
                                threads)
    if planes.device.type != "cuda":
        raise ValueError(f"ablate_stats runs on cpu or cuda tensors, not "
                         f"{planes.device}")
    pw._check(planes, uv, valid, patch, RADIUS)
    w, c, h, wi, _ = planes.shape
    n = uv.shape[0]
    out = torch.empty((6, w, n), dtype=torch.float32, device=planes.device)
    if n * w == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = lib.pb_ablate_stats(
            planes.data_ptr(), uv.data_ptr(), valid.data_ptr(),
            patch.data_ptr(), out.data_ptr(), n, w, c, h, wi,
            STAGES.index(stage), WINDOWS.index(window), threads, stream)
    if err != 0:
        msg = lib.pb_ablate_error_string(err).decode()
        raise RuntimeError(f"ablate_stats kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    count_launch(ablate_stats, f"{stage}/{window}")
    return out


reset_launches(ablate_stats, MODES)
