#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Drives the port's paths at the repository's full size (370x1226 images,
4096 points, 5-frame window, 5x5 patches, C = 1), from seeds:

  1. the card: torch's device name, and nvidia-smi's name and power limit;
  2. build: the three kernel sources compiled from photobundle_torch/csrc/
     (one nvcc per source, started together), ptxas registers and spills;
  3. kernel K1 (csrc/patch_warp.cu) vs its plain PyTorch version on a
     synthetic window solve's own inputs, with the median time of each;
  4. one window solve: lm_solve(backend="cuda"), 8 fixed iterations; K1's
     launch count over that run; then the same solve on the plain torch
     backend, LM iterations/s of both, and a parity solve of the two;
  5. kernel K2 (csrc/patch_bicubic.cu) vs its plain version on phase 3's
     inputs within the bicubic margins, with the median time of each;
  6. the engine: PhotometricBundleAdjustment.add_frame over 15 frames of
     the textured-sphere scene (entry.make_sequence) at KITTI 00's
     left-camera intrinsics, drifted VO poses in, in the reference-exact
     configuration (configs/reference_exact.cfg: bicubic sampling, so
     every window solve runs K2); K2's launch count, costs, ATE,
     keyframes/s, window-solve ms and the first window's cost on both
     backends from the same state;
  7. the same engine in the default configuration (bilinear, sampled:
     K1) over 8 frames;
  8. kernel K3 (csrc/patch_scaled.cu, the warped grid of patchWarp=scale)
     vs its plain version on phase 3's inputs with a scale rho per
     observation (numpy seed 1, uniform in [0.45, 2.3], clamped) inside
     K3's margins;
  9. the affine modes (patchNormalization=affine) vs their plain versions
     on the same inputs: K1's (the port's K4), K3's (K5) and K2's;
 10. the engine on phase 6's scene, 8 frames each, with patchWarp=scale
     (K3), patchNormalization=affine (K1's affine mode), both (K3's
     affine mode) and the reference-exact configuration with affine
     normalization (K2's affine mode): launch counts, costs, ATE,
     keyframes/s, window-solve ms, and the first window's cost on both
     backends, the torch run restricted to the cuda path's valid set;
 11. K1's sort-reuse variant (csrc/patch_warp.cu, sorted_patch_stats) on
     phase 3's inputs and on a 65 536-point instance of the same problem
     (entry.make_problem, the same frames), in the order lm_solve builds
     under PB_SORTED_DISPATCH=1: bitwise equal to K1's unsorted sums (mean
     and off) and within the kernel tolerance of its plain version; device
     time per launch sorted and unsorted, the sort's own ms, the share of
     blocks that staged their windows in shared memory, the bound;
 12. the command line on a KITTI-format sequence at 370x1226: phase 6's
     scene written as 12 stereo PNG pairs (the port's stdlib PNG writer),
     calib.txt, times.txt, poses/00.txt and a drifted VO input, refined
     in configs/kitti_production.cfg (BM stereo with 128 disparities on
     the card, the speckle filter, 3-level coarse-to-fine, motion and pose
     priors; dataDir, numFrames and maxNumPoints=4096 as key=value
     overrides) three times: `python -m photobundle_torch.cli` as a
     subprocess with PB_SORTED_DISPATCH=1, then cli.main in this process
     with it (launch counts checked) and without it. The three trajectory
     files must be byte-identical, every window's cost non-increasing and
     the refined ATE below the input's. Also the card's stereo time per
     frame (BM, and SGM once) and the host speckle filter's.

Each kernel comparison reports the kernel's and the plain version's median
time per call (CUDA events), the kernel's device time per launch
(torch.profiler) and its bound on this card. Every engine run zeroes the
launch counts just before it and checks, just after, that its kernel ran
in its normalization mode once per LM iteration plus once per window and
that no other kernel or mode ran (phase 12: the sorted kernel once per
LM iteration plus once per solve of every level, K1 twice per window for
the coarse-to-fine guard).

Prints a JSON line of kernel results, the card's name and power limit,
and, as the last line, {"ok": true, "device": {...}}. Any failed phase
raises and exits non-zero without that line. Needs a CUDA card: without
one it exits non-zero before doing anything.
"""

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_PTS, W, H, WI, PATCH_RADIUS, SEED = 4096, 5, 370, 1226, 2, 1
ITERS = 8                 # fixed-length solve, tolerances zeroed (bench.py)
HUBER_DELTA = 0.05
TIMED_SOLVES = 5
KERNEL_CALLS = 50
PROFILED_CALLS = 20
# Kernel vs plain version: the same f32 samples (the kernels are built
# without multiply-add contraction), reduced in another order.
KERNEL_RTOL, KERNEL_ATOL_ROW = 1e-4, 1e-6
SOLVE_RTOL = 1e-4
# The parity solve keeps observations this many pixels inside both
# backends' border margins (which differ by one pixel) and starts heavily
# damped, where f32 rounding differences are not amplified by the
# problem's near-null point-depth directions.
PARITY_MARGIN_PX, PARITY_LAMBDA = 24, 1.0
# The engine's scene: KITTI 00's published left-camera intrinsics and
# stereo baseline, the texture's wavelengths scaled by 100 / fx so that its
# features keep the ~10-80 px of the repository's test scene (fx = 100).
# Its field of view (+-40 deg) is wider than the sphere (+-37 deg from the
# first pose): rays past the sphere get invalid depth, so no point is
# seeded on them.
KITTI_FX, KITTI_CX, KITTI_CY, KITTI_BASELINE = 718.856, 607.19, 185.22, 0.537
ENGINE_FRAMES, DEFAULT_FRAMES, WARP_FRAMES, SCENE_SEED = 15, 8, 8, 0
DRIFT_TRANS, DRIFT_ROT = 0.005, 0.0005      # VO drift per frame (m, rad)
ENGINE_COST_RTOL = 1e-5
RHO_SEED, RHO_LO, RHO_HI = 1, 0.45, 2.3     # phase 8's scales
DENSE_PTS = 65536                           # phase 11's second instance
CLI_FRAMES, CLI_TIMEOUT_S = 12, 600         # phase 12
CLI_DIR = os.path.join("build", "chip_smoke_cli")
# One NVIDIA H100 SXM (NVIDIA's data sheet): HBM bandwidth and f32 rate
# outside the tensor cores.
H100_BYTES_PER_S, H100_F32_FLOPS = 3.35e12, 67e12
# Operations per patch pixel (multiplies and adds, counted once each):
# sampling value, d/dx and d/dy (bilinear: 3 planes x 4 taps; scaled:
# 3 planes x two row blends and one column blend; bicubic: the separable
# 4-tap filters, rows amortized over the patch), then the epilogue
# (off: residual and six products; mean: plus the three means and
# centring; affine: plus the norm, the projection and two divisions).
SAMPLE_FLOPS = {"bilinear": 21, "scaled": 27, "bicubic": 43}
NORM_FLOPS = {"off": 13, "mean": 20, "affine": 36}
# Bytes per texel the function needs: value, d/dx and d/dy for the bilinear
# kernels (their float4 texel's fourth lane is padding), the value alone
# for the bicubic one.
GRAD_TEXEL_BYTES, VALUE_TEXEL_BYTES = 12, 4


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke failed: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, calls: int, warmup: int = 3) -> float:
    """Median of per-call device times (CUDA events) after a warm-up."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def device_us_per_launch(fn, calls: int = PROFILED_CALLS):
    """Device time per launch of the port's kernels (the `*stats*_kernel`
    entries of a torch.profiler trace) over `calls` calls of fn; None if
    the trace has no device time."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if "stats" in evt.key and "_kernel" in evt.key:
            total += (getattr(evt, "self_device_time_total", 0.0)
                      or getattr(evt, "self_cuda_time_total", 0.0))
    return total / calls if total > 0 else None


def ptxas_table(log: str) -> dict:
    """{(kernel, R, normalization code): (registers, spill-store bytes)} of
    every kernel instance in a `ptxas -v` log (instances are named
    <kernel><R, NORM> in the mangled entry names; a kernel templated on R
    alone, with the normalization a runtime argument, is listed with code
    None)."""
    table, current = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:entry function '|Function properties for )"
                      r"\w*?([a-z_]+_kernel)ILi(\d+)E(?:Li(\d+)E)?", line)
        if m:
            current = (m.group(1), int(m.group(2)),
                       None if m.group(3) is None else int(m.group(3)))
            regs, spill = table.get(current, (None, None))
            table[current] = (regs, spill)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            table[current] = (table[current][0], int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            table[current] = (int(m.group(1)), table[current][1])
    return table


def print_ptxas(name: str, built) -> None:
    """One line per kernel and normalization mode: registers / spill-store
    bytes for R = 1..4 (nothing if the library was not built in this
    process)."""
    from photobundle_torch.ops import _common

    table = ptxas_table(built.log)
    for kernel in sorted({k for k, _, _ in table}):
        for code, norm in enumerate(_common.NORMS):
            cells = [table.get((kernel, r, code), (None, None))
                     for r in _common.RADII]
            say(f"  ptxas {name} {kernel} {norm}: registers/spill bytes for "
                f"R = 1..4: " + ", ".join(f"{g}/{b}" for g, b in cells))


def compare_with_plain(got, want, valid_nm):
    """Kernel sums (6, W, N) against the plain version's: finite, exact
    zeros for invalid observations, |d| <= 1e-4 |plain| + 1e-6 row max.
    Returns (max abs error, max relative error over entries above 1e-3
    of their row's max, max of |d| over that bound)."""
    torch.cuda.synchronize()
    v = valid_nm.T                                               # (W, N)
    check(bool(torch.isfinite(got).all()), "kernel output not finite")
    check(bool((got[:, ~v] == 0).all()),
          "kernel sums of invalid observations are not exact zeros")
    err = (got - want).abs()
    row_max = want.abs().amax(dim=(1, 2), keepdim=True)
    bound = KERNEL_RTOL * want.abs() + KERNEL_ATOL_ROW * row_max
    max_abs = float(err.max())
    big = want.abs() > 1e-3 * row_max
    max_rel = float((err[big] / want.abs()[big]).max())
    worst = float(torch.where(err > 0, err / bound, 0.0).max())
    check(worst <= 1.0,
          f"kernel disagrees with plain version: max abs {max_abs:.3e}, "
          f"max rel {max_rel:.3e}, {worst:.3f} of the tolerance")
    return max_abs, max_rel, worst


def window_texels(uv_nm, valid_nm, pr, win, back, h, wi):
    """Flat (frame, y, x) indices of every texel in the fixed-grid windows
    of the valid observations: win x win from (floor(u) - back), clamped
    inside the image as the kernels clamp it."""
    q = uv_nm[valid_nm]                                          # (M, 2)
    f = torch.nonzero(valid_nm)[:, 1]
    x0 = torch.clamp(torch.floor(q[:, 0]).long() - back, 0, wi - win)
    y0 = torch.clamp(torch.floor(q[:, 1]).long() - back, 0, h - win)
    k = torch.arange(win, device=uv_nm.device)
    return ((f[:, None, None] * h + y0[:, None, None] + k[:, None]) * wi
            + x0[:, None, None] + k)


def scaled_texels(uv_nm, rho_nm, valid_nm, pr, h, wi):
    """Flat (frame, y, x) indices of every texel the warped-grid kernel
    reads for the valid observations: its tap rows {ty, ty + 1} times its
    tap columns {tx, tx + 1}."""
    from photobundle_torch.ops import patch_scaled as ps

    ty, _, tx, _ = ps.scaled_taps(uv_nm, rho_nm, valid_nm, pr, h, wi)
    f = torch.arange(valid_nm.shape[1], device=uv_nm.device)[None, :, None]
    rows = torch.cat([ty, ty + 1], dim=-1)                       # (N, W, 2ps)
    cols = torch.cat([tx, tx + 1], dim=-1)
    lin = (f * h + rows)[..., :, None] * wi + cols[..., None, :]
    return lin[valid_nm]


def kernel_bound(texels, texel_bytes, valid_nm, channels, pr, sample, norm,
                 with_rho=False):
    """Least time the card could take for one call: the larger of the
    bytes the call must move over HBM bandwidth
    and its f32 operations over the f32 rate. Bytes: each distinct texel
    the valid observations need (per channel, `texel_bytes` each: what the
    function reads, not the kernel's padded layout), the validity flags, uv
    (and rho) of the valid observations, the descriptors of the points
    with a valid observation, and the (6, W, N) output. Operations:
    SAMPLE_FLOPS + NORM_FLOPS per patch pixel per channel of each valid
    observation."""
    n, w = valid_nm.shape
    p = (2 * pr + 1) ** 2
    n_valid = int(valid_nm.sum())
    n_points = int(valid_nm.any(dim=1).sum())
    distinct = int(torch.unique(texels.reshape(-1)).numel())
    nbytes = (distinct * channels * texel_bytes + n * w
              + n_valid * (8 + (4 if with_rho else 0))
              + n_points * channels * p * 4 + 6 * w * n * 4)
    flops = n_valid * channels * p * (SAMPLE_FLOPS[sample] + NORM_FLOPS[norm])
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops)


def kernel_phase(tag, label, kernel, plain, valid_nm, bound):
    """Hold one kernel (or mode) against its plain version and time both.
    Returns its numbers for the JSON line."""
    max_abs, max_rel, worst = compare_with_plain(kernel(), plain(),
                                                 valid_nm)
    ms = median_ms(kernel, KERNEL_CALLS)
    plain_ms = median_ms(plain, KERNEL_CALLS)
    dev_us = device_us_per_launch(kernel)
    torch.cuda.synchronize()
    dev = "not measured" if dev_us is None else f"{dev_us:.2f} us"
    say(f"phase {tag} {label} vs plain at {N_PTS}x{W} obs "
        f"({int(valid_nm.sum())} valid), R={PATCH_RADIUS}: max abs err "
        f"{max_abs:.3e}, max rel err {max_rel:.3e}, {worst:.3f} of the "
        f"tolerance |d| <= {KERNEL_RTOL:g}|plain| + {KERNEL_ATOL_ROW:g} row "
        f"max | median "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms over {KERNEL_CALLS} "
        f"calls | device time per launch {dev} (profiler, {PROFILED_CALLS} "
        f"launches) | bound {bound['bound_ms'] * 1e3:.3f} us by "
        f"{bound['bound_by']} ({bound['bytes'] / 1e6:.2f} MB, "
        f"{bound['flops'] / 1e6:.2f} MFLOP)")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                library_ms=None)


def ate(poses, gt) -> float:
    """Absolute trajectory error: RMS of the camera-centre differences (no
    alignment, as tests/test_engine.py measures it)."""
    d = poses[:, :3, 3] - gt[:, :3, 3]
    return float(np.sqrt((d * d).sum(-1).mean()))


def run_engine(tag, cfg, scene, init, n_frames, counted, kernels,
               ate_must_fall=True):
    """Drive PhotometricBundleAdjustment.add_frame over the scene's first
    `n_frames` frames on the card, from the drifted poses `init`.
    `counted` = (kernel wrapper, normalization mode). Zeroes every kernel's
    launch counts just before the run and checks, just after, that every
    window solve launched the counted kernel in its mode once per LM
    iteration plus once for its initial point, that no other kernel or
    mode ran, that no solve raised its cost, and (with `ate_must_fall`)
    that the refined trajectory beats the initial one. Prints the engine's
    numbers and returns them, with the state the first window solve
    started from."""
    from photobundle_torch.core.engine import PhotometricBundleAdjustment
    from photobundle_torch.ops import _common

    cam, images, depths, gt = scene
    pba = PhotometricBundleAdjustment(cam, images[0].shape, cfg)
    check(pba.device.type == "cuda", f"engine runs on {pba.device}")
    check(pba.backend == "cuda", f"engine resolved backend {pba.backend}")
    first_state = []
    optimize = pba._optimize

    def optimize_keeping_first_state(window, points):
        if not first_state:          # _optimize leaves its inputs as they are
            first_state.append((window, points))
        return optimize(window, points)

    pba._optimize = optimize_keeping_first_state
    window_size = cfg.slidingWindowSize
    refined = init[:n_frames].copy()
    results, frame_s = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        _common.reset_launches(k)
    for i in range(n_frames):
        if i == window_size:
            t_keyframes = time.perf_counter()
        t0 = time.perf_counter()
        res = pba.add_frame(images[i], depths[i], init[i])
        if res is None:
            torch.cuda.synchronize()    # ingest only: time it whole
        frame_s.append(time.perf_counter() - t0)
        if res is not None:
            refined[res.frame_ids] = res.poses
            results.append(res)
    keyframes_s = time.perf_counter() - t_keyframes
    counts = {(k.__name__, m): k.launches[m] for k in kernels
              for m in _common.NORMS}
    peak = torch.cuda.max_memory_allocated() / 2**20

    fn, norm = counted
    launches = counts.pop((fn.__name__, norm))
    others = {f"{k}/{m}": v for (k, m), v in counts.items() if v}
    expected = sum(r.iterations + 1 for r in results)
    its = [r.iterations for r in results]
    say(f"phase {tag} engine ({cfg.interpolation}, "
        f"{cfg.resolve_gradient_mode()}, patchWarp "
        f"{cfg.resolve_patch_warp()}, normalization "
        f"{cfg.resolve_normalization()}): {n_frames} frames "
        f"{images[0].shape[0]}x{images[0].shape[1]}, {len(results)} "
        f"windows, {pba.num_active_points} active points "
        f"(capacity {cfg.maxNumPoints}); {fn.__name__}/{norm} launches "
        f"{launches} (sum of iterations + 1: {expected}), other kernels "
        f"and modes {others or 'none'}")
    for r in results:
        say(f"  {r.message()}, solve {r.solve_time_s * 1e3:.1f} ms")
    check(len(results) == n_frames - window_size + 1,
          f"{len(results)} window solves ran")
    check(launches == expected > 0, f"{fn.__name__}/{norm} launched "
          f"{launches} times, expected {expected}")
    check(not others, f"other kernels or modes launched: {others}")
    for r in results:
        check(np.isfinite(r.final_cost) and r.final_cost <= r.initial_cost,
              f"window {r.frame_ids.tolist()} cost {r.initial_cost} -> "
              f"{r.final_cost}")
        check(bool(np.isfinite(r.poses).all()), "refined poses not finite")
    ate_init, ate_ref = ate(init[:n_frames], gt[:n_frames]), ate(
        refined, gt[:n_frames])
    solve_ms = statistics.median(r.solve_time_s * 1e3 for r in results)
    ingest_ms = statistics.median(frame_s[1:window_size - 1]) * 1e3
    rate = (n_frames - window_size) / keyframes_s
    say(f"phase {tag} ATE init {ate_init:.6f} m, refined {ate_ref:.6f} m | "
        f"keyframes/s {rate:.3f} over frames {window_size}..{n_frames - 1} "
        f"| median window solve {solve_ms:.1f} ms | iterations per window "
        f"{its} | median ingest-only frame {ingest_ms:.1f} ms (frames "
        f"1..{window_size - 2}) | peak device memory {peak:.1f} MiB")
    if ate_must_fall:
        check(ate_ref < ate_init, "refinement did not reduce the ATE")
    return dict(engine=pba, first_state=first_state[0], results=results,
                launches=launches)


def first_window_cost(pba, state, backend, restrict=None):
    """Initial cost, observation count and (N, W) valid set of a window
    solve's start state, evaluated on `backend` with the solve's own terms
    (depth prior, patch warp); `restrict` (N, W) narrows the observations.
    The configuration has no pose priors, so this is the solve's initial
    cost."""
    from photobundle_torch.core import residuals as res_mod

    cfg = pba.cfg
    check(cfg.motionPriorWeight == 0 and cfg.posePriorWeight <= 0
          and cfg.posePriorRotWeight <= 0, "expected no pose priors")
    window, points = state
    point_valid, _, depth_prior, patch_warp = pba.solve_terms(window, points)
    obs = points.obs & point_valid[:, None]
    if restrict is not None:
        obs = obs & restrict
    if patch_warp is not None:
        patch_warp = (patch_warp[0], *res_mod.patch_warp_ref_geometry(
            window.t_wc, points.x_world, patch_warp[1]))
    res = res_mod.evaluate_compressed(
        pba.camera, window.t_wc, points.x_world, points.patch,
        window.channels, window.grads, obs, pba.offsets, cfg.robustThreshold,
        cfg.resolve_gradient_mode(), depth_prior=depth_prior,
        backend=backend, normalize=cfg.resolve_normalization(),
        robust_kind=cfg.robustLoss, patch_warp=patch_warp)
    return float(res.cost), int(res.n_residuals), res.valid


def check_first_window(tag, run, restrict_torch):
    """The first window's initial cost on both backends from the state its
    solve started from: equal observation counts (the torch run restricted
    to the cuda path's valid set when `restrict_torch`), costs within
    ENGINE_COST_RTOL, and the cuda cost equal to the solve's own."""
    cc, nc, valid = first_window_cost(run["engine"], run["first_state"],
                                      "cuda")
    ct, nt, _ = first_window_cost(run["engine"], run["first_state"], "torch",
                                  valid if restrict_torch else None)
    rel = abs(ct / cc - 1)
    say(f"phase {tag} first window initial cost: cuda {cc:.6f} ({nc} obs), "
        f"torch {ct:.6f} ({nt} obs"
        f"{', restricted to the cuda valid set' if restrict_torch else ''}),"
        f" rel diff {rel:.3e} (rtol {ENGINE_COST_RTOL:g})")
    check(nc == nt, "backends take different observations in the first "
          "window")
    check(rel <= ENGINE_COST_RTOL, f"first window cost rel diff {rel:.3e}")
    first = run["results"][0].initial_cost
    check(abs(cc / first - 1) <= ENGINE_COST_RTOL,
          f"first window cost {cc:.6f} differs from its solve's initial "
          f"cost {first:.6f}")


def sorted_instance(n_pts: int, dev):
    """Phase 3's synthetic window problem at `n_pts` points (the same
    frames: entry.make_problem draws them from the seed alone), its valid
    observations inside K1's margins, and the sorted-dispatch order
    lm_solve builds for it. Returns (planes, uv_nm, valid_nm, patch,
    order, sort_ms)."""
    from photobundle_torch import entry
    from photobundle_torch.core import residuals as res_mod
    from photobundle_torch.ops import patch_warp as pw

    cam, _, args = entry.make_problem(n_pts, W, H, WI, PATCH_RADIUS,
                                      seed=SEED, device=dev)
    t_wc, x_world, patch, channels, grads, obs = args[:6]
    pr = PATCH_RADIUS
    _, uv, in_front, _, _ = res_mod._observation_geometry_pm(cam, t_wc,
                                                             x_world)
    in_bounds = ((uv[:, 0] >= pr) & (uv[:, 0] <= WI - 2 - pr)
                 & (uv[:, 1] >= pr) & (uv[:, 1] <= H - 2 - pr))
    valid_nm = (obs.T & in_front & in_bounds).T.contiguous()
    uv_nm = uv.permute(2, 0, 1).contiguous()

    def order():
        return res_mod.sorted_dispatch_order(res_mod.dispatch_key(
            cam, t_wc, x_world, obs, (H, WI)))

    sort_ms = median_ms(order, KERNEL_CALLS)
    return (pw.build_planes(channels, grads), uv_nm, valid_nm, patch,
            order(), sort_ms)


def sorted_phase(dev) -> dict:
    """Phase 11: K1's sort-reuse variant against K1 and its plain version
    at phase 3's size and at DENSE_PTS points. Returns the phase-3 size's
    numbers for the JSON line."""
    from photobundle_torch.ops import patch_warp as pw

    pr = PATCH_RADIUS
    numbers = None
    for n_pts in (N_PTS, DENSE_PTS):
        planes, uv_nm, valid_nm, patch, order, sort_ms = sorted_instance(
            n_pts, dev)
        staged = torch.zeros(pw.sorted_blocks(n_pts, W), dtype=torch.uint8,
                             device=dev)
        for norm in ("mean", "off"):
            got = pw.sorted_patch_stats(planes, uv_nm, valid_nm, patch, pr,
                                        order, norm, staged=staged)
            k1 = pw.patch_stats(planes, uv_nm, valid_nm, patch, pr, norm)
            torch.cuda.synchronize()
            check(torch.equal(got, k1), f"sorted kernel ({norm}) differs "
                  f"from K1 at {n_pts} points: max |d| "
                  f"{float((got - k1).abs().max()):.3e}")
            plain = pw.sorted_patch_stats_reference(planes, uv_nm, valid_nm,
                                                    patch, pr, order, norm)
            max_abs, max_rel, worst = compare_with_plain(got, plain,
                                                         valid_nm)
            say(f"phase 11 sorted vs K1 at {n_pts}x{W} obs "
                f"({int(valid_nm.sum())} valid), {norm}: bitwise equal | vs "
                f"plain: max abs err {max_abs:.3e}, {worst:.3f} of the "
                f"tolerance")
        share = float(staged.float().mean())

        def sorted_call():
            return pw.sorted_patch_stats(planes, uv_nm, valid_nm, patch, pr,
                                         order)

        def k1_call():
            return pw.patch_stats(planes, uv_nm, valid_nm, patch, pr)

        def plain_call():
            return pw.sorted_patch_stats_reference(planes, uv_nm, valid_nm,
                                                   patch, pr, order)

        ms, k1_ms = median_ms(sorted_call, KERNEL_CALLS), median_ms(
            k1_call, KERNEL_CALLS)
        plain_ms = median_ms(plain_call, 10)
        dev_sorted = device_us_per_launch(sorted_call)
        dev_k1 = device_us_per_launch(k1_call)
        bound = kernel_bound(window_texels(uv_nm, valid_nm, pr, 2 * pr + 2,
                                           pr, H, WI),
                             GRAD_TEXEL_BYTES, valid_nm, 1, pr, "bilinear",
                             "mean")
        fmt = lambda us: "not measured" if us is None else f"{us:.2f} us"
        say(f"phase 11 at {n_pts} points, mean: device time per launch "
            f"sorted {fmt(dev_sorted)}, K1 unsorted {fmt(dev_k1)} "
            f"(profiler, {PROFILED_CALLS} launches) | median per call "
            f"sorted {ms:.4f} ms, K1 {k1_ms:.4f} ms, plain {plain_ms:.4f} ms"
            f" | the sort (key + stable sort) {sort_ms:.4f} ms per solve | "
            f"blocks that staged: {share:.4f} of {staged.numel()} | bound "
            f"{bound['bound_ms'] * 1e3:.3f} us by {bound['bound_by']} "
            f"({bound['bytes'] / 1e6:.2f} MB, {bound['flops'] / 1e6:.2f} "
            f"MFLOP)")
        if numbers is None:
            numbers = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound["bound_ms"],
                           bound_by=bound["bound_by"], library_ms=None)
    return numbers


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def cli_phase(kernels, dev) -> int:
    """Phase 12: the command line on a KITTI-format sequence on `dev`,
    three runs (see the module docstring). Returns the sorted kernel's
    launches in the counted run (b)."""
    from photobundle_torch import cli, entry
    from photobundle_torch.core import lm
    from photobundle_torch.core.engine import PhotometricBundleAdjustment
    from photobundle_torch.image import stereo as stereo_mod
    from photobundle_torch.io import kitti
    from photobundle_torch.io import trajectory as traj
    from photobundle_torch.io.speckle import speckle_filter_numpy
    from photobundle_torch.ops import _common
    from photobundle_torch.ops import patch_warp as pw

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    data = os.path.join(CLI_DIR, "kitti")
    t0 = time.perf_counter()
    _, gt = entry.write_kitti_sequence(
        data, np.random.default_rng(SCENE_SEED), n_frames=CLI_FRAMES,
        shape=(H, WI), fx=KITTI_FX, cx=KITTI_CX, cy=KITTI_CY,
        baseline=KITTI_BASELINE, texture_scale=100.0 / KITTI_FX,
        mark_misses=True)
    vo = entry.drift_poses(np.random.default_rng(SCENE_SEED + 1), gt,
                           DRIFT_TRANS, DRIFT_ROT, 1)
    vo_path = os.path.join(data, "vo.txt")
    entry.write_poses(vo_path, vo)
    say(f"phase 12 wrote a {CLI_FRAMES}-frame KITTI-format sequence "
        f"({H}x{WI} stereo PNGs) in {time.perf_counter() - t0:.1f} s")

    # Stereo alone on frame 0: BM on the card (CUDA events), SGM once, the
    # speckle filter on the host.
    cfg = cli.load_config(cli.build_argparser().parse_args(
        ["--config", "configs/kitti_production.cfg", f"dataDir={data}"]))
    seq = os.path.join(data, "sequences", "00")
    left, right = (torch.as_tensor(kitti._imread_gray(os.path.join(
        seq, sub, "000000.png")), device=dev)
        for sub in ("image_0", "image_1"))
    kw = dict(num_disparities=cfg.numDisparities,
              min_disparity=cfg.minDisparity,
              sad_radius=cfg.sadWindowSize // 2)
    bm_ms = median_ms(lambda: stereo_mod.block_match(left, right, **kw), 5,
                      warmup=1)
    disp, valid = stereo_mod.block_match(left, right, **kw)
    t0 = time.perf_counter()
    stereo_mod.semi_global_match(left, right, **kw)
    torch.cuda.synchronize()
    sgm_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    _, kept = speckle_filter_numpy(disp.cpu().numpy(), valid.cpu().numpy(),
                                   max_diff=cfg.speckleRange,
                                   min_region=cfg.speckleWindowSize)
    speckle_ms = (time.perf_counter() - t0) * 1e3
    say(f"phase 12 stereo per frame ({H}x{WI}, {cfg.numDisparities} "
        f"disparities): BM {bm_ms:.2f} ms on the card (CUDA events, median "
        f"of 5), SGM {sgm_ms:.1f} ms (host clock, once), speckle filter "
        f"{speckle_ms:.1f} ms on the host | BM valid share "
        f"{float(valid.float().mean()):.3f}, after speckle "
        f"{float(kept.mean()):.3f}")

    def argv(tag):
        return ["--config", "configs/kitti_production.cfg", "--poses",
                vo_path, "--output", os.path.join(CLI_DIR, f"{tag}.txt"),
                "--log", os.path.join(CLI_DIR, f"{tag}.jsonl"),
                "--device", dev.type, f"dataDir={data}",
                f"numFrames={CLI_FRAMES}", f"maxNumPoints={N_PTS}"]

    # (a) the command a user types, in its own process.
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "photobundle_torch.cli", *argv("a")],
        env=dict(os.environ, PB_SORTED_DISPATCH="1"), capture_output=True,
        text=True, timeout=CLI_TIMEOUT_S)
    wall_a = time.perf_counter() - t0
    check(proc.returncode == 0, f"CLI subprocess exited "
          f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    report = proc.stderr[proc.stderr.rfind("timing report"):].splitlines()
    say(f"phase 12 (a) python -m photobundle_torch.cli, PB_SORTED_DISPATCH=1:"
        f" exit 0 in {wall_a:.1f} s; its timer report:")
    for line in report[1:5]:
        say(f"    {line.split('] ')[-1]}")

    # (b), (c): cli.main in this process, sorted dispatch on and off.
    iterations, frame_s = [], []
    solve, add = lm.lm_solve, PhotometricBundleAdjustment.add_frame

    def counted_solve(*args, **kwargs):
        out = solve(*args, **kwargs)
        iterations.append(int(out[2].iterations))
        return out

    def timed_add(self, *args, **kwargs):
        t = time.perf_counter()
        out = add(self, *args, **kwargs)
        frame_s.append(time.perf_counter() - t)
        return out

    def in_process(tag, sorted_dispatch):
        iterations.clear()
        frame_s.clear()
        os.environ["PB_SORTED_DISPATCH"] = sorted_dispatch
        lm.lm_solve = counted_solve
        PhotometricBundleAdjustment.add_frame = timed_add
        for k in kernels:
            _common.reset_launches(k)
        try:
            rc = cli.main(argv(tag))
            torch.cuda.synchronize()
        finally:
            lm.lm_solve = solve
            PhotometricBundleAdjustment.add_frame = add
            os.environ.pop("PB_SORTED_DISPATCH")
        check(rc == 0, f"cli.main returned {rc}")
        counts = {(k.__name__, m): n for k in kernels
                  for m, n in k.launches.items() if n}
        rate = (CLI_FRAMES - W) / sum(frame_s[W:])
        return counts, list(iterations), rate

    runs, launches = {}, None
    for tag, flag in (("b", "1"), ("c", "0")):
        runs[tag] = in_process(tag, flag)
    records = {tag: read_jsonl(os.path.join(CLI_DIR, f"{tag}.jsonl"))
               for tag in "abc"}
    windows = CLI_FRAMES - W + 1
    for tag, recs in records.items():
        check(len(recs) == windows, f"run ({tag}) logged {len(recs)} windows")
        for r in recs:
            check(r["final_cost"] <= r["initial_cost"], f"run ({tag}) window "
                  f"{r['frame_ids']} cost {r['initial_cost']} -> "
                  f"{r['final_cost']}")
    for tag, (counts, its, rate) in runs.items():
        solves = len(its)
        expected = sum(i + 1 for i in its)
        sorted_n = counts.pop(("sorted_patch_stats", "mean"), 0)
        k1_n = counts.pop(("patch_stats", "mean"), 0)
        say(f"phase 12 ({tag}) cli.main, PB_SORTED_DISPATCH="
            f"{'1' if tag == 'b' else '0'}: {solves} solves over {windows} "
            f"windows (3 levels each), iterations {its}; launches: sorted "
            f"{sorted_n}, K1 {k1_n}, others {counts or 'none'} | "
            f"keyframes/s {rate:.3f} over frames {W}..{CLI_FRAMES - 1}")
        check(solves == 3 * windows, f"({tag}) ran {solves} solves")
        check(not counts, f"({tag}) other kernels or modes ran: {counts}")
        if tag == "b":
            check(sorted_n == expected and k1_n == 2 * windows,
                  f"(b) sorted kernel launched {sorted_n} times (expected "
                  f"{expected}), K1 {k1_n} (expected {2 * windows})")
            launches = sorted_n
        else:
            check(sorted_n == 0 and k1_n == expected + 2 * windows,
                  f"(c) K1 launched {k1_n} times, expected "
                  f"{expected + 2 * windows}")
    solve_ms = statistics.median(r["solve_time_s"] * 1e3
                                 for r in records["b"])
    say(f"phase 12 median window solve (b) {solve_ms:.1f} ms, (c) "
        f"{statistics.median(r['solve_time_s'] * 1e3 for r in records['c']):.1f}"
        f" ms")

    texts = {tag: open(os.path.join(CLI_DIR, f"{tag}.txt")).read()
             for tag in "abc"}
    if texts["b"] != texts["c"]:
        in_process("c2", "0")
        again = open(os.path.join(CLI_DIR, "c2.txt")).read()
        say(f"phase 12 sorted and unsorted trajectories differ; two "
            f"unsorted runs {'agree' if again == texts['c'] else 'differ'}")
    check(texts["a"] == texts["b"] == texts["c"],
          "the three runs' refined_poses files are not byte-identical")
    gt_traj = traj.Trajectory(gt.astype(np.float64))
    ate_vo = traj.ate_rmse(traj.Trajectory(vo.astype(np.float64)), gt_traj,
                           align=False)
    ate_ref = traj.ate_rmse(traj.load_poses_kitti(
        os.path.join(CLI_DIR, "a.txt")), gt_traj, align=False)
    say(f"phase 12 the three trajectory files are byte-identical | ATE "
        f"(unaligned) VO input {ate_vo:.6f} m, refined {ate_ref:.6f} m")
    check(ate_ref < ate_vo, "the CLI did not lower the ATE")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke test runs only on a CUDA card")
    from photobundle_torch import entry
    from photobundle_torch.config import ConfigFile, PBAConfig
    from photobundle_torch.core import lm
    from photobundle_torch.core import residuals as res_mod
    from photobundle_torch.image import patches as patches_mod
    from photobundle_torch.ops import _build, _common
    from photobundle_torch.ops import patch_bicubic as pb
    from photobundle_torch.ops import patch_scaled as ps
    from photobundle_torch.ops import patch_warp as pw

    kernels = (pw.patch_stats, pb.bicubic_stats, ps.scaled_stats,
               pw.sorted_patch_stats)
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say(f"phase 1 device: {name} | nvidia-smi: {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # -- phase 2: build every kernel from the checkout's sources ---------
    builds = _build.build_all(["patch_warp", "patch_bicubic", "patch_scaled"])
    for built in builds.values():
        say(f"phase 2 build: {built.path.name} for sm_90a in "
            f"{built.seconds:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    print_ptxas("patch_warp", builds["patch_warp"])

    # -- phase 3: kernel vs plain version on the solve's inputs ----------
    cam, offsets, args = entry.make_problem(N_PTS, W, H, WI, PATCH_RADIUS,
                                            seed=SEED, device=dev)
    t_wc, x_world, patch, channels, grads, obs, point_valid, frozen = args
    pr = PATCH_RADIUS
    _, uv, in_front, _, _ = res_mod._observation_geometry_pm(cam, t_wc,
                                                             x_world)
    in_bounds = ((uv[:, 0] >= pr) & (uv[:, 0] <= WI - 2 - pr)
                 & (uv[:, 1] >= pr) & (uv[:, 1] <= H - 2 - pr))
    valid_nm = (obs.T & in_front & in_bounds).T.contiguous()   # (N, W)
    uv_nm = uv.permute(2, 0, 1).contiguous()                    # (N, W, 2)
    planes = pw.build_planes(channels, grads)
    win1 = window_texels(uv_nm, valid_nm, pr, 2 * pr + 2, pr, H, WI)
    k1 = kernel_phase(
        "3", "K1", lambda: pw.patch_stats(planes, uv_nm, valid_nm, patch, pr),
        lambda: pw.patch_stats_reference(planes, uv_nm, valid_nm, patch, pr),
        valid_nm, kernel_bound(win1, GRAD_TEXEL_BYTES, valid_nm, 1, pr,
                               "bilinear", "mean"))

    # -- phase 4: the slice ----------------------------------------------
    kw = dict(huber_delta=HUBER_DELTA, gradient_mode="sampled",
              max_iterations=ITERS, function_tolerance=0.0,
              parameter_tolerance=0.0)

    def solve(backend, obs_mask=obs, **extra):
        return lm.lm_solve(cam, t_wc, x_world, patch, channels, grads,
                           obs_mask, point_valid, frozen, offsets,
                           backend=backend, **kw, **extra)

    for k in kernels:
        _common.reset_launches(k)
    t_out, x_out, st = solve("cuda")
    torch.cuda.synchronize()
    launches = pw.patch_stats.launches["mean"]
    iters = int(st.iterations)
    c0, c1 = float(st.initial_cost), float(st.final_cost)
    logs = st.cost_log[:iters]
    say(f"phase 4 cuda solve: {iters} iterations, cost {c0:.6f} -> "
        f"{c1:.6f}, accept {st.accept_log.int().tolist()}, kernel launches "
        f"{launches}")
    check(launches == iters + 1,
          f"kernel launched {launches} times, expected {iters + 1}")
    check(sum(sum(k.launches.values()) for k in kernels) == launches,
          "another kernel or mode ran in the default solve")
    check(iters == ITERS, f"solve ran {iters} iterations, not {ITERS}")
    check(bool(torch.isfinite(logs).all()), "non-finite cost in the log")
    check(c1 < c0, "final cost did not decrease")
    check(tuple(t_out.shape) == (W, 4, 4)
          and tuple(x_out.shape) == (N_PTS, 3),
          "refined poses / points have the wrong shape")
    check(bool(torch.isfinite(t_out).all() and torch.isfinite(x_out).all()),
          "refined poses / points are not finite")
    check(torch.equal(t_out[frozen], t_wc[frozen]),
          "frozen gauge poses moved")

    def its_per_s(backend):
        times = []
        for _ in range(TIMED_SOLVES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve(backend)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ms = " ".join(f"{t * 1e3:.2f}" for t in sorted(times))
        return ITERS / statistics.median(times), ms

    cuda_ips, cuda_ms = its_per_s("cuda")
    _, _, st_t = solve("torch")
    torch_ips, torch_ms = its_per_s("torch")
    torch.cuda.synchronize()
    ct = float(st_t.final_cost)
    say(f"phase 4 torch solve: {int(st_t.iterations)} iterations, cost "
        f"{float(st_t.initial_cost):.6f} -> {ct:.6f}, accept "
        f"{st_t.accept_log.int().tolist()}; final cost vs cuda: rel diff "
        f"{abs(ct / c1 - 1):.3e}")
    check(int(st_t.iterations) == iters, "torch solve iteration count "
          "differs from the cuda solve")
    say(f"phase 4 LM it/s (median of {TIMED_SOLVES} solves of {ITERS} "
        f"iterations): cuda {cuda_ips:.2f} (solve ms {cuda_ms}), torch "
        f"{torch_ips:.2f} (solve ms {torch_ms})")

    # Parity solve: observations inside both margins, damped start.
    m = PARITY_MARGIN_PX
    interior = ((uv[:, 0] >= pr + m) & (uv[:, 0] <= WI - 2 - pr - m)
                & (uv[:, 1] >= pr + m) & (uv[:, 1] <= H - 2 - pr - m)).T
    par = {be: solve(be, obs & interior, initial_lambda=PARITY_LAMBDA)[2]
           for be in ("cuda", "torch")}
    torch.cuda.synchronize()
    pc, pt = par["cuda"], par["torch"]
    rel = abs(float(pt.final_cost) / float(pc.final_cost) - 1)
    log_rel = float((pt.cost_log / pc.cost_log - 1).abs().max())
    say(f"phase 4 parity solve ({int((obs & interior).sum())} interior obs, "
        f"initial lambda {PARITY_LAMBDA:g}): cuda {float(pc.final_cost):.6f}"
        f" accept {pc.accept_log.int().tolist()}, torch "
        f"{float(pt.final_cost):.6f} accept {pt.accept_log.int().tolist()};"
        f" final rel diff {rel:.3e}, max cost-log rel diff {log_rel:.3e} "
        f"(rtol {SOLVE_RTOL:g})")
    check(int(pc.iterations) == int(pt.iterations) == ITERS,
          "parity solves ran different iteration counts")
    check(bool((pc.accept_log == pt.accept_log).all()),
          "parity solves accepted different steps")
    check(rel <= SOLVE_RTOL, f"parity final cost rel diff {rel:.3e}")
    say(f"phase 4 peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # -- phase 5: K2 vs its plain version on phase 3's inputs ------------
    in_bicubic = ((uv[:, 0] >= pr + 1) & (uv[:, 0] <= WI - 3 - pr)
                  & (uv[:, 1] >= pr + 1) & (uv[:, 1] <= H - 3 - pr))
    valid_bc = (obs.T & in_front & in_bicubic).T.contiguous()   # (N, W)
    value_planes = pb.build_value_planes(channels)
    print_ptxas("patch_bicubic", builds["patch_bicubic"])
    win2 = window_texels(uv_nm, valid_bc, pr, 2 * pr + 4, pr + 1, H, WI)
    k2 = kernel_phase(
        "5", "K2",
        lambda: pb.bicubic_stats(value_planes, uv_nm, valid_bc, patch, pr),
        lambda: pb.bicubic_stats_reference(value_planes, uv_nm, valid_bc,
                                           patch, pr),
        valid_bc, kernel_bound(win2, VALUE_TEXEL_BYTES, valid_bc, 1, pr,
                               "bicubic", "mean"))

    # -- phase 6: the engine, reference-exact configuration (K2) ---------
    scene = entry.make_sequence(
        np.random.default_rng(SCENE_SEED), n_frames=ENGINE_FRAMES,
        shape=(H, WI), fx=KITTI_FX, cx=KITTI_CX, cy=KITTI_CY,
        baseline=KITTI_BASELINE, texture_scale=100.0 / KITTI_FX,
        mark_misses=True)
    drifted = entry.drift_poses(np.random.default_rng(SCENE_SEED + 1),
                                scene[3], DRIFT_TRANS, DRIFT_ROT, 1)
    exact_cfg = PBAConfig.from_config_file(
        ConfigFile("configs/reference_exact.cfg"))
    run6 = run_engine("6", exact_cfg, scene, drifted, ENGINE_FRAMES,
                      (pb.bicubic_stats, "mean"), kernels)
    # Both port backends take the same observations under the bicubic
    # margins.
    check_first_window("6", run6, restrict_torch=False)

    # -- phase 7: the engine, default configuration (K1) -----------------
    run_engine("7", PBAConfig(), scene, drifted, DEFAULT_FRAMES,
               (pw.patch_stats, "mean"), kernels, ate_must_fall=False)

    # -- phase 8: K3 vs its plain version on phase 3's inputs ------------
    rho_np = np.random.default_rng(RHO_SEED).uniform(
        RHO_LO, RHO_HI, size=(N_PTS, W)).astype(np.float32)
    rho_nm = torch.as_tensor(np.clip(rho_np, 0.5, 2.0), device=dev)
    ext = rho_nm.T * pr                                          # (W, N)
    in_scaled = ((uv[:, 0] >= 1 + ext) & (uv[:, 0] <= (WI - 2) - ext)
                 & (uv[:, 1] >= 1 + ext) & (uv[:, 1] <= (H - 2) - ext))
    valid_sc = (obs.T & in_front & in_scaled).T.contiguous()    # (N, W)
    print_ptxas("patch_scaled", builds["patch_scaled"])
    win3 = scaled_texels(uv_nm, rho_nm, valid_sc, pr, H, WI)
    k3 = kernel_phase(
        "8", "K3",
        lambda: ps.scaled_stats(planes, uv_nm, rho_nm, valid_sc, patch, pr),
        lambda: ps.scaled_stats_reference(planes, uv_nm, rho_nm, valid_sc,
                                          patch, pr),
        valid_sc, kernel_bound(win3, GRAD_TEXEL_BYTES, valid_sc, 1, pr,
                               "scaled", "mean", with_rho=True))

    # -- phase 9: the affine modes vs their plain versions ---------------
    patch_aff = patches_mod.affine_normalize(patch).contiguous()
    k4 = kernel_phase(
        "9", "K1 affine (K4)",
        lambda: pw.patch_stats(planes, uv_nm, valid_nm, patch_aff, pr,
                               "affine"),
        lambda: pw.patch_stats_reference(planes, uv_nm, valid_nm, patch_aff,
                                         pr, "affine"),
        valid_nm, kernel_bound(win1, GRAD_TEXEL_BYTES, valid_nm, 1, pr,
                               "bilinear", "affine"))
    k5 = kernel_phase(
        "9", "K3 affine (K5)",
        lambda: ps.scaled_stats(planes, uv_nm, rho_nm, valid_sc, patch_aff,
                                pr, "affine"),
        lambda: ps.scaled_stats_reference(planes, uv_nm, rho_nm, valid_sc,
                                          patch_aff, pr, "affine"),
        valid_sc, kernel_bound(win3, GRAD_TEXEL_BYTES, valid_sc, 1, pr,
                               "scaled", "affine", with_rho=True))
    k2a = kernel_phase(
        "9", "K2 affine",
        lambda: pb.bicubic_stats(value_planes, uv_nm, valid_bc, patch_aff,
                                 pr, "affine"),
        lambda: pb.bicubic_stats_reference(value_planes, uv_nm, valid_bc,
                                           patch_aff, pr, "affine"),
        valid_bc, kernel_bound(win2, VALUE_TEXEL_BYTES, valid_bc, 1, pr,
                               "bicubic", "affine"))

    # -- phase 10: the engine with the warp and affine normalization -----
    runs10 = {}
    for tag, cfg, counted in (
            ("10a", PBAConfig(patchWarp="scale"), (ps.scaled_stats, "mean")),
            ("10b", PBAConfig(patchNormalization="affine"),
             (pw.patch_stats, "affine")),
            ("10c", PBAConfig(patchWarp="scale", patchNormalization="affine"),
             (ps.scaled_stats, "affine")),
            ("10d", exact_cfg.replace(patchNormalization="affine"),
             (pb.bicubic_stats, "affine"))):
        runs10[tag] = run_engine(tag, cfg, scene, drifted, WARP_FRAMES,
                                 counted, kernels, ate_must_fall=False)
        # The kernel path's margins are tighter than the gather path's
        # per-sample validity (bilinear and warped grids): hold the torch
        # run to the cuda path's valid set.
        check_first_window(tag, runs10[tag], restrict_torch=True)

    # -- phase 11: K1's sort-reuse variant ------------------------------
    k1s = sorted_phase(dev)

    # -- phase 12: the command line on a KITTI-format sequence -----------
    cli_launches = cli_phase(kernels, dev)

    def entry_json(name, source, replaces, launches, numbers):
        return {"name": name, "route": "cuda",
                "source": f"photobundle_torch/csrc/{source}",
                "replaces": f"photobundle_tpu/ops/patch_warp.py:{replaces}",
                "launches": launches, **numbers}

    print(json.dumps({"kernels": [
        entry_json("patch_stats", "patch_warp.cu", 350, launches, k1),
        entry_json("bicubic_stats", "patch_bicubic.cu", 176,
                   run6["launches"], k2),
        entry_json("scaled_stats", "patch_scaled.cu", 775,
                   runs10["10a"]["launches"], k3),
        entry_json("patch_stats/affine", "patch_warp.cu", 100,
                   runs10["10b"]["launches"], k4),
        entry_json("scaled_stats/affine", "patch_scaled.cu", 613,
                   runs10["10c"]["launches"], k5),
        entry_json("bicubic_stats/affine", "patch_bicubic.cu", 176,
                   runs10["10d"]["launches"], k2a),
        entry_json("sorted_patch_stats", "patch_warp.cu", 393, cli_launches,
                   k1s),
    ]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
