#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Drives the port's paths at the repository's full size (370x1226 images,
4096 points, 5-frame window, 5x5 patches, C = 1), from seeds:

  1. the card: torch's device name, and nvidia-smi's name and power limit;
  2. build: both kernels compiled from photobundle_torch/csrc/ (one nvcc
     per source, started together);
  3. kernel K1 (csrc/patch_warp.cu) vs its plain PyTorch version on a
     synthetic window solve's own inputs, with the median time of each;
  4. one window solve: lm_solve(backend="cuda"), 8 fixed iterations; K1's
     launch count over that run; then the same solve on the plain torch
     backend, LM iterations/s of both, and a parity solve of the two;
  5. kernel K2 (csrc/patch_bicubic.cu): its ptxas registers and spills,
     then K2 vs its plain version on phase 3's inputs within the bicubic
     margins, with the median time of each;
  6. the engine: PhotometricBundleAdjustment.add_frame over 15 frames of
     the textured-sphere scene (entry.make_sequence) at KITTI 00's
     left-camera intrinsics, drifted VO poses in, in the reference-exact
     configuration (configs/reference_exact.cfg: bicubic sampling, so
     every window solve runs K2); K2's launch count, costs, ATE,
     keyframes/s, window-solve ms and the first window's cost on both
     backends from the same state;
  7. the same engine in the default configuration (bilinear, sampled:
     K1) over 8 frames.

Prints a JSON line of kernel results, the card's name and power limit,
and, as the last line, {"ok": true, "device": {...}}. Any failed phase
raises and exits non-zero without that line. Needs a CUDA card: without
one it exits non-zero before doing anything.
"""

import json
import statistics
import subprocess
import time

import numpy as np
import torch

N_PTS, W, H, WI, PATCH_RADIUS, SEED = 4096, 5, 370, 1226, 2, 1
ITERS = 8                 # fixed-length solve, tolerances zeroed (bench.py)
HUBER_DELTA = 0.05
TIMED_SOLVES = 5
KERNEL_CALLS = 50
# Kernel vs plain version: f32 sums of (2R+1)^2 products taken in another
# order (and with fused multiply-adds) on the card.
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
ENGINE_FRAMES, DEFAULT_FRAMES, SCENE_SEED = 15, 8, 0
DRIFT_TRANS, DRIFT_ROT = 0.005, 0.0005      # VO drift per frame (m, rad)
ENGINE_COST_RTOL = 1e-5


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


def print_ptxas(built) -> None:
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")


def compare_with_plain(got, want, valid_nm):
    """Kernel sums (6, W, N) against the plain version's: finite, exact
    zeros for invalid observations, |d| <= 1e-4 |plain| + 1e-6 row max.
    Returns (max abs error, max relative error over entries above 1e-3
    of their row's max)."""
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
    check(bool((err <= bound).all()),
          f"kernel disagrees with plain version: max abs {max_abs:.3e}, "
          f"max rel {max_rel:.3e}")
    return max_abs, max_rel


def ate(poses, gt) -> float:
    """Absolute trajectory error: RMS of the camera-centre differences (no
    alignment, as tests/test_engine.py measures it)."""
    d = poses[:, :3, 3] - gt[:, :3, 3]
    return float(np.sqrt((d * d).sum(-1).mean()))


def run_engine(tag, cfg, scene, init, n_frames, counted, idle,
               ate_must_fall=True):
    """Drive PhotometricBundleAdjustment.add_frame over the scene's first
    `n_frames` frames on the card, from the drifted poses `init`. Checks
    that every window solve launched the `counted` kernel once per LM
    iteration plus once for its initial point and never the `idle` one,
    that no solve raised its cost, and (with `ate_must_fall`) that the
    refined trajectory beats the initial one. Prints the engine's numbers and returns them, with
    the state the first window solve started from."""
    from photobundle_torch.core.engine import PhotometricBundleAdjustment

    cam, images, depths, gt = scene
    pba = PhotometricBundleAdjustment(cam, images[0].shape, cfg,
                                      device="cuda")
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
    counted.launches = idle.launches = 0
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
    launches, idle_launches = counted.launches, idle.launches
    peak = torch.cuda.max_memory_allocated() / 2**20

    expected = sum(r.iterations + 1 for r in results)
    its = [r.iterations for r in results]
    say(f"phase {tag} engine ({cfg.interpolation}, "
        f"{cfg.resolve_gradient_mode()}): {n_frames} frames "
        f"{images[0].shape[0]}x{images[0].shape[1]}, {len(results)} "
        f"windows, {pba.num_active_points} active points "
        f"(capacity {cfg.maxNumPoints}); {counted.__name__} launches "
        f"{launches} (sum of iterations + 1: {expected}), "
        f"{idle.__name__} launches {idle_launches}")
    for r in results:
        say(f"  {r.message()}, solve {r.solve_time_s * 1e3:.1f} ms")
    check(len(results) == n_frames - window_size + 1,
          f"{len(results)} window solves ran")
    check(launches == expected, f"{counted.__name__} launched {launches} "
          f"times, expected {expected}")
    check(idle_launches == 0, f"{idle.__name__} launched {idle_launches} "
          f"times")
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


def first_window_cost(pba, state, backend):
    """Initial cost and observation count of a window solve's start state,
    evaluated on `backend` (the configuration has no prior terms)."""
    from photobundle_torch.core import residuals as res_mod

    cfg = pba.cfg
    check(cfg.depthPriorWeight == 0 and cfg.motionPriorWeight == 0
          and cfg.posePriorWeight == 0, "expected a prior-free config")
    window, points = state
    point_valid = points.active & (points.obs.sum(1) >= 2)
    res = res_mod.evaluate_compressed(
        pba.camera, window.t_wc, points.x_world, points.patch,
        window.channels, window.grads, points.obs & point_valid[:, None],
        pba.offsets, cfg.robustThreshold, cfg.resolve_gradient_mode(),
        backend=backend, normalize=cfg.resolve_normalization(),
        robust_kind=cfg.robustLoss)
    return float(res.cost), int(res.n_residuals)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke test runs only on a CUDA card")
    from photobundle_torch import entry
    from photobundle_torch.config import ConfigFile, PBAConfig
    from photobundle_torch.core import lm
    from photobundle_torch.core import residuals as res_mod
    from photobundle_torch.ops import _build
    from photobundle_torch.ops import patch_bicubic as pb
    from photobundle_torch.ops import patch_warp as pw

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say(f"phase 1 device: {name} | nvidia-smi: {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # -- phase 2: build both kernels from the checkout's sources ---------
    builds = _build.build_all(["patch_warp", "patch_bicubic"])
    for built in builds.values():
        say(f"phase 2 build: {built.path.name} for sm_90a in "
            f"{built.seconds:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    print_ptxas(builds["patch_warp"])

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

    def kernel():
        return pw.patch_stats(planes, uv_nm, valid_nm, patch, pr)

    def plain():
        return pw.patch_stats_reference(planes, uv_nm, valid_nm, patch, pr)

    max_abs, max_rel = compare_with_plain(kernel(), plain(), valid_nm)
    ms = median_ms(kernel, KERNEL_CALLS)
    plain_ms = median_ms(plain, KERNEL_CALLS)
    torch.cuda.synchronize()
    say(f"phase 3 K1 vs plain at {N_PTS}x{W} obs ({int(valid_nm.sum())} "
        f"valid), R={pr}: max abs err {max_abs:.3e}, max rel err "
        f"{max_rel:.3e} (tol |d| <= {KERNEL_RTOL:g}|plain| + "
        f"{KERNEL_ATOL_ROW:g} row max) | median kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms over {KERNEL_CALLS} calls")

    # -- phase 4: the slice ----------------------------------------------
    kw = dict(huber_delta=HUBER_DELTA, gradient_mode="sampled",
              max_iterations=ITERS, function_tolerance=0.0,
              parameter_tolerance=0.0)

    def solve(backend, obs_mask=obs, **extra):
        return lm.lm_solve(cam, t_wc, x_world, patch, channels, grads,
                           obs_mask, point_valid, frozen, offsets,
                           backend=backend, **kw, **extra)

    pw.patch_stats.launches = 0
    t_out, x_out, st = solve("cuda")
    torch.cuda.synchronize()
    launches = pw.patch_stats.launches
    iters = int(st.iterations)
    c0, c1 = float(st.initial_cost), float(st.final_cost)
    logs = st.cost_log[:iters]
    say(f"phase 4 cuda solve: {iters} iterations, cost {c0:.6f} -> "
        f"{c1:.6f}, accept {st.accept_log.int().tolist()}, kernel launches "
        f"{launches}")
    check(launches == iters + 1,
          f"kernel launched {launches} times, expected {iters + 1}")
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
    say(f"phase 5 K2 build: {builds['patch_bicubic'].path.name}")
    print_ptxas(builds["patch_bicubic"])
    in_bicubic = ((uv[:, 0] >= pr + 1) & (uv[:, 0] <= WI - 3 - pr)
                  & (uv[:, 1] >= pr + 1) & (uv[:, 1] <= H - 3 - pr))
    valid_bc = (obs.T & in_front & in_bicubic).T.contiguous()   # (N, W)
    value_planes = pb.build_value_planes(channels)

    def kernel2():
        return pb.bicubic_stats(value_planes, uv_nm, valid_bc, patch, pr)

    def plain2():
        return pb.bicubic_stats_reference(value_planes, uv_nm, valid_bc,
                                          patch, pr)

    max_abs2, max_rel2 = compare_with_plain(kernel2(), plain2(), valid_bc)
    ms2 = median_ms(kernel2, KERNEL_CALLS)
    plain_ms2 = median_ms(plain2, KERNEL_CALLS)
    say(f"phase 5 K2 vs plain at {N_PTS}x{W} obs ({int(valid_bc.sum())} "
        f"valid), R={pr}: max abs err {max_abs2:.3e}, max rel err "
        f"{max_rel2:.3e} (tol |d| <= {KERNEL_RTOL:g}|plain| + "
        f"{KERNEL_ATOL_ROW:g} row max) | median kernel {ms2:.4f} ms, plain "
        f"{plain_ms2:.4f} ms over {KERNEL_CALLS} calls")

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
                      counted=pb.bicubic_stats, idle=pw.patch_stats)
    # The first window's initial cost on both backends, from the state
    # its solve started from.
    costs = {be: first_window_cost(run6["engine"], run6["first_state"], be)
             for be in ("cuda", "torch")}
    (cc, nc), (ct6, nt) = costs["cuda"], costs["torch"]
    rel6 = abs(ct6 / cc - 1)
    say(f"phase 6 first window initial cost: cuda {cc:.6f} ({nc} obs), "
        f"torch {ct6:.6f} ({nt} obs), rel diff {rel6:.3e} "
        f"(rtol {ENGINE_COST_RTOL:g})")
    check(nc == nt, "backends take different observations in the first "
          "window")
    check(rel6 <= ENGINE_COST_RTOL, f"first window cost rel diff {rel6:.3e}")
    first = run6["results"][0].initial_cost
    check(abs(cc / first - 1) <= ENGINE_COST_RTOL,
          f"first window cost {cc:.6f} differs from its solve's initial "
          f"cost {first:.6f}")

    # -- phase 7: the engine, default configuration (K1) -----------------
    run_engine("7", PBAConfig(), scene, drifted, DEFAULT_FRAMES,
               counted=pw.patch_stats, idle=pb.bicubic_stats,
               ate_must_fall=False)

    print(json.dumps({"kernels": [
        {"name": "patch_stats", "route": "cuda",
         "source": "photobundle_torch/csrc/patch_warp.cu",
         "replaces": "photobundle_tpu/ops/patch_warp.py:350",
         "launches": launches, "max_abs_err": max_abs, "ms": ms,
         "plain_ms": plain_ms},
        {"name": "bicubic_stats", "route": "cuda",
         "source": "photobundle_torch/csrc/patch_bicubic.cu",
         "replaces": "photobundle_tpu/ops/patch_warp.py:176",
         "launches": run6["launches"], "max_abs_err": max_abs2, "ms": ms2,
         "plain_ms": plain_ms2},
    ]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
