#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Drives the port's main path (one sliding-window LM + Schur solve through
the fused patch-stats CUDA kernel) at the repository's full-size window:
4096 points x 5 frames x 5x5 patches on 370x1226 images, C = 1, random
synthetic problem from a seed. Phases:

  1. the card: torch's device name, and nvidia-smi's name and power limit;
  2. build: the kernel compiled from photobundle_torch/csrc/patch_warp.cu;
  3. kernel vs its plain PyTorch version on the solve's own inputs, with
     the median time of each;
  4. the slice: lm_solve(backend="cuda"), 8 fixed iterations; the kernel's
     launch count over that run; then the same solve on the plain torch
     backend, LM iterations/s of both, and a parity solve of the two.

Prints a JSON line of kernel results, the card's name and power limit,
and, as the last line, {"ok": true, "device": {...}}. Any failed phase
raises and exits non-zero without that line. Needs a CUDA card: without
one it exits non-zero before doing anything.
"""

import json
import statistics
import subprocess
import time

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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke test runs only on a CUDA card")
    from photobundle_torch import entry
    from photobundle_torch.core import lm
    from photobundle_torch.core import residuals as res_mod
    from photobundle_torch.ops import _build
    from photobundle_torch.ops import patch_warp as pw

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say(f"phase 1 device: {name} | nvidia-smi: {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # -- phase 2: build the kernel from the checkout's source ------------
    built = _build.library("patch_warp")
    say(f"phase 2 build: {built.path.name} for sm_90a in "
        f"{built.seconds:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")

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
    planes = res_mod.make_cuda_ctx(channels, grads)

    def kernel():
        return pw.patch_stats(planes, uv_nm, valid_nm, patch, pr)

    def plain():
        return pw.patch_stats_reference(planes, uv_nm, valid_nm, patch, pr)

    got, want = kernel(), plain()
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
    ms = median_ms(kernel, KERNEL_CALLS)
    plain_ms = median_ms(plain, KERNEL_CALLS)
    torch.cuda.synchronize()
    say(f"phase 3 kernel vs plain at {N_PTS}x{W} obs ({int(v.sum())} "
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
    say(f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f}"
        f" MiB")

    print(json.dumps({"kernels": [{
        "name": "patch_stats",
        "route": "cuda",
        "source": "photobundle_torch/csrc/patch_warp.cu",
        "replaces": "photobundle_tpu/ops/patch_warp.py:350",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
