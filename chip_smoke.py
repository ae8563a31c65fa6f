#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Drives the port's paths at the repository's full size (370x1226 images,
4096 points, 5-frame window, 5x5 patches, C = 1 but for phase 20's
descriptors and the shipped configurations' own sizes), from seeds:

  1. the card: torch's device name, and nvidia-smi's name and power limit;
  2. build: the eight kernel sources compiled from photobundle_torch/csrc/
     (one nvcc per source, started together; the build time), ptxas
     registers and spills;
  3. kernel K1 (csrc/patch_warp.cu) vs its plain PyTorch version on a
     synthetic window solve's own inputs, with the median time of each and
     its device time cold and warm; then the same problem at wider patch
     radii (phases 3, 5, 8 and 9 there): K1 at R = 6, 9, 10 and 19 vs its
     plain version in every normalization, the sorted entry bitwise K1;
     K2 at R = 6, 9, 10, 12, 19 and 25 and K3 at R = 6 and 9, and both on
     both sides of their design's crossover radius, vs their plain
     versions in every normalization and bitwise their one-thread design
     with a run-time radius;
  4. one window solve: lm_solve(backend="cuda"), 8 fixed iterations, as
     CUDA graph replays (core/lm.py) from a cold key: K1's launch count
     over that run and the LM body's own kernels (the ordered sums of
     ops/ordered_sum, the Cholesky solve of ops/chol_solve, once per
     body), captured with it, the call's time cold and warm, the key's
     graphs' device memory; the same solve with capture=False (the same body in
     the eager host loop): the same iterations, accept log and
     termination, costs within GRAPH_RTOL, and whether the two are
     bitwise equal (else the first field that differs); K1's device time
     per launch inside the solve (L2 as the solve leaves it) and its
     traced launches against the count (the fullest of up to 5 traces);
     for both, LM iterations/s, host
     syncs per solve and the card's idle share over one solve; a sweep of
     lm.LM_READBACK over the fixed solve and two that end early; then the
     torch backend, LM iterations/s of both backends, and a parity solve
     of the two; last, `photobundle_torch.bench` (the port's twin of
     bench.py) in this process, its JSON line printed on a phase line;
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
     K1) over 8 frames, then one frame traced (the card's busy time and
     idle share) and one with its host syncs counted, (7b) at patchRadius=5 over 6 frames (K1 alone)
     and (7c) the reference-exact configuration at patchRadius=12 over 6
     frames (K2's runtime-radius instance alone);
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
     time per launch sorted and unsorted, the sort's own ms, the blocks
     by branch (union box, own windows, gathered), the bound; then at
     both sizes bitwise K1 at SORTED_RADII with C = 1 and 3 (the frames'
     channels scaled by 0.5 .. 1.5), the blocks by branch of each;
 12. the command line on a KITTI-format sequence at 370x1226: phase 6's
     scene written as 12 stereo PNG pairs (the port's stdlib PNG writer),
     calib.txt, times.txt, poses/00.txt and a drifted VO input, refined
     in configs/kitti_production.cfg (BM stereo with 128 disparities on
     the card, the speckle filter, 3-level coarse-to-fine, motion and pose
     priors; dataDir, numFrames, maxNumPoints=4096 and a depth cache,
     CLI_DEPTH_CACHE, as key=value overrides) three times: `python -m
     photobundle_torch.cli` as a subprocess with PB_SORTED_DISPATCH=1
     (computing the stereo and writing the cache), then cli.main in this
     process with it (launch counts checked) and without it (both reading
     the cache). The three trajectory
     files must be byte-identical, every window's cost non-increasing and
     the refined ATE below the input's. First the dataset alone: the depth
     producer dataLoader=auto takes (the native host runtime where it
     builds, else the torch matcher; the build error is printed),
     dataLoader=native running the runtime or raising where it does not
     build, and the dataset's ms per frame for each producer (over
     DATASET_FRAMES frames, 3 for the torch matcher); then the
     card's stereo time per frame (BM, and SGM once) and the host speckle
     filter's (Python, and native where it builds);
 13. K4's sample store and K6 (csrc/patch_samples.cu, the 'rows', 'block'
     and 'raw' layouts of ops/patch_samples) against their plain versions
     on phase 3's inputs, bitwise, and at R = 9, 10 and 19 too; beside
     them the one PyTorch call that computes each layout's function
     (F.grid_sample for rows and block, an advanced-indexing window gather
     for raw: `library_ms`, with grid_sample's largest difference from
     the plain samples); the four
     `warp_patches` variants against each other; then phase 4's solve
     with PB_GROUPED_STATS=0 (the unfused path): the row store launched
     once per LM iteration plus once and no other kernel, its damped
     interior parity solve within SOLVE_RTOL of the fused one, LM it/s of
     both; and the unfused solve at R = 5 (the row store alone,
     Σ(iterations + 1) launches);
 14. K7 (csrc/patch_stats.cu, ops/patch_stats) through its entry point in
     both modes on phase 3's inputs: cost_only's rr bitwise the full
     mode's, K7's sums against K1's mean-mode sums, each mode against its
     plain version and bitwise its first design (one thread, a run-time
     radius); the same at R = 5, 9, 10 and 19 on phase 3's problem at
     that radius, and at R = 62, the reference's widest patch, on 512
     points (the plain version's windows take 254 KB per observation);
 15. the tools in this process: `bench_warp_kernel` at phase 3's size and
     `ablate_patch_stats` at 4096 and 65 536 points (full/own bitwise K1),
     K8's full/own bitwise K1 at 64, 128 and 256 threads with its device
     time beside K1's, then each K8 variant (csrc/patch_ablate.cu, stage x
     window, 64 threads) against its plain version on phase 3's inputs
     (the partial stages bitwise);
 16. batched windows (core/batched.py): K1's batch axis on phase 3's
     inputs stacked for B = 4 windows (window b's uv shifted b x 0.37 px)
     against its plain version and bitwise 4 single-window launches at R
     = 2, 9 and 19, its device time at B = 1, 2 and 4; the batch axes of
     K2, K3, K5 (K3's affine mode), K4's row store and sorted K1 on the
     same windows (each inside its own margins; K3's scales phase 8's
     draw; sorted K1's order each window's own), each bitwise 4
     single-window launches at R = 2 and at its wide radius (AXES: 19,
     9, 9, 19, 19; sorted K1 also at SORTED_RADII with C = 1 and 3, and
     bitwise K1's batch axis on the same windows), then at B = 3 against
     its plain version and timed,
     and its device time at B = 1, 2, 3 and 4 beside its bound; the LM
     body's own kernels: the batched Cholesky solve (csrc/chol_solve.cu)
     at W = 5, 10, 32 and B = 1, 4, 8 against its plain version
     (cholesky_ex + cholesky_solve) within 1e-4 of the solution's scale,
     bitwise its single-window launches, NaN in the one non-SPD window
     alone, timed beside `torch.linalg.solve` (and at B = 1 beside
     cholesky_ex + cholesky_solve); every ordered sum
     (csrc/ordered_sum.cu) of one eager body at B = 4 against its plain
     version and bitwise its kernel-order twin (`row_dot_ordered`), timed
     beside torch's sum / matmul, and so one body's ordered sums at
     65 536 x 5 and 32 768 x 32 (B = 1) against their plain versions; the
     body's aten operations at B = 1 and 4, equal; then the
     batched engine in the default configuration, 8 frames, B = 4
     sequences, sequence k phase 6's frames shifted k px and brightened
     0.001 k and drifted from its own seed (k + 1): every batched
     ingest's result, sequence by sequence, bitwise the single engine's
     `_ingest` from that sequence's slice of the state; the windows
     against B single engines fed the same frames (equal frame ids and
     point counts, poses within 1e-3, final costs within 1e-3 relative:
     the reference's oracle, tests/test_engine.py:376-385; and bitwise:
     poses, points, final cost), K1 launched once per evaluation for the
     whole batch (the batched solve's replays + 1, + 2 per cold key), the
     Cholesky kernel once per body and the ordered sums launched;
     host syncs per batched solve, the cold key's warm-up + capture ms,
     its graphs' memory and the card's idle share over a warm batched
     solve per B; the batched ingest at B = 1, 2, 4 and 8 into full
     rings, warm, beside one and B single ingests: ms (CUDA events),
     device activities and launch calls (torch.profiler), host syncs,
     each the same at every B (in a child process, `chip_smoke.py
     ingest-cost`, whose traces are whole); then `tools/bench_batched`
     in this process at B = 1 and 4; last the batched engine at B = 3 on
     the same sequences over 6 frames (two window solves) beside 3 single
     engines in each configuration that runs one of those batch axes
     (AXIS_CONFIGS: configs/reference_exact.cfg, patchWarp=scale, with
     patchNormalization=affine too, PB_GROUPED_STATS=0,
     PB_SORTED_DISPATCH=1, each variable set for its run alone): every
     window's poses, points and final cost bitwise the single engine's,
     its kernel launched once per evaluation for the whole batch and no
     other kernel or mode;
 17. multi-sequence refinement: `python -m photobundle_torch.multi` on
     phase 12's KITTI-format sequence in configs/kitti_production.cfg,
     units of 6 frames, with 2 spawned workers and then 1 inline, both
     reading phase 12's depth cache: the merged trajectories
     byte-identical;
 18. device meshes (parallel/mesh.py, parallel/sharded.py) on the one
     card: (a) NCCL at world size 1 in this process, captured:
     ShardedLMSolver (points = 1) on phase 3's problem and the engine's
     wrapper on a window of phase 6's scene, each bitwise the unsharded
     captured solve, K1 launched as its replays count, the collectives per
     body and ms per solve beside the unsharded solve's; (b) two gloo
     ranks sharing the card (this script run as `chip_smoke.py mesh-rank
     <k> <port>`), capture=False: points = 2 on phase 3's problem, frames
     = 2 x points = 1 on a 4096 x 4 instance (both on phase 4's parity
     observations from a start damped by MESH_LAMBDA), the engine with
     meshPoints = 2 (default configuration, phase 6's scene, 8 frames)
     and the batched engine with meshWindows = 2 (B = 2): every output
     bitwise equal across the ranks, the solves within tests/
     test_sharding.py's tolerances of the single-rank solve (poses 1e-4,
     points 1e-3, cost 1e-3, equal iterations), the engine within 5e-5 of
     the single engine, each batched window bitwise its single engine;
     and the witness that MESH_LAMBDA's damping hides no fault of the
     layouts: both solves again from phase 4's start (lambda 1), in f64
     (plain evaluation) within 1e-8 of the single-rank f64 solve, the
     f32 differences from that start printed beside them;
 19. the remaining tools on the card (photobundle_torch/tools), in this
     process but for verify_e2e's command line and the breakdown: (a)
     `bench_lm_breakdown` in one process of its own at 4096 (and the body
     at B = 4 windows beside it: as many kernels per body) and 65 536
     points x 5, and in another at 32 768 points x 32: each phase's ms
     (CUDA events) and
     device ms against its bytes floor (none below it), each phase
     bitwise the outputs of one capture=False body on that body's
     inputs, and the body's per-phase device time, kernel count and
     heaviest kernels (torch.profiler) beside the replayed body's median
     time, each of its two traces holding one device activity per launch
     of the body; (b) `probe_eval65k` at 65 536 x 5, stage by stage; (c)
     `verify_e2e`: `python -m photobundle_torch.cli` on its synthetic
     sequence, VERIFY OK; (d) the golden: GOLDEN_FRAMES frames of the box
     room at 370x1226 rendered on the card (torch renderer; frame 0 held
     to the numpy renderer within tests/test_torch_golden.py's bounds),
     `golden_kitti` with the iid error model in W5_production (K1) and
     reference_exact (K2): every window's cost non-increasing, K1 and K2
     launched, W5_production's refined ATE below the input's, and each
     reference_exact window solved again from its pre-solve state on the
     plain backend: the same observations, the initial cost within 1e-5
     and K2's final cost at most 2 % above the plain one; then
     `golden_aggregate` on its printed table, `diagnose_rpe`,
     `eval_traj` and `plot_traj` (where matplotlib is installed) on its
     output; (e) `bench_keyframes`, `bench_sampling` and `bench_scaling`
     at their JAX twins' sizes (bench_scaling at three of its six). It
     prints its wall time;
 20. the shipped configurations no earlier phase runs, through cli.main on
     phase 12's sequence, each as shipped but for dataDir and numFrames
     (SHIPPED_CONFIGS: kitti_stereo, kitti_large_window (12 frames, three
     windows of ten poses, 8192 points), kitti_sgbm_bicubic (SGBM stereo,
     K2), kitti_minimum_slice (R = 1), 8 frames each but the wide one):
     (A) each with solverBackend=cuda and with solverBackend=torch: every
     pose finite, every window's cost non-increasing, the configuration's
     kernel launched once per evaluation of every solve on the cuda run and
     no kernel on the torch run, both runs' first windows from bitwise the
     same state and its initial cost within ENGINE_COST_RTOL on the two
     backends; under pipelineResults (kitti_stereo, kitti_large_window) the
     trajectory file byte-identical to a run with pipelineResults=False
     (the card's non-blocking result fetch); per run the wall s, dataset
     and stereo ms per frame, window-solve ms, LM iterations, ATE, peak
     device memory and the card; (B) K1 with the IntensityAndGradient (C =
     3) and BitPlanes (C = 8) descriptors at R = 2 and 19 and K2 with C = 3
     at both, each against its plain version at 4096 x 5 with its bound,
     each C-channel launch bitwise the sum, from zeros in channel order,
     of its C one-channel launches (every normalization), a B = 2 launch
     at C = 3 bitwise its two single launches (hashes printed), then the
     engine over 8 frames of phase 6's scene with each descriptor (K1)
     and in kitti_sgbm_bicubic.cfg's settings with C = 3 (K2), each first
     window held across backends, with a hash of its refined poses;
 21. se3 on the card (geometry/se3.py, whose small-angle sin and cos are
     taken in f64 and rounded to f32 on every device): se3_exp and
     se3_log over SE3_TWISTS twists at rotation angles SE3_ANGLES, held to
     the port's CPU result (equal NaN rows; max |d| printed and held to
     SE3_EXP_ATOL and SE3_LOG_ATOL), and how many of the card's f32 sin
     and cos of those angles differ from the f64 values rounded.

Each phase prints its time ("phase N took ... s").

Each kernel comparison reports the kernel's and the plain version's median
time per call (CUDA events), the kernel's device time per launch
(torch.profiler, with L2 flushed before each launch) and its bound on this
card, computed from the run's inputs (bytes at the HBM rate, f32
operations at the f32 rate), and fails if a measured time is below the
bound's floor: the bound less the output bytes that L2 can still hold,
dirty, when the kernel ends. Every engine run zeroes the
launch counts just before it and checks, just after, that its kernel ran
in its normalization mode once per evaluation of every solve and that no
other kernel or mode ran (phase 12: the sorted kernel in every solve of
every level, K1 twice per window for the coarse-to-fine guard).

Solves run as CUDA graph replays, and a wrapper counts a launch when the
graph that captured it replays (core/lm.py). The identity every check
holds: a kernel run once per evaluation launches, per solve, its body
replays + 1 (the start evaluation) times, plus 2 per cold graph key (its
warm-up runs one start and one body before the capture). The replays
are the solve's iterations, and past an early end the no-op bodies up to
the next host read of the termination code (none with lm.LM_READBACK =
1); `expected_launches` computes it from lm.runs.

Prints a JSON line of kernel results, the card's name and power limit,
and, as the last line, {"ok": true, "device": {...}}. Any failed phase
raises and exits non-zero without that line. Needs a CUDA card: without
one it exits non-zero before doing anything.
"""

import hashlib
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
# The captured solve against the same body in the eager host loop: the same
# kernels on the same inputs, so equal but for a library's choice of
# algorithm inside a capture.
GRAPH_RTOL = 1e-6
# Phase 4's sweep of lm.LM_READBACK (bodies between two host reads of the
# termination code): the fixed-length solve and solves that end early, at
# the engine's default tolerances and at a looser function tolerance.
READBACKS = (1, 2, 4, 8)
EARLY_SOLVES = ((1e-6, 1e-8), (1e-3, 1e-8))      # (function, parameter)
EARLY_MAX_ITERATIONS = 50
READBACK_ROUNDS = 4
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
# Sorted K1 held bitwise to K1 (phase 11, at N_PTS and DENSE_PTS) and to
# its single launches and K1's batch axis (phase 16, B = BATCH_KERNEL) at
# these radii and channel counts: each branch of its design (own windows,
# union box, gathered) and the runtime radius.
SORTED_RADII, SORTED_CHANNELS = (1, 2, 3, 4, 10, 19), (1, 3)
# Phase 21: se3 on the card over twists at rotation angles SE3_ANGLES
# (log-uniform; se3_log's NaN band 1e-4 to 2.44e-4 and the cancelling
# range above it), held to the port's CPU result: se3_exp within
# SE3_EXP_ATOL, se3_log within SE3_LOG_ATOL, equal NaN rows.
SE3_TWISTS, SE3_ANGLES, SE3_SEED = 20000, (1e-5, 0.3), 21
SE3_EXP_ATOL, SE3_LOG_ATOL = 1e-6, 1e-4
# Wider patches, held to their plain versions in phases 3 (K1), 5 (K2),
# 8 (K3) and 9 (their affine modes), in every normalization: the rolled
# rows (6, 9) and, for K1, sorted K1 and K2, the runtime-radius instances
# past 9 (K2 to past the fixed grid's 19); K2 and K3 also, in the modes
# concerned, on both sides of every radius where their design changes
# (`design` of ops/patch_bicubic and ops/patch_scaled).
K1_WIDE_RADII = (6, 9, 10, 19)
K2_WIDE_RADII = (6, 9, 10, 12, 19, 25)
K3_WIDE_RADII = (6, 9)
WIDE_CALLS = 10                  # calls per median at the wider radii
ENGINE_WIDE_RADIUS = 12          # phase 7c: reference exact past R = 9
WIDE_ENGINE_RADIUS = 5                      # phase 7b's wide-patch engine
BENCH_CALLS, ABLATE_CALLS = 50, 64          # phase 15's tools (their K)
# Phase 13: the sample store held bitwise to its plain version at these
# radii (the compile-time instances' largest, the runtime-radius instance,
# the fixed-grid limit) besides R = 2, and the unfused solve at a radius
# past the store's earlier 1..4.
STORE_WIDE_RADII = (9, 10, 19)
UNFUSED_RADIUS = 5
# Phase 14: K7 besides R = 2 at its rolled rows (5, 9), its runtime-radius
# instance (10, 19) and, on fewer points, at the reference's widest patch.
K7_WIDE_RADII = (5, 9, 10, 19)
K7_WIDEST_PTS = 512
# Phase 12: the sequence, the CLI runs' time limit, and the frames the
# dataset alone is timed over (dataLoader=auto; the runs read all 12).
CLI_FRAMES, CLI_TIMEOUT_S, DATASET_FRAMES = 12, 600, 4
# Phase 16: the batch-axis K1 at B windows and these radii; the batched
# engine at these batch sizes, held to single engines within the bounds
# of the reference's oracle (tests/test_engine.py:376-385); the batched
# bench tool at its batch sizes (the engine at B = 2 and the bench at B =
# 2 and 8 cut to keep the script's time: the ingest runs B = 1-8).
BATCH_KERNEL, BATCH_RADII, BATCH_SHIFT_PX = 4, (2, 9, 19), 0.37
BATCH_SIZES, BENCH_BATCHES = (4,), (1, 4)
BATCH_POSE_ATOL, BATCH_COST_RTOL = 1e-3, 1e-3
# Phase 16's other batch axes, each held at R = 2 and at its wide radius
# (label: wide radius; K2's, K3's and the row store's and sorted K1's
# widest instances but K3's, whose limit is 9), and the batched engine at
# B = ENGINE_BATCH over W + 1 frames (two window solves) in each
# configuration that runs one of them (label: (configuration, its
# environment), the label naming the wrapper and mode it launches).
AXES = {"bicubic_stats": 19, "scaled_stats": 9, "scaled_stats/affine": 9,
        "warp_patches/rows": 19, "sorted_patch_stats": 19}
ENGINE_BATCH = 3
# Each axis's source and the line of the JAX kernel body it replaces in
# photobundle_tpu/ops/patch_warp.py (sorted K1: K1's body with sort_reuse).
AXIS_SOURCES = {"bicubic_stats": ("patch_bicubic.cu", 176),
                "scaled_stats": ("patch_scaled.cu", 775),
                "scaled_stats/affine": ("patch_scaled.cu", 613),
                "warp_patches/rows": ("patch_samples.cu", 100),
                "sorted_patch_stats": ("patch_warp.cu", 393)}
AXIS_CONFIGS = {
    "bicubic_stats": ("configs/reference_exact.cfg", {}),
    "scaled_stats": (dict(patchWarp="scale"), {}),
    "scaled_stats/affine": (dict(patchWarp="scale",
                                 patchNormalization="affine"), {}),
    "warp_patches/rows": ({}, {"PB_GROUPED_STATS": "0"}),
    "sorted_patch_stats": ({}, {"PB_SORTED_DISPATCH": "1"}),
}
# Phase 16's sequence k: phase 6's frames shifted left by k px and
# brightened by BATCH_BRIGHTEN x k; the batched ingest's cost at
# INGEST_BATCHES, warm, each number the median of INGEST_CALLS calls.
BATCH_BRIGHTEN, INGEST_BATCHES, INGEST_CALLS = 0.001, (1, 2, 4, 8), 5
# Phase 16: the LM body's own kernels (ops/chol_solve, ops/ordered_sum).
# The batched Cholesky solve at these window sizes (systems of 6W) and
# batch sizes against its plain version (cuSOLVER through
# torch.linalg.cholesky_ex / cholesky_solve) within CHOL_RTOL of the
# solution's largest entry (systems m m^T / 6W + I: condition ~5), window
# CHOL_BAD of every batch of more than two not positive definite; the
# ordered sums of one eager batched body at BODY_BATCH windows against
# their plain versions within ORDERED_RTOL of each output's sum of
# absolute terms (both f32, summed in other orders); the body's aten
# operations at B = 1 and BODY_BATCH.
CHOL_WINDOWS, CHOL_BATCHES = (5, 10, 32), (1, 4, 8)
CHOL_BAD, CHOL_RTOL = 2, 1e-4
BODY_BATCH, ORDERED_RTOL, ORDERED_CALLS = 4, 1e-5, 20
# One body's ordered sums are also held and timed at these sizes (points,
# poses; B = 1): phase 11's 65 536 points and bench_scaling's widest
# window. Their plain versions are taken over slices of rows, no products
# tensor past ORDERED_SLICE elements (s_off at 32 768 x 32 would be 3.6e9).
ORDERED_SIZES = ((65536, 5), (32768, 32))
ORDERED_SLICE = 1 << 28
# Phase 17: the multi-sequence runs' units and their time limit.
MULTI_FRAMES_PER_UNIT, MULTI_TIMEOUT_S = 6, 600
MULTI_DIR = os.path.join("build", "chip_smoke_multi")
CLI_DIR = os.path.join("build", "chip_smoke_cli")
# The depth cache (depthCacheDir) of phase 12's command-line runs: run (a)
# computes and writes every frame's stereo depth, runs (b) and (c) and
# phase 17's read it (the host speckle filter takes ~0.7-1 s a frame on
# the card's machine; phase 20's runs compute their own stereo).
CLI_DEPTH_CACHE = os.path.join(CLI_DIR, "depth")
# Phase 18: device meshes. Two gloo ranks share the card (NCCL refuses two
# ranks on one device); their solves are held to the single-rank solve
# within tests/test_sharding.py's tolerances, on phase 4's parity
# observations from a start damped by MESH_LAMBDA: the slice problem's
# point depths are near-null directions (baselines of ~1 cm at 4-30 m),
# which amplify summation-order differences between layouts (from an
# initial lambda of 1 single points end ~1-2 cm apart in f32; from 100,
# 6e-5 on the CPU); the engine within that file's 5e-5. The witness that
# the layouts are right from lambda 1 too: the same solves in f64 within
# MESH_F64_TOL of the single-rank f64 solve (~7e-11 on the CPU).
MESH_DIR = os.path.join("build", "chip_smoke_mesh")
MESH_RANKS, MESH_TIMEOUT_S, MESH_TIMED, MESH_LAMBDA = 2, 600, 3, 100.0
MESH_F64_TOL = 1e-8
MESH_POSE_TOL, MESH_POINT_TOL, MESH_COST_RTOL = 1e-4, 1e-3, 1e-3
MESH_ENGINE_ATOL, MESH_FRAMES_W = 5e-5, 4
# Phase 19: the tools. The golden's sequence length (its stereo runs the
# host speckle filter, ~0.7 s a frame on the card's machine; 24 frames
# until phase 20 took the time: 16 still reach the box room's turn) and
# where its files go.
TOOLS_DIR = os.path.join("build", "chip_smoke_tools")
GOLDEN_FRAMES = 16
# bench_lm_breakdown's calls per phase at 4096 points: its default (the
# JAX tool's 1024) spends ~30 s of host time on event-timed calls; 256
# average as well.
BREAKDOWN_CALLS = 256
BREAKDOWN_TIMEOUT_S = 420
# Its sizes (points, poses, calls per phase at most), by child process:
# phase 3's and phase 11's 65 536 points in one; bench_scaling's widest
# window (fewer calls: a body there takes ~5 ms) in one of its own, as
# after the other two a process's traces of it missed one activity of
# 539 (two traces, one whole run).
BREAKDOWN_PROCESSES = (((N_PTS, W, BREAKDOWN_CALLS),
                        (DENSE_PTS, W, BREAKDOWN_CALLS)),
                       ((32768, 32, 30),))
GOLDEN_CONFIGS = ("W5_production", "reference_exact")
# bench_scaling's smallest, widest-point and widest-window sizes of its six
# (all six until phase 20 took the time).
SCALING_SIZES = "4096x5,65536x5,32768x32"
# reference_exact's window solves (K2) against the plain backend's from the
# same states: the initial costs agree within GOLDEN_INIT_RTOL, and the
# final cost may exceed the plain solve's by GOLDEN_COST_RTOL. The scale
# of its windows is free (one fixed pose, no prior), so the solves end at
# the function tolerance a few iterations apart in a flat valley (the
# port against the JAX package from the same states on the CPU: 2.3 %
# below to 0.68 % above, tests/test_torch_golden.py), and the chain's
# poses part from there: no bound on its ATE is held.
GOLDEN_INIT_RTOL, GOLDEN_COST_RTOL = 1e-5, 2e-2
# Phase 20: the shipped configurations no earlier phase runs, through
# cli.main on phase 12's sequence, as shipped but for dataDir and
# numFrames (kitti_large_window: three windows of ten poses; the others:
# DEFAULT_FRAMES, four windows of five), on both backends; then K1 with the
# three- and eight-channel descriptors (IntensityAndGradient, BitPlanes)
# at these radii, K2 with the three-channel one, and the engine with each.
SHIPPED_CONFIGS = ("kitti_stereo", "kitti_large_window", "kitti_sgbm_bicubic",
                   "kitti_minimum_slice")
SHIPPED_FRAMES = {"kitti_large_window": 12}
SHIPPED_DIR = os.path.join("build", "chip_smoke_shipped")
DESCRIPTORS = ("IntensityAndGradient", "BitPlanes")
DESCRIPTOR_RADII = (2, 19)
# Every kernel source of photobundle_torch/csrc/, built together in phase 2.
SOURCES = ("patch_warp", "patch_bicubic", "patch_scaled", "patch_samples",
           "patch_stats", "patch_ablate", "ordered_sum", "chol_solve")
# One NVIDIA H100 SXM: HBM bandwidth and f32 rate outside the tensor
# cores (photobundle_torch/tools). Bounds take bytes at the HBM rate, so
# device times are taken with the 50 MB L2 flushed before each launch
# (every input then comes from HBM): a warm L2 serves a kernel's inputs
# faster than HBM.
from photobundle_torch.tools import H100_BYTES_PER_S, H100_F32_FLOPS  # noqa: E402
# L2 is write-back: a kernel may end with up to this much of its output in
# L2, written to HBM after its end, so its device time can undercut the
# bound (each output written once at the HBM rate) by that much.
H100_L2_BYTES = 50 << 20
L2_FLUSH_BYTES = 256 << 20        # written between timed launches
# Operations per patch pixel (multiplies and adds, counted once each):
# sampling value, d/dx and d/dy (bilinear: 3 planes x 4 taps; scaled:
# 3 planes x two row blends and one column blend; bicubic: the separable
# 4-tap filters, rows amortized over the patch), then the epilogue
# (off: residual and six products; mean: plus the three means and
# centring; affine: plus the norm, the projection and two divisions).
SAMPLE_FLOPS = {"bilinear": 21, "scaled": 27, "bicubic": 43}
NORM_FLOPS = {"off": 13, "mean": 20, "affine": 36}
# K7's cost_only mode per patch pixel: the value's bilinear sample (4
# products, 3 sums), its mean, centring, the descriptor and r^2.
K7_COST_FLOPS = 12
# K8's stages (ops/patch_ablate), per patch pixel: 'loads' per window
# texel (two sums and the running sum), 'combine' the bilinear sample and
# three sums, 'subtract' one more, 'center' the means and the centred
# sums, 'full' K1's mean mode.
ABLATE_FLOPS = {"loads": 3, "combine": 24, "subtract": 25, "center": 31,
                "full": 41}
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


_flush_buffer = []


def flush_l2(read: bool = False) -> None:
    """Evict the card's L2: write L2_FLUSH_BYTES (five times its 50 MB), so
    the next kernel reads its inputs from HBM; with `read`, read them
    instead (sum), so that L2 holds clean lines, none dirty to write
    back."""
    if not _flush_buffer:
        _flush_buffer.append(torch.zeros(L2_FLUSH_BYTES // 4,
                                         dtype=torch.float32, device="cuda"))
    if read:
        _flush_buffer[0].sum()
    else:
        _flush_buffer[0].zero_()


def device_us_per_launch(fn, calls: int = PROFILED_CALLS, match="stats",
                         tries: int = 3, flush=True):
    """Device time per launch of the port's kernels (the card's activities
    whose name holds `match`, in a torch.profiler trace), averaged over the
    launches the trace holds, of `calls` calls of fn after one warm-up
    call, with L2 flushed before each call (the flush's own kernel is not
    counted; `flush="read"`: by reading, `flush_l2(read=True)`;
    `flush=False`: back to back, warm). A trace may miss launches:
    it is taken again, up to `tries` times, until it holds all of them.
    None if no trace has device time. Self-contained (kernel_times.py times
    older checkouts with it)."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                if flush:
                    flush_l2(read=flush == "read")
                fn()
            torch.cuda.synchronize()
        evts = [evt for evt in prof.key_averages()
                if evt.device_type == DeviceType.CUDA and match in evt.key]
        total = sum(evt.self_device_time_total for evt in evts)
        launches = sum(evt.count for evt in evts)
        if launches >= calls:
            break
    return total / launches if total > 0 else None


def library_us_per_call(fn, calls: int = PROFILED_CALLS, tries: int = 3):
    """Device time per call of one PyTorch call (every kernel it launches,
    in a torch.profiler trace), L2 flushed by writing before each call as
    `device_us_per_launch` does (the flush's fill kernel is not counted).
    Returns (µs per call or None, the kernels' names). A trace may miss
    launches: it is taken again, up to `tries` times, until each kernel
    appears `calls` times."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                flush_l2()
                fn()
            torch.cuda.synchronize()
        evts = [evt for evt in prof.key_averages()
                if evt.device_type == DeviceType.CUDA
                and "FillFunctor" not in evt.key]
        if evts and min(evt.count for evt in evts) >= calls:
            break
    total = sum(evt.self_device_time_total for evt in evts)
    names = [evt.key.split("(")[0][:60] for evt in evts]
    return (total / calls if total > 0 else None), names


def us_text(us) -> str:
    return "not measured" if us is None else f"{us:.2f} us"


def gpu_clocks() -> str:
    """The card's SM clock, its maximum, and its power draw, now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_instances(log: str) -> dict:
    """{(kernel, template arguments): (registers, spill-store bytes)} of
    every kernel instance in a `ptxas -v` log, its integer and bool
    template arguments as written ("2,1,true")."""
    table, current = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:entry function '|Function properties for )"
                      r"\w*?([a-z_]+_kernel)I((?:L[ib]\d+E)+)E", line)
        if m:
            args = ",".join(
                ("true" if v == "1" else "false") if t == "b" else v
                for t, v in re.findall(r"L([ib])(\d+)E", m.group(2)))
            current = (m.group(1), args)
            table.setdefault(current, (None, None))
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


def ptxas_table(log: str) -> dict:
    """{(kernel, R, normalization code): (registers, spill-store bytes)} of
    every kernel instance <R, NORM> in a `ptxas -v` log (`ptxas_instances`;
    a kernel templated on R alone, with the normalization a runtime
    argument, is listed with code None; K1's single-channel instances,
    <R, NORM, true>, as '<kernel>[C=1]')."""
    table = {}
    for (kernel, args), cell in ptxas_instances(log).items():
        vals = [{"true": "1", "false": "0"}.get(v, v)
                for v in args.split(",")]
        if len(vals) > 2 and vals[2] == "1":
            kernel += "[C=1]"
        table[(kernel, int(vals[0]),
               int(vals[1]) if len(vals) > 1 else None)] = cell
    return table


def print_ptxas(name: str, built, radii) -> None:
    """One line per kernel and normalization mode: registers / spill-store
    bytes for each of `radii` (nothing if the library was not built in
    this process)."""
    from photobundle_torch.ops import _common

    table = ptxas_table(built.log)
    for kernel in sorted({k for k, _, _ in table}):
        for code, norm in enumerate(_common.NORMS):
            cells = [table.get((kernel, r, code), (None, None))
                     for r in radii]
            say(f"  ptxas {name} {kernel} {norm}: registers/spill bytes for "
                f"R = {radii[0]}..{radii[-1]}"
                f"{' (0: the runtime-radius instance)' if radii[0] == 0 else ''}"
                f": " + ", ".join(f"{g}/{b}" for g, b in cells))


def print_ptxas_instances(name: str, built) -> None:
    """One line: registers / spill-store bytes of every kernel instance of
    a library, by its template arguments (nothing if the library was not
    built in this process)."""
    cells = [f"{k}<{a}> {g}/{sp}"
             for (k, a), (g, sp) in sorted(ptxas_instances(built.log).items())]
    say(f"  ptxas {name} registers/spill bytes: {'; '.join(cells)}")


def print_ptxas_typed(name: str, built) -> None:
    """One line: registers / spill-store bytes of each f32 (f) and f64 (d)
    instance of a library whose kernels are templated on their type (the
    LM body's, csrc/ordered_sum.cu and csrc/chol_solve.cu; nothing if the
    library was not built in this process)."""
    cells, current = {}, None
    for line in built.log.splitlines():
        m = re.search(r"(?:entry function '|Function properties for )"
                      r"\w*?\d(chol_solve\w*?|row_dot_\w+?)I([fd])"
                      r"((?:L[ib]\d+E)*)E", line)
        if m:
            args = ",".join([m.group(2), *re.findall(r"L[ib](\d+)E",
                                                      m.group(3))])
            current = f"{m.group(1)}<{args}>"
            cells.setdefault(current, [None, None])
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            cells[current][1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cells[current][0] = int(m.group(1))
    say(f"  ptxas {name} registers/spill bytes: " + "; ".join(
        f"{k} {g}/{sp}" for k, (g, sp) in sorted(cells.items())))


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


def window_texels(uv_nm, valid_nm, pr, win, back, h, wi, frame_nm=None):
    """Flat (frame, y, x) indices of every texel in the fixed-grid windows
    of the valid observations: win x win from (floor(u) - back), clamped
    inside the image as the kernels clamp it. `frame_nm` (N, W): the frame
    each window is read from (default: the observation's own)."""
    q = uv_nm[valid_nm]                                          # (M, 2)
    f = (torch.nonzero(valid_nm)[:, 1] if frame_nm is None
         else frame_nm[valid_nm])
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
    return bytes_ops_bound(nbytes, flops, out_bytes=6 * w * n * 4)


def compare_bitwise(got, want, valid_nm):
    """Kernel output equal to the plain version's, bitwise (the sample
    stores and K8's partial stages round every operation once, in one
    order, as their plain versions do). Returns compare_with_plain's
    triple."""
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "kernel output not finite")
    max_abs = float((got - want).abs().max())
    check(torch.equal(got, want), f"kernel is not bitwise its plain "
          f"version: max abs {max_abs:.3e}")
    return max_abs, 0.0, 0.0


def bytes_ops_bound(nbytes, flops, out_bytes):
    """Least time the card could take: the larger of the bytes over HBM
    bandwidth and the f32 operations over the f32 rate. `out_bytes`, the
    output's share of `nbytes`, sets the floor a measured time is held to
    (`time_floor_us`)."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, out_bytes=out_bytes)


def time_floor_us(bound) -> float:
    """The least device time a launch can measure: the bound, less the
    output bytes that L2 holds dirty when the kernel ends
    (H100_L2_BYTES at most): their write to HBM comes after the kernel's
    end and is not in its device time."""
    hbm_bytes = bound["bytes"] - min(bound["out_bytes"], H100_L2_BYTES)
    return max(hbm_bytes / H100_BYTES_PER_S,
               bound["flops"] / H100_F32_FLOPS) * 1e6


def samples_bound(texels, valid_nm, pr, layout):
    """Bound of one sample store (ops/patch_samples): the distinct window
    texels of the valid observations (12 B each), their uv, the flags, and
    the stored tensor (every observation's tile); the bilinear combine's
    operations (none for 'raw')."""
    n, w = valid_nm.shape
    n_valid = int(valid_nm.sum())
    k = 2 * pr + (2 if layout == "raw" else 1)
    out_bytes = n * w * k * 3 * k * 4
    nbytes = (int(torch.unique(texels.reshape(-1)).numel()) * GRAD_TEXEL_BYTES
              + n * w + n_valid * 8 + out_bytes)
    flops = 0 if layout == "raw" else (
        n_valid * (2 * pr + 1) ** 2 * SAMPLE_FLOPS["bilinear"])
    return bytes_ops_bound(nbytes, flops, out_bytes)


def k7_bound(texels, valid_nm, pr, cost_only):
    """Bound of K7 (ops/patch_stats): the distinct window texels (value,
    d/dx and d/dy at 12 B; the value alone at 4 B for cost_only), uv, flags,
    the descriptors of points with a valid observation, the (W N, 8)
    output; per patch pixel the bilinear sample and K7's epilogue."""
    n, w = valid_nm.shape
    p = (2 * pr + 1) ** 2
    n_valid = int(valid_nm.sum())
    n_points = int(valid_nm.any(dim=1).sum())
    texel_bytes = VALUE_TEXEL_BYTES if cost_only else GRAD_TEXEL_BYTES
    nbytes = (int(torch.unique(texels.reshape(-1)).numel()) * texel_bytes
              + n * w + n_valid * 8 + n_points * p * 4 + w * n * 8 * 4)
    per_pixel = K7_COST_FLOPS if cost_only else (SAMPLE_FLOPS["bilinear"]
                                                 + NORM_FLOPS["mean"])
    return bytes_ops_bound(nbytes, n_valid * p * per_pixel,
                           out_bytes=w * n * 8 * 4)


def ablate_bound(uv_nm, valid_nm, pr, stage, window, threads):
    """Bound of one K8 variant (ops/patch_ablate) at `threads` per block:
    the distinct texels of the windows its valid observations read (12 B;
    with 'shared' their blocks' first observations' windows), the uv it
    reads, the flags, the descriptors where the stage reads them, the
    (6, W, N) output; ABLATE_FLOPS per patch pixel ('loads': per texel)."""
    from photobundle_torch.ops import patch_ablate as pa

    n, w = valid_nm.shape
    p = (2 * pr + 1) ** 2
    sp, sf = pa.window_sources(valid_nm, window, threads)
    src_valid = valid_nm[sp, sf]
    uv_src = torch.where(src_valid[..., None], uv_nm[sp, sf], 0.0)
    texels = window_texels(uv_src, valid_nm, pr, 2 * pr + 2, pr, H, WI,
                           frame_nm=sf)
    n_valid = int(valid_nm.sum())
    n_uv = int(torch.unique((sf * n + sp)[valid_nm & src_valid]).numel())
    n_points = int(valid_nm.any(dim=1).sum())
    reads_desc = stage in ("subtract", "center", "full")
    nbytes = (int(torch.unique(texels.reshape(-1)).numel()) * GRAD_TEXEL_BYTES
              + n * w + n_uv * 8 + (n_points * p * 4 if reads_desc else 0)
              + 6 * w * n * 4)
    per_obs = ABLATE_FLOPS[stage] * (
        (2 * pr + 2) ** 2 if stage == "loads" else p)
    return bytes_ops_bound(nbytes, n_valid * per_obs,
                           out_bytes=6 * w * n * 4)


def kernel_phase(tag, label, kernel, plain, valid_nm, bound,
                 compare=compare_with_plain, match="stats",
                 radius=PATCH_RADIUS, warm=False, calls=KERNEL_CALLS):
    """Hold one kernel (or mode) against its plain version (`compare`) and
    time both (medians of `calls` calls); its device time per launch is
    that of the profiler's `*<match>*_kernel` entries (with `warm`, also
    back to back without the L2 flush: `warm_us`). Returns its numbers
    for the JSON line."""
    max_abs, max_rel, worst = compare(kernel(), plain(), valid_nm)
    ms = median_ms(kernel, calls)
    plain_ms = median_ms(plain, calls)
    dev_us = device_us_per_launch(kernel, match=match)
    warm_us = (device_us_per_launch(kernel, match=match, flush=False)
               if warm else None)
    torch.cuda.synchronize()
    share = roofline_share(f"phase {tag} {label}", dev_us, ms, bound)
    dev = us_text(dev_us)
    tolerance = ("bitwise" if compare is compare_bitwise else
                 f"{worst:.3f} of the tolerance |d| <= {KERNEL_RTOL:g}|plain|"
                 f" + {KERNEL_ATOL_ROW:g} row max")
    say(f"phase {tag} {label} vs plain at {valid_nm.shape[0]}x"
        f"{valid_nm.shape[1]} obs ({int(valid_nm.sum())} valid), "
        f"R={radius}: max abs err {max_abs:.3e}, max rel err "
        f"{max_rel:.3e}, {tolerance} | median "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms over {calls} "
        f"calls | device time per launch {dev} (profiler, {PROFILED_CALLS} "
        f"launches, L2 flushed before each)"
        f"{f', warm {us_text(warm_us)} (back to back)' if warm else ''} "
        f"| bound "
        f"{bound['bound_ms'] * 1e3:.3f} us by {bound['bound_by']} "
        f"({bound['bytes'] / 1e6:.2f} MB, {bound['flops'] / 1e6:.2f} MFLOP)"
        f", roofline share {share_text(share)}")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                library_ms=None, device_us=dev_us,
                **({"warm_us": warm_us} if warm else {}))


def roofline_share(label, dev_us, ms, bound):
    """Bound over device time per launch (None if not measured). Fails
    where a measured time, per launch or per call, is below the bound's
    floor (`time_floor_us`): the bound's byte or operation count, or its
    rate, would then be wrong."""
    bound_us, floor_us = bound["bound_ms"] * 1e3, time_floor_us(bound)
    check(ms * 1e3 >= floor_us, f"{label}: {ms * 1e3:.3f} us per call is "
          f"below its floor {floor_us:.3f} us (bound {bound_us:.3f} us)")
    if dev_us is None:
        return None
    check(dev_us >= floor_us, f"{label}: device time {dev_us:.3f} us per "
          f"launch is below its floor {floor_us:.3f} us (bound "
          f"{bound_us:.3f} us)")
    return bound_us / dev_us


def share_text(share) -> str:
    return "not measured" if share is None else f"{share:.3f}"


def kernel_label(k) -> str:
    """A kernel wrapper's name with its module's (K1's and K7's wrappers are
    both `patch_stats`)."""
    return f"{k.__module__.rsplit('.', 1)[-1]}.{k.__name__}"


def reset_all(kernels) -> None:
    """Zero every kernel wrapper's launch counts, and lm_solve's counts of
    what it ran (core/lm.py `runs`)."""
    from photobundle_torch.core import lm
    from photobundle_torch.ops import _common

    for k in kernels:
        _common.reset_launches(k)
    lm.reset_runs()


def expected_launches(iterations) -> int:
    """Launches of a kernel run once per evaluation, over lm_solve calls
    since `reset_all` that ran `iterations` (a list, one per solve), by
    core/lm.py's identity: per solve its replays + 1, plus one start and
    one body per cold graph key's warm-up. A solve's replays are its
    iterations, and past an early end the no-op bodies up to the next
    read of the termination code (none with lm.LM_READBACK = 1). Fails if
    lm.runs disagrees with `iterations`."""
    from photobundle_torch.core import lm

    r = lm.runs
    no_ops = r["bodies"] - r["warm_ups"] - sum(iterations)
    check(r["starts"] == len(iterations) + r["warm_ups"],
          f"{r['starts']} start evaluations for {len(iterations)} solves "
          f"and {r['warm_ups']} warm-ups")
    check(no_ops >= 0 and (lm.LM_READBACK > 1 or no_ops == 0),
          f"{r['bodies']} bodies for {sum(iterations)} iterations and "
          f"{r['warm_ups']} warm-ups")
    return sum(i + 1 for i in iterations) + no_ops + 2 * r["warm_ups"]


def launch_counts(kernels) -> dict:
    """{(kernel label, mode): launches} of every wrapper's every mode."""
    return {(kernel_label(k), m): n for k in kernels
            for m, n in k.launches.items()}


def lm_runs() -> dict:
    from photobundle_torch.core import lm

    return dict(lm.runs)


def ate(poses, gt) -> float:
    """Absolute trajectory error: RMS of the camera-centre differences (no
    alignment, as tests/test_engine.py measures it)."""
    d = poses[:, :3, 3] - gt[:, :3, 3]
    return float(np.sqrt((d * d).sum(-1).mean()))


def run_engine(tag, cfg, scene, init, n_frames, counted, kernels,
               ate_must_fall=True, profile=False):
    """Drive PhotometricBundleAdjustment.add_frame over the scene's first
    `n_frames` frames on the card, from the drifted poses `init`.
    `counted` = (kernel wrapper, normalization mode). Zeroes every kernel's
    launch counts just before the run and checks, just after, that every
    window solve launched the counted kernel in its mode once per LM
    iteration plus once for its initial point, that no other kernel or
    mode ran, that no solve raised its cost, and (with `ate_must_fall`)
    that the refined trajectory beats the initial one. With `profile`,
    after those checks, two more frames: the card's busy time over one
    (torch.profiler) and the host syncs of the other. Prints the engine's
    numbers and returns them, with the state the first window solve
    started from."""
    from photobundle_torch.core.engine import PhotometricBundleAdjustment

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
    reset_all(kernels)
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
    counts = launch_counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2**20

    fn, norm = counted
    launches = counts.pop((kernel_label(fn), norm))
    others = {f"{k}/{m}": v for (k, m), v in counts.items() if v}
    its = [r.iterations for r in results]
    expected = expected_launches(its)
    warm_ups = lm_runs()["warm_ups"]
    say(f"phase {tag} engine ({cfg.interpolation}, "
        f"{cfg.resolve_gradient_mode()}, R {cfg.patchRadius}, patchWarp "
        f"{cfg.resolve_patch_warp()}, normalization "
        f"{cfg.resolve_normalization()}): {n_frames} frames "
        f"{images[0].shape[0]}x{images[0].shape[1]}, {len(results)} "
        f"windows, {pba.num_active_points} active points "
        f"(capacity {cfg.maxNumPoints}); {fn.__name__}/{norm} launches "
        f"{launches} (sum of iterations + 1, + 2 per each of {warm_ups} "
        f"graph warm-ups: {expected}), other kernels "
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
    if profile:
        frame = [n_frames]

        def next_frame():
            i = frame[0]
            frame[0] += 1
            t0 = time.perf_counter()
            res = pba.add_frame(images[i], depths[i], init[i])
            torch.cuda.synchronize()
            return res, (time.perf_counter() - t0) * 1e3

        out = []
        busy = device_busy(lambda: out.append(next_frame()))
        syncs = host_syncs(lambda: out.append(next_frame()))
        (res_p, ms_p), (res_s, ms_s) = out
        say(f"phase {tag} one more frame (add_frame with a "
            f"{res_p.iterations}-iteration window solve, {ms_p:.1f} ms "
            f"traced): " + busy_text(*busy, statistics.median(frame_s[
                window_size - 1:]) * 1e3, "frame")
            + f" | the next frame ({res_s.iterations} iterations, "
            f"{ms_s:.1f} ms): host syncs {syncs}")
    return dict(engine=pba, first_state=first_state[0], results=results,
                launches=launches, first_cost=results[0].initial_cost)


def first_window_cost(pba, state, backend, restrict=None):
    """Initial cost, observation count and (N, W) valid set of a window
    solve's start state, evaluated on `backend` with the solve's own terms
    (depth prior, patch warp, and the pose priors' cost at the start, as
    lm_solve counts it); `restrict` (N, W) narrows the observations."""
    from photobundle_torch.core import lm
    from photobundle_torch.core import residuals as res_mod
    from photobundle_torch.geometry import se3

    cfg = pba.cfg
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
    anchor = (se3.se3_inverse(window.t_wc[:-1]) @ window.t_wc[1:]
              if cfg.motionPriorWeight > 0 else None)
    pose_prior = ((window.t_vo, cfg.posePriorWeight, cfg.posePriorRotWeight)
                  if cfg.posePriorWeight > 0 or cfg.posePriorRotWeight > 0
                  else None)
    prior = lm.prior_cost(window.t_wc,
                          motion_prior_weight=cfg.motionPriorWeight,
                          rel0=anchor, pose_prior=pose_prior)
    return float(res.cost + prior), int(res.n_residuals), res.valid


def check_first_window(tag, run, restrict_torch):
    """The first window's initial cost on both backends from the state its
    solve started from (`run`: engine, first_state, first_cost): equal
    observation counts (the torch run restricted to the cuda path's valid
    set when `restrict_torch`), costs within ENGINE_COST_RTOL, and the cuda
    cost equal to the solve's own. Returns the torch cost."""
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
    first = run["first_cost"]
    check(abs(cc / first - 1) <= ENGINE_COST_RTOL,
          f"first window cost {cc:.6f} differs from its solve's initial "
          f"cost {first:.6f}")
    return ct


def sorted_instance(n_pts: int, dev, pr: int = PATCH_RADIUS,
                    time_sort: bool = True):
    """Phase 3's synthetic window problem at `n_pts` points and patch
    radius `pr` (the same frames: entry.make_problem draws them from the
    seed alone), its valid observations inside K1's margins, and the
    sorted-dispatch order lm_solve builds for it. Returns (planes, uv_nm,
    valid_nm, patch, order, sort_ms; None unless `time_sort`)."""
    from photobundle_torch import entry
    from photobundle_torch.core import residuals as res_mod
    from photobundle_torch.ops import patch_warp as pw

    cam, _, args = entry.make_problem(n_pts, W, H, WI, pr, seed=SEED,
                                      device=dev)
    t_wc, x_world, patch, channels, grads, obs = args[:6]
    _, uv, in_front, _, _ = res_mod._observation_geometry_pm(cam, t_wc,
                                                             x_world)
    in_bounds = ((uv[:, 0] >= pr) & (uv[:, 0] <= WI - 2 - pr)
                 & (uv[:, 1] >= pr) & (uv[:, 1] <= H - 2 - pr))
    valid_nm = (obs.T & in_front & in_bounds).T.contiguous()
    uv_nm = uv.permute(2, 0, 1).contiguous()

    def order():
        return res_mod.sorted_dispatch_order(res_mod.dispatch_key(
            cam, t_wc, x_world, obs, (H, WI)))

    sort_ms = median_ms(order, KERNEL_CALLS) if time_sort else None
    return (pw.build_planes(channels, grads), uv_nm, valid_nm, patch,
            order(), sort_ms)


def wide_phase(dev) -> dict:
    """Phases 3, 5, 8 and 9 at the wider patch radii: K1 (K1_WIDE_RADII)
    with its sorted entry bitwise K1, K2 (K2_WIDE_RADII) and K3
    (K3_WIDE_RADII), each against its plain version in every
    normalization with its bound from its own texel count; K2 and K3 also
    on both sides of every radius where their design changes, in the mode
    concerned, and bitwise their one-thread design with a run-time radius
    wherever they run. K2 and K3 take the observations inside K1's margins
    and their own, and phase 8's scales. Returns K2's numbers at
    ENGINE_WIDE_RADIUS (mean) for the JSON line."""
    from photobundle_torch.image import patches as patches_mod
    from photobundle_torch.ops import _common
    from photobundle_torch.ops import patch_bicubic as pb
    from photobundle_torch.ops import patch_scaled as ps
    from photobundle_torch.ops import patch_warp as pw

    def runs(design, radii, top):
        """{(R, norm)}: every normalization at `radii`, and each mode at
        both radii of every step R, R + 1 (R < top) where its design
        changes."""
        kernel = design.__module__.rsplit(".", 1)[-1]
        pairs = {(r, norm) for r in radii for norm in _common.NORMS}
        for norm in _common.NORMS:
            names = {r: design(r, norm) for r in range(1, top + 1)}
            for r in range(1, top):
                if names[r] != names[r + 1]:
                    pairs |= {(r, norm), (r + 1, norm)}
                    say(f"phases 3/5/8/9 wide: {kernel} {norm}: "
                        f"'{names[r]}' at R = {r}, '{names[r + 1]}' at "
                        f"R = {r + 1}")
        return pairs

    k2_runs = runs(pb.design, K2_WIDE_RADII, 10)
    k3_runs = runs(ps.design, K3_WIDE_RADII, 9)
    rho_nm = torch.as_tensor(np.clip(np.random.default_rng(RHO_SEED).uniform(
        RHO_LO, RHO_HI, size=(N_PTS, W)), 0.5, 2.0).astype(np.float32),
        device=dev)
    numbers = None
    for pr in sorted(set(K1_WIDE_RADII) | {r for r, _ in k2_runs | k3_runs}):
        planes, uv_nm, valid_nm, patch, order, _ = sorted_instance(
            N_PTS, dev, pr, time_sort=False)
        x, y = uv_nm[..., 0], uv_nm[..., 1]
        valid_bc = (valid_nm & (x >= pr + 1) & (x <= WI - 3 - pr)
                    & (y >= pr + 1) & (y <= H - 3 - pr)).contiguous()
        ext = rho_nm * pr
        valid_sc = (valid_nm & (x >= 1 + ext) & (x <= (WI - 2) - ext)
                    & (y >= 1 + ext) & (y <= (H - 2) - ext)).contiguous()
        value_planes = planes[..., 0].contiguous()
        for norm in _common.NORMS:
            desc = (patches_mod.affine_normalize(patch).contiguous()
                    if norm == "affine" else patch)

            def tag(phase):
                return "9" if norm == "affine" else phase

            if pr in K1_WIDE_RADII:
                texels = window_texels(uv_nm, valid_nm, pr, 2 * pr + 2, pr,
                                       H, WI)
                kernel_phase(
                    tag("3"), f"K1 {norm}",
                    lambda: pw.patch_stats(planes, uv_nm, valid_nm, desc, pr,
                                           norm),
                    lambda: pw.patch_stats_reference(planes, uv_nm, valid_nm,
                                                     desc, pr, norm),
                    valid_nm, kernel_bound(texels, GRAD_TEXEL_BYTES, valid_nm,
                                           1, pr, "bilinear", norm),
                    radius=pr, calls=WIDE_CALLS)
                got = pw.sorted_patch_stats(planes, uv_nm, valid_nm, desc,
                                            pr, order, norm)
                k1 = pw.patch_stats(planes, uv_nm, valid_nm, desc, pr, norm)
                torch.cuda.synchronize()
                check(torch.equal(got, k1), f"sorted kernel ({norm}) "
                      f"differs from K1 at R={pr}")
            if (pr, norm) in k2_runs:
                texels_bc = window_texels(uv_nm, valid_bc, pr, 2 * pr + 4,
                                          pr + 1, H, WI)
                k2 = kernel_phase(
                    tag("5"), f"K2 {norm}",
                    lambda: pb.bicubic_stats(value_planes, uv_nm, valid_bc,
                                             desc, pr, norm),
                    lambda: pb.bicubic_stats_reference(
                        value_planes, uv_nm, valid_bc, desc, pr, norm),
                    valid_bc, kernel_bound(texels_bc, VALUE_TEXEL_BYTES,
                                           valid_bc, 1, pr, "bicubic", norm),
                    radius=pr, calls=WIDE_CALLS)
                if pr == ENGINE_WIDE_RADIUS and norm == "mean":
                    numbers = k2
                got = pb.bicubic_stats(value_planes, uv_nm, valid_bc, desc,
                                       pr, norm)
                one = pb.bicubic_stats_one_thread(value_planes, uv_nm,
                                                  valid_bc, desc, pr, norm)
                torch.cuda.synchronize()
                check(torch.equal(got, one), f"K2 ({norm}) at R={pr} is not "
                      f"bitwise its one-thread design")
            if (pr, norm) in k3_runs:
                texels_sc = scaled_texels(uv_nm, rho_nm, valid_sc, pr, H, WI)
                kernel_phase(
                    tag("8"), f"K3 {norm}",
                    lambda: ps.scaled_stats(planes, uv_nm, rho_nm, valid_sc,
                                            desc, pr, norm),
                    lambda: ps.scaled_stats_reference(
                        planes, uv_nm, rho_nm, valid_sc, desc, pr, norm),
                    valid_sc, kernel_bound(texels_sc, GRAD_TEXEL_BYTES,
                                           valid_sc, 1, pr, "scaled", norm,
                                           with_rho=True),
                    radius=pr, calls=WIDE_CALLS)
                got = ps.scaled_stats(planes, uv_nm, rho_nm, valid_sc, desc,
                                      pr, norm)
                one = ps.scaled_stats_one_thread(planes, uv_nm, rho_nm,
                                                 valid_sc, desc, pr, norm)
                torch.cuda.synchronize()
                check(torch.equal(got, one), f"K3 ({norm}) at R={pr} is not "
                      f"bitwise its one-thread design")
        say(f"phases 3/5/8/9 at R={pr}: "
            + ", ".join(what for what, on in (
                ("sorted kernel bitwise K1", pr in K1_WIDE_RADII),
                ("K2 bitwise its one-thread design",
                 any(r == pr for r, _ in k2_runs)),
                ("K3 bitwise its one-thread design",
                 any(r == pr for r, _ in k3_runs))) if on)
            + " in the modes run")
    return numbers


def insitu_us(fn, match: str, launched: int, tries: int = 5):
    """Device time per launch of the kernels named `match` inside one call
    of fn (a solve), L2 as the call leaves it: (us, launches in the
    trace, traces taken). A trace can drop device activities (PERF.md
    section 7): it is retaken, up to `tries` traces, until it holds the
    `launched` launches the wrapper counted, and the fullest trace counts
    (a trace drops activities, never adds one), as `traced_activities`
    does."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    best = None
    for taken in range(1, tries + 1):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        evts = [evt for evt in prof.key_averages()
                if evt.device_type == DeviceType.CUDA and match in evt.key]
        launches = sum(evt.count for evt in evts)
        total = sum(evt.self_device_time_total for evt in evts)
        if best is None or launches > best[1]:
            best = ((total / launches if total > 0 else None), launches)
        if launches >= launched:
            break
    return (*best, taken)


def first_difference(got, want):
    """None if two (t_wc, x_world, LMStats) are equal bit for bit (NaN
    where NaN), else the first field and index where they differ."""
    names = ["t_wc", "x_world"] + [f"stats.{f}" for f in got[2]._fields]
    for name, a, b in zip(names, (got[0], got[1], *got[2]),
                          (want[0], want[1], *want[2])):
        same = a == b
        if a.is_floating_point():
            same |= torch.isnan(a) & torch.isnan(b)
        if not bool(same.all()):
            idx = tuple(torch.nonzero(~same)[0].tolist())
            return f"{name}{list(idx)} ({a[idx].item()} vs {b[idx].item()})"
    return None


def host_syncs(fn) -> int:
    """Host syncs of one call of fn: the warnings of
    torch.cuda.set_sync_debug_mode('warn') (every operation that waits for
    the card, pageable host-to-device copies included)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def device_busy(fn):
    """The card over one call of fn (torch.profiler): (busy ms, the union
    of its activities' intervals; span ms, from the first activity's start
    to the last one's end; the number of activities). Busy and span are
    None if the trace holds no device activity."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return None, None, 0
    busy, reach = 0.0, spans[0][0]
    for begin, end in spans:
        if end > reach:
            busy += end - max(begin, reach)
            reach = end
    return busy / 1e3, (reach - spans[0][0]) / 1e3, len(spans)


def busy_text(busy, span, n_dev, wall_ms, what) -> str:
    """device_busy's numbers as text: the idle share over the traced span
    (the profiler slows the host) and over `wall_ms`, the untraced call's
    median host time."""
    if busy is None:
        return "device busy not measured (no device activity traced)"
    return (f"device busy {busy:.3f} ms of {span:.3f} ms from the first "
            f"device activity to the last (idle share {1 - busy / span:.3f}"
            f"), of the untraced {what}'s {wall_ms:.3f} ms (idle share "
            f"{1 - busy / wall_ms:.3f}); {n_dev} device activities "
            f"(torch.profiler, one {what})")


def readback_phase(solve) -> None:
    """Phase 4's sweep of lm.LM_READBACK (warm keys): READBACK_ROUNDS
    rounds, each running every interval in turn (the order reversed every
    other round), each interval TIMED_SOLVES solves of each kind: the
    fixed-length solve and EARLY_SOLVES' solves that end early. Prints
    each interval's median ms per kind, its bodies and reads per solve,
    and the sum of its medians; the module's value is restored."""
    from photobundle_torch.core import lm

    chosen = lm.LM_READBACK
    kinds = [("fixed", {})] + [
        (f"ftol {f:g}", dict(function_tolerance=f, parameter_tolerance=x,
                             max_iterations=EARLY_MAX_ITERATIONS))
        for f, x in EARLY_SOLVES]
    for _, extra in kinds[1:]:
        solve("cuda", **extra)                       # capture once
    times = {(k, kind): [] for k in READBACKS for kind, _ in kinds}
    counts = {}
    try:
        for r in range(READBACK_ROUNDS):
            for k in (READBACKS if r % 2 == 0 else READBACKS[::-1]):
                lm.LM_READBACK = k
                for kind, extra in kinds:
                    for _ in range(TIMED_SOLVES):
                        lm.reset_runs()
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        _, _, st = solve("cuda", **extra)
                        it = int(st.iterations)
                        torch.cuda.synchronize()
                        times[k, kind].append(time.perf_counter() - t0)
                    counts[k, kind] = (it, lm.runs["bodies"],
                                       lm.runs["readbacks"])
    finally:
        lm.LM_READBACK = chosen
    for k in READBACKS:
        med = {kind: statistics.median(times[k, kind]) * 1e3
               for kind, _ in kinds}
        say(f"phase 4 LM_READBACK={k}: " + " | ".join(
            f"{kind} {med[kind]:.2f} ms ({counts[k, kind][0]} iterations, "
            f"{counts[k, kind][1]} bodies, {counts[k, kind][2]} reads)"
            for kind, _ in kinds) + f" | sum {sum(med.values()):.2f} ms")
    say(f"phase 4 lm.LM_READBACK is {chosen} (medians of "
        f"{READBACK_ROUNDS * TIMED_SOLVES} solves per cell in "
        f"{READBACK_ROUNDS} interleaved rounds, host clock; max_iterations "
        f"{EARLY_MAX_ITERATIONS} for the solves that end early)")


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
        counts = branch_counts(staged)

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
        shares = [roofline_share(f"phase 11 {label} at {n_pts} points", d,
                                 t, bound)
                  for label, d, t in (("sorted", dev_sorted, ms),
                                      ("K1", dev_k1, k1_ms))]
        say(f"phase 11 at {n_pts} points, mean: device time per launch "
            f"sorted {us_text(dev_sorted)}, K1 unsorted {us_text(dev_k1)} "
            f"(profiler, {PROFILED_CALLS} launches, L2 flushed before each; "
            f"roofline share {', '.join(map(share_text, shares))}) | median "
            f"per call "
            f"sorted {ms:.4f} ms, K1 {k1_ms:.4f} ms, plain {plain_ms:.4f} ms"
            f" | the sort (key + stable sort) {sort_ms:.4f} ms per solve | "
            f"blocks by branch: {counts} | bound "
            f"{bound['bound_ms'] * 1e3:.3f} us by {bound['bound_by']} "
            f"({bound['bytes'] / 1e6:.2f} MB, {bound['flops'] / 1e6:.2f} "
            f"MFLOP)")
        if numbers is None:
            numbers = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound["bound_ms"],
                           bound_by=bound["bound_by"], library_ms=None,
                           device_us=dev_sorted)
        for r in SORTED_RADII:
            planes_r, uv_r, valid_r, patch_r, order_r, _ = (
                (planes, uv_nm, valid_nm, patch, order, None) if r == pr
                else sorted_instance(n_pts, dev, r, time_sort=False))
            for c in SORTED_CHANNELS:
                planes_c, patch_c = with_channels(planes_r, patch_r, c)
                staged = torch.zeros(pw.sorted_blocks(n_pts, W),
                                     dtype=torch.uint8, device=dev)
                got = pw.sorted_patch_stats(planes_c, uv_r, valid_r, patch_c,
                                            r, order_r, staged=staged)
                k1 = pw.patch_stats(planes_c, uv_r, valid_r, patch_c, r)
                torch.cuda.synchronize()
                check(torch.equal(got, k1), f"sorted kernel differs from K1 "
                      f"at {n_pts} points, R = {r}, C = {c}")
                say(f"phase 11 sorted bitwise K1 at {n_pts} points, R = {r}, "
                    f"C = {c}: blocks by branch {branch_counts(staged)}")
                del got, k1, planes_c
    return numbers


def with_channels(planes, patch, c: int):
    """planes (..., W, 1, H, Wi, 4) and patch (..., N, 1, P) as C channels:
    channel k the one channel scaled by linspace(0.5, 1.5, C)[k] (the
    descriptor repeated), so every channel's sums differ."""
    if c == 1:
        return planes, patch
    gain = torch.linspace(0.5, 1.5, c, device=planes.device).tolist()
    return (torch.cat([planes * g for g in gain], dim=-4).contiguous(),
            patch.repeat_interleave(c, dim=-2).contiguous())


def branch_counts(staged) -> str:
    """A sorted launch's blocks by branch, from its `staged` flags
    (SortedBranch in csrc/patch_warp.cu: 0 gathered, 1 union box, 2 own
    windows)."""
    n = torch.bincount(staged.flatten().long(), minlength=3).tolist()
    return (f"union box {n[1]}, own windows {n[2]}, gathered {n[0]} "
            f"of {staged.numel()}")


def grid_sample_call(planes, uv_nm, valid_nm, pr):
    """The one PyTorch call that computes the bilinear stores' samples,
    F.grid_sample on the (value, d/dx, d/dy) planes as (W, 3C, H, Wi) at
    the patch grid (W, N, P, 2), align_corners=True: its output is
    (W, 3C, N, P), channel-major planes. Invalid observations sample at
    pixel (0, 0). Returns (the call, its output as (s, gx, gy) each
    (N, W, C, P))."""
    import torch.nn.functional as F

    w, c, h, wi, _ = planes.shape
    n = uv_nm.shape[0]
    img = (planes[..., :3].permute(0, 1, 4, 2, 3)
           .reshape(w, 3 * c, h, wi).contiguous())
    k = torch.arange(-pr, pr + 1, dtype=torch.float32, device=planes.device)
    q = torch.where(valid_nm[..., None], uv_nm, 0.0).permute(1, 0, 2)
    gx = (q[..., 0, None, None] + k[None, :]).expand(w, n, k.numel(),
                                                      k.numel())
    gy = (q[..., 1, None, None] + k[:, None]).expand(w, n, k.numel(),
                                                      k.numel())
    grid = torch.stack([2 * gx / (wi - 1) - 1, 2 * gy / (h - 1) - 1],
                       dim=-1).reshape(w, n, -1, 2).contiguous()

    def call():
        return F.grid_sample(img, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    out = call().reshape(w, c, 3, n, -1).permute(2, 3, 0, 1, 4)
    return call, tuple(out)


def window_gather_call(planes, uv_nm, valid_nm, pr):
    """The one PyTorch call that computes the raw store's windows: an
    advanced-indexing gather planes[f, :, y, x, :3] of every observation's
    clamped (2R+2)^2 window (invalid ones: the window at (0, 0)), output
    (N*W, WIN, WIN, C, 3) frame-major. Returns (the call, its output in the
    raw store's layout (C, N*W, WIN, 3 WIN))."""
    w, c, h, wi, _ = planes.shape
    n = uv_nm.shape[0]
    win = 2 * pr + 2
    q = torch.where(valid_nm[..., None], uv_nm, 0.0).permute(1, 0, 2)
    q = q.reshape(w * n, 2)                                  # frame-major
    x0 = torch.clamp(torch.floor(q[:, 0]).long() - pr, 0, wi - win)
    y0 = torch.clamp(torch.floor(q[:, 1]).long() - pr, 0, h - win)
    f = torch.arange(w, device=planes.device).repeat_interleave(n)
    k = torch.arange(win, device=planes.device)
    fi, yi, xi = f[:, None, None], (y0[:, None] + k)[:, :, None], (
        x0[:, None] + k)[:, None, :]

    def call():
        return planes[fi, :, yi, xi, :3]

    out = call().permute(3, 0, 1, 2, 4).reshape(c, w * n, win, 3 * win)
    return call, out


def samples_phase(planes, uv_nm, valid_nm, texels, solve, obs, interior,
                  kernels) -> tuple:
    """Phase 13: K4's row store and K6 (ops/patch_samples) against their
    plain versions on phase 3's inputs (and at STORE_WIDE_RADII), each
    beside the one PyTorch call that computes the same function
    (`library_ms`), the four `warp_patches` variants against each other,
    then lm_solve under PB_GROUPED_STATS=0 at R = 2 and UNFUSED_RADIUS.
    Returns ({layout: numbers}, the row store's launches in the R = 2
    solve)."""
    from photobundle_torch import entry
    from photobundle_torch.core import lm
    from photobundle_torch.ops import patch_samples as smp

    pr = PATCH_RADIUS
    numbers = {}
    gs_call, gs_out = grid_sample_call(planes, uv_nm, valid_nm, pr)
    gather_call, gather_out = window_gather_call(planes, uv_nm, valid_nm, pr)
    gs_us, gs_kernels = library_us_per_call(gs_call)
    gather_us, gather_kernels = library_us_per_call(gather_call)
    torch.cuda.synchronize()
    for layout in smp.LAYOUTS:
        numbers[layout] = kernel_phase(
            "13", f"sample store '{layout}'",
            lambda: smp.store(planes, uv_nm, valid_nm, pr, layout),
            lambda: smp.store_reference(planes, uv_nm, valid_nm, pr, layout),
            valid_nm, samples_bound(texels, valid_nm, pr, layout),
            compare=compare_bitwise, match="samples")
        lib_us = gather_us if layout == "raw" else gs_us
        numbers[layout]["library_ms"] = (None if lib_us is None
                                         else lib_us / 1e3)
    plain = smp.unpack(smp.store_reference(planes, uv_nm, valid_nm, pr),
                       uv_nm, valid_nm, pr, "rows")
    gs_err = max(float((a - b).abs()[valid_nm].max())
                 for a, b in zip(gs_out, plain))
    raw_plain = smp.store_reference(planes, uv_nm, valid_nm, pr, "raw")
    fm = valid_nm.T.reshape(-1)                    # frame-major validity
    check(torch.equal(gather_out[:, fm], raw_plain[:, fm]),
          "the window gather differs from the raw store's plain version")
    say(f"phase 13 library calls, device time per call (profiler, L2 "
        f"flushed before each): F.grid_sample on planes (W, 3C, H, Wi) at "
        f"grid (W, N, P, 2), output (W, 3C, N, P) = "
        f"{tuple(gs_call().shape)}, {us_text(gs_us)} ({gs_kernels}), "
        f"largest |difference| from the plain samples "
        f"{gs_err:.3e} (its align_corners normalization rounds the "
        f"coordinate); the window gather planes[f, :, y, x, :3], output "
        f"(N W, WIN, WIN, C, 3), {us_text(gather_us)} ({gather_kernels}), "
        f"bitwise the raw store on valid observations")
    for wide in STORE_WIDE_RADII:
        planes_r, uv_r, valid_r, _, _, _ = sorted_instance(
            N_PTS, planes.device, wide, time_sort=False)
        win_r = window_texels(uv_r, valid_r, wide, 2 * wide + 2, wide, H, WI)
        for layout in smp.LAYOUTS:
            kernel_phase(
                "13", f"sample store '{layout}'",
                lambda: smp.store(planes_r, uv_r, valid_r, wide, layout),
                lambda: smp.store_reference(planes_r, uv_r, valid_r, wide,
                                            layout),
                valid_r, samples_bound(win_r, valid_r, wide, layout),
                compare=compare_bitwise, match="samples", radius=wide,
                calls=WIDE_CALLS)
    rows = smp.warp_patches(planes, uv_nm, valid_nm, pr)
    for variant in smp.VARIANTS:
        layout = smp.layout_of(variant)
        got = smp.warp_patches(planes, uv_nm, valid_nm, pr, variant)
        want = smp.unpack(smp.store_reference(planes, uv_nm, valid_nm, pr,
                                              layout),
                          uv_nm, valid_nm, pr, layout)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) and torch.equal(a, c)
                  for a, b, c in zip(got, want, rows)),
              f"warp_patches '{variant}' differs from its plain version or "
              f"from 'rows'")
    say(f"phase 13 warp_patches variants {', '.join(smp.VARIANTS)}: "
        f"(s, gx, gy) {tuple(rows[0].shape)} bitwise equal to each other "
        f"and to their plain versions")

    # The unfused solve: PB_GROUPED_STATS=0.
    def timed(**env):
        os.environ.update(env)
        try:
            times = []
            for _ in range(TIMED_SOLVES):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                solve("cuda")
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        finally:
            for key in env:
                os.environ.pop(key)
        return ITERS / statistics.median(times)

    os.environ["PB_GROUPED_STATS"] = "0"
    try:
        reset_all(kernels)
        _, _, st = solve("cuda")
        torch.cuda.synchronize()
        counts = {key: n for key, n in launch_counts(kernels).items() if n}
        expected = expected_launches([int(st.iterations)])
        unfused = solve("cuda", obs & interior,
                        initial_lambda=PARITY_LAMBDA)[2]
    finally:
        os.environ.pop("PB_GROUPED_STATS")
    fused = solve("cuda", obs & interior, initial_lambda=PARITY_LAMBDA)[2]
    torch.cuda.synchronize()
    iters = int(st.iterations)
    launches = counts.pop(("patch_samples.warp_patches", "rows"), 0)
    say(f"phase 13 cuda solve with PB_GROUPED_STATS=0: {iters} iterations, "
        f"cost {float(st.initial_cost):.6f} -> {float(st.final_cost):.6f}; "
        f"row-store launches {launches}, other kernels "
        f"{counts or 'none'}")
    check(iters == ITERS and launches == expected,
          f"row store launched {launches} times over {iters} iterations "
          f"(expected {expected})")
    check(not counts, f"other kernels ran under PB_GROUPED_STATS=0: {counts}")
    check(float(st.final_cost) < float(st.initial_cost),
          "unfused solve did not lower the cost")
    rel = abs(float(unfused.final_cost) / float(fused.final_cost) - 1)
    log_rel = float((unfused.cost_log / fused.cost_log - 1).abs().max())
    say(f"phase 13 parity solve (interior obs, initial lambda "
        f"{PARITY_LAMBDA:g}): unfused {float(unfused.final_cost):.6f}, fused "
        f"{float(fused.final_cost):.6f}; final rel diff {rel:.3e}, max "
        f"cost-log rel diff {log_rel:.3e} (rtol {SOLVE_RTOL:g})")
    check(int(unfused.iterations) == int(fused.iterations) == ITERS,
          "parity solves ran different iteration counts")
    check(bool((unfused.accept_log == fused.accept_log).all()),
          "parity solves accepted different steps")
    check(rel <= SOLVE_RTOL, f"unfused parity final cost rel diff {rel:.3e}")
    ips_unfused = timed(PB_GROUPED_STATS="0")
    ips_fused = timed()
    say(f"phase 13 LM it/s (median of {TIMED_SOLVES} solves of {ITERS} "
        f"iterations): unfused {ips_unfused:.2f}, fused {ips_fused:.2f}")

    # The unfused solve past the store's earlier radii (1..4).
    cam, offsets, args = entry.make_problem(N_PTS, W, H, WI, UNFUSED_RADIUS,
                                            seed=SEED, device=planes.device)
    os.environ["PB_GROUPED_STATS"] = "0"
    try:
        reset_all(kernels)
        _, _, st = lm.lm_solve(
            cam, *args, offsets, huber_delta=HUBER_DELTA,
            gradient_mode="sampled", max_iterations=ITERS,
            function_tolerance=0.0, parameter_tolerance=0.0, backend="cuda")
        torch.cuda.synchronize()
        counts = {key: n for key, n in launch_counts(kernels).items() if n}
        expected = expected_launches([int(st.iterations)])
    finally:
        os.environ.pop("PB_GROUPED_STATS")
    iters = int(st.iterations)
    rows_run = counts.pop(("patch_samples.warp_patches", "rows"), 0)
    say(f"phase 13 cuda solve with PB_GROUPED_STATS=0 at R="
        f"{UNFUSED_RADIUS}: {iters} iterations, cost "
        f"{float(st.initial_cost):.6f} -> {float(st.final_cost):.6f}; "
        f"row-store launches {rows_run}, other kernels {counts or 'none'}")
    check(iters == ITERS and rows_run == expected,
          f"row store launched {rows_run} times over {iters} iterations at "
          f"R={UNFUSED_RADIUS} (expected {expected})")
    check(not counts, f"other kernels ran under PB_GROUPED_STATS=0 at R="
          f"{UNFUSED_RADIUS}: {counts}")
    check(bool(torch.isfinite(st.cost_log[:iters]).all())
          and float(st.final_cost) < float(st.initial_cost),
          f"unfused solve at R={UNFUSED_RADIUS} did not lower the cost")
    return numbers, launches


def k7_rows_as_stats(rows, n, w):
    """K7's (W N, 8) rows as K1's (6, W, N) layout (a view)."""
    return rows.reshape(w, n, 8)[..., :6].permute(2, 0, 1)


def k7_radius(label, planes, value_planes, uv_nm, valid_nm, patch, pr,
              kernels) -> tuple:
    """Phase 14 at one patch radius: K7's entry point once per mode (its
    launches, counted from zero), cost_only's rr bitwise the full mode's,
    then each mode against its plain version and bitwise its first design.
    Returns ({mode: numbers}, {mode: launches of the entry-point calls})."""
    from photobundle_torch.ops import patch_stats as k7

    n, w = valid_nm.shape
    ps = 2 * pr + 1
    desc = patch.reshape(n, 1, ps, ps)
    texels = window_texels(uv_nm, valid_nm, pr, 2 * pr + 2, pr, H, WI)
    reset_all(kernels)
    full = k7.patch_stats(planes, uv_nm, valid_nm, desc, pr)
    cost = k7.patch_stats(value_planes, uv_nm, valid_nm, desc, pr,
                          cost_only=True)
    torch.cuda.synchronize()
    counts = {key: c for key, c in launch_counts(kernels).items() if c}
    launches = {m: counts.pop(("patch_stats.patch_stats", m), 0)
                for m in k7.MODES}
    check(launches == {"full": 1, "cost_only": 1} and not counts,
          f"K7 entry points at R={pr} launched {launches}, others {counts}")
    check(tuple(full[0].shape) == (n, w, 2, 2)
          and bool(torch.isfinite(full[0]).all()), "K7 gtg malformed")
    check(torch.equal(full[2], cost[2]), f"K7 cost_only rr at R={pr} is not "
          "the full mode's bitwise")
    numbers = {}
    for mode, src in (("full", planes), ("cost_only", value_planes)):
        cost_only = mode == "cost_only"
        say(f"phase 14 K7 {mode} at R={pr}: design "
            f"'{k7.design(pr, cost_only)}'")
        numbers[mode] = kernel_phase(
            "14", f"K7 {mode}{label}",
            lambda: k7_rows_as_stats(k7.stats_rows(
                src, uv_nm, valid_nm, desc, pr, cost_only), n, w),
            lambda: k7_rows_as_stats(k7.patch_stats_reference(
                src, uv_nm, valid_nm, desc, pr, cost_only), n, w),
            valid_nm, k7_bound(texels, valid_nm, pr, cost_only), radius=pr,
            calls=KERNEL_CALLS if pr == PATCH_RADIUS else WIDE_CALLS)
        got = k7.stats_rows(src, uv_nm, valid_nm, desc, pr, cost_only)
        one = k7.stats_rows_one_thread(src, uv_nm, valid_nm, desc, pr,
                                       cost_only)
        torch.cuda.synchronize()
        check(torch.equal(got, one), f"K7 {mode} at R={pr} is not bitwise "
              f"its first design")
    say(f"phase 14 K7 at R={pr}: entry points launched {launches}; "
        f"cost_only rr bitwise the full mode's; both modes bitwise the "
        f"first design")
    return numbers, launches


def k7_phase(planes, channels, uv_nm, valid_nm, patch, kernels,
             dev) -> dict:
    """Phase 14: K7 (ops/patch_stats) at R = 2 on phase 3's inputs (and
    its sums against K1's mean-mode sums), at K7_WIDE_RADII on phase 3's
    problem at that radius, and at the widest radius on K7_WIDEST_PTS
    points (`k7_radius` at each). Returns {radius: (numbers, launches)}."""
    from photobundle_torch.ops import _common
    from photobundle_torch.ops import patch_bicubic as pb
    from photobundle_torch.ops import patch_stats as k7
    from photobundle_torch.ops import patch_warp as pw

    pr = PATCH_RADIUS
    n, w = valid_nm.shape
    runs = {pr: k7_radius("", planes, pb.build_value_planes(channels),
                          uv_nm, valid_nm, patch, pr, kernels)}
    k1 = pw.patch_stats(planes, uv_nm, valid_nm, patch, pr)
    desc = patch.reshape(n, 1, 2 * pr + 1, 2 * pr + 1)
    max_abs, _, worst = compare_with_plain(
        k7_rows_as_stats(k7.stats_rows(planes, uv_nm, valid_nm, desc, pr),
                         n, w), k1, valid_nm)
    say(f"phase 14 K7 vs K1's mean-mode sums at R={pr}: max abs "
        f"{max_abs:.3e}, {worst:.3f} of the kernel tolerance")
    widest = _common.STATS_MAX
    say(f"phase 14 K7 at R={widest} on {K7_WIDEST_PTS} points, not "
        f"{N_PTS}: the plain version's windows take "
        f"{(2 * widest + 2) ** 2 * 16 / 1e3:.0f} KB per observation")
    for wide, n_pts in [(r, N_PTS) for r in K7_WIDE_RADII] + [
            (widest, K7_WIDEST_PTS)]:
        planes_r, uv_r, valid_r, patch_r, _, _ = sorted_instance(
            n_pts, dev, wide, time_sort=False)
        runs[wide] = k7_radius(f" R={wide}", planes_r,
                               planes_r[..., 0].contiguous(), uv_r, valid_r,
                               patch_r, wide, kernels)
    return runs


def tools_phase(planes, uv_nm, valid_nm, patch, kernels) -> tuple:
    """Phase 15: both tools in this process (the store benchmark at phase
    3's size, the ablation at N_PTS and DENSE_PTS points, full/own bitwise
    K1), then every K8 variant at 64 threads against its plain version on
    phase 3's inputs. Returns ({variant: numbers}, launch counts of the
    tools' runs)."""
    from photobundle_torch.ops import patch_ablate as pa
    from photobundle_torch.ops import patch_warp as pw
    from photobundle_torch.tools import ablate_patch_stats, bench_warp_kernel

    reset_all(kernels)
    t0 = time.perf_counter()
    bench = bench_warp_kernel.main([str(N_PTS), str(W), "--calls",
                                    str(BENCH_CALLS)])
    say(f"phase 15 bench_warp_kernel at {N_PTS}x{W} in "
        f"{time.perf_counter() - t0:.1f} s: " + ", ".join(
            f"{v} {r['ms']:.4f} ms/eval by CUDA events, device "
            f"{us_text(r['device_us'])}/eval ({r['ns_per_obs']:.3f} ns/obs "
            f"by events)" for v, r in bench.items()))
    check(len({r["checksum"] for r in bench.values()}) == 1,
          "bench_warp_kernel variants disagree")
    for n_pts in (N_PTS, DENSE_PTS):
        t0 = time.perf_counter()
        abl = ablate_patch_stats.main([str(n_pts), str(W),
                                       str(ABLATE_CALLS)])
        check(abl["full_own_bitwise_k1"], f"ablation full/own is not K1 "
              f"bitwise at {n_pts} points")
        say(f"phase 15 ablate_patch_stats at {n_pts}x{W} in "
            f"{time.perf_counter() - t0:.1f} s, full/own bitwise K1; device "
            f"us per launch (per call by CUDA events): " + ", ".join(
                f"{k} {us_text(r['device_us'])} ({r['ms'] * 1e3:.2f} us)"
                for k, r in abl["variants"].items()))
    counts = launch_counts(kernels)
    ran = {k: c for k, c in counts.items() if c}
    say(f"phase 15 launches of the tools' runs: {ran}")
    # Each variant makes three runs of `calls` launches (a warm-up, one
    # timed by CUDA events, one traced by the profiler) and one call for its
    # checksum; 'packed' takes the block store; the ablation runs at two
    # sizes and three block sizes, plus one full/own launch per size for
    # its K1 check beside one K1 launch.
    per_mode = 2 * 3 * len(pa.THREADS) * ABLATE_CALLS
    per_variant = 3 * BENCH_CALLS + 1
    want = {("patch_samples.warp_patches", "rows"): per_variant,
            ("patch_samples.warp_patches", "block"): 2 * per_variant,
            ("patch_samples.warp_patches", "raw"): per_variant,
            ("patch_warp.patch_stats", "mean"): 2,
            **{("patch_ablate.ablate_stats", m): per_mode + (m == "full/own")
               * 2 for m in pa.MODES}}
    check(ran == want, f"the tools launched {ran}, expected {want}")
    pr = PATCH_RADIUS
    k1_us = device_us_per_launch(
        lambda: pw.patch_stats(planes, uv_nm, valid_nm, patch, pr))
    say(f"phase 15 card: {gpu_clocks()} (SM clock, max, power draw) | K1 "
        f"again on phase 3's inputs: {us_text(k1_us)} per launch "
        f"(profiler)")
    k1 = pw.patch_stats(planes, uv_nm, valid_nm, patch, pr)
    own_us = {}
    for t in pa.THREADS:
        def own(t=t):
            return pa.ablate_stats(planes, uv_nm, valid_nm, patch, "full",
                                   "own", t)

        check(torch.equal(own(), k1), f"K8 full/own at {t} threads is not "
              f"K1 bitwise")
        own_us[t] = device_us_per_launch(own, match="ablate")
    say(f"phase 15 K8 full/own (bitwise K1 at every thread count), device "
        f"time per launch L2 cold: " + ", ".join(
            f"{t} threads {us_text(u)}" for t, u in own_us.items())
        + f" | K1 (64 threads) {us_text(k1_us)}")
    numbers = {}
    for stage in pa.STAGES:
        for window in pa.WINDOWS:
            numbers[f"{stage}/{window}"] = kernel_phase(
                "15", f"K8 {stage}/{window} (64 threads)",
                lambda: pa.ablate_stats(planes, uv_nm, valid_nm, patch, stage,
                                        window),
                lambda: pa.ablate_reference(planes, uv_nm, valid_nm, patch,
                                            stage, window),
                valid_nm, ablate_bound(uv_nm, valid_nm, pr, stage, window,
                                       64),
                compare=(compare_with_plain if stage == "full"
                         else compare_bitwise), match="ablate")
    return numbers, counts


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def write_cli_sequence():
    """Phase 12's sequence, written anew under CLI_DIR: phase 6's scene as
    CLI_FRAMES KITTI-format stereo PNG pairs and a drifted VO input
    (vo.txt). Returns (its root, ground-truth poses, VO poses)."""
    from photobundle_torch import entry

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    data = os.path.join(CLI_DIR, "kitti")
    _, gt = entry.write_kitti_sequence(
        data, np.random.default_rng(SCENE_SEED), n_frames=CLI_FRAMES,
        shape=(H, WI), fx=KITTI_FX, cx=KITTI_CX, cy=KITTI_CY,
        baseline=KITTI_BASELINE, texture_scale=100.0 / KITTI_FX,
        mark_misses=True)
    vo = entry.drift_poses(np.random.default_rng(SCENE_SEED + 1), gt,
                           DRIFT_TRANS, DRIFT_ROT, 1)
    entry.write_poses(os.path.join(data, "vo.txt"), vo)
    return data, gt, vo


def cli_phase(kernels, dev) -> int:
    """Phase 12: the command line on a KITTI-format sequence on `dev`,
    three runs (see the module docstring). Returns the sorted kernel's
    launches in the counted run (b)."""
    from photobundle_torch import cli, native
    from photobundle_torch.core import lm
    from photobundle_torch.core.engine import PhotometricBundleAdjustment
    from photobundle_torch.image import stereo as stereo_mod
    from photobundle_torch.io import kitti
    from photobundle_torch.io import trajectory as traj
    from photobundle_torch.io.speckle import speckle_filter_numpy
    from photobundle_torch.ops import patch_warp as pw

    t0 = time.perf_counter()
    data, gt, vo = write_cli_sequence()
    vo_path = os.path.join(data, "vo.txt")
    say(f"phase 12 wrote a {CLI_FRAMES}-frame KITTI-format sequence "
        f"({H}x{WI} stereo PNGs) in {time.perf_counter() - t0:.1f} s")

    # The dataset as the command line builds it (dataLoader=auto): its
    # producer and its time per frame; the torch producer beside it; and
    # dataLoader=native, which runs the native runtime or raises.
    cfg = cli.load_config(cli.build_argparser().parse_args(
        ["--config", "configs/kitti_production.cfg", f"dataDir={data}"]))
    built = native.available()
    dataset_ms = {}
    for mode, frames in (("auto", DATASET_FRAMES), ("python", 3)):
        t0 = time.perf_counter()
        ds = kitti.create_dataset(cfg.replace(dataLoader=mode,
                                              numFrames=frames), device=dev)
        for i in range(frames):
            check(ds.get_frame(i).depth_valid.any(),
                  f"dataLoader={mode}: frame {i} has no valid depth")
        torch.cuda.synchronize()
        dataset_ms[f"{mode} ({ds.producer}, {frames} frames)"] = (
            time.perf_counter() - t0) * 1e3 / frames
        if mode == "auto":
            producer = ds.producer
            check(producer == ("native" if built else "torch"),
                  f"dataLoader=auto took producer {producer}")
        del ds
    try:
        nds = kitti.create_dataset(cfg.replace(dataLoader="native",
                                               numFrames=1), device=dev)
    except RuntimeError as e:
        check(not built, f"dataLoader=native raised with the runtime built: "
              f"{e}")
        native_run = f"raised ({str(e)[:200]})"
    else:
        check(built and nds.producer == "native" and nds._native is not None,
              "dataLoader=native did not run the native runtime")
        native_run = "ran the native runtime"
        del nds
    why = "" if built else (f" (native runtime unavailable: "
                            f"{str(native.build_error())[:300]})")
    say(f"phase 12 dataset: dataLoader=auto took producer '{producer}'{why}"
        f"; dataLoader=native {native_run} | dataset ms per frame (host "
        f"clock, decode + stereo + speckle + depth, the first frame "
        f"included): " + ", ".join(f"{k} {v:.1f}"
                                   for k, v in dataset_ms.items()))

    # Stereo alone on frame 0: BM on the card (CUDA events), SGM once, the
    # speckle filter on the host (native where it builds, and Python).
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
    speckle_kw = dict(max_diff=cfg.speckleRange,
                      min_region=cfg.speckleWindowSize)
    t0 = time.perf_counter()
    _, kept = speckle_filter_numpy(disp.cpu().numpy(), valid.cpu().numpy(),
                                   **speckle_kw)
    speckle_ms = (time.perf_counter() - t0) * 1e3
    native_speckle = "not built"
    if built:
        t0 = time.perf_counter()
        _, kept_native = native.speckle_filter(
            disp.cpu().numpy(), valid.cpu().numpy(), **speckle_kw)
        native_speckle = f"{(time.perf_counter() - t0) * 1e3:.1f} ms"
        check(np.array_equal(kept, kept_native),
              "the native speckle filter differs from the Python one")
    say(f"phase 12 stereo per frame ({H}x{WI}, {cfg.numDisparities} "
        f"disparities): BM {bm_ms:.2f} ms on the card (CUDA events, median "
        f"of 5), SGM {sgm_ms:.1f} ms (host clock, once), speckle filter "
        f"{speckle_ms:.1f} ms in Python, {native_speckle} native, on the "
        f"host | BM valid share {float(valid.float().mean()):.3f}, after "
        f"speckle {float(kept.mean()):.3f}")

    def argv(tag):
        return ["--config", "configs/kitti_production.cfg", "--poses",
                vo_path, "--output", os.path.join(CLI_DIR, f"{tag}.txt"),
                "--log", os.path.join(CLI_DIR, f"{tag}.jsonl"),
                "--device", dev.type, f"dataDir={data}",
                f"numFrames={CLI_FRAMES}", f"maxNumPoints={N_PTS}",
                f"depthCacheDir={CLI_DEPTH_CACHE}"]

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
        reset_all(kernels)
        try:
            rc = cli.main(argv(tag))
            torch.cuda.synchronize()
        finally:
            lm.lm_solve = solve
            PhotometricBundleAdjustment.add_frame = add
            os.environ.pop("PB_SORTED_DISPATCH")
        check(rc == 0, f"cli.main returned {rc}")
        counts = {key: n for key, n in launch_counts(kernels).items() if n}
        rate = (CLI_FRAMES - W) / sum(frame_s[W:])
        return counts, list(iterations), rate, expected_launches(iterations)

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
    for tag, (counts, its, rate, expected) in runs.items():
        solves = len(its)
        sorted_n = counts.pop(("patch_warp.sorted_patch_stats", "mean"), 0)
        k1_n = counts.pop(("patch_warp.patch_stats", "mean"), 0)
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


def batched_inputs(planes, uv_nm, seen_nm, patch, pr: int, b: int):
    """Phase 3's inputs for b windows on a leading batch axis: window k
    reads its own copy of phase 3's planes at phase 3's uv + k x
    BATCH_SHIFT_PX, valid where phase 3's observation is seen (observed,
    in front) and inside K1's margins at radius pr; descriptors phase 3's
    at its radius, else drawn (numpy seed SEED + pr) for every window."""
    n = uv_nm.shape[0]
    if pr != PATCH_RADIUS:
        rng = np.random.default_rng(SEED + pr)
        patch = torch.as_tensor(rng.standard_normal(
            (n, 1, (2 * pr + 1) ** 2)).astype(np.float32),
            device=uv_nm.device)
    uv_b, valid_b = [], []
    for k in range(b):
        q = uv_nm + k * BATCH_SHIFT_PX
        inside = ((q[..., 0] >= pr) & (q[..., 0] <= WI - 2 - pr)
                  & (q[..., 1] >= pr) & (q[..., 1] <= H - 2 - pr))
        uv_b.append(q)
        valid_b.append(seen_nm & inside)
    return (planes.expand(b, *planes.shape).contiguous(),
            torch.stack(uv_b), torch.stack(valid_b),
            patch.expand(b, *patch.shape).contiguous())


def batched_rows(stats):
    """(B, 6, W, N) sums as (6, W, B N), windows outermost along the
    points (`compare_with_plain`'s layout)."""
    b, six, w, n = stats.shape
    return stats.permute(1, 2, 0, 3).reshape(six, w, b * n)


def batched_kernel_phase(planes, uv_nm, seen_nm, patch) -> dict:
    """Phase 16's kernel part: K1's batch axis against its plain version
    and bitwise single-window launches at BATCH_RADII; its numbers for
    the JSON line (R = 2, B = BATCH_KERNEL) with its device time per
    launch at B = 1, 2 and BATCH_KERNEL."""
    from photobundle_torch.ops import patch_warp as pw

    b = BATCH_KERNEL
    numbers = None
    for pr in BATCH_RADII:
        args = batched_inputs(planes, uv_nm, seen_nm, patch, pr, b)
        valid = args[2].reshape(-1, W)                      # (B N, W)
        got = pw.patch_stats(*args, pr)
        singles = torch.stack([pw.patch_stats(*(a[k] for a in args), pr)
                               for k in range(b)])
        torch.cuda.synchronize()
        check(torch.equal(got, singles), f"phase 16 K1 batch axis at R = "
              f"{pr} is not bitwise {b} single-window launches")
        if pr != PATCH_RADIUS:
            max_abs, _, worst = compare_with_plain(
                batched_rows(got),
                batched_rows(pw.patch_stats_reference(*args, pr)), valid)
            say(f"phase 16 K1 batch axis, B = {b}, R = {pr}: bitwise {b} "
                f"single-window launches; vs plain max abs err "
                f"{max_abs:.3e}, {worst:.3f} of the tolerance")
            continue
        bound = summed_bound([kernel_bound(
            window_texels(args[1][k], args[2][k], pr, 2 * pr + 2, pr, H, WI),
            GRAD_TEXEL_BYTES, args[2][k], 1, pr, "bilinear", "mean")
            for k in range(b)])
        numbers = kernel_phase(
            "16", f"K1 batch axis (B = {b}; bitwise {b} single-window "
            f"launches)", lambda: pw.patch_stats(*args, pr),
            lambda: pw.patch_stats_reference(*args, pr), valid, bound,
            compare=lambda g, w_, v: compare_with_plain(
                batched_rows(g), batched_rows(w_), v))
        by_batch = {}
        for size in (1, 2):
            by_batch[size] = device_us_per_launch(
                lambda: pw.patch_stats(*(a[:size] for a in args), pr))
        by_batch[b] = numbers["device_us"]
        say("phase 16 K1 batch axis device time per launch (L2 flushed): "
            + ", ".join(f"B = {k} {us_text(v)}" for k, v in by_batch.items()))
        numbers["device_us_by_batch"] = by_batch
    return numbers


def uv_dispatch_key(uv_nm, valid_nm):
    """`residuals.dispatch_key` from the observations' own coordinates in
    the window's middle frame: (16-row band, column), observations not
    valid there last."""
    from photobundle_torch.core import residuals as res_mod

    mid = uv_nm.shape[1] // 2
    ok = valid_nm[:, mid]
    q = torch.where(ok[:, None], uv_nm[:, mid], 0.0)
    col = torch.clamp(torch.floor(q[:, 0]), 0, WI - 1).long()
    row = torch.clamp(torch.floor(q[:, 1]), 0, H - 1).long()
    band = res_mod.DISPATCH_BAND
    return torch.where(ok, (row // band) * WI + col, -(-H // band) * WI)


def axis_inputs(label, planes, value_planes, uv_nm, seen_nm, patch, pr: int,
                b: int):
    """Phase 16's inputs of one new batch axis (a label of AXES) at radius
    pr for b windows: (kernel, plain, args, valid, bounds, match): the
    wrapper and its plain version, both called as f(*args) with every
    operand on a leading batch axis (so args sliced [k] or [:e] is window
    k's call or the first e windows'), the valid observations (B, N, W),
    each window's bound, and the kernels' device-time name. Windows as
    `batched_inputs` makes them, valid inside the kernel's own margins;
    K3/K5's scales phase 8's draw (numpy seed RHO_SEED) per window; sorted
    K1's order each window's own: `uv_dispatch_key` of its coordinates,
    reversed in odd windows."""
    from photobundle_torch.core import residuals as res_mod
    from photobundle_torch.image import patches as patches_mod
    from photobundle_torch.ops import patch_bicubic as pb
    from photobundle_torch.ops import patch_samples as smp
    from photobundle_torch.ops import patch_scaled as ps
    from photobundle_torch.ops import patch_warp as pw

    kind, _, norm = label.partition("/")
    norm = norm or "mean"
    tex, q, _, desc = batched_inputs(planes, uv_nm, seen_nm, patch, pr, b)
    if norm == "affine":
        desc = patches_mod.affine_normalize(desc).contiguous()
    n = uv_nm.shape[0]
    lo, hi = ((pr + 1, 3 + pr) if kind == "bicubic_stats" else (pr, 2 + pr))
    if kind == "scaled_stats":
        rho = torch.as_tensor(np.clip(np.random.default_rng(RHO_SEED).uniform(
            RHO_LO, RHO_HI, size=(b, n, W)), 0.5, 2.0).astype(np.float32),
            device=uv_nm.device)
        lo, hi = 1 + rho * pr, 2 + rho * pr
    valid = seen_nm[None] & ((q[..., 0] >= lo) & (q[..., 0] <= WI - hi)
                             & (q[..., 1] >= lo) & (q[..., 1] <= H - hi))
    if kind == "bicubic_stats":
        args = (value_planes.expand(b, *value_planes.shape).contiguous(), q,
                valid, desc)
        kernel, plain, match = pb.bicubic_stats, pb.bicubic_stats_reference, \
            "stats"
        bounds = [kernel_bound(window_texels(q[k], valid[k], pr, 2 * pr + 4,
                                             pr + 1, H, WI),
                               VALUE_TEXEL_BYTES, valid[k], 1, pr, "bicubic",
                               norm) for k in range(b)]
    elif kind == "scaled_stats":
        args = (tex, q, rho, valid, desc)
        kernel, plain, match = ps.scaled_stats, ps.scaled_stats_reference, \
            "stats"
        bounds = [kernel_bound(scaled_texels(q[k], rho[k], valid[k], pr, H,
                                             WI),
                               GRAD_TEXEL_BYTES, valid[k], 1, pr, "scaled",
                               norm, with_rho=True) for k in range(b)]
    elif kind == "warp_patches":
        args = (tex, q, valid)
        bounds = [samples_bound(window_texels(q[k], valid[k], pr, 2 * pr + 2,
                                              pr, H, WI), valid[k], pr,
                                "rows") for k in range(b)]
        return (lambda *a: smp.store(*a, pr, "rows"),
                lambda *a: smp.store_reference(*a, pr, "rows"), args, valid,
                bounds, "samples")
    else:
        feed = []
        for k in range(b):
            f, _ = res_mod.sorted_dispatch_order(uv_dispatch_key(q[k],
                                                                 valid[k]))
            feed.append(f.flip(0) if k % 2 else f)
        feed = torch.stack(feed)
        args = (tex, q, valid, desc, feed, torch.argsort(feed, dim=1))
        bounds = []
        for k in range(b):
            bounds.append(kernel_bound(
                window_texels(q[k], valid[k], pr, 2 * pr + 2, pr, H, WI),
                GRAD_TEXEL_BYTES, valid[k], 1, pr, "bilinear", norm))
            bounds[-1]["bytes"] += 8 * n          # the window's feed
        return (lambda *a: pw.sorted_patch_stats(*a[:4], pr, a[4:], norm),
                lambda *a: pw.sorted_patch_stats_reference(*a[:4], pr, a[4:],
                                                           norm),
                args, valid, bounds, "sorted")
    return (lambda *a: kernel(*a, pr, norm), lambda *a: plain(*a, pr, norm),
            args, valid, bounds, match)


def summed_bound(bounds):
    """One bound of several windows' work: their bytes, operations and
    output bytes summed."""
    return bytes_ops_bound(*(sum(part[key] for part in bounds)
                             for key in ("bytes", "flops", "out_bytes")))


def batched_axes_phase(planes, channels, uv_nm, seen_nm, patch) -> dict:
    """Phase 16's kernel part for the batch axes of K2, K3, K5, K4's row
    store and sorted K1 (AXES): each held bitwise to BATCH_KERNEL
    single-window launches at R = 2 and at its wide radius (AXES); then, at
    R = 2, against its plain version and timed at B = ENGINE_BATCH (the
    JSON line's numbers, beside the launches of its engine run), and its
    cold device time per launch at B = 1, 2 and BATCH_KERNEL beside its
    bound (the B windows' bounds summed) and the share. Returns {label:
    numbers}."""
    from photobundle_torch.ops import patch_bicubic as pb

    value_planes = pb.build_value_planes(channels)
    b, e = BATCH_KERNEL, ENGINE_BATCH
    out = {}
    for label, wide in AXES.items():
        for pr in (wide, PATCH_RADIUS):
            kernel, plain, args, valid, bounds, match = axis_inputs(
                label, planes, value_planes, uv_nm, seen_nm, patch, pr, b)
            got = kernel(*args)
            singles = torch.stack([kernel(*(a[k] for a in args))
                                   for k in range(b)])
            torch.cuda.synchronize()
            check(torch.equal(got, singles), f"phase 16 {label} batch axis "
                  f"at R = {pr} is not bitwise {b} single-window launches")
            say(f"phase 16 {label} batch axis, B = {b}, R = {pr} "
                f"({int(valid.sum())} valid observations): bitwise {b} "
                f"single-window launches")
            del got, singles
        first = tuple(a[:e] for a in args)
        stores = label.startswith("warp_patches")
        numbers = kernel_phase(
            "16", f"{label} batch axis (B = {e})", lambda: kernel(*first),
            lambda: plain(*first), valid[:e].reshape(-1, W),
            summed_bound(bounds[:e]),
            compare=compare_bitwise if stores else (
                lambda g, w_, v: compare_with_plain(
                    batched_rows(g), batched_rows(w_), v)),
            match=match)
        cold = {e: numbers["device_us"]}
        bound_us = {k: summed_bound(bounds[:k])["bound_ms"] * 1e3
                    for k in (1, 2, e, b)}
        for size in (1, 2, b):
            part = tuple(a[:size] for a in args)
            cold[size] = device_us_per_launch(lambda: kernel(*part),
                                              match=match)
        say(f"phase 16 {label} batch axis device time per launch (L2 "
            f"flushed) | bound (the B windows' bounds summed) | share: "
            + ", ".join(
                f"B = {k} {us_text(cold[k])} | {bound_us[k]:.3f} us | "
                + share_text(None if cold[k] is None
                             else bound_us[k] / cold[k])
                for k in sorted(cold)))
        numbers["device_us_by_batch"] = cold
        out[label] = numbers
    return out


def sorted_axes_phase(planes, uv_nm, seen_nm, patch) -> None:
    """Phase 16's sorted K1 at SORTED_RADII with SORTED_CHANNELS: a
    B = BATCH_KERNEL launch on `axis_inputs`' windows (each in its own
    order; C > 1 as `with_channels` makes them) bitwise its single-window
    launches and K1's batch axis on the same windows."""
    from photobundle_torch.ops import patch_warp as pw

    b = BATCH_KERNEL
    for r in SORTED_RADII:
        kernel, _, args, valid, _, _ = axis_inputs(
            "sorted_patch_stats", planes, None, uv_nm, seen_nm, patch, r, b)
        for c in SORTED_CHANNELS:
            tex, desc = with_channels(args[0], args[3], c)
            call = (tex, args[1], args[2], desc, *args[4:])
            got = kernel(*call)
            singles = torch.stack([kernel(*(a[k] for a in call))
                                   for k in range(b)])
            k1 = pw.patch_stats(*call[:4], r)
            torch.cuda.synchronize()
            check(torch.equal(got, singles) and torch.equal(got, k1),
                  f"phase 16 sorted K1 batch axis at R = {r}, C = {c} is not "
                  f"bitwise its single-window launches and K1's batch axis")
            say(f"phase 16 sorted K1 batch axis, B = {b}, R = {r}, C = {c} "
                f"({int(valid.sum())} valid observations): bitwise {b} "
                f"single-window launches and K1's batch axis")
            del got, singles, k1, tex


def se3_phase(dev) -> None:
    """Phase 21: the port's se3_exp and se3_log on the card against its
    CPU result over SE3_TWISTS twists at rotation angles SE3_ANGLES
    (translations of scale 0.5), and the card's own f32 sin and cos of
    those angles against the f64 values rounded to f32."""
    from photobundle_torch.geometry import se3

    rng = np.random.default_rng(SE3_SEED)
    lo, hi = np.log(SE3_ANGLES[0]), np.log(SE3_ANGLES[1])
    angle = np.exp(rng.uniform(lo, hi, SE3_TWISTS))
    axis = rng.standard_normal((SE3_TWISTS, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    xi = torch.as_tensor(np.concatenate(
        [rng.standard_normal((SE3_TWISTS, 3)) * 0.5, axis * angle[:, None]],
        axis=1).astype(np.float32))
    t_cpu = se3.se3_exp(xi)
    t_card = se3.se3_exp(xi.to(dev)).cpu()
    exp_err = float((t_card - t_cpu).abs().max())
    log_cpu = se3.se3_log(t_cpu)
    log_card = se3.se3_log(t_cpu.to(dev)).cpu()
    nan_cpu = torch.isnan(log_cpu).any(dim=1)
    nan_card = torch.isnan(log_card).any(dim=1)
    same_nan = torch.equal(nan_cpu, nan_card)
    log_err = float((log_card - log_cpu)[~nan_cpu & ~nan_card].abs().max())
    theta = torch.sqrt(se3._norm2(xi[:, 3:].to(dev)) + se3._EPS * se3._EPS)
    off = {name: int((fn(theta) != fn(theta.double()).float()).sum())
           for name, fn in (("cos", torch.cos), ("sin", torch.sin))}
    say(f"phase 21 se3 on the card over {SE3_TWISTS} twists at angles "
        f"{SE3_ANGLES[0]:g} .. {SE3_ANGLES[1]:g} rad: se3_exp max |d| vs the "
        f"CPU {exp_err:.3e} (limit {SE3_EXP_ATOL:g}); se3_log NaN rows card "
        f"{int(nan_card.sum())}, CPU {int(nan_cpu.sum())}, "
        f"{'equal' if same_nan else 'DIFFERENT'}, max |d| elsewhere "
        f"{log_err:.3e} (limit {SE3_LOG_ATOL:g}) | the card's f32 cos / sin "
        f"differ from the f64 values rounded on {off['cos']} / {off['sin']} "
        f"of {SE3_TWISTS} angles (the port takes the latter)")
    check(same_nan, "phase 21: se3_log's NaN rows on the card differ from "
          "the CPU's")
    check(exp_err <= SE3_EXP_ATOL and log_err <= SE3_LOG_ATOL,
          f"phase 21: se3 on the card differs from the CPU: se3_exp "
          f"{exp_err:.3e}, se3_log {log_err:.3e}")


def shifted_sequence(scene, k: int):
    """Phase 16's sequence k: phase 6's images and depth maps shifted left
    by k px (the last column repeated), the images brightened by
    BATCH_BRIGHTEN x k, as tools/bench_batched builds its sequences; no
    two sequences of a batch ingest the same frame."""
    _, images, depths, _ = scene

    def shift(a):
        if not k:
            return a
        return np.concatenate([a[:, k:], np.repeat(a[:, -1:], k, axis=1)],
                              axis=1)

    return ([shift(im) + np.float32(BATCH_BRIGHTEN * k) for im in images],
            [shift(d) for d in depths])


def single_ingest(proto, window, points, k, image, depth, t_wc, frame_id,
                  age_id, count):
    """The single engine's `_ingest` of sequence k's frame from sequence
    k's slice of a stacked state, the frame transported as a single
    engine transports it."""
    from photobundle_torch.core.batched import _slice

    image, depth = proto._host_frame(image, depth)
    put = lambda a: torch.as_tensor(a).to(proto.device)  # noqa: E731
    return proto._ingest(_slice(window, k), _slice(points, k), put(image),
                         put(depth), put(np.asarray(t_wc, np.float32)),
                         frame_id, age_id, count)


class IngestRecord:
    """Wraps a batched engine's `_ingest` and keeps each call's state,
    arguments and result; `check(frames)` then holds every sequence's
    slice of the result bitwise to the single engine's `_ingest` from
    that sequence's slice of the state (outside the timed step)."""

    def __init__(self, bp):
        self.bp, self.calls, self.checked = bp, [], 0
        self.inner = bp._ingest
        bp._ingest = self

    def __call__(self, window, points, *args):
        out = self.inner(window, points, *args)
        self.calls.append((window, points, args, out))
        return out

    def check(self, frames, what: str) -> None:
        from photobundle_torch.core.batched import _slice

        window, points, args, out = self.calls.pop()
        frame_id, age_id, count = args[3:]
        for k, (image, depth, t_wc) in enumerate(frames):
            want = single_ingest(self.bp._proto, window, points, k, image,
                                 depth, t_wc, frame_id, age_id, count)
            diff = tree_difference(tuple(_slice(t, k) for t in out), want)
            check(diff is None, f"{what}, frame {frame_id}, sequence {k}: "
                  f"the batched ingest differs from the single ingest at "
                  f"{diff}")
        self.checked += 1


def traced_activities(fn, tries: int = 5):
    """One call of fn under torch.profiler: (device activities, host
    runtime calls that put one on the device: kernel launches, memsets
    and copies, bench_lm_breakdown.LAUNCH_CALLS). A trace that holds fewer
    activities than launch calls may have dropped some (PERF.md section
    7): it is retaken, up to `tries` traces, and the trace with the most
    device activities counts: a trace drops activities, never adds one
    (one run's last trace of the batched ingest at B = 1 held 357, those
    at B = 2, 4 and 8 held 390, each with 399 launch calls)."""
    from torch.autograd import DeviceType

    from photobundle_torch.tools.bench_lm_breakdown import LAUNCH_CALLS

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    best = None
    for _ in range(tries):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        device = sum(e.device_type == DeviceType.CUDA for e in events)
        host = sum(e.device_type == DeviceType.CPU
                   and any(c in e.name for c in LAUNCH_CALLS)
                   for e in events)
        if best is None or device > best[0]:
            best = (device, host)
        if device == host:
            break
    return best


def written_out_vs_einsum(scene) -> None:
    """Phase 16: the ingest's batch-exact pose products
    (`se3.transform_points_each`, `se3.se3_inverse_each`) against the
    einsums a single pose's ingest ran before them (cuBLAS's GEMM and
    GEMV), on phase 6's poses and the points they see: the elements that
    differ (0: the single engine rounds as it did)."""
    from photobundle_torch.geometry import camera as cam_mod
    from photobundle_torch.geometry import se3

    cam, _, _, gt = scene
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    t_wc = torch.as_tensor(np.stack(gt).astype(np.float32), device=dev)
    inv_d = sum(int((se3.se3_inverse_each(t) != se3.se3_inverse(t)).sum())
                for t in t_wc)
    tr_d, tr_n = 0, 0
    for k, t in enumerate(t_wc):
        for n in (N_PTS, 1024):
            uv = torch.as_tensor(rng.uniform([0, 0], [WI - 1, H - 1], (
                n, 2)).astype(np.float32), device=dev)
            z = torch.as_tensor(rng.uniform(2, 60, n).astype(np.float32),
                                device=dev)
            x = cam_mod.backproject(cam.to(dev), uv, z)
            tr_d += int((se3.transform_points_each(t, x)
                         != se3.transform_points(t, x)).sum())
            tr_n += x.numel()
    say(f"phase 16 the ingest's written-out pose products against the "
        f"einsums on this card: se3_inverse {inv_d} of {t_wc.numel()} "
        f"elements differ ({len(t_wc)} poses, one GEMV each), "
        f"transform_points {tr_d} of {tr_n} ({len(t_wc)} poses x "
        f"{N_PTS} and 1024 points, one GEMM each)")


def engine_scene():
    """Phase 6's scene (the engine phases' and phase 16's): the textured
    sphere at KITTI 00's intrinsics, ENGINE_FRAMES frames."""
    from photobundle_torch import entry

    return entry.make_sequence(
        np.random.default_rng(SCENE_SEED), n_frames=ENGINE_FRAMES,
        shape=(H, WI), fx=KITTI_FX, cx=KITTI_CX, cy=KITTI_CY,
        baseline=KITTI_BASELINE, texture_scale=100.0 / KITTI_FX,
        mark_misses=True)


def ingest_cost_child() -> None:
    """`chip_smoke.py ingest-cost`: `ingest_cost_phase` on phase 6's scene
    in a process of its own. Its traces must hold every device activity:
    in chip_smoke's own process, after the earlier phases, each
    torch.profiler trace of an ingest lost 5 of them, whatever its size
    (394 of 399 at every B, 393 of 398 for a single ingest, 3179 of 3184
    for 8), and one trace at B = 1 lost only 1, which failed the check
    that the activities are equal at every B; in a fresh process every
    trace held them all (H100 80GB HBM3: 399 of 399 at B = 1, 2, 4, 8)."""
    from photobundle_torch.config import PBAConfig

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke ingest-cost: no CUDA card")
    ingest_cost_phase(engine_scene(), PBAConfig())


def run_ingest_cost() -> None:
    """Phase 16's ingest cost in a child process (`ingest_cost_child`):
    its lines printed here, its failure this run's."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "ingest-cost"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=600)
    print(proc.stdout, end="", flush=True)
    check(proc.returncode == 0, f"phase 16 ingest cost: the child process "
          f"exited with code {proc.returncode}: "
          f"{proc.stdout.strip().splitlines()[-1:]}")


def ingest_cost_phase(scene, cfg) -> dict:
    """Phase 16's cost of one batched ingest at INGEST_BATCHES, warm: B
    sequences (shifted_sequence) ingested into full rings (the steady
    state: a slide, a cull, tracking and selection), beside one single
    ingest and B single ingests from the same states. Returns per B the
    numbers: ms (CUDA events), device activities and host launch calls
    (torch.profiler), host syncs (set_sync_debug_mode)."""
    from photobundle_torch.core.batched import \
        BatchedPhotometricBundleAdjustment, _slice

    cam, _, _, gt = scene
    h, wi = scene[1][0].shape
    out = {}
    for b in INGEST_BATCHES:
        bp = BatchedPhotometricBundleAdjustment(cam, (h, wi), cfg, b)
        proto = bp._proto
        seqs = [shifted_sequence(scene, k) for k in range(b)]

        def inputs(i):
            frames = [proto._host_frame(seqs[k][0][i], seqs[k][1][i])
                      for k in range(b)]
            return (bp._frame_images([im for im, _ in frames]),
                    bp._put(np.stack([d for _, d in frames])),
                    bp._put(np.stack([np.asarray(gt[i], np.float32)] * b)))

        window, points = bp.window, bp.points
        for i in range(W):
            window, points = bp._ingest(window, points, *inputs(i), i, i, i)
        args = (*inputs(W), W, W, W)
        # The single ingests' states and frames, on the card beforehand as
        # the batched ingest's are.
        alone = []
        for k in range(b):
            image, depth = proto._host_frame(seqs[k][0][W], seqs[k][1][W])
            alone.append((_slice(window, k), _slice(points, k),
                          torch.as_tensor(image).to(proto.device),
                          torch.as_tensor(depth).to(proto.device),
                          args[2][k].clone(), W, W, W))

        def batched():
            return bp._ingest(window, points, *args)

        def single(k=0):
            return proto._ingest(*alone[k])

        def singles():
            return [single(k) for k in range(b)]

        got = batched()
        for k in range(b):
            diff = tree_difference(tuple(_slice(t, k) for t in got),
                                   single(k))
            check(diff is None, f"phase 16 ingest cost, B = {b}, sequence "
                  f"{k}: the batched ingest differs from the single "
                  f"ingest at {diff}")
        row = {}
        for name, fn in (("batched", batched), ("single", single),
                         ("singles", singles)):
            device, host = traced_activities(fn)
            row[name] = {"ms": median_ms(fn, INGEST_CALLS, warmup=2),
                         "device_activities": device,
                         "launch_calls": host, "host_syncs": host_syncs(fn)}
        out[b] = row
        say(f"phase 16 batched ingest, B = {b} (warm, full rings, "
            f"{h}x{wi}; bitwise {b} single ingests): "
            + " | ".join(
                f"{name} {r['ms']:.3f} ms, {r['device_activities']} device "
                f"activities, {r['launch_calls']} launch calls, "
                f"{r['host_syncs']} host syncs"
                for name, r in (("batched ingest", row["batched"]),
                                ("one single ingest", row["single"]),
                                (f"{b} single ingests", row["singles"]))))
        del bp, window, points, got, alone
        torch.cuda.empty_cache()
    written_out_vs_einsum(scene)
    for key in ("device_activities", "launch_calls", "host_syncs"):
        seen = {b: out[b]["batched"][key] for b in INGEST_BATCHES}
        check(len(set(seen.values())) == 1, f"phase 16: the batched "
              f"ingest's {key} differ with B: {seen}")
    return out


def batched_phase(scene, kernels) -> tuple:
    """Phase 16's engine part (see the module docstring). Returns the
    launches of K1, the ordered sums and the Cholesky solve in the batched
    engine's run at the largest batch size (the slice's main path)."""
    from photobundle_torch import entry
    from photobundle_torch.config import PBAConfig
    from photobundle_torch.core import lm
    from photobundle_torch.core.batched import \
        BatchedPhotometricBundleAdjustment
    from photobundle_torch.core.engine import PhotometricBundleAdjustment
    from photobundle_torch.ops import patch_warp as pw
    from photobundle_torch.tools import bench_batched

    cam, images, depths, gt = scene
    cfg = PBAConfig()
    n = DEFAULT_FRAMES
    launches = None
    for b in BATCH_SIZES:
        inits = [entry.drift_poses(np.random.default_rng(k), gt, DRIFT_TRANS,
                                   DRIFT_ROT, 1) for k in range(1, b + 1)]
        seqs = [shifted_sequence(scene, k) for k in range(b)]
        singles = []
        for k in range(b):
            pba = PhotometricBundleAdjustment(cam, images[0].shape, cfg)
            singles.append([r for i in range(n) if (r := pba.add_frame(
                seqs[k][0][i], seqs[k][1][i], inits[k][i]))])
        bp = BatchedPhotometricBundleAdjustment(cam, images[0].shape, cfg, b)
        check(bp.device.type == "cuda" and bp.backend == "cuda",
              f"batched engine on {bp.device}, backend {bp.backend}")
        record = IngestRecord(bp)
        batched = [[] for _ in range(b)]
        step_ms = []
        torch.cuda.synchronize()
        reset_all(kernels)
        reset_body_kernels()
        for i in range(n):
            frames = [(seqs[k][0][i], seqs[k][1][i], inits[k][i])
                      for k in range(b)]
            t0 = time.perf_counter()
            rs = bp.add_frames(*map(list, zip(*frames)))
            dt = (time.perf_counter() - t0) * 1e3
            record.check(frames, f"phase 16 B = {b}")
            if rs is None:
                continue
            step_ms.append(dt)
            for k, r in enumerate(rs):
                batched[k].append(r)
        counts = launch_counts(kernels)
        runs = lm_runs()
        body = check_body_launches(f"phase 16 B = {b}", runs)
        k1 = counts.pop((kernel_label(pw.patch_stats), "mean"))
        others = {f"{k}/{m}": v for (k, m), v in counts.items() if v}
        its = [max(r.iterations for r in solve) for solve in zip(*batched)]
        expected = expected_launches(its)
        pose_d, cost_d, unequal = 0.0, 0.0, []
        for ra_list, rb_list in zip(singles, batched):
            check(len(ra_list) == len(rb_list) == n - W + 1,
                  f"B = {b}: {len(ra_list)} single and {len(rb_list)} "
                  f"batched window results")
            for ra, rb in zip(ra_list, rb_list):
                check(np.array_equal(ra.frame_ids, rb.frame_ids)
                      and ra.num_points == rb.num_points,
                      f"B = {b} window {ra.frame_ids.tolist()}: frame ids "
                      f"or point counts differ ({ra.num_points} vs "
                      f"{rb.num_points})")
                check(bool(np.isfinite(rb.poses).all())
                      and rb.final_cost <= rb.initial_cost,
                      f"B = {b} window {rb.frame_ids.tolist()}: cost "
                      f"{rb.initial_cost} -> {rb.final_cost}")
                pose_d = max(pose_d, float(np.abs(ra.poses - rb.poses).max()))
                cost_d = max(cost_d, abs(rb.final_cost / ra.final_cost - 1))
                if not (np.array_equal(ra.poses, rb.poses)
                        and np.array_equal(ra.points_xyz, rb.points_xyz)
                        and ra.final_cost == rb.final_cost):
                    unequal.append(ra.frame_ids.tolist())
        say(f"phase 16 batched engine, B = {b} (default configuration, "
            f"{n} frames, sequence k phase 6's frames shifted k px and "
            f"brightened {BATCH_BRIGHTEN:g} k, drift seeds 1..{b}): each "
            f"sequence's window and point table after each of the "
            f"{record.checked} batched ingests bitwise the single engine's "
            f"_ingest from its slice; {len(its)} batched solves, "
            f"iterations per solve (the longest window) {its}; K1 launches "
            f"{k1} (once per evaluation for the whole batch: replays + 1, "
            f"+ 2 per cold key: {expected}; lm runs {runs}), other kernels "
            f"and modes {others or 'none'}; the body's kernels: row_dot "
            f"{body[0]}, chol_solve {body[1]} (one per body) | against {b} "
            f"single engines: "
            f"largest pose difference {pose_d:.3e} (atol "
            f"{BATCH_POSE_ATOL:g}), largest final-cost rel difference "
            f"{cost_d:.3e} (rtol {BATCH_COST_RTOL:g}); frame ids and point "
            f"counts equal; windows whose poses, points or final cost are "
            f"not bitwise the single engine's: {unequal or 'none'} | median "
            f"ms per step (B frames ingested + the batched solve + the "
            f"fetch) {statistics.median(step_ms):.1f}")
        check(record.checked == n and not record.calls,
              f"B = {b}: {record.checked} of {n} batched ingests checked")
        check(not unequal, f"B = {b}: windows {unequal} are not bitwise the "
              f"single engines'")
        check(k1 == expected > 0, f"B = {b}: K1 launched {k1} times, "
              f"expected {expected}")
        check(not others, f"B = {b}: other kernels or modes ran: {others}")
        check(pose_d <= BATCH_POSE_ATOL and cost_d <= BATCH_COST_RTOL,
              f"B = {b}: batched results differ from single engines: poses "
              f"{pose_d:.3e}, cost {cost_d:.3e}")
        launches = (k1, *body)
        # One batched solve from the state the run ended in: cold key
        # (warm-up + captures), its graphs' memory, warm, host syncs.
        lm.clear_graph_cache()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        bp._optimize(bp.window, bp.points)
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.empty_cache()
        graph_mib = (torch.cuda.memory_reserved() - reserved) / 2**20
        t0 = time.perf_counter()
        bp._optimize(bp.window, bp.points)
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3
        syncs = host_syncs(lambda: bp._optimize(bp.window, bp.points))
        busy = device_busy(lambda: bp._optimize(bp.window, bp.points))
        say(f"phase 16 batched solve, B = {b}: cold key {cold_ms:.1f} ms, "
            f"warm {warm_ms:.1f} ms (warm-up + captures {cold_ms - warm_ms:.1f}"
            f" ms) | the key's graphs and buffers {graph_mib:.1f} MiB "
            f"(memory_reserved after empty_cache) | host syncs per batched "
            f"solve {syncs} (set_sync_debug_mode('warn')) | "
            + busy_text(*busy, warm_ms, "batched solve"))
        del bp, record
    run_ingest_cost()
    data = bench_batched.scene(12)
    for b in BENCH_BATCHES:
        t0 = time.perf_counter()
        record = bench_batched.measure(b, "cuda", 12, data)
        say(f"phase 16 bench_batched ({time.perf_counter() - t0:.1f} s, "
            f"python -m photobundle_torch.tools.bench_batched): "
            f"{json.dumps(record)}")
        check(record["keyframes_per_s_total"] > 0,
              f"bench_batched at B = {b} measured no rate")
        torch.cuda.empty_cache()
    return launches


def body_kernels() -> tuple:
    """The wrappers of the LM body's own kernels: the ordered sums and the
    batched Cholesky solve."""
    from photobundle_torch.ops import chol_solve as cs
    from photobundle_torch.ops import ordered_sum as osm

    return osm.row_dot, cs.chol_solve


def reset_body_kernels() -> None:
    from photobundle_torch.ops import _common

    for k in body_kernels():
        _common.reset_launches(k)


def body_launches() -> tuple:
    """(ordered-sum launches, Cholesky launches) since the last reset."""
    return tuple(sum(k.launches.values()) for k in body_kernels())


def check_body_launches(tag: str, runs: dict) -> tuple:
    """The body's kernels launched on the path just run: the Cholesky
    solve once per LM body (lm.runs['bodies'], warm-ups and replays
    included), the ordered sums at least once. Returns their launches."""
    dots, chol = body_launches()
    check(chol == runs["bodies"] > 0, f"{tag}: chol_solve launched {chol} "
          f"times for {runs['bodies']} LM bodies")
    check(dots > 0, f"{tag}: row_dot never launched")
    return dots, chol


def chol_systems(w: int, b: int, dev, seed: int):
    """b reduced-system-sized SPD systems (6W x 6W, m m^T / 6W + I) and
    right-hand sides from a seed; window CHOL_BAD of a batch of more than
    two has a negative pivot."""
    n = 6 * w
    g = torch.Generator().manual_seed(seed)
    m = torch.randn((b, n, n), generator=g, dtype=torch.float64)
    s = (m @ m.transpose(-1, -2) / n + torch.eye(n, dtype=torch.float64))
    s = s.float()
    if b > 2:
        s[CHOL_BAD, 3, 3] = -1.0
    return s.to(dev), torch.randn((b, n), generator=g).to(dev)


def chol_phase(dev) -> dict:
    """The batched Cholesky kernel at CHOL_WINDOWS x CHOL_BATCHES against
    its plain version, bitwise across B, NaN in the failing window alone,
    timed. Returns the numbers at W and BODY_BATCH (the main path's)."""
    from photobundle_torch.ops import chol_solve as cs

    out = None
    for w in CHOL_WINDOWS:
        for b in CHOL_BATCHES:
            s, rhs = chol_systems(w, b, dev, 100 * w + b)
            n = 6 * w
            got = cs.chol_solve(s, rhs)
            want = cs.chol_solve_reference(s, rhs)
            bad = torch.zeros(b, dtype=torch.bool, device=dev)
            if b > 2:
                bad[CHOL_BAD] = True
            for label, x in (("kernel", got), ("plain", want)):
                nan = torch.isnan(x)
                check(torch.equal(nan.all(-1), bad)
                      and torch.equal(nan.any(-1), bad),
                      f"phase 16 chol_solve W = {w}, B = {b}: the {label} "
                      f"has NaN in windows {nan.any(-1).tolist()}, the "
                      f"failing window is {bad.tolist()}")
            err = float((got - want)[~bad].abs().max())
            scale = float(want[~bad].abs().max())
            check(err <= CHOL_RTOL * scale, f"phase 16 chol_solve W = {w}, "
                  f"B = {b}: max abs err {err:.3e} > {CHOL_RTOL:g} x "
                  f"{scale:.3e}")
            singles = torch.cat([cs.chol_solve(s[k:k + 1], rhs[k:k + 1])
                                 for k in range(b)])
            same = torch.equal(got.view(torch.int32),
                               singles.view(torch.int32))
            check(same, f"phase 16 chol_solve W = {w}, B = {b}: the batch "
                  f"is not bitwise its windows' single launches")
            ms = median_ms(lambda: cs.chol_solve(s, rhs), KERNEL_CALLS)
            plain_ms = median_ms(lambda: cs.chol_solve_reference(s, rhs),
                                 KERNEL_CALLS)
            dev_us = device_us_per_launch(lambda: cs.chol_solve(s, rhs),
                                          match="chol_solve")
            lib_us, _ = library_us_per_call(lambda: torch.linalg.solve(s,
                                                                       rhs))
            # cuSOLVER's factor-and-solve route for one system.
            cho_us = (library_us_per_call(
                lambda: torch.cholesky_solve(
                    rhs[..., None], torch.linalg.cholesky_ex(s)[0]))[0]
                if b == 1 else None)
            # A symmetric solve reads the lower triangle alone.
            bound = bytes_ops_bound(
                b * (n * (n + 1) // 2 + 2 * n) * s.element_size(),
                b * (n ** 3 / 3 + 2 * n * n), b * n * s.element_size())
            share = roofline_share(f"phase 16 chol_solve W = {w}, B = {b}",
                                   dev_us, ms, bound)
            say(f"phase 16 chol_solve W = {w} (n = {n}), B = {b}: max abs "
                f"err {err:.3e} of {scale:.3e} (rtol {CHOL_RTOL:g}) vs "
                f"cholesky_ex + cholesky_solve; NaN in window(s) "
                f"{bad.nonzero().flatten().tolist()} alone; bitwise its {b} "
                f"single launches: {same} | median kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms | device time per launch "
                f"{us_text(dev_us)} (L2 flushed, mode "
                f"{cs.mode(n, s.dtype)}), torch.linalg.solve "
                f"{us_text(lib_us)}"
                + ("" if cho_us is None else
                   f", cholesky_ex + cholesky_solve {us_text(cho_us)}")
                + f" | bound {bound['bound_ms'] * 1e3:.3f} us "
                f"by {bound['bound_by']}, roofline share {share_text(share)}")
            if (w, b) == (W, BODY_BATCH):
                out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound["bound_ms"],
                           bound_by=bound["bound_by"],
                           library_ms=None if lib_us is None
                           else lib_us / 1e3, device_us=dev_us)
    return out


def body_problem(cam, offsets, args, b: int):
    """(stacked LMProblem, LMConfig) of phase 3's problem as b windows, the
    points of window k shifted by 1e-4 k."""
    from photobundle_torch.core import lm

    t_wc, x_world, patch, channels, grads, obs, pv, frozen = args
    kw = dict(huber_delta=HUBER_DELTA, gradient_mode="sampled",
              backend="cuda", max_iterations=ITERS)
    setups = [lm.setup(cam, t_wc, x_world + 1e-4 * k, patch, channels,
                       grads, obs, pv, frozen, offsets, **kw)
              for k in range(b)]
    return lm.stack_problems([p for p, _ in setups]), setups[0][1]


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits, for equality that tells -0 from 0 and NaN
    from NaN."""
    return t.view(torch.int32 if t.element_size() == 4 else torch.int64)


def ordered_plain(a, c):
    """(row_dot_reference(a, c), the sums of |terms|), over slices of a's
    rows so that no products tensor holds more than ORDERED_SLICE
    elements (one slice where it fits: row_dot_reference itself)."""
    from photobundle_torch.ops import ordered_sum as osm

    if c is None:
        return osm.row_dot_reference(a), osm.row_dot_reference(a.abs())
    per_row = max(1, c[..., 0].numel() * a.shape[-1])
    rows = max(1, ORDERED_SLICE // per_row)
    parts = [(osm.row_dot_reference(a[..., i:i + rows, :], c),
              osm.row_dot_reference(a[..., i:i + rows, :].abs(), c.abs()))
             for i in range(0, a.shape[-2], rows)]
    return (torch.cat([w for w, _ in parts], -2),
            torch.cat([m for _, m in parts], -2))


def record_body_sums(cam, offsets, args, b: int) -> list:
    """Every row_dot call of one eager LM body at b windows of a problem:
    [(a, c, out)]."""
    from photobundle_torch.core import lm
    from photobundle_torch.ops import ordered_sum as osm

    recorded, real = [], osm.row_dot

    def rec(a, c=None):
        out = real(a, c)
        recorded.append((a, c, out))
        return out

    rec.launches = real.launches      # the wrapper counts under its name

    start, body = lm.program(*body_problem(cam, offsets, args, b))
    state, _ = start()
    osm.row_dot = rec                 # contract, row_sum, sum_over call it
    try:
        body(state)
    finally:
        osm.row_dot = real
    torch.cuda.synchronize()
    return recorded


def measure_body_sums(tag: str, recorded: list, twin: bool) -> dict:
    """Each recorded call held to its plain version (within ORDERED_RTOL of
    each output's sum of |terms|) and, with `twin`, bitwise its
    kernel-order twin; timed (kernel and plain: median of ORDERED_CALLS,
    CUDA events; device time L2 flushed; torch's sum / matmul), its bound
    summed. Returns the sums over the calls and the heaviest call."""
    from photobundle_torch.ops import ordered_sum as osm

    real = osm.row_dot
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, t_bytes=0.0,
               t_ops=0.0, device_us=0.0, max_abs_err=0.0, worst=0.0)
    heaviest = (0.0, None, 0.0)
    twins = 0
    for a, c, out in recorded:
        want, mag = ordered_plain(a, c)
        err = (out - want).abs()
        worst = float((err / (ORDERED_RTOL * mag + 1e-30)).max())
        tot["max_abs_err"] = max(tot["max_abs_err"], float(err.max()))
        tot["worst"] = max(tot["worst"], worst)
        del want, mag, err
        if twin:
            same = torch.equal(bits(out), bits(osm.row_dot_ordered(a, c)))
            check(same, f"{tag}: row_dot of {tuple(a.shape)} x "
                  f"{None if c is None else tuple(c.shape)} is not bitwise "
                  f"its kernel-order twin")
            twins += same
        k = a.shape[-1]
        nbytes = (a.numel() + (0 if c is None else c.numel())
                  + out.numel()) * a.element_size()
        flops = out.numel() * k * (1 if c is None else 2)
        lib = ((lambda a=a: a.sum(-1)) if c is None else
               (lambda a=a, c=c: torch.matmul(a, c.transpose(-1, -2))))
        tot["ms"] += median_ms(lambda a=a, c=c: real(a, c), ORDERED_CALLS)
        tot["plain_ms"] += median_ms(lambda a=a, c=c: ordered_plain(a, c)[0],
                                     ORDERED_CALLS)
        tot["library_ms"] += (library_us_per_call(lib)[0] or 0.0) / 1e3
        dev_us = device_us_per_launch(lambda a=a, c=c: real(a, c),
                                      match="row_dot") or 0.0
        tot["device_us"] += dev_us
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
        tot["t_bytes"] += t_bytes
        tot["t_ops"] += t_ops
        if dev_us > heaviest[0]:
            heaviest = (dev_us, (tuple(a.shape), None if c is None
                                 else tuple(c.shape)),
                        max(t_bytes, t_ops) * 1e6)
    tot["bound_ms"] = max(tot["t_bytes"], tot["t_ops"]) * 1e3
    tot["bound_by"] = ("bytes" if tot["t_bytes"] >= tot["t_ops"]
                       else "operations")
    shapes = sorted({tuple(a.shape) for a, _, _ in recorded})
    say(f"{tag}: {len(recorded)} calls in one body (shapes {shapes}), each "
        f"held to its plain version: max abs err {tot['max_abs_err']:.3e}, "
        f"worst {tot['worst']:.3f} of the tolerance ({ORDERED_RTOL:g} x the "
        f"sum of |terms|)"
        + (f"; {twins} of {len(recorded)} bitwise their kernel-order twin"
           if twin else "")
        + f" | summed over the body: kernel {tot['ms']:.4f} ms (median per "
        f"call, CUDA events), plain {tot['plain_ms']:.4f} ms, device "
        f"{tot['device_us']:.2f} us (L2 flushed before each), torch "
        f"sum / matmul {tot['library_ms']:.4f} ms, bound "
        f"{tot['bound_ms'] * 1e3:.3f} us by {tot['bound_by']} | heaviest "
        f"call {heaviest[1]}: device {heaviest[0]:.2f} us, bound "
        f"{heaviest[2]:.3f} us")
    check(tot["worst"] <= 1.0, f"{tag}: row_dot differs from its plain "
          f"version by {tot['worst']:.3f} of its tolerance")
    return tot


def ordered_phase(cam, offsets, args) -> dict:
    """The ordered sums of one eager body at BODY_BATCH windows: every
    call recorded, then each held to its plain version and its
    kernel-order twin and timed at its shapes; one body's at each of
    ORDERED_SIZES (B = 1) against their plain versions, timed; and the
    body's aten operations at B = 1 and BODY_BATCH. Returns the
    BODY_BATCH body's summed numbers for the JSON line."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from photobundle_torch import entry
    from photobundle_torch.core import lm

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    ops = {}
    for b in (1, BODY_BATCH):
        start, body = lm.program(*body_problem(cam, offsets, args, b))
        state, _ = start()
        body(state)
        with Ops() as count:
            body(state)
        ops[b] = count.n
    say(f"phase 16 aten operations per LM body (cuda backend, eager): "
        f"{ops[1]} at B = 1, {ops[BODY_BATCH]} at B = {BODY_BATCH}")
    check(ops[1] == ops[BODY_BATCH], "the LM body's operations grow with B")

    tot = measure_body_sums(
        f"phase 16 row_dot at {N_PTS} x {W}, B = {BODY_BATCH}",
        record_body_sums(cam, offsets, args, BODY_BATCH), twin=True)
    dev = args[0].device
    for n_pts, w in ORDERED_SIZES:
        t0 = time.perf_counter()
        cam_s, off_s, args_s = entry.make_problem(
            n_pts, w, H, WI, PATCH_RADIUS, seed=SEED, device=dev)
        measure_body_sums(f"phase 16 row_dot at {n_pts} x {w}, B = 1",
                          record_body_sums(cam_s, off_s, args_s, 1),
                          twin=False)
        del cam_s, off_s, args_s
        torch.cuda.empty_cache()
        say(f"phase 16 row_dot at {n_pts} x {w}: "
            f"{time.perf_counter() - t0:.1f} s")
    return dict(max_abs_err=tot["max_abs_err"], ms=tot["ms"],
                plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
                bound_by=tot["bound_by"], library_ms=tot["library_ms"],
                device_us=tot["device_us"])


def axis_config(label):
    """AXIS_CONFIGS' configuration of a label, a PBAConfig."""
    from photobundle_torch.config import ConfigFile, PBAConfig

    cfg, _ = AXIS_CONFIGS[label]
    if isinstance(cfg, str):
        return PBAConfig.from_config_file(ConfigFile(cfg))
    return PBAConfig(**cfg)


def batched_configs_phase(scene, kernels) -> dict:
    """Phase 16's engine runs of the other batch axes: for each label of
    AXIS_CONFIGS, with its environment set for its run alone, the batched
    engine at B = ENGINE_BATCH on phase 16's sequences (W + 1 frames, two
    window solves) beside ENGINE_BATCH single engines fed the same frames:
    every window's poses, points and final cost bitwise the single
    engine's, the label's kernel launched once per evaluation for the
    whole batch (`expected_launches`) and no other kernel or mode. Returns
    {label: its launches in the batched run}."""
    from photobundle_torch import entry
    from photobundle_torch.core.batched import \
        BatchedPhotometricBundleAdjustment
    from photobundle_torch.core.engine import PhotometricBundleAdjustment

    cam, images, _, gt = scene
    b, n = ENGINE_BATCH, W + 1
    inits = [entry.drift_poses(np.random.default_rng(k), gt, DRIFT_TRANS,
                               DRIFT_ROT, 1) for k in range(1, b + 1)]
    seqs = [shifted_sequence(scene, k) for k in range(b)]
    out = {}
    for label, (_, env) in AXIS_CONFIGS.items():
        cfg = axis_config(label)
        saved = {key: os.environ.get(key) for key in env}
        os.environ.update(env)
        try:
            t0 = time.perf_counter()
            singles = []
            for k in range(b):
                pba = PhotometricBundleAdjustment(cam, images[0].shape, cfg)
                singles.append([r for i in range(n) if (r := pba.add_frame(
                    seqs[k][0][i], seqs[k][1][i], inits[k][i]))])
            bp = BatchedPhotometricBundleAdjustment(cam, images[0].shape,
                                                    cfg, b)
            check(bp.device.type == "cuda" and bp.backend == "cuda",
                  f"batched engine on {bp.device}, backend {bp.backend}")
            batched = [[] for _ in range(b)]
            torch.cuda.synchronize()
            reset_all(kernels)
            for i in range(n):
                rs = bp.add_frames([s[0][i] for s in seqs],
                                   [s[1][i] for s in seqs],
                                   [init[i] for init in inits])
                for k, r in enumerate(rs or []):
                    batched[k].append(r)
            counts = launch_counts(kernels)
            runs = lm_runs()
        finally:
            for key, value in saved.items():
                if value is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = value
        name, _, mode = label.partition("/")
        wrapper = {"bicubic_stats": "patch_bicubic.bicubic_stats",
                   "scaled_stats": "patch_scaled.scaled_stats",
                   "warp_patches": "patch_samples.warp_patches",
                   "sorted_patch_stats": "patch_warp.sorted_patch_stats"}
        launched = counts.pop((wrapper[name], mode or "mean"))
        others = {f"{k}/{m}": v for (k, m), v in counts.items() if v}
        its = [max(r.iterations for r in solve) for solve in zip(*batched)]
        expected = expected_launches(its)
        unequal = []
        for ra_list, rb_list in zip(singles, batched):
            check(len(ra_list) == len(rb_list) == n - W + 1,
                  f"{label}: {len(ra_list)} single and {len(rb_list)} "
                  f"batched window results")
            for ra, rb in zip(ra_list, rb_list):
                check(bool(np.isfinite(rb.poses).all())
                      and rb.final_cost <= rb.initial_cost,
                      f"{label} window {rb.frame_ids.tolist()}: cost "
                      f"{rb.initial_cost} -> {rb.final_cost}")
                if not (np.array_equal(ra.frame_ids, rb.frame_ids)
                        and ra.num_points == rb.num_points
                        and np.array_equal(ra.poses, rb.poses)
                        and np.array_equal(ra.points_xyz, rb.points_xyz)
                        and ra.final_cost == rb.final_cost):
                    unequal.append(ra.frame_ids.tolist())
        setting = ", ".join([str(AXIS_CONFIGS[label][0] or
                                 "default configuration"),
                             *(f"{k}={v}" for k, v in env.items())])
        say(f"phase 16 batched engine, B = {b}, {label} ({setting}; {n} "
            f"frames of phase 16's sequences, "
            f"{time.perf_counter() - t0:.1f} s with the single engines): "
            f"{len(its)} batched solves, iterations per solve (the longest "
            f"window) {its}; {label} launches {launched} (once per "
            f"evaluation for the whole batch: {expected}; lm runs {runs}), "
            f"other kernels and modes {others or 'none'} | windows whose "
            f"frame ids, point count, poses, points or final cost are not "
            f"bitwise the single engine's: {unequal or 'none'}")
        check(not unequal, f"{label}: windows {unequal} are not bitwise the "
              f"single engines'")
        check(launched == expected > 0, f"{label}: launched {launched} "
              f"times, expected {expected}")
        check(not others, f"{label}: other kernels or modes ran: {others}")
        out[label] = launched
        del bp
    return out


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def leaves(tree) -> list:
    """The tensors of nested tuples, depth first."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for item in tree for t in leaves(item)]


def tree_difference(got, want):
    """None if two nested tuples of tensors are equal bit for bit (NaN
    where NaN), else the first leaf (its index) that differs."""
    for k, (a, b) in enumerate(zip(leaves(got), leaves(want))):
        same = a == b
        if a.is_floating_point():
            same |= torch.isnan(a) & torch.isnan(b)
        if a.shape != b.shape or not bool(same.all()):
            return f"leaf {k} of shape {tuple(a.shape)}"
    return None


def mesh_solver_kw(**extra) -> dict:
    """Phase 4's solve (8 fixed iterations, K1) as a sharded solver's
    options."""
    return {**dict(huber_delta=HUBER_DELTA, gradient_mode="sampled",
                   backend="cuda", max_iterations=ITERS,
                   function_tolerance=0.0, parameter_tolerance=0.0), **extra}


def collectives_per_body(run) -> float:
    """Collectives one LM body issues (one per dtype of each
    parallel/sharded.Collective call): those of run(ITERS) less those of
    run(ITERS // 2), over ITERS // 2 (run: an eager solve of that many
    iterations)."""
    from photobundle_torch.parallel import sharded

    apply = sharded.Collective.apply
    count = [0]

    def counting(self, *tensors):
        count[0] += len({t.dtype for t in tensors})
        return apply(self, *tensors)

    sharded.Collective.apply = counting
    try:
        totals = []
        for iters in (ITERS, ITERS // 2):
            count[0] = 0
            run(iters)
            totals.append(count[0])
    finally:
        sharded.Collective.apply = apply
    return (totals[0] - totals[1]) / (ITERS - ITERS // 2)


def mesh_nccl_phase(dev, solve, cam, offsets, args, scene, drifted,
                    kernels) -> int:
    """Phase 18 (a): NCCL at world size 1 in this process. ShardedLMSolver
    (points = 1) on phase 3's problem and the engine's wrapper on a window
    of phase 6's scene (default configuration), both captured, each
    bitwise the unsharded captured solve, K1 launched as its replays
    count; collectives per body; ms per solve beside the unsharded
    solve's. Returns K1's launches in the sharded solve."""
    import torch.distributed as dist

    from photobundle_torch.config import PBAConfig
    from photobundle_torch.core.engine import PhotometricBundleAdjustment
    from photobundle_torch.ops import patch_warp as pw
    from photobundle_torch.parallel import mesh as mesh_mod
    from photobundle_torch.parallel import sharded

    dist.init_process_group(mesh_mod.backend_for(dev),
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0, device_id=dev)
    try:
        mesh = mesh_mod.make_mesh(points=1)
        solver = sharded.ShardedLMSolver(mesh, cam, offsets, n_points=N_PTS,
                                         **mesh_solver_kw())
        base = solve("cuda")
        torch.cuda.synchronize()
        reset_all(kernels)
        got = solver(*args)
        torch.cuda.synchronize()
        k1 = pw.patch_stats.launches["mean"]
        runs = lm_runs()
        iters = int(got[2].iterations)
        expected = expected_launches([iters])
        check(k1 == expected and runs["captures"] == 2
              and runs["warm_ups"] == 1,
              f"sharded solve: K1 launched {k1} times, expected {expected};"
              f" {runs}")
        check(sum(sum(k.launches.values()) for k in kernels) == k1,
              "another kernel or mode ran in the sharded solve")
        differs = tree_difference(got, base)
        check(differs is None, f"ShardedLMSolver (NCCL, world size 1) "
              f"differs from the unsharded captured solve at {differs}")
        per_body = collectives_per_body(
            lambda n: sharded.ShardedLMSolver(
                mesh, cam, offsets, n_points=N_PTS,
                **mesh_solver_kw(max_iterations=n, capture=False))(*args))
        # The engine's wrapper on the state after a window of the scene.
        cam_s, images, depths, _ = scene
        pba = PhotometricBundleAdjustment(cam_s, images[0].shape,
                                          PBAConfig())
        for i in range(W):
            pba.add_frame(images[i], depths[i], drifted[i])
        window, points = pba.window, pba.points
        ref = pba._optimize(window, points)
        wrapped = sharded.wrap_engine_optimize(pba._optimize, mesh)
        torch.cuda.synchronize()
        reset_all(kernels)
        out = wrapped(window, points)
        torch.cuda.synchronize()
        eng_k1 = pw.patch_stats.launches["mean"]
        eng_expected = expected_launches([int(out[2].iterations)])
        check(eng_k1 == eng_expected, f"engine wrapper: K1 launched "
              f"{eng_k1} times, expected {eng_expected}")
        eng_differs = tree_difference(out, ref)
        check(eng_differs is None, f"the engine's wrapper (NCCL, world size "
              f"1) differs from the unsharded window solve at {eng_differs}")
        times = {"unsharded": [], "sharded": []}
        for _ in range(TIMED_SOLVES):
            for name, fn in (("unsharded", lambda: solve("cuda")),
                             ("sharded", lambda: solver(*args))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
        ms = {k: statistics.median(v) for k, v in times.items()}
        say(f"phase 18 (a) NCCL at world size 1, captured: ShardedLMSolver "
            f"(points = 1) on phase 3's problem bitwise the unsharded "
            f"captured solve ({iters} iterations), K1 launches {k1} "
            f"({iters} replays + 1, + 2 for the cold key's warm-up; lm runs "
            f"{runs}); {per_body:g} collectives per body | the engine's "
            f"wrapper (wrap_engine_optimize) on a window of phase 6's scene "
            f"bitwise the unsharded window solve, K1 launches {eng_k1} | ms "
            f"per solve (median of {TIMED_SOLVES}, interleaved): sharded "
            f"{ms['sharded']:.3f}, unsharded {ms['unsharded']:.3f} (all: "
            f"{' '.join(f'{t:.2f}' for t in times['sharded'])} / "
            f"{' '.join(f'{t:.2f}' for t in times['unsharded'])})")
        return k1
    finally:
        dist.destroy_process_group()


def interior_obs(cam, t_wc, x_world, obs):
    """obs inside both backends' margins by PARITY_MARGIN_PX (phase 4's
    parity inputs)."""
    from photobundle_torch.core import residuals as res_mod

    uv = res_mod._observation_geometry_pm(cam, t_wc, x_world)[1]
    m, pr = PARITY_MARGIN_PX, PATCH_RADIUS
    inside = ((uv[:, 0] >= pr + m) & (uv[:, 0] <= WI - 2 - pr - m)
              & (uv[:, 1] >= pr + m) & (uv[:, 1] <= H - 2 - pr - m)).T
    return obs & inside


def mesh_problems(dev, dtype=torch.float32):
    """Phase 18 (b)'s two solve problems on `dev`: phase 3's (W frames)
    and a MESH_FRAMES_W-frame instance of it, each with phase 4's parity
    observations, in `dtype`. Returns [(cam, offsets, args), ...]."""
    from photobundle_torch import entry

    out = []
    for w in (W, MESH_FRAMES_W):
        cam, offsets, args = entry.make_problem(N_PTS, w, H, WI, PATCH_RADIUS,
                                                seed=SEED, device=dev)
        args = list(args)
        args[5] = interior_obs(cam, args[0], args[1], args[5])
        if dtype != torch.float32:
            args = [a.to(dtype) if a.is_floating_point() else a
                    for a in args]
            cam = type(cam)(*(v.to(dtype) for v in cam))
            offsets = offsets.to(dtype)
        out.append((cam, offsets, tuple(args)))
    return out


def mesh_witness_kw(dtype) -> dict:
    """The witness solves' options: phase 4's start (lambda 1); f64 takes
    the plain evaluation (K1 is f32)."""
    return mesh_solver_kw(initial_lambda=PARITY_LAMBDA, **(
        {} if dtype == torch.float32 else {"backend": "torch"}))


def mesh_rank(rank: int, port: int) -> None:
    """One of phase 18 (b)'s gloo ranks on the card (this script run as
    `chip_smoke.py mesh-rank <rank> <port>`): the points = 2 solve, the
    (frames 2, points 1) solve, the engine with meshPoints = 2 and the
    batched engine with meshWindows = 2 (B = 2), eager (gloo), on the
    inputs in MESH_DIR; writes rank<k>.npz there."""
    import torch.distributed as dist

    from photobundle_torch import entry
    from photobundle_torch.config import PBAConfig
    from photobundle_torch.core.batched import \
        BatchedPhotometricBundleAdjustment
    from photobundle_torch.core.engine import PhotometricBundleAdjustment
    from photobundle_torch.geometry.camera import Camera
    from photobundle_torch.ops import _build, _common
    from photobundle_torch.ops import patch_warp as pw
    from photobundle_torch.parallel import make_mesh, sharded
    from photobundle_torch.parallel import mesh as mesh_mod

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.build_all(SOURCES)
    mesh_mod.initialize_distributed(f"127.0.0.1:{port}", MESH_RANKS, rank,
                                    device=dev, backend="gloo")
    out, ms = {}, {}

    def timed(name, fn):
        result = fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(MESH_TIMED):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms[name] = statistics.median(times)
        return result

    (cam, offsets, args), (cam4, off4, args4) = mesh_problems(dev)
    kw = mesh_solver_kw(initial_lambda=MESH_LAMBDA)
    points = sharded.ShardedLMSolver(make_mesh(points=MESH_RANKS), cam,
                                     offsets, n_points=N_PTS, **kw)
    frames = sharded.make_frames_sharded_solver(
        sharded.make_frames_mesh(frames=MESH_RANKS, points=1), cam4, off4,
        n_points=N_PTS, window_size=MESH_FRAMES_W, **kw)
    _common.reset_launches(pw.patch_stats)
    for name, solver, a in (("points", points, args),
                            ("frames", frames, args4)):
        t, x, st = timed(name, lambda: solver(*a))
        out.update({f"{name}/t_wc": t, f"{name}/x": x,
                    **{f"{name}/{k}": v for k, v in st._asdict().items()}})
    out["k1_launches"] = torch.tensor(pw.patch_stats.launches["mean"])
    for dtype in (torch.float64, torch.float32):
        (cam, offsets, args), (cam4, off4, args4) = mesh_problems(dev, dtype)
        kw = mesh_witness_kw(dtype)
        witness = (
            ("points", sharded.ShardedLMSolver(
                make_mesh(points=MESH_RANKS), cam, offsets, n_points=N_PTS,
                **kw), args),
            ("frames", sharded.make_frames_sharded_solver(
                sharded.make_frames_mesh(frames=MESH_RANKS, points=1), cam4,
                off4, n_points=N_PTS, window_size=MESH_FRAMES_W, **kw),
             args4))
        for name, solver, a in witness:
            t, x, st = solver(*a)
            key = f"lambda1/{str(dtype)[6:]}/{name}"
            out.update({f"{key}/t_wc": t, f"{key}/x": x,
                        f"{key}/iterations": st.iterations,
                        f"{key}/final_cost": st.final_cost})
    with np.load(os.path.join(MESH_DIR, "scene.npz")) as data:
        scene = {k: data[k] for k in data.files}
    cam_s = Camera.create(*(float(v) for v in scene["cam"]), device=dev)
    images, depths, gt = scene["images"], scene["depths"], scene["gt"]
    pba = PhotometricBundleAdjustment(cam_s, images[0].shape,
                                      PBAConfig(meshPoints=MESH_RANKS))
    t0 = time.perf_counter()
    results = [r for i in range(len(images)) if (
        r := pba.add_frame(images[i], depths[i], scene["drifted"][i]))]
    out["engine/poses"] = np.stack([r.poses for r in results])
    out["engine/iterations"] = np.array([r.iterations for r in results])
    ms["engine (8 frames)"] = (time.perf_counter() - t0) * 1e3
    inits = [entry.drift_poses(np.random.default_rng(k), gt, DRIFT_TRANS,
                               DRIFT_ROT, 1) for k in (1, 2)]
    bp = BatchedPhotometricBundleAdjustment(
        cam_s, images[0].shape, PBAConfig(meshWindows=MESH_RANKS), 2)
    t0 = time.perf_counter()
    out["batched/poses"] = torch.as_tensor(np.stack([
        np.stack([r.poses for r in rs]) for i in range(len(images))
        if (rs := bp.add_frames([images[i]] * 2, [depths[i]] * 2,
                                [init[i] for init in inits]))]))
    ms["batched engine (8 frames)"] = (time.perf_counter() - t0) * 1e3
    out["ms"] = np.frombuffer(json.dumps(ms).encode(), np.uint8)
    np.savez(os.path.join(MESH_DIR, f"rank{rank}.npz"),
             **{k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                for k, v in out.items()})
    dist.destroy_process_group()


def mesh_gloo_phase(dev, scene, drifted) -> None:
    """Phase 18 (b): MESH_RANKS spawned gloo ranks sharing the card
    (`mesh_rank`), capture=False. Their outputs must be bitwise equal, the
    solves within the JAX tests' tolerances of the single-rank captured
    solve on the card, the engine within MESH_ENGINE_ATOL of the single
    engine, and each batched window bitwise its single engine's."""
    from photobundle_torch import entry
    from photobundle_torch.config import PBAConfig
    from photobundle_torch.core import lm
    from photobundle_torch.core.engine import PhotometricBundleAdjustment

    cam_s, images, depths, gt = scene
    n = DEFAULT_FRAMES
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    np.savez(os.path.join(MESH_DIR, "scene.npz"),
             cam=np.array([float(v) for v in cam_s], np.float32),
             images=np.stack(images[:n]), depths=np.stack(depths[:n]),
             gt=gt[:n], drifted=drifted[:n])
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "mesh-rank", str(k),
         str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True) for k in range(MESH_RANKS)]
    try:
        # The single-rank references while the ranks run.
        refs = []
        for cam, offsets, args in mesh_problems(dev):
            refs.append(lm.lm_solve(cam, *args, offsets, **mesh_solver_kw(
                initial_lambda=MESH_LAMBDA)))
        witness_refs = {}
        for dtype in (torch.float64, torch.float32):
            for name, (cam, offsets, args) in zip(
                    ("points", "frames"), mesh_problems(dev, dtype)):
                witness_refs[f"{str(dtype)[6:]}/{name}"] = lm.lm_solve(
                    cam, *args, offsets, **mesh_witness_kw(dtype))
        pba = PhotometricBundleAdjustment(cam_s, images[0].shape,
                                          PBAConfig())
        results = [r for i in range(n) if (
            r := pba.add_frame(images[i], depths[i], drifted[i]))]
        engine = np.stack([r.poses for r in results])
        engine_its = [r.iterations for r in results]
        singles = []
        for k in (1, 2):
            init = entry.drift_poses(np.random.default_rng(k), gt,
                                     DRIFT_TRANS, DRIFT_ROT, 1)
            pba = PhotometricBundleAdjustment(cam_s, images[0].shape,
                                              PBAConfig())
            singles.append(np.stack([r.poses for i in range(n) if (
                r := pba.add_frame(images[i], depths[i], init[i]))]))
        logs = []
        for proc in procs:
            log, _ = proc.communicate(timeout=MESH_TIMEOUT_S)
            logs.append(log)
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.communicate()
    wall = time.perf_counter() - t0
    for k, (proc, log) in enumerate(zip(procs, logs)):
        check(proc.returncode == 0, f"mesh rank {k} exited "
              f"{proc.returncode}:\n{log[-4000:]}")
    ranks = []
    for k in range(MESH_RANKS):
        with np.load(os.path.join(MESH_DIR, f"rank{k}.npz")) as data:
            ranks.append({key: data[key] for key in data.files})
    for key in ranks[0]:
        if key != "ms":
            check(all(np.array_equal(r[key], ranks[0][key], equal_nan=True)
                      for r in ranks[1:]), f"mesh ranks differ in {key}")
    r = ranks[0]
    worst, fails = {}, []
    for name, (t, x, st) in zip(("points", "frames"), refs):
        t, x = t.cpu().numpy(), x.cpu().numpy()
        dt = float(np.abs(r[f"{name}/t_wc"] - t).max())
        dx = float(np.abs(r[f"{name}/x"] - x).max())
        dc = abs(float(r[f"{name}/final_cost"]) / float(st.final_cost) - 1)
        its = (int(r[f"{name}/iterations"]), int(st.iterations))
        if not (its[0] == its[1]
                and np.allclose(r[f"{name}/t_wc"], t, atol=MESH_POSE_TOL,
                                rtol=MESH_POSE_TOL)
                and np.allclose(r[f"{name}/x"], x, atol=MESH_POINT_TOL,
                                rtol=MESH_POINT_TOL)
                and dc <= MESH_COST_RTOL):
            fails.append(f"{name} solve vs single: iterations {its}, poses "
                         f"{dt:.3e}, points {dx:.3e}, cost {dc:.3e}")
        worst[name] = (dt, dx, dc)
    witness = {}
    for key, (t, x, st) in witness_refs.items():
        got = {k: r[f"lambda1/{key}/{k}"] for k in ("t_wc", "x",
                                                      "iterations",
                                                      "final_cost")}
        dt = float(np.abs(got["t_wc"] - t.cpu().numpy()).max())
        dx = float(np.abs(got["x"] - x.cpu().numpy()).max())
        dc = abs(float(got["final_cost"]) / float(st.final_cost) - 1)
        its = (int(got["iterations"]), int(st.iterations))
        witness[key] = (dt, dx, dc)
        if key.startswith("float64") and not (
                its[0] == its[1] and max(dt, dx, dc) <= MESH_F64_TOL):
            fails.append(f"{key} solve from lambda {PARITY_LAMBDA:g} vs "
                         f"single: iterations {its}, poses {dt:.3e}, points "
                         f"{dx:.3e}, cost {dc:.3e} (tolerance "
                         f"{MESH_F64_TOL:g})")
    same_shape = r["engine/poses"].shape == engine.shape
    de = (float(np.abs(r["engine/poses"] - engine).max()) if same_shape
          else float("inf"))
    if de > MESH_ENGINE_ATOL:
        fails.append(f"engine (meshPoints = {MESH_RANKS}) vs single: shapes "
                     f"{r['engine/poses'].shape} {engine.shape}, poses "
                     f"{de:.3e}, iterations {r['engine/iterations'].tolist()}"
                     f" vs {engine_its}")
    bitwise = [bool(np.array_equal(r["batched/poses"][:, b], single))
               for b, single in enumerate(singles)]
    if not all(bitwise):
        fails.append(f"batched windows (meshWindows = {MESH_RANKS}) bitwise "
                     f"their single engines: {bitwise}")
    ms = json.loads(bytes(r["ms"]).decode())
    say(f"phase 18 (b) {MESH_RANKS} gloo ranks sharing the card "
        f"(capture=False), {wall:.1f} s: every output bitwise equal across "
        f"ranks | points = {MESH_RANKS} on phase 3's problem and frames = "
        f"{MESH_RANKS} x points = 1 on a {N_PTS} x {MESH_FRAMES_W} instance "
        f"(phase 4's parity observations, initial lambda {MESH_LAMBDA:g}) vs "
        f"the single-rank captured solve: "
        + ", ".join(f"{k} poses {v[0]:.3e}, points {v[1]:.3e}, cost rel "
                    f"{v[2]:.3e}" for k, v in worst.items())
        + f" (tolerances {MESH_POSE_TOL:g}, {MESH_POINT_TOL:g}, "
        f"{MESH_COST_RTOL:g}; equal iterations) | witness from phase 4's "
        f"start (lambda {PARITY_LAMBDA:g}) vs the single-rank solve of its "
        f"dtype (f64 held to {MESH_F64_TOL:g}, equal iterations; f32 "
        f"printed): " + ", ".join(
            f"{k} poses {v[0]:.3e}, points {v[1]:.3e}, cost rel {v[2]:.3e}"
            for k, v in witness.items())
        + f" | engine meshPoints = "
        f"{MESH_RANKS}, default configuration, {n} frames: {len(engine)} "
        f"windows (iterations {r['engine/iterations'].tolist()}, single "
        f"{engine_its}), poses within {de:.3e} of the single engine (atol "
        f"{MESH_ENGINE_ATOL:g}) | batched engine meshWindows = {MESH_RANKS},"
        f" B = 2: windows bitwise their single engines {bitwise} | K1 "
        f"launches per rank in the two solves {int(r['k1_launches'])} | ms "
        f"on rank 0: " + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()))
    check(not fails, "; ".join(fails))


def multi_phase(dev) -> None:
    """Phase 17: `python -m photobundle_torch.multi` on phase 12's
    sequence, units of MULTI_FRAMES_PER_UNIT frames, with 2 spawned
    workers and then 1: the merged trajectories byte-identical."""
    data = os.path.join(CLI_DIR, "kitti")
    check(os.path.isfile(os.path.join(data, "vo.txt")),
          "phase 12's sequence is missing")
    shutil.rmtree(MULTI_DIR, ignore_errors=True)
    poses = os.path.join(MULTI_DIR, "poses")
    os.makedirs(poses)
    shutil.copyfile(os.path.join(data, "vo.txt"),
                    os.path.join(poses, "00.txt"))
    texts, walls = {}, {}
    for workers in (2, 1):
        out = os.path.join(MULTI_DIR, f"out{workers}")
        cmd = [sys.executable, "-m", "photobundle_torch.multi",
               "--config", "configs/kitti_production.cfg", "--sequences",
               "0", "--output-dir", out, "--workers", str(workers),
               "--frames-per-unit", str(MULTI_FRAMES_PER_UNIT),
               "--poses-dir", poses, "--device", dev.type,
               f"dataDir={data}", f"maxNumPoints={N_PTS}",
               f"depthCacheDir={CLI_DEPTH_CACHE}"]
        t0 = time.perf_counter()
        # A process group of its own: a time-out stops it and its workers.
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            log, _ = proc.communicate(timeout=MULTI_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.communicate()
            raise
        walls[workers] = time.perf_counter() - t0
        check(proc.returncode == 0, f"multi --workers {workers} exited "
              f"{proc.returncode}:\n{log[-4000:]}")
        done = [f for f in os.listdir(os.path.join(out, ".sched"))
                if f.endswith(".done")]
        check(len(done) == CLI_FRAMES // MULTI_FRAMES_PER_UNIT,
              f"multi --workers {workers}: {len(done)} units done")
        with open(os.path.join(out, "00.txt")) as f:
            texts[workers] = f.read()
        claimed = sorted(set(re.findall(r"\[(w\d)\] refining unit", log)))
        say(f"phase 17 python -m photobundle_torch.multi --workers "
            f"{workers} --frames-per-unit {MULTI_FRAMES_PER_UNIT}: exit 0 in "
            f"{walls[workers]:.1f} s, {len(done)} units done"
            f"{f', claimed by {claimed}' if claimed else ''}, merged "
            f"trajectory of {len(texts[workers].splitlines())} poses")
    check(len(texts[1].splitlines()) == CLI_FRAMES,
          "the merged trajectory does not cover the sequence")
    check(texts[2] == texts[1], "the 2-worker merged trajectory is not "
          "byte-identical to the 1-worker one")
    say("phase 17 the 2-worker and 1-worker merged trajectories are "
        "byte-identical")


def tee(fn, *args):
    """(fn(*args), what it printed): its standard output is captured and
    echoed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    sys.stdout.write(buf.getvalue())
    sys.stdout.flush()
    return out, buf.getvalue()


def golden_frame_check(synthetic, root: str, dev) -> None:
    """Frame 0 of the golden rendered on the card (float32) against the
    numpy renderer (float64) at full size: image within 1/255, depth
    within 1e-4 relative on > 90 % of the pixels, validity masks
    disagreeing on < 1 %; and the PNG on disk within one level of the
    numpy image's quantization."""
    from photobundle_torch.config import PBAConfig
    from photobundle_torch.io import kitti as kitti_mod
    from photobundle_torch.io import trajectory as traj_mod

    ks = kitti_mod.KittiStereoDataset(
        root=root, sequence=0,
        cfg=PBAConfig(dataDir=root, numFrames=1), device=dev)
    pose = traj_mod.load_poses_kitti(os.path.join(
        root, "poses", "00.txt")).poses[0].astype(np.float32)
    tex = synthetic.make_texture(np.random.default_rng(12), n_waves=96,
                                 min_wavelength=0.25, max_wavelength=4.0)
    boxes = synthetic.default_obstacles()
    t0 = time.perf_counter()
    img_np, depth_np = synthetic.render_box(tex, ks.camera, pose, (H, WI),
                                            obstacles=boxes)
    np_s = time.perf_counter() - t0
    render = synthetic.make_render_box_torch((H, WI), obstacles=boxes,
                                             device=dev)
    render(tex, ks.camera, pose)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img_t, depth_t = render(tex, ks.camera, pose)
    card_ms = (time.perf_counter() - t0) * 1e3
    d_img = float(np.max(np.abs(img_t - img_np)))
    valid = (depth_np > 0) & (depth_t > 0)
    d_depth = float(np.max(np.abs(depth_t - depth_np)[valid]
                           / depth_np[valid]))
    mask = float(np.mean((depth_np > 0) != (depth_t > 0)))
    png_u8 = np.rint(kitti_mod._imread_gray(ks.left_files[0]) * 255)
    d_png = float(np.max(np.abs(png_u8 - np.clip(img_np * 255, 0, 255)
                                .astype(np.uint8))))
    say(f"phase 19 golden frame 0 at {H}x{WI}, torch renderer on the card "
        f"({card_ms:.1f} ms) vs numpy ({np_s:.1f} s on the host): image "
        f"max |d| {d_img:.3e} (< 1/255), depth max rel {d_depth:.3e} (< "
        f"1e-4) on {valid.mean():.4f} of the pixels (> 0.9), masks differ "
        f"on {mask:.5f} (< 0.01); the PNG on disk within {d_png:.0f} level "
        f"of the numpy image's")
    check(d_img < 1.0 / 255.0 and valid.mean() > 0.9 and d_depth < 1e-4
          and mask < 0.01 and d_png <= 1,
          "the card's golden renderer left the numpy renderer's bounds")


class PlainTwinSolves:
    """While open: every window solve of an engine in bicubic
    interpolation (the golden's reference_exact, K2) is solved again from
    the same pre-solve state by a twin engine on the plain backend
    (`solverBackend=torch`, the same card). `rows` holds each pair's
    (initial cost, final cost, obs per frame, residuals), K2's first."""

    def __init__(self):
        from photobundle_torch.core import engine
        self.cls = engine.PhotometricBundleAdjustment
        self.solve = self.cls._optimize
        self.rows = []

    def __enter__(self):
        solve, rows, cls, twins = self.solve, self.rows, self.cls, {}

        def fields(stats):
            return (float(stats.initial_cost), float(stats.final_cost),
                    stats.obs_per_frame.tolist(), int(stats.n_residuals))

        def recorded(pba, window, points, shard_ctx=None):
            out = solve(pba, window, points, shard_ctx)
            if pba.cfg.interpolation == "bicubic":
                if id(pba) not in twins:
                    twins[id(pba)] = cls(
                        pba.camera_full, pba.image_shape,
                        pba.cfg.replace(solverBackend="torch"),
                        device=pba.device)
                plain = solve(twins[id(pba)], window, points)
                rows.append((fields(out[2]), fields(plain[2])))
            return out

        cls._optimize = recorded
        return self

    def __exit__(self, *exc):
        self.cls._optimize = self.solve


def tools_phase_19(dev, kernels) -> None:
    """Phase 19: the remaining tools on the card (see the docstring)."""
    from photobundle_torch.ops import patch_bicubic as pb
    from photobundle_torch.ops import patch_warp as pw
    from photobundle_torch.tools import (bench_keyframes, bench_lm_breakdown,
                                         bench_sampling, bench_scaling,
                                         diagnose_rpe, eval_traj,
                                         golden_aggregate, golden_kitti,
                                         plot_traj, probe_eval65k, synthetic,
                                         verify_e2e)

    t_phase = time.perf_counter()
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    os.makedirs(TOOLS_DIR)
    # (a) one LM iteration phase by phase, and one body's profile.
    # Child processes of their own (BREAKDOWN_PROCESSES): in this process,
    # after phases 3-18, the body's traces missed most of the assembly's
    # device activities (two whole runs); a fresh process traces them all,
    # and a trace that misses one fails the phase.
    sizes, recs = [], []
    for group in BREAKDOWN_PROCESSES:
        part = [(n, w, min(calls, bench_lm_breakdown.default_calls(n)))
                for n, w, calls in group]
        code = "from photobundle_torch.tools import bench_lm_breakdown as b\n"
        # At phase 3's size the body is also traced at BODY_BATCH windows.
        code += "".join(
            f"b.main(['{n}', '{w}', '{k}'"
            f"{f', \'--batch\', \'{BODY_BATCH}\'' if n == N_PTS else ''}])\n"
            for n, w, k in part)
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True,
                             timeout=BREAKDOWN_TIMEOUT_S)
        sys.stdout.write(run.stdout)
        check(run.returncode == 0, f"bench_lm_breakdown exited "
              f"{run.returncode}:\n{run.stderr[-4000:]}")
        got = [json.loads(line) for line in run.stdout.splitlines()
               if line.startswith('{"tool": "bench_lm_breakdown"')]
        check(len(got) == len(part), f"bench_lm_breakdown printed "
              f"{len(got)} records, not {len(part)}")
        say(f"phase 19a bench_lm_breakdown at {len(part)} size(s) in one "
            f"process: {time.perf_counter() - t0:.1f} s")
        sizes += part
        recs += got
    for (n, w, calls), rec in zip(sizes, recs):
        for key, row in rec["phases"].items():
            check(row["bitwise"], f"bench_lm_breakdown {n}: the phase "
                  f"{key} is not bitwise the body's on its inputs")
            check(min(row["ms"], row["device_ms"]) >= row["floor_ms"],
                  f"bench_lm_breakdown {n}: {key} took {row['ms']:.4f} ms "
                  f"(device {row['device_ms']:.4f}) under its bytes floor "
                  f"{row['floor_ms']:.4f} ms")
        check(rec["n_pts"] == n and rec["body"]["evaluate"]["kernels"] > 0
              and rec["body_ms"] > 0, f"bench_lm_breakdown {n}: the body's "
              "trace attributes no device time to the evaluation")
        check(rec["trace_complete"], f"bench_lm_breakdown {n}: the body's "
              f"traces hold {rec['trace_kernels']} device activities for "
              f"{rec['launches']} launches")
        say(f"phase 19a bench_lm_breakdown {n} x {w}, K = {calls}: every "
            f"phase bitwise the body's and above its bytes floor; the "
            f"body's phases {rec['body_ms']:.3f} ms of device time in "
            f"{rec['body_kernels']} kernels (every trace whole: "
            f"{rec['trace_kernels']} of {rec['launches']} launches), the "
            f"replayed body {rec['replayed_body_ms']:.3f} ms")
        bat = rec["batched"]
        if bat is None:
            continue
        check(bat["trace_complete"], f"bench_lm_breakdown {n} at B = "
              f"{bat['batch']}: the body's traces hold {bat['trace_kernels']}"
              f" device activities for {bat['launches']} launches")
        check(bat["body_kernels"] == rec["body_kernels"], f"bench_lm_breakdown"
              f" {n}: {bat['body_kernels']} kernels per body at B = "
              f"{bat['batch']}, {rec['body_kernels']} at B = 1")
        say(f"phase 19a bench_lm_breakdown {n} x {w} per body phase, device "
            f"ms / kernels at B = 1 | B = {bat['batch']}: " + ", ".join(
                f"{ph} {rec['body'][ph]['ms']:.3f}/"
                f"{rec['body'][ph]['kernels']} | {bat['body'][ph]['ms']:.3f}/"
                f"{bat['body'][ph]['kernels']}" for ph in rec["body"])
            + f"; body {rec['body_ms']:.3f} | {bat['body_ms']:.3f} ms, "
            f"replayed {rec['replayed_body_ms']:.3f} | "
            f"{bat['replayed_body_ms']:.3f} ms")
    # (b) the evaluation stage by stage at 65 536 points.
    t0 = time.perf_counter()
    rec = probe_eval65k.main([str(DENSE_PTS), str(W)])
    check(all(row["device_ms"] > 0 for row in rec["stages"].values()),
          "probe_eval65k measured no device time in a stage")
    say(f"phase 19b probe_eval65k {DENSE_PTS} x {W} "
        f"({time.perf_counter() - t0:.1f} s)")
    # (c) the command line on verify_e2e's synthetic sequence.
    t0 = time.perf_counter()
    rec = verify_e2e.main(["--root", os.path.join(TOOLS_DIR, "verify_e2e")])
    check(rec["windows"] > 0 and rec["ate_refined"] < rec["ate_init"],
          f"verify_e2e: {rec}")
    say(f"phase 19c verify_e2e ({time.perf_counter() - t0:.1f} s): VERIFY "
        f"OK, {rec['windows']} windows, ATE {rec['ate_init']:.5f} -> "
        f"{rec['ate_refined']:.5f}")
    # (d) the golden: render on the card, refine in two configurations.
    root = os.path.join(TOOLS_DIR, "golden_box")
    out = os.path.join(TOOLS_DIR, "golden_out")
    t0 = time.perf_counter()
    reset_all(kernels)
    with PlainTwinSolves() as twins:
        golden, text = tee(golden_kitti.main, [
            "--root", root, "--frames", str(GOLDEN_FRAMES), "--error-model",
            "iid", "--configs", ",".join(GOLDEN_CONFIGS), "--out-dir", out])
    k1, k2 = (pw.patch_stats.launches["mean"],
              pb.bicubic_stats.launches["mean"])
    golden_s = time.perf_counter() - t0
    with open(os.path.join(root, "render_provenance.json")) as f:
        check(json.load(f)["renderer"] == "torch",
              "the golden was not rendered on the card")
    for name in GOLDEN_CONFIGS:
        recs = read_jsonl(os.path.join(out, f"refined_{name}.txt.jsonl"))
        check(len(recs) == GOLDEN_FRAMES - W + 1,
              f"golden {name}: {len(recs)} windows solved")
        check(all(r["final_cost"] <= r["initial_cost"] for r in recs),
              f"golden {name}: a window's cost rose")
    prod = golden["rows"]["W5_production"]
    check(prod["ate"] < golden["ate_init"], f"golden W5_production: refined "
          f"ATE {prod['ate']:.4f} not below the input's "
          f"{golden['ate_init']:.4f}")
    check(k1 > 0 and k2 > 0, f"golden: K1 launched {k1}, K2 {k2} times")
    # reference_exact (K2) window by window against its plain twin, from
    # the same pre-solve states.
    check(len(twins.rows) == GOLDEN_FRAMES - W + 1,
          f"golden reference_exact: {len(twins.rows)} twin solves")
    worst_init = worst_final = 0.0
    for k, (kern, plain) in enumerate(twins.rows):
        check(kern[2] == plain[2] and kern[3] == plain[3],
              f"golden reference_exact window {k}: observations per frame "
              f"{kern[2]} / residuals {kern[3]} against the plain solve's "
              f"{plain[2]} / {plain[3]}")
        init_gap = abs(kern[0] - plain[0]) / plain[0]
        final_gap = kern[1] / plain[1] - 1.0
        worst_init = max(worst_init, init_gap)
        worst_final = max(worst_final, final_gap)
        check(init_gap <= GOLDEN_INIT_RTOL and final_gap <= GOLDEN_COST_RTOL,
              f"golden reference_exact window {k}: costs {kern[0]:.6f} -> "
              f"{kern[1]:.6f} against the plain solve's {plain[0]:.6f} -> "
              f"{plain[1]:.6f}")
    say(f"phase 19d golden reference_exact against its plain twin, "
        f"{len(twins.rows)} windows from the same states: observations "
        f"equal, initial costs within {worst_init:.2e} (<= "
        f"{GOLDEN_INIT_RTOL:g}), final costs at most {worst_final:+.2%} "
        f"above the plain solve's (<= {GOLDEN_COST_RTOL:.0%})")
    say(f"phase 19d golden_kitti ({golden_s:.1f} s, {GOLDEN_FRAMES} frames "
        f"rendered on the card and refined twice): every window's cost "
        f"non-increasing; ATE {golden['ate_init']:.4f} -> "
        + ", ".join(f"{n} {r['ate']:.4f} ({r['reduction']:+.1f} %)"
                    for n, r in golden["rows"].items())
        + f"; K1 launched {k1}, K2 {k2} times")
    golden_frame_check(synthetic, root, dev)
    log = os.path.join(out, "golden.log")
    with open(log, "w") as f:
        f.write(text)
    check(golden_aggregate.main(["--logs", log]) == 0,
          "golden_aggregate found no table")
    refined = os.path.join(out, "refined_W5_production.txt")
    gt = os.path.join(root, "poses", "00.txt")
    init = os.path.join(out, "vo_init.txt")
    check(diagnose_rpe.main(["--run", refined, "--gt", gt, "--init",
                             init]) == 0, "diagnose_rpe failed")
    lines = eval_traj.main([refined, gt, init])
    check(lines[1]["ate_rmse_m"] < lines[0]["ate_rmse_m"],
          "eval_traj: the refined ATE is not below the input's")
    import importlib.util
    if importlib.util.find_spec("matplotlib") is None:
        say("phase 19d plot_traj not run: matplotlib is not installed on "
            "this machine (tests/test_torch_tools.py runs it on the CPU)")
    else:
        png_path = os.path.join(out, "traj.png")
        plot_traj.main([refined, gt, init, "--jsonl", refined + ".jsonl",
                        "--out", png_path])
        check(os.path.getsize(png_path) > 10_000, "plot_traj wrote no plot")
    # (e) the engine's and the solve's benches at their JAX twins' sizes
    # (bench_scaling at SCALING_SIZES of them).
    for label, fn, argv in (
            ("bench_keyframes", bench_keyframes.main, []),
            ("bench_sampling", bench_sampling.main, []),
            ("bench_scaling", bench_scaling.main, ["--sizes", SCALING_SIZES])):
        t0 = time.perf_counter()
        fn(argv)
        say(f"phase 19e {label} ({time.perf_counter() - t0:.1f} s)")
    say(f"phase 19 done in {time.perf_counter() - t_phase:.1f} s")


class FirstWindow:
    """While open: the engine of the next run (cli.main builds its own)
    and the state its first window solve starts from are recorded
    (`engine`, `state`), and every lm_solve's iteration count, as a device
    tensor read after the run (a read here would make the run wait where
    it does not)."""

    def __init__(self):
        from photobundle_torch.core import engine, lm
        self.cls, self.lm = engine.PhotometricBundleAdjustment, lm
        self.optimize, self.solve = self.cls._optimize, lm.lm_solve
        self.engine = self.state = None
        self.iterations = []

    def __enter__(self):
        rec = self

        def optimize(pba, window, points, shard_ctx=None):
            if rec.engine is None:   # _optimize leaves its inputs as they are
                rec.engine, rec.state = pba, (window, points)
            return rec.optimize(pba, window, points, shard_ctx)

        def solve(*args, **kwargs):
            out = rec.solve(*args, **kwargs)
            rec.iterations.append(out[2].iterations)
            return out

        self.cls._optimize, self.lm.lm_solve = optimize, solve
        return self

    def __exit__(self, *exc):
        self.cls._optimize, self.lm.lm_solve = self.optimize, self.solve


def shipped_run(path, data, n, out, kernels, **overrides) -> dict:
    """cli.main on the configuration file `path` over the first `n` frames
    of the sequence under `data` (its vo.txt in), key=value overrides
    besides dataDir and numFrames, writing `out`.txt and `out`.jsonl.
    Returns the run's wall s, its dataset's s per frame (`get_frame`:
    decode, stereo, depth) and stereo s per frame (`_compute_depth`, the
    torch matcher and depth; none where the native producer runs), launch
    counts, lm_solve iterations and expected launches, peak device memory,
    records, trajectory text, and the engine with its first window's
    pre-solve state."""
    from photobundle_torch import cli
    from photobundle_torch.io import kitti

    argv = ["--config", path, "--poses", os.path.join(data, "vo.txt"),
            "--output", f"{out}.txt", "--log", f"{out}.jsonl",
            f"dataDir={data}", f"numFrames={n}",
            *(f"{k}={v}" for k, v in overrides.items())]
    cls = kitti.KittiStereoDataset
    timed = {"get_frame": [], "_compute_depth": []}
    methods = {name: getattr(cls, name) for name in timed}

    def timer(name):
        def call(self, *args, **kwargs):
            t = time.perf_counter()
            out = methods[name](self, *args, **kwargs)   # host arrays out
            timed[name].append(time.perf_counter() - t)
            return out
        return call

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all(kernels)
    for name in timed:
        setattr(cls, name, timer(name))
    try:
        with FirstWindow() as rec:
            t0 = time.perf_counter()
            rc = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for name, method in methods.items():
            setattr(cls, name, method)
    check(rc == 0, f"cli.main {' '.join(argv)} returned {rc}")
    its = [int(i) for i in rec.iterations]
    with open(f"{out}.txt") as f:
        text = f.read()
    return dict(wall=wall, dataset_s=timed["get_frame"],
                stereo_s=timed["_compute_depth"],
                counts={k: v for k, v in launch_counts(kernels).items() if v},
                iterations=its, expected=expected_launches(its),
                peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                records=read_jsonl(f"{out}.jsonl"), text=text,
                engine=rec.engine, first_state=rec.state)


def same_state(a, b) -> bool:
    """Two engine states (window, points), every tensor bitwise equal."""
    return all(torch.equal(x, y) for sa, sb in zip(a, b)
               for x, y in zip(sa, sb))


def shipped_phase(kernels, dev) -> None:
    """Phase 20 (A): SHIPPED_CONFIGS through cli.main on phase 12's
    sequence, each as shipped but for dataDir and numFrames, run with
    solverBackend=cuda (what auto resolves to on the card) and
    solverBackend=torch: every frame's pose finite, every window's cost
    non-increasing, the configuration's kernel launched once per
    evaluation of every solve on the cuda run and no kernel on the torch
    run, both runs' first windows starting from bitwise the same state,
    and that state's initial cost within ENGINE_COST_RTOL on the two
    backends (the torch evaluation restricted to the cuda path's valid
    set where sampling is bilinear, as phase 10 restricts it); under
    pipelineResults the cuda run's trajectory file byte-identical to a
    run with pipelineResults=False. Later windows are chained (f32
    differences compound), so their costs are printed, not held."""
    from photobundle_torch.config import ConfigFile, PBAConfig
    from photobundle_torch.io import trajectory as traj
    from photobundle_torch.ops import patch_bicubic as pb
    from photobundle_torch.ops import patch_warp as pw

    data = os.path.join(CLI_DIR, "kitti")
    check(os.path.isfile(os.path.join(data, "vo.txt")),
          "phase 12's sequence is missing")
    shutil.rmtree(SHIPPED_DIR, ignore_errors=True)
    os.makedirs(SHIPPED_DIR)
    gt = traj.load_poses_kitti(os.path.join(data, "poses", "00.txt")).poses
    vo = traj.load_poses_kitti(os.path.join(data, "vo.txt")).poses
    smi = nvidia_smi()
    for name in SHIPPED_CONFIGS:
        path = os.path.join("configs", f"{name}.cfg")
        cfg = PBAConfig.from_config_file(ConfigFile(path))
        check(cfg.resolve_backend(dev) == "cuda", f"{name}: solverBackend="
              f"{cfg.solverBackend} resolves to {cfg.resolve_backend(dev)}")
        n = SHIPPED_FRAMES.get(name, DEFAULT_FRAMES)
        windows = n - cfg.slidingWindowSize + 1
        kernel = (pb.bicubic_stats if cfg.interpolation == "bicubic"
                  else pw.patch_stats)
        counted = (kernel_label(kernel), cfg.resolve_normalization())
        runs = {be: shipped_run(path, data, n,
                                os.path.join(SHIPPED_DIR, f"{name}_{be}"),
                                kernels, solverBackend=be)
                for be in ("cuda", "torch")}
        ate_vo = ate(vo[:n], gt[:n])
        for be, run in runs.items():
            poses = traj.load_poses_kitti(
                os.path.join(SHIPPED_DIR, f"{name}_{be}.txt")).poses
            check(len(poses) == len(vo) and bool(np.isfinite(poses).all()),
                  f"{name} ({be}): {len(poses)} poses written, finite "
                  f"{bool(np.isfinite(poses).all())}")
            recs = run["records"]
            check(len(recs) == windows == len(run["iterations"]),
                  f"{name} ({be}): {len(recs)} windows logged, "
                  f"{len(run['iterations'])} solves, expected {windows}")
            for r in recs:
                check(r["final_cost"] <= r["initial_cost"], f"{name} ({be}) "
                      f"window {r['frame_ids']} cost {r['initial_cost']} -> "
                      f"{r['final_cost']}")
            counts = dict(run["counts"])
            if be == "cuda":
                n_k = counts.pop(counted, 0)
                check(n_k == run["expected"] >= windows,
                      f"{name}: {counted} launched {n_k} times, expected "
                      f"{run['expected']} (iterations {run['iterations']})")
                check(not counts, f"{name}: other kernels ran: {counts}")
                what = f"{counted[0]}/{counted[1]} launches {n_k} (expected " \
                       f"{run['expected']})"
            else:
                check(not counts, f"{name} (torch): kernels ran: {counts}")
                what = "no kernel launched"
            solve_ms = statistics.median(r["solve_time_s"] * 1e3
                                         for r in recs)
            stereo = (f"{statistics.median(run['stereo_s']) * 1e3:.1f}"
                      if run["stereo_s"] else "not separable (native "
                      "producer)")
            say(f"phase 20 {name} ({be}): {n} frames, {windows} windows, "
                f"{what} | wall {run['wall'] / n:.3f} s per frame | dataset "
                f"{statistics.median(run['dataset_s']) * 1e3:.1f} ms per "
                f"frame, of it stereo ({cfg.stereoAlgorithm}) {stereo} ms "
                f"(medians over {n} frames) | median window "
                f"solve {solve_ms:.1f} ms, LM iterations {run['iterations']} "
                f"| ATE (unaligned) VO input {ate_vo:.6f} m, refined "
                f"{ate(poses[:n], gt[:n]):.6f} m | peak device memory "
                f"{run['peak_mib']:.1f} MiB | {smi}")
        cuda, plain = runs["cuda"], runs["torch"]
        check(same_state(cuda["first_state"], plain["first_state"]),
              f"{name}: the two runs' first windows start from different "
              f"states")
        first = dict(engine=cuda["engine"], first_state=cuda["first_state"],
                     first_cost=cuda["records"][0]["initial_cost"])
        ct = check_first_window(f"20 {name}", first,
                                restrict_torch=cfg.interpolation != "bicubic")
        say(f"phase 20 {name} the torch run's own first window starts at "
            f"{plain['records'][0]['initial_cost']:.6f} (its valid set; the "
            f"cuda path's valid set: {ct:.6f}); windows' costs, cuda / "
            f"torch (chained, not held): " + "; ".join(
                f"{a['initial_cost']:.5f} -> {a['final_cost']:.5f} / "
                f"{b['initial_cost']:.5f} -> {b['final_cost']:.5f}"
                for a, b in zip(cuda["records"], plain["records"])))
        if cfg.pipelineResults:
            sync = shipped_run(path, data, n,
                               os.path.join(SHIPPED_DIR, f"{name}_sync"),
                               kernels, solverBackend="cuda",
                               pipelineResults=False)
            check(sync["text"] == cuda["text"], f"{name}: the trajectory "
                  f"under pipelineResults differs from the one without it")
            say(f"phase 20 {name} pipelineResults: the trajectory file is "
                f"byte-identical to the run with pipelineResults=False "
                f"({sync['wall'] / n:.3f} s per frame there)")


def descriptor_instance(dev, descriptor: str, pr: int):
    """Phase 3's problem at radius `pr` (`sorted_instance`) with its frames
    turned into `descriptor`'s channels, as ingest builds them
    (image/descriptor.make_channels, gradients of each channel), and each
    point's descriptor extracted from frame 0 at its projection there,
    mean-normalized. Returns (channels (W, C, H, Wi), planes, uv_nm,
    valid_nm, patch (N, C, P))."""
    from photobundle_torch.image import descriptor as descriptor_mod
    from photobundle_torch.image import interp
    from photobundle_torch.image import patches as patches_mod
    from photobundle_torch.ops import patch_warp as pw

    planes1, uv_nm, valid_nm, _, _, _ = sorted_instance(N_PTS, dev, pr,
                                                        time_sort=False)
    channels = descriptor_mod.make_channels(planes1[:, 0, ..., 0],
                                            descriptor).contiguous()
    gx, gy = interp.image_gradients(channels)
    planes = pw.build_planes(channels, torch.stack([gx, gy], dim=-1))
    patch, _ = patches_mod.extract_patches(
        channels[0], uv_nm[:, 0].contiguous(),
        patches_mod.patch_offsets(pr, device=dev))
    return (channels, planes, uv_nm, valid_nm,
            patches_mod.mean_normalize(patch).contiguous())


def descriptor_calls(dev, radii=DESCRIPTOR_RADII):
    """Phase 20 (B)'s kernel calls, each on `descriptor_instance`'s inputs:
    {label: (kernel call, plain call, valid (N, W), bound, the instance's
    (kernel wrapper, planes, uv, valid, patch, radius))} for K1 with each
    of the DESCRIPTORS at each of `radii` ("K1 C=<C> R=<R>") and
    K2 with the first ("K2 C=3 R=<R>"; its observations inside the
    bicubic margins, R+1 <= u <= Wi-3-R), the mean normalization."""
    from photobundle_torch.ops import patch_bicubic as pb
    from photobundle_torch.ops import patch_warp as pw

    out = {}
    for descriptor in DESCRIPTORS:
        for pr in radii:
            channels, planes, uv_nm, valid_nm, patch = descriptor_instance(
                dev, descriptor, pr)
            c = channels.shape[1]
            texels = window_texels(uv_nm, valid_nm, pr, 2 * pr + 2, pr, H, WI)
            args = (planes, uv_nm, valid_nm, patch, pr)
            out[f"K1 C={c} R={pr}"] = (
                lambda args=args: pw.patch_stats(*args),
                lambda args=args: pw.patch_stats_reference(*args), valid_nm,
                kernel_bound(texels, GRAD_TEXEL_BYTES, valid_nm, c, pr,
                             "bilinear", "mean"), (pw.patch_stats, *args))
            if descriptor == DESCRIPTORS[0]:
                x, y = uv_nm[..., 0], uv_nm[..., 1]
                valid_bc = (valid_nm & (x >= pr + 1) & (x <= WI - 3 - pr)
                            & (y >= pr + 1) & (y <= H - 3 - pr)).contiguous()
                texels_bc = window_texels(uv_nm, valid_bc, pr, 2 * pr + 4,
                                          pr + 1, H, WI)
                args = (channels, uv_nm, valid_bc, patch, pr)
                out[f"K2 C={c} R={pr}"] = (
                    lambda args=args: pb.bicubic_stats(*args),
                    lambda args=args: pb.bicubic_stats_reference(*args),
                    valid_bc, kernel_bound(texels_bc, VALUE_TEXEL_BYTES,
                                           valid_bc, c, pr, "bicubic",
                                           "mean"), (pb.bicubic_stats, *args))
    return out


def output_hash(t: torch.Tensor) -> str:
    """The first 16 hex digits of the SHA-256 of a tensor's bytes: equal
    hashes, bitwise equal tensors."""
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def channel_composition(label, kernel, planes, uv, valid, patch, pr) -> None:
    """Phase 20 (B)'s composition check, in every normalization: a
    C-channel launch of `kernel` (K1 or K2) equals, bitwise, the sum from
    0.f, in channel order, of C one-channel launches on each channel's
    planes and descriptor slice (each channel's six sums are taken apart
    from the others and only then added, in order, to zeros). Prints both
    hashes."""
    from photobundle_torch.ops import _common

    c = planes.shape[1]
    for norm in _common.NORMS:
        got = kernel(planes, uv, valid, patch, pr, norm)
        summed = torch.zeros_like(got)
        for ch in range(c):
            summed = summed + kernel(planes[:, ch:ch + 1].contiguous(), uv,
                                     valid, patch[:, ch:ch + 1].contiguous(),
                                     pr, norm)
        torch.cuda.synchronize()
        same = torch.equal(bits(got), bits(summed))
        say(f"phase 20 {label} {norm}: the C={c} launch {output_hash(got)}, "
            f"the channel-ordered sum of {c} one-channel launches "
            f"{output_hash(summed)}: "
            f"{'bitwise equal' if same else 'DIFFERENT'}")
        check(same and bool(torch.isfinite(got).all())
              and float(got.abs().sum()) > 0,
              f"phase 20 {label} {norm}: the C={c} launch is not the "
              f"channel-ordered sum of its one-channel launches (max abs "
              f"difference {float((got - summed).abs().max()):.3e})")


def batch_composition(label, kernel, planes, uv, valid, patch, pr) -> None:
    """Phase 20 (B): a B = 2 launch of `kernel`, the instance and a second
    window (its frames and points rolled by one), equals its two single
    launches bitwise, in every normalization. Prints both hashes."""
    from photobundle_torch.ops import _common

    second = (planes.roll(1, 0), uv, valid, patch.roll(1, 0))
    batch = [torch.stack(pair).contiguous()
             for pair in zip((planes, uv, valid, patch), second)]
    for norm in _common.NORMS:
        got = kernel(*batch, pr, norm)
        want = torch.stack([kernel(planes, uv, valid, patch, pr, norm),
                            kernel(*second, pr, norm)])
        torch.cuda.synchronize()
        same = torch.equal(bits(got), bits(want))
        say(f"phase 20 {label} {norm}: a B = 2 launch {output_hash(got)}, "
            f"its two single launches {output_hash(want)}: "
            f"{'bitwise equal' if same else 'DIFFERENT'}")
        check(same, f"phase 20 {label} {norm}: the B = 2 launch is not its "
              f"two single launches")


def descriptor_phase(dev, kernels, scene, drifted) -> dict:
    """Phase 20 (B): K1 with the DESCRIPTORS' channels (C = 3 and 8) at
    DESCRIPTOR_RADII and K2 with C = 3 at both (`descriptor_calls`), each
    against its plain version at 4096 x 5 with its bound, each C-channel
    launch bitwise the channel-ordered sum of its one-channel launches in
    every normalization, and a B = 2 launch at C = 3 bitwise its two
    single launches; then the descriptor engines (`descriptor_engines`).
    Returns {label: (numbers for the JSON line, the engine's launches)}."""
    out = {}
    for label, (kernel, plain, valid, bound, args) in descriptor_calls(
            dev).items():
        pr = args[-1]
        name, c = label.split()[0], label.split()[1]
        numbers = kernel_phase(
            "20", f"{name} {c}", kernel, plain, valid, bound, radius=pr,
            calls=KERNEL_CALLS if pr == PATCH_RADIUS else WIDE_CALLS)
        if pr == PATCH_RADIUS:
            out[f"{name} {c.replace('=', '')}"] = numbers
        channel_composition(label, *args)
        if c == "C=3":
            batch_composition(label, *args)
    engines = descriptor_engines(kernels, scene, drifted)
    return {label: (out[label], launches)
            for label, launches in engines.items()}


def descriptor_engines(kernels, scene, drifted) -> dict:
    """Phase 20 (B)'s engines: over DEFAULT_FRAMES of phase 6's scene in
    the default configuration with each of the DESCRIPTORS (K1) and in
    kitti_sgbm_bicubic.cfg's settings with IntensityAndGradient (K2), each
    first window held across backends; prints a hash of each run's
    refined poses and first window's start. Returns {label: the engine's
    launches}."""
    from photobundle_torch.config import ConfigFile, PBAConfig
    from photobundle_torch.ops import patch_bicubic as pb
    from photobundle_torch.ops import patch_warp as pw

    out = {}
    sgbm = PBAConfig.from_config_file(ConfigFile(
        os.path.join("configs", "kitti_sgbm_bicubic.cfg")))
    for label, cfg, counted in (
            ("K1 C3", PBAConfig(descriptor=DESCRIPTORS[0]),
             (pw.patch_stats, "mean")),
            ("K1 C8", PBAConfig(descriptor=DESCRIPTORS[1]),
             (pw.patch_stats, "mean")),
            ("K2 C3", sgbm.replace(descriptor=DESCRIPTORS[0]),
             (pb.bicubic_stats, "mean"))):
        tag = f"20 {label} ({cfg.descriptor})"
        run = run_engine(tag, cfg, scene, drifted, DEFAULT_FRAMES, counted,
                         kernels, ate_must_fall=False)
        check_first_window(tag, run,
                           restrict_torch=cfg.interpolation != "bicubic")
        poses = np.concatenate([r.poses for r in run["results"]])
        start = run["first_state"][1]
        say(f"phase {tag} hashes: refined poses of every window "
            f"{hashlib.sha256(poses.tobytes()).hexdigest()[:16]}, the first "
            f"window's start points {output_hash(start.x_world)}")
        out[label] = run["launches"]
    return out


_lap = [0.0]


def lap(label: str) -> None:
    """Prints the seconds since the previous lap: each phase's time."""
    now = time.perf_counter()
    say(f"{label} took {now - _lap[0]:.1f} s")
    _lap[0] = now


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke test runs only on a CUDA card")
    from photobundle_torch import bench, entry
    from photobundle_torch.config import ConfigFile, PBAConfig
    from photobundle_torch.core import lm
    from photobundle_torch.core import residuals as res_mod
    from photobundle_torch.image import patches as patches_mod
    from photobundle_torch.ops import _build, _common
    from photobundle_torch.ops import patch_ablate as pa
    from photobundle_torch.ops import patch_bicubic as pb
    from photobundle_torch.ops import patch_samples as smp
    from photobundle_torch.ops import patch_scaled as ps
    from photobundle_torch.ops import patch_stats as k7
    from photobundle_torch.ops import patch_warp as pw

    t_start = time.perf_counter()
    _lap[0] = t_start
    kernels = (pw.patch_stats, pb.bicubic_stats, ps.scaled_stats,
               pw.sorted_patch_stats, smp.warp_patches, k7.patch_stats,
               pa.ablate_stats)
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say(f"phase 1 device: {name} | nvidia-smi: {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # -- phase 2: build every kernel from the checkout's sources ---------
    t0 = time.perf_counter()
    builds = _build.build_all(SOURCES)
    for built in builds.values():
        say(f"phase 2 build: {built.path.name} for sm_90a in "
            f"{built.seconds:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    say(f"phase 2 built {len(SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    for source in ("patch_warp", "patch_bicubic", "patch_scaled"):
        print_ptxas(source, builds[source], (0, *_common.WARPED_RADII))
    for source in ("patch_samples", "patch_stats", "patch_ablate"):
        print_ptxas_instances(source, builds[source])
    for source in ("ordered_sum", "chol_solve"):
        print_ptxas_typed(source, builds[source])
    lap("phases 1-2")

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
    say(f"phase 3 card: {gpu_clocks()} (SM clock, max, power draw)")
    k1 = kernel_phase(
        "3", "K1", lambda: pw.patch_stats(planes, uv_nm, valid_nm, patch, pr),
        lambda: pw.patch_stats_reference(planes, uv_nm, valid_nm, patch, pr),
        valid_nm, kernel_bound(win1, GRAD_TEXEL_BYTES, valid_nm, 1, pr,
                               "bilinear", "mean"), warm=True)
    k2_wide = wide_phase(dev)
    lap("phase 3 (with the wide radii of phases 3, 5, 8 and 9)")

    # -- phase 4: the slice ----------------------------------------------
    kw = dict(huber_delta=HUBER_DELTA, gradient_mode="sampled",
              max_iterations=ITERS, function_tolerance=0.0,
              parameter_tolerance=0.0)

    def solve(backend, obs_mask=obs, **extra):
        return lm.lm_solve(cam, t_wc, x_world, patch, channels, grads,
                           obs_mask, point_valid, frozen, offsets,
                           backend=backend, **{**kw, **extra})

    # The main path: a cold key (warm-up, two captures, replays), its
    # graphs' device memory, then the same key warm.
    lm.clear_graph_cache()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    reset_all(kernels)
    reset_body_kernels()
    t0 = time.perf_counter()
    t_out, x_out, st = solve("cuda")
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    launches = pw.patch_stats.launches["mean"]
    runs = lm_runs()
    body4 = check_body_launches("phase 4", runs)
    iters = int(st.iterations)
    expected = expected_launches([iters])
    torch.cuda.empty_cache()
    cache_mib = (torch.cuda.memory_reserved() - reserved) / 2**20
    c0, c1 = float(st.initial_cost), float(st.final_cost)
    logs = st.cost_log[:iters]
    say(f"phase 4 cuda solve (CUDA graphs, cold key): {iters} iterations, "
        f"cost {c0:.6f} -> {c1:.6f}, accept {st.accept_log.int().tolist()},"
        f" kernel launches {launches} (expected {expected}: {iters} "
        f"replays + 1, + 2 for the warm-up); lm runs {runs} | the body's "
        f"kernels, captured with it: row_dot {body4[0]} launches, "
        f"chol_solve {body4[1]} (one per body)")
    check(launches == expected and runs["warm_ups"] == 1
          and runs["captures"] == 2,
          f"kernel launched {launches} times, expected {expected}; {runs}")
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
    reset_all(kernels)
    t0 = time.perf_counter()
    solve("cuda")
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    warm = pw.patch_stats.launches["mean"]
    check(warm == ITERS + 1 and lm_runs()["captures"] == 0,
          f"warm key launched the kernel {warm} times, expected "
          f"{ITERS + 1}")
    say(f"phase 4 cold call {cold_ms:.1f} ms (warm-up + two captures + "
        f"replays), warm call {warm_ms:.1f} ms: capture and warm-up "
        f"{cold_ms - warm_ms:.1f} ms | the key's graphs and static buffers "
        f"hold {cache_mib:.1f} MiB of device memory (memory_reserved "
        f"after empty_cache; cache of {lm.GRAPH_CACHE_SIZE} keys) | warm "
        f"launches {warm} = {ITERS} replays + 1")

    # The same body in the eager host loop (capture=False).
    t_e, x_e, st_e = solve("cuda", capture=False)
    torch.cuda.synchronize()
    rel_cost = float(((st_e.cost_log - st.cost_log) / st.cost_log)
                     .abs().max())
    check(int(st_e.iterations) == iters
          and torch.equal(st_e.accept_log, st.accept_log)
          and int(st_e.termination) == int(st.termination),
          "captured and eager solves ran differently")
    check(rel_cost <= GRAPH_RTOL, f"captured vs eager cost rel diff "
          f"{rel_cost:.3e}")
    differs = first_difference((t_out, x_out, st), (t_e, x_e, st_e))
    say(f"phase 4 captured vs eager (capture=False): same iterations, "
        f"accept log and termination, cost-log rel diff {rel_cost:.3e} "
        f"(rtol {GRAPH_RTOL:g}); bitwise equal: "
        f"{'yes' if differs is None else 'no, first at ' + differs}")
    # K1 inside the solve, L2 as the solve leaves it (not flushed); the
    # trace's K1 launches against the per-replay count.
    reset_all(kernels)
    situ_us, situ_n, traces = insitu_us(lambda: solve("cuda"),
                                        "patch_stats_kernel", ITERS + 1)
    counted = pw.patch_stats.launches["mean"]
    say(f"phase 4 K1 in the solve: {us_text(situ_us)} per launch over "
        f"{situ_n} traced launches, the fullest of {traces} trace(s) (L2 "
        f"as the solve leaves it) | phase 3: cold "
        f"{us_text(k1['device_us'])}, warm {us_text(k1['warm_us'])}")
    check(counted == traces * (ITERS + 1) and situ_n == ITERS + 1,
          f"{traces} warm solves launched K1 {counted} times (counted), the "
          f"fullest of their traces held {situ_n}, expected {ITERS + 1} "
          f"each")

    def its_per_s(backend, **extra):
        times = []
        for _ in range(TIMED_SOLVES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve(backend, **extra)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ms = " ".join(f"{t * 1e3:.2f}" for t in sorted(times))
        return ITERS / statistics.median(times), ms

    for label, extra in (("captured", {}), ("eager", {"capture": False})):
        ips, ms = its_per_s("cuda", **extra)
        syncs = host_syncs(lambda: solve("cuda", **extra))
        busy, span, n_dev = device_busy(lambda: solve("cuda", **extra))
        say(f"phase 4 cuda solve {label}: LM it/s {ips:.2f} (median of "
            f"{TIMED_SOLVES} solves of {ITERS} iterations; solve ms {ms}) | "
            f"host syncs per solve {syncs} (set_sync_debug_mode('warn')) | "
            + busy_text(busy, span, n_dev, ITERS / ips * 1e3, "solve"))
    readback_phase(solve)
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
        f"iterations, CUDA graphs): cuda {cuda_ips:.2f} (solve ms "
        f"{cuda_ms}), torch {torch_ips:.2f} (solve ms {torch_ms})")

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
    # The port's twin of bench.py, in this process (its JSON line here,
    # not as the last line).
    t0 = time.perf_counter()
    record = bench.measure("cuda")
    say(f"phase 4 bench ({time.perf_counter() - t0:.1f} s, python -m "
        f"photobundle_torch.bench): {json.dumps(record)}")
    check(record["value"] > 0 and record["vs_baseline"] > 0,
          "the bench measured no rate")
    lap("phase 4")

    # -- phase 5: K2 vs its plain version on phase 3's inputs ------------
    in_bicubic = ((uv[:, 0] >= pr + 1) & (uv[:, 0] <= WI - 3 - pr)
                  & (uv[:, 1] >= pr + 1) & (uv[:, 1] <= H - 3 - pr))
    valid_bc = (obs.T & in_front & in_bicubic).T.contiguous()   # (N, W)
    value_planes = pb.build_value_planes(channels)
    win2 = window_texels(uv_nm, valid_bc, pr, 2 * pr + 4, pr + 1, H, WI)
    k2 = kernel_phase(
        "5", "K2",
        lambda: pb.bicubic_stats(value_planes, uv_nm, valid_bc, patch, pr),
        lambda: pb.bicubic_stats_reference(value_planes, uv_nm, valid_bc,
                                           patch, pr),
        valid_bc, kernel_bound(win2, VALUE_TEXEL_BYTES, valid_bc, 1, pr,
                               "bicubic", "mean"))
    lap("phase 5")

    # -- phase 6: the engine, reference-exact configuration (K2) ---------
    scene = engine_scene()
    drifted = entry.drift_poses(np.random.default_rng(SCENE_SEED + 1),
                                scene[3], DRIFT_TRANS, DRIFT_ROT, 1)
    exact_cfg = PBAConfig.from_config_file(
        ConfigFile("configs/reference_exact.cfg"))
    run6 = run_engine("6", exact_cfg, scene, drifted, ENGINE_FRAMES,
                      (pb.bicubic_stats, "mean"), kernels)
    # Both port backends take the same observations under the bicubic
    # margins.
    check_first_window("6", run6, restrict_torch=False)
    lap("phase 6")

    # -- phase 7: the engine, default configuration (K1) -----------------
    run_engine("7", PBAConfig(), scene, drifted, DEFAULT_FRAMES,
               (pw.patch_stats, "mean"), kernels, ate_must_fall=False,
               profile=True)
    # A patch radius past 4, where K1 rolls its row loop.
    run_engine("7b", PBAConfig(patchRadius=WIDE_ENGINE_RADIUS), scene,
               drifted, W + 1, (pw.patch_stats, "mean"), kernels,
               ate_must_fall=False)
    # The reference-exact configuration past R = 9 (K2's runtime-radius
    # instance).
    run7c = run_engine("7c", exact_cfg.replace(patchRadius=ENGINE_WIDE_RADIUS),
                       scene, drifted, W + 1, (pb.bicubic_stats, "mean"),
                       kernels, ate_must_fall=False)
    lap("phase 7")

    # -- phase 8: K3 vs its plain version on phase 3's inputs ------------
    rho_np = np.random.default_rng(RHO_SEED).uniform(
        RHO_LO, RHO_HI, size=(N_PTS, W)).astype(np.float32)
    rho_nm = torch.as_tensor(np.clip(rho_np, 0.5, 2.0), device=dev)
    ext = rho_nm.T * pr                                          # (W, N)
    in_scaled = ((uv[:, 0] >= 1 + ext) & (uv[:, 0] <= (WI - 2) - ext)
                 & (uv[:, 1] >= 1 + ext) & (uv[:, 1] <= (H - 2) - ext))
    valid_sc = (obs.T & in_front & in_scaled).T.contiguous()    # (N, W)
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
    lap("phases 8-9")

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
    lap("phase 10")

    # -- phase 11: K1's sort-reuse variant ------------------------------
    k1s = sorted_phase(dev)
    lap("phase 11")

    # -- phase 12: the command line on a KITTI-format sequence -----------
    cli_launches = cli_phase(kernels, dev)
    lap("phase 12")

    # -- phase 13: K4's sample store, K6, and PB_GROUPED_STATS=0 ----------
    k6, rows_launches = samples_phase(planes, uv_nm, valid_nm, win1, solve,
                                      obs, interior, kernels)
    lap("phase 13")

    # -- phase 14: K7 ----------------------------------------------------
    k7_runs = k7_phase(planes, channels, uv_nm, valid_nm, patch, kernels,
                       dev)
    lap("phase 14")

    # -- phase 15: the tools (the store benchmark, the K1 ablation K8) ---
    k8, tool_launches = tools_phase(planes, uv_nm, valid_nm, patch, kernels)
    lap("phase 15")

    # -- phase 16: batched windows (K1's batch axis, the batched engine) --
    seen_nm = (obs.T & in_front).T.contiguous()
    k1b = batched_kernel_phase(planes, uv_nm, seen_nm, patch)
    axes = batched_axes_phase(planes, channels, uv_nm, seen_nm, patch)
    sorted_axes_phase(planes, uv_nm, seen_nm, patch)
    chol = chol_phase(dev)
    dots = ordered_phase(cam, offsets, args)
    batched_launches, dot_launches, chol_launches = batched_phase(scene,
                                                                  kernels)
    axis_launches = batched_configs_phase(scene, kernels)
    lap("phase 16")

    # -- phase 17: multi-sequence refinement -----------------------------
    multi_phase(dev)
    lap("phase 17")

    # -- phase 18: device meshes (NCCL at world size 1; two gloo ranks) ---
    mesh_launches = mesh_nccl_phase(dev, solve, cam, offsets, args, scene,
                                    drifted, kernels)
    mesh_gloo_phase(dev, scene, drifted)
    lap("phase 18")

    # -- phase 19: the remaining tools on the card -----------------------
    tools_phase_19(dev, kernels)
    lap("phase 19")

    # -- phase 20: the shipped configurations; descriptors with C > 1 ----
    shipped_phase(kernels, dev)
    lap("phase 20 (A)")
    described = descriptor_phase(dev, kernels, scene, drifted)
    lap("phase 20 (B)")

    # -- phase 21: se3's small-angle rounding on the card ----------------
    se3_phase(dev)
    lap("phase 21")

    pw_py = "photobundle_tpu/ops/patch_warp.py"

    def entry_json(name, source, replaces, launches, numbers):
        return {"name": name, "route": "cuda",
                "source": f"photobundle_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, **numbers}

    say(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        entry_json("patch_stats", "patch_warp.cu", f"{pw_py}:350", launches,
                   k1),
        entry_json(f"patch_stats/batch{BATCH_KERNEL}", "patch_warp.cu",
                   f"{pw_py}:577", batched_launches, k1b),
        entry_json("patch_stats/mesh", "patch_warp.cu", f"{pw_py}:577",
                   mesh_launches, k1),
        *(entry_json(f"{label}/batch{ENGINE_BATCH}", AXIS_SOURCES[label][0],
                     f"{pw_py}:{AXIS_SOURCES[label][1]}",
                     axis_launches[label], axes[label]) for label in AXES),
        entry_json("bicubic_stats", "patch_bicubic.cu", f"{pw_py}:176",
                   run6["launches"], k2),
        entry_json("scaled_stats", "patch_scaled.cu", f"{pw_py}:775",
                   runs10["10a"]["launches"], k3),
        entry_json("patch_stats/affine", "patch_warp.cu", f"{pw_py}:100",
                   runs10["10b"]["launches"], k4),
        entry_json("scaled_stats/affine", "patch_scaled.cu", f"{pw_py}:613",
                   runs10["10c"]["launches"], k5),
        entry_json("bicubic_stats/affine", "patch_bicubic.cu", f"{pw_py}:176",
                   runs10["10d"]["launches"], k2a),
        entry_json(f"bicubic_stats/R{ENGINE_WIDE_RADIUS}", "patch_bicubic.cu",
                   f"{pw_py}:176", run7c["launches"], k2_wide),
        entry_json("sorted_patch_stats", "patch_warp.cu", f"{pw_py}:393",
                   cli_launches, k1s),
        entry_json("warp_patches/rows", "patch_samples.cu", f"{pw_py}:100",
                   rows_launches, k6["rows"]),
        *(entry_json(f"warp_patches/{layout}", "patch_samples.cu",
                     f"{pw_py}:978",
                     tool_launches[("patch_samples.warp_patches", layout)],
                     k6[layout]) for layout in ("block", "raw")),
        *(entry_json(f"patch_stats_k7/{mode}"
                     f"{'' if r == PATCH_RADIUS else f'/R{r}'}",
                     "patch_stats.cu",
                     "photobundle_tpu/ops/patch_stats.py:235",
                     launches_r[mode], numbers_r[mode])
          for r, (numbers_r, launches_r) in k7_runs.items()
          for mode in k7.MODES),
        *(entry_json(f"ablate_stats/{mode}", "patch_ablate.cu",
                     "tools/ablate_packed_kernel.py:49",
                     tool_launches[("patch_ablate.ablate_stats", mode)],
                     k8[mode]) for mode in pa.MODES),
        *(entry_json(f"patch_stats/{label.split()[1]}", "patch_warp.cu",
                     f"{pw_py}:350", launches_c, numbers_c)
          for label, (numbers_c, launches_c) in described.items()
          if label.startswith("K1")),
        entry_json("bicubic_stats/C3", "patch_bicubic.cu", f"{pw_py}:176",
                   described["K2 C3"][1], described["K2 C3"][0]),
        entry_json(f"chol_solve/batch{BODY_BATCH}", "chol_solve.cu",
                   "photobundle_tpu/core/schur.py:282 (XLA's cho_factor; "
                   "no TPU kernel)", chol_launches, chol),
        entry_json(f"row_dot/batch{BODY_BATCH}", "ordered_sum.cu",
                   "photobundle_tpu/core/schur.py:134 (XLA's einsums and "
                   "sums; no TPU kernel)", dot_launches, dots),
    ]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["mesh-rank"]:
        mesh_rank(int(sys.argv[2]), int(sys.argv[3]))
    elif sys.argv[1:2] == ["ingest-cost"]:
        ingest_cost_child()
    else:
        main()
