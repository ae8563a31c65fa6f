"""Large-window validation of the ('frames', 'points') layout against the
single-rank solve.

Twin of tools/validate_frames_sharding.py (W = 64 keyframes, 102 400
points, 64x96 images, patch radius 1, 3 iterations by default):

    torchrun --nproc-per-node 4 -m \
        photobundle_torch.tools.validate_frames_sharding [--frames 2] \
        [--points 102400] [--window 64] [--device cpu]

Every rank builds the same problem (`entry.make_problem`, numpy seed 7)
and solves it on the ('frames' = --frames, 'points' = the rest) mesh
(parallel/sharded.make_frames_sharded_solver) and alone (lm.lm_solve).
In float32 the reduced system of a large window is near-singular along
gauge directions, so summation-order noise grows; the checks there are
the cost within 1 % and equal iteration counts. In float64, at a quarter
of the points, the sharded poses must match the single solve's to 1e-8.
Prints the per-rank window-image memory of both layouts. Runs on the card
unless --device cpu is given (on the CPU pass small sizes).
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from .. import entry
from ..core import lm
from ..core.engine import require_device
from ..parallel import mesh as mesh_mod
from ..parallel import sharded

H, WI, RADIUS, ITERS, SEED = 64, 96, 1, 3, 7


def solves(n_points: int, window: int, frames: int, device, dtype):
    """(sharded (t, x, stats), single (t, x, stats), seconds of each)."""
    cam, offsets, args = entry.make_problem(n_points, window, H, WI, RADIUS,
                                            seed=SEED, device=device)
    args = tuple(a.to(dtype) if a.is_floating_point() else a for a in args)
    cam = type(cam)(*(v.to(dtype) for v in cam))
    mesh = sharded.make_frames_mesh(
        frames=frames, points=dist.get_world_size() // frames)
    solver = sharded.make_frames_sharded_solver(
        mesh, cam, offsets.to(dtype), n_points=n_points, window_size=window,
        huber_delta=0.05, max_iterations=ITERS)
    t0 = time.perf_counter()
    out = solver(*args)
    float(out[2].final_cost)
    t1 = time.perf_counter()
    single = lm.lm_solve(cam, *args, offsets.to(dtype), huber_delta=0.05,
                         max_iterations=ITERS)
    float(single[2].final_cost)
    return out, single, (t1 - t0, time.perf_counter() - t1)


def run(n_points: int, window: int, frames: int, device) -> None:
    """The validation in the initialized world; raises on a failed
    check."""
    lead = dist.get_rank() == 0
    img = window * H * WI * 4 * 3       # channels + the two gradients, C = 1
    if lead:
        print(f"problem: W={window} frames x N={n_points} points; window "
              f"images {img / 1e6:.1f} MB replicated, "
              f"{img / frames / 1e6:.1f} MB per rank frames-sharded")
    (_, _, s_sh), (_, _, s_1), (dt_sh, dt_1) = solves(
        n_points, window, frames, device, torch.float32)
    rel = abs(float(s_sh.final_cost) / float(s_1.final_cost) - 1)
    if lead:
        print(f"f32: sharded cost {float(s_sh.initial_cost):.6f} -> "
              f"{float(s_sh.final_cost):.6f} in {int(s_sh.iterations)} "
              f"iterations ({dt_sh:.1f} s), single -> "
              f"{float(s_1.final_cost):.6f} in {int(s_1.iterations)} "
              f"({dt_1:.1f} s); cost agreement {rel:.4%}")
    if rel >= 0.01 or int(s_sh.iterations) != int(s_1.iterations):
        raise RuntimeError(f"f32 cost divergence {rel:.3%} or iteration "
                           f"counts differ")
    (t_sh, _, _), (t_1, _, _), _ = solves(n_points // 4, window, frames,
                                          device, torch.float64)
    d64 = float((t_sh - t_1).abs().max())
    if lead:
        print(f"f64 at {n_points // 4} points: max pose difference "
              f"{d64:.3e}")
    if d64 >= 1e-8:
        raise RuntimeError(f"f64 pose difference {d64:.3e}")
    if lead:
        print("FRAMES-SHARDING VALIDATION OK (f64 exact; f32 "
              "conditioning-limited cost agreement)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--points", type=int, default=102_400)
    ap.add_argument("--window", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card; rank k "
                         "takes card LOCAL_RANK), cuda:<i> (every rank "
                         "on card i) or cpu")
    ap.add_argument("--backend", default=None,
                    help="nccl (cards) or gloo; by default the device's")
    args = ap.parse_args(argv)
    device = mesh_mod.initialize_from_env(require_device(args.device),
                                          args.backend)
    if not dist.is_initialized():
        raise SystemExit("launch with torchrun --nproc-per-node N (N >= 2)")
    try:
        run(args.points, args.window, args.frames, device)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
