"""Sharded LM solve time by layout and rank count.

Twin of tools/bench_multihost.py: times the points-sharded and the
('frames', 'points')-sharded solves of `entry.make_problem` over the
world's ranks, one per device (NCCL on cards, gloo on the CPU or with
--backend gloo):

    torchrun --nproc-per-node N -m photobundle_torch.tools.bench_multihost \
        [--layout points,frames] [--points 4096] [--window 4] \
        [--height 370] [--width 1226] [--device cpu] [--backend gloo]

Rank 0 prints one JSON line per layout: {"layout", "ranks", "points",
"window", "ms_per_lm_iter", "m_obs_per_s", "device", "backend"}. The
solve runs REPS times on varied inputs (the poses jittered from numpy seed
7, the same on every rank) after one warm-up; ms per LM iteration is the
slope between I_LO- and I_HI-iteration solves (tolerances zeroed), which
cancels the per-call host work. Each group of REPS solves is timed with
CUDA events on a card (the host clock on the CPU) and ends in a host read
of the summed final costs. The frames layout takes frames = 2 where the
rank count is even (else 1), points = the rest. On cards the solves are
captured (NCCL); gloo runs the eager loop.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import entry
from ..core.engine import require_device
from ..geometry import se3
from ..parallel import mesh as mesh_mod
from ..parallel import sharded
from . import device_name

I_LO, I_HI, REPS = 4, 16, 3


def _solver(layout, mesh, cam, offsets, n_points, window, iters, backend):
    kw = dict(n_points=n_points, huber_delta=0.05, backend=backend,
              max_iterations=iters, function_tolerance=0.0,
              parameter_tolerance=0.0)
    if layout == "points":
        return sharded.ShardedLMSolver(mesh, cam, offsets, **kw)
    return sharded.make_frames_sharded_solver(mesh, cam, offsets,
                                              window_size=window, **kw)


def measure(layout: str, device, n_points: int, window: int, height: int,
            width: int) -> dict:
    """One layout's record in the initialized world."""
    world = dist.get_world_size()
    if layout == "points":
        mesh = mesh_mod.make_mesh(points=world)
    elif layout == "frames":
        n_fr = 2 if world % 2 == 0 and window % 2 == 0 else 1
        mesh = sharded.make_frames_mesh(frames=n_fr, points=world // n_fr)
    else:
        raise ValueError(f"unknown layout {layout!r}")
    cam, offsets, prob = entry.make_problem(n_points, window, height, width,
                                            2, seed=1, device=device)
    t_wc, *rest = prob
    backend = "cuda" if device.type == "cuda" else "torch"
    rng = np.random.default_rng(7)
    inits = []
    for _ in range(REPS + 1):
        xi = rng.standard_normal((window, 6)).astype(np.float32) * 0.002
        xi[0] = 0
        inits.append(t_wc @ se3.se3_exp(torch.as_tensor(xi, device=device)))

    def timed(iters):
        solve = _solver(layout, mesh, cam, offsets, n_points, window, iters,
                        backend)
        float(solve(inits[0], *rest)[2].final_cost)          # warm-up
        if device.type == "cuda":
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
        t0 = time.perf_counter()
        acc = sum(solve(t, *rest)[2].final_cost for t in inits[1:])
        float(acc)
        if device.type == "cuda":
            end.record()
            end.synchronize()
            return begin.elapsed_time(end) / 1e3 / REPS
        return (time.perf_counter() - t0) / REPS

    ms_iter = (timed(I_HI) - timed(I_LO)) / (I_HI - I_LO) * 1e3
    return {"layout": layout, "ranks": world, "points": n_points,
            "window": window, "ms_per_lm_iter": round(ms_iter, 4),
            "m_obs_per_s": round(n_points * window / ms_iter / 1e3, 3),
            "device": device_name(device),
            "backend": dist.get_backend()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layout", default="points,frames")
    ap.add_argument("--points", type=int, default=4096)
    ap.add_argument("--window", type=int, default=4)
    ap.add_argument("--height", type=int, default=370)
    ap.add_argument("--width", type=int, default=1226)
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
        for layout in args.layout.split(","):
            record = measure(layout, device, args.points, args.window,
                             args.height, args.width)
            if dist.get_rank() == 0:
                print(json.dumps(record), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
