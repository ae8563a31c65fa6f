"""Multi-process sharded solve: the points-sharded LM solve over a world of
ranks, one per device (gloo on the CPU, NCCL on cards).

Twin of tools/demo_multiprocess.py, launched with torchrun:

    torchrun --nproc-per-node 2 -m photobundle_torch.tools.demo_multiprocess \
        [--device cpu]

Every rank builds the same problem (`entry.make_problem`, 32 points per
rank, 3 frames, numpy seed 0, points moved 1 cm), solves it with
`parallel.sharded.ShardedLMSolver` over points = world size (Huber 0.05,
6 iterations), prints its costs, and checks that the cost did not rise
and that every rank's poses and points are bitwise rank 0's; rank 0
prints MULTIPROCESS OK. Runs on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse

import torch.distributed as dist

from .. import entry
from ..core.engine import require_device
from ..parallel import mesh as mesh_mod
from ..parallel import sharded

POINTS_PER_RANK = 32


def run(device) -> tuple:
    """The demo in the initialized world; returns (initial cost, final
    cost, accepted steps)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    n = POINTS_PER_RANK * world
    cam, offsets, args = entry.make_problem(n, 3, 64, 96, 2, seed=0,
                                            device=device)
    t_wc, x_world, *rest = args
    solver = sharded.ShardedLMSolver(
        mesh_mod.make_mesh(points=world), cam, offsets, n_points=n,
        huber_delta=0.05, max_iterations=6)
    t, x, stats = solver(t_wc, x_world + 0.01, *rest)
    ic, fc = float(stats.initial_cost), float(stats.final_cost)
    acc = int(stats.accepted_steps)
    print(f"[rank {rank}] cost {ic:.6f} -> {fc:.6f} acc={acc}", flush=True)
    if not fc <= ic:
        raise RuntimeError(f"rank {rank}: the cost rose, {ic} -> {fc}")
    mesh_mod.check_replicated(t, "the refined poses")
    mesh_mod.check_replicated(x, "the refined points")
    if rank == 0:
        print("MULTIPROCESS OK", flush=True)
    return ic, fc, acc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
        run(device)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
