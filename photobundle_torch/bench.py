"""LM iterations/s of the KITTI-scale window solve: the port's twin of the
repository's bench.py.

    python -m photobundle_torch.bench [--device cpu] [--points N]
        [--frames W] [--height H] [--width WI] [--chain K]

Prints ONE JSON line with bench.py's keys,
    {"metric": "...", "value": N, "unit": "...", "vs_baseline": N},
and "device", the name of what it ran on.

The same problem and method as bench.py: `entry.make_problem(4096, 5,
370, 1226, 2, seed=1)`, Huber delta 0.05, sampled gradients, the fused
kernel backend ('cuda'), M_ITERS = 8 iterations per solve with the
tolerances zeroed (a probe checks that a solve runs exactly that many),
K chained solves from x_world + 1e-4 i, each with a fresh lambda, their
final costs summed on the device. `value` is K * M_ITERS over the median
of REPEATS chains, each timed whole with CUDA events on the card (the
host clock, after a host read of the sum, on the CPU). `vs_baseline`
divides it by the same chain on the host CPU through the port, K = 2,
CPU_REPEATS chains, as bench.py's CPU divisor is.

The solves run as lm_solve runs them: on a card, as CUDA graph replays
(the graphs of this shape are captured by the probe). Runs on the card
unless --device cpu is given, and raises where there is none.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from . import entry
from .core import lm
from .core.engine import require_device

METRIC = "BA_iterations_per_s_kitti_scale_window"
N_PTS, W, H, WI, PATCH_RADIUS, SEED = 4096, 5, 370, 1226, 2, 1
M_ITERS = 8          # iterations per chain link (fixed length, fresh lambda)
K_CARD = 32          # chain links per timed chain (bench.py's K_TPU)
K_CPU = 2            # the CPU chain: shorter, the same link length
REPEATS, CPU_REPEATS = 5, 3


def chain_rate(device, k: int, repeats: int, shape, backend: str = "cuda",
               gradient_mode: str = "sampled",
               patch_warp: str | None = None) -> float:
    """LM iterations/s of K chained M_ITERS-iteration solves on `device`:
    k * M_ITERS over the median time of `repeats` chains. `shape` =
    (points, frames, height, width, patch radius). The sampling path
    (the tools' bench_sampling): `backend`, `gradient_mode`, and
    `patch_warp` ('scale' or None; every point's reference slot 0)."""
    dev = require_device(device)
    cam, offsets, args = entry.make_problem(*shape, seed=SEED, device=dev)
    t_wc, x_world, *rest = args
    warp = None
    if patch_warp is not None:
        warp = (patch_warp, torch.zeros((shape[0],), dtype=torch.int32,
                                        device=dev))

    def solve(x0):
        return lm.lm_solve(cam, t_wc, x0, *rest, offsets, huber_delta=0.05,
                           gradient_mode=gradient_mode, backend=backend,
                           patch_warp=warp, max_iterations=M_ITERS,
                           function_tolerance=0.0, parameter_tolerance=0.0)

    # Probe: the rate's numerator assumes every link runs all M_ITERS
    # (with the tolerances zeroed only a lambda overflow ends a solve
    # early, which 8 fresh-lambda iterations never reach).
    n_probe = int(solve(x_world)[2].iterations)
    if n_probe != M_ITERS:
        raise RuntimeError(f"probe solve ran {n_probe} iterations, not "
                           f"{M_ITERS}")

    def chain():
        acc = torch.zeros((), device=dev)
        for i in range(k):
            acc = acc + solve(x_world + 1e-4 * i)[2].final_cost
        return acc

    float(chain())                                   # warm-up
    times = []
    for _ in range(repeats):
        if dev.type == "cuda":
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
            acc = chain()
            end.record()
            end.synchronize()
            times.append(begin.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            acc = chain()
            float(acc)
            times.append(time.perf_counter() - t0)
        if not torch.isfinite(acc):
            raise RuntimeError(f"chain's summed final cost is {float(acc)}")
    return k * M_ITERS / statistics.median(times)


def measure(device="cuda", shape=(N_PTS, W, H, WI, PATCH_RADIUS),
            k=K_CARD) -> dict:
    """The benchmark's record: the rate of K-solve chains on `device`, and
    its ratio to K_CPU-solve chains on the host CPU."""
    dev = require_device(device)
    value = chain_rate(dev, k, REPEATS, shape)
    baseline = chain_rate("cpu", K_CPU, CPU_REPEATS, shape)
    n, w, h, wi, pr = shape
    ps = 2 * pr + 1
    return {
        "metric": METRIC,
        "value": round(value, 3),
        "unit": (f"LM iterations/s ({n} pts x {w} frames x {ps}x{ps} "
                 f"patches, {h}x{wi})"),
        "vs_baseline": round(value / baseline, 3),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--points", type=int, default=N_PTS)
    ap.add_argument("--frames", type=int, default=W)
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--width", type=int, default=WI)
    ap.add_argument("--chain", type=int, default=K_CARD,
                    help="solves per timed chain on --device")
    a = ap.parse_args(argv)
    print(json.dumps(measure(
        a.device, (a.points, a.frames, a.height, a.width, PATCH_RADIUS),
        a.chain)), flush=True)


if __name__ == "__main__":
    main()
