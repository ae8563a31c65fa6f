"""Scaling study: LM iterations/s against problem size (points x window).

Twin of tools/bench_scaling.py at its sizes, (4096, 5), (16384, 5),
(65536, 5), (4096, 16), (16384, 16) and (32768, 32) on 370x1226
(`entry.make_problem(n, w, 370, 1226, 2, seed=1)`), by
`photobundle_torch.bench`'s method: K chained solves of M = 8 fixed
iterations (a probe checks the count) from x_world + 1e-4 i, each with a
fresh lambda, timed whole with CUDA events (the host clock on the CPU),
the median of REPEATS chains; K = max(2, 2^22 / (n w M)) keeps a chain
at ~4M observation-iterations. On a card the solves replay as CUDA graphs
(the graph cache is cleared between sizes). Prints one JSON line per
size with the JAX tool's keys.

    python -m photobundle_torch.tools.bench_scaling [--sizes 4096x5,...] \
        [--height H] [--width WI] [--chain K] [--device cpu]

Runs on the card unless given --device cpu, and raises where there is
none.
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import bench
from ..core import lm
from ..core.engine import require_device
from . import device_name

H, WI, R = 370, 1226, 2
M = bench.M_ITERS
REPEATS = 3
SIZES = ((4096, 5), (16384, 5), (65536, 5), (4096, 16), (16384, 16),
         (32768, 32))


def run(dev, n_pts: int, w: int, shape=(H, WI), k: int | None = None
        ) -> dict:
    k = k or max(2, (1 << 22) // (n_pts * w * M))
    rate = bench.chain_rate(dev, k, REPEATS, (n_pts, w, *shape, R))
    t_iter = 1.0 / rate
    rec = {
        "points": n_pts, "window": w, "observations": n_pts * w,
        "ms_per_lm_iteration": round(t_iter * 1e3, 3),
        "lm_iterations_per_s": round(rate, 1),
        "obs_per_s_millions": round(n_pts * w / t_iter / 1e6, 1),
        "chain": k, "device": device_name(dev),
    }
    print(json.dumps(rec), flush=True)
    if dev.type == "cuda":
        lm.clear_graph_cache()
        torch.cuda.empty_cache()
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="bench_scaling")
    ap.add_argument("--sizes", default=",".join(f"{n}x{w}" for n, w in SIZES),
                    help="comma-separated points x window")
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--width", type=int, default=WI)
    ap.add_argument("--chain", type=int, default=None,
                    help="solves per chain for every size (default: "
                         "max(2, 2^22 / (n w M)))")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    sizes = [tuple(int(v) for v in s.split("x"))
             for s in args.sizes.split(",")]
    return [run(dev, n, w, (args.height, args.width), args.chain)
            for n, w in sizes]


if __name__ == "__main__":
    main()
