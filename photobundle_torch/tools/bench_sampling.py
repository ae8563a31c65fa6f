"""Sampling-path comparison at the headline shape: ms per LM iteration
for each (interpolation, backend, patch grid) pair.

Twin of tools/bench_sampling.py, the same problem
(`entry.make_problem(4096, 5, 370, 1226, 2, seed=1)`, Huber delta 0.05)
and the same method as `photobundle_torch.bench`: K chained solves of
M = 8 fixed iterations (tolerances zeroed, a fresh lambda each; a probe
checks that a solve runs exactly 8), each from x_world + 1e-4 i, timed
whole with CUDA events on the card (the host clock on the CPU), the
median of REPEATS chains. On a card the solves replay as CUDA graphs,
both backends alike. Paths: bilinear (K1), bicubic (K2) and the scaled
grid (patchWarp=scale, every point's reference slot 0: K3), each on the
`cuda` kernels and on the `torch` gathers. A failure raises.

    python -m photobundle_torch.tools.bench_sampling [--points N] \
        [--frames W] [--height H] [--width WI] [--chain K] [--device cpu]

Prints one line per path, then one JSON line. Runs on the card unless
given --device cpu, and raises where there is none.
"""

from __future__ import annotations

import argparse
import json

from .. import bench
from ..core.engine import require_device
from . import device_name

N, W, H, WI, R = 4096, 5, 370, 1226, 2
REPEATS = 3
# (label, backend, gradient mode, patch warp, chain length): the JAX
# tool's paths and chain lengths.
PATHS = (
    ("bilinear + cuda warp kernel (K1)", "cuda", "sampled", None, 64),
    ("bilinear + torch gathers", "torch", "sampled", None, 4),
    ("bicubic + cuda kernel (K2, Ceres parity)", "cuda", "bicubic", None,
     16),
    ("bicubic + torch gathers", "torch", "bicubic", None, 2),
    ("patchWarp=scale + cuda scaled kernel (K3)", "cuda", "sampled", "scale",
     32),
    ("patchWarp=scale + torch gathers", "torch", "sampled", "scale", 4),
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="bench_sampling")
    ap.add_argument("--points", type=int, default=N)
    ap.add_argument("--frames", type=int, default=W)
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--width", type=int, default=WI)
    ap.add_argument("--chain", type=int, default=None,
                    help="solves per chain for every path (default: each "
                         "path's own)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    shape = (args.points, args.frames, args.height, args.width, R)
    rows = {}
    for label, backend, mode, warp, k in PATHS:
        rate = bench.chain_rate(dev, args.chain or k, REPEATS, shape,
                                backend=backend, gradient_mode=mode,
                                patch_warp=warp)
        ms = 1e3 / rate
        rows[label] = {"ms_per_lm_iteration": ms, "lm_iterations_per_s": rate}
        print(f"{label:44s}: {ms:7.2f} ms/iter ({rate:6.1f} it/s)",
              flush=True)
    rec = {"tool": "bench_sampling", "device": device_name(dev),
           "points": args.points, "window": args.frames,
           "image": [args.height, args.width], "paths": rows}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
