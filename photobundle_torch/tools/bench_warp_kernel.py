"""Time the store variants of `warp_patches` (K4's row store and K6).

Twin of tools/bench_warp_kernel.py: random 370x1226 planes (numpy seed
0), uv uniform in [8, size - 8], N = 4096 points x W = 5 frames, R = 2.
Per variant (packed, rows, block, raw), K = 50 chained calls with varied
inputs (uv + 0.013 i), each output consumed, timed by CUDA events (the
host clock with --device cpu) and, on a card, by the device time of all
their kernels (torch.profiler: the store kernel, the relayout copies and,
for 'raw', the bilinear combine; the twin of the JAX tool's K calls
inside one jit, which leave no host gaps). Prints ms per evaluation and
ns per observation for each variant, then one JSON line.

    python -m photobundle_torch.tools.bench_warp_kernel [n_pts] [w] \
        [--calls K] [--device cpu]

Runs on the card unless given --device cpu, and raises where there is
none.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..core.engine import require_device
from ..ops import patch_samples
from ..ops.patch_warp import build_planes
from . import device_name, device_us_per_call, ms_per_call

H, WI, R = 370, 1226, 2


def make_inputs(n_pts: int, w: int, device):
    """(planes, uv (N, W, 2), valid (N, W)): the JAX tool's problem."""
    rng = np.random.default_rng(0)
    imgs = rng.random((w, 1, H, WI), np.float32)
    grads = rng.random((w, 1, H, WI, 2), np.float32)
    planes = build_planes(torch.as_tensor(imgs, device=device),
                          torch.as_tensor(grads, device=device))
    uv = rng.uniform([8, 8], [WI - 8, H - 8], size=(n_pts, w, 2))
    uv = torch.as_tensor(uv.astype(np.float32), device=device)
    return planes, uv, torch.ones((n_pts, w), dtype=torch.bool, device=device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_pts", type=int, nargs="?", default=4096)
    ap.add_argument("w", type=int, nargs="?", default=5)
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    planes, uv0, valid = make_inputs(args.n_pts, args.w, dev)
    uvs = [uv0 + 0.013 * i for i in range(args.calls)]
    obs = args.n_pts * args.w
    results = {}
    for variant in patch_samples.VARIANTS:

        def run():
            acc = torch.zeros((), device=dev)
            for uv in uvs:
                s, gx, _ = patch_samples.warp_patches(planes, uv, valid, R,
                                                      variant)
                acc = acc + s[0, 0, 0, 0] + gx[0, 0, 0, 0]
            return acc

        ms = ms_per_call(run, args.calls, dev)
        dev_us = (device_us_per_call(run, args.calls) if dev.type == "cuda"
                  else None)
        # Every sample of one call: variants that agree bitwise sum alike.
        checksum = sum(float(t.contiguous().sum(dtype=torch.float64))
                       for t in patch_samples.warp_patches(planes, uv0, valid,
                                                           R, variant))
        results[variant] = dict(ms=ms, ns_per_obs=ms * 1e6 / obs,
                                device_us=dev_us,
                                device_ns_per_obs=(None if dev_us is None
                                                   else dev_us * 1e3 / obs),
                                checksum=checksum)
        on_card = ("" if dev_us is None else f" | device {dev_us:9.3f} "
                   f"us/eval  {dev_us * 1e3 / obs:7.3f} ns/obs")
        print(f"{variant:6s}: {ms:9.4f} ms/eval  {ms * 1e6 / obs:8.3f} "
              f"ns/obs{on_card}", flush=True)
    print(json.dumps({"tool": "bench_warp_kernel",
                      "device": device_name(dev), "n_pts": args.n_pts,
                      "w": args.w, "calls": args.calls,
                      "variants": results}), flush=True)
    return results


if __name__ == "__main__":
    main()
