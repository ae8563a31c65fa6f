"""Stage-by-stage attribution of the cuda evaluation at 65 536 x 5.

Twin of tools/probe_eval65k.py at its problem
(`entry.make_problem(N, W, 370, 1226, 2, seed=1)`, defaults 65 536 x 5,
R = 2), through the port's own cuda evaluation, not the JAX tool's TPU
lane packing:

  geometry (pm)                    `_observation_geometry_pm`
  geometry + kernel(fused)         all that K1 reads (`kernel_geometry`),
                                   and K1 (the six sums per observation)
  full evaluate_compressed         the evaluation (with the prior rows
                                   and the robust whitening)
  geometry + kernel(nofuse)        the same geometry and K4's row store
                                   (the samples, no sums)
  full, PB_GROUPED_STATS=0         the evaluation with the row store and
                                   the unfused stats (`_ungrouped_stats`)

Each stage is called K times from x_world + 1e-4 i, the outputs kept
alive, timed by CUDA events (host launch gaps included; the host clock
on the CPU) and, on a card, by the device time of its activities in a
torch.profiler trace of a few calls.

    python -m photobundle_torch.tools.probe_eval65k [n_pts] [w] [K] \
        [--height H --width WI] [--device cpu]

Prints one line per stage, then one JSON line. Runs on the card unless
given --device cpu, and raises where there is none.
"""

from __future__ import annotations

import argparse
import json

from .. import entry
from ..core import residuals as res_mod
from ..core.engine import require_device
from ..ops import patch_samples, patch_warp
from . import device_name, device_us_per_call, ms_per_call

H, WI, PR = 370, 1226, 2
HUBER = 0.05
PROFILED_CALLS = 10


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="probe_eval65k")
    ap.add_argument("n_pts", type=int, nargs="?", default=65536)
    ap.add_argument("w", type=int, nargs="?", default=5)
    ap.add_argument("calls", type=int, nargs="?", default=64)
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--width", type=int, default=WI)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    k = args.calls
    cam, offsets, problem = entry.make_problem(
        args.n_pts, args.w, args.height, args.width, PR, seed=1, device=dev)
    t_wc, x_world, patch, channels, grads, obs, pv, _ = problem
    obs = obs & pv[:, None]
    ctx = res_mod.make_cuda_ctx(channels, grads, "sampled")
    xs = [x_world + 1e-4 * i for i in range(k)]
    print(f"[N={args.n_pts} W={args.w} K={k}; device {device_name(dev)}]",
          flush=True)

    planes = ctx[1]

    def full(x, grouped=True):
        return res_mod.evaluate_compressed(
            cam, t_wc, x, patch, channels, grads, obs, offsets, HUBER,
            backend="cuda", ctx=ctx, grouped_stats=grouped)

    def geometry(x):
        """uv and valid (N, W, ...) as K1 reads them."""
        return res_mod.kernel_geometry(cam, t_wc, x, channels, obs, None,
                                       "sampled", None, PR)[:2]

    def fused(x):
        return patch_warp.patch_stats(planes, *geometry(x), patch, PR,
                                      "mean")

    def nofuse(x):
        return patch_samples.warp_patches(planes, *geometry(x), PR, "rows")

    stages = (
        ("geometry (pm)",
         lambda x: res_mod._observation_geometry_pm(cam, t_wc, x)),
        ("geometry + kernel(fused)", fused),
        ("full evaluate_compressed", full),
        ("geometry + kernel(nofuse)", nofuse),
        ("full, PB_GROUPED_STATS=0 (row store)",
         lambda x: full(x, grouped=False)),
    )
    rows = {}
    for label, fn in stages:

        def run(n, fn=fn):
            return [fn(xs[i]) for i in range(n)]       # outputs kept alive

        ms = ms_per_call(lambda: run(k), k, dev)
        kp = min(k, PROFILED_CALLS)
        dev_us = (device_us_per_call(lambda: run(kp), kp)
                  if dev.type == "cuda" else None)
        rows[label] = dict(ms=ms, device_ms=None if dev_us is None
                           else dev_us / 1e3)
        dev_txt = "" if dev_us is None else f"  device {dev_us / 1e3:7.3f} ms"
        print(f"{label:36s}: {ms:7.3f} ms/iter{dev_txt}", flush=True)
    rec = {"tool": "probe_eval65k", "device": device_name(dev),
           "n_pts": args.n_pts, "w": args.w, "calls": k,
           "image": [args.height, args.width], "stages": rows}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
