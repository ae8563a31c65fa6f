"""Attribute K1's time per observation to its stages (kernel K8).

Twin of tools/ablate_packed_kernel.py: the synthetic window problem of
`entry.make_problem` (seed 1; default 65 536 points x 5 frames at
370x1226, R = 2), valid observations inside K1's margins. Per variant of
`ops/patch_ablate.ablate_stats` (stage x window x threads per block), K
chained calls with varied inputs (the points moved by 1e-4 i, the
geometry recomputed before the timing), timed by CUDA events (the host
clock with --device cpu; host launch gaps included) and, on a card, by
the kernel's device time (torch.profiler; the twin of the JAX tool's K
calls inside one jit). Prints ms per call, device us per launch and ns per
observation per variant, whether full/own equals K1
(`patch_warp.patch_stats`) bitwise, and one JSON line.

    python -m photobundle_torch.tools.ablate_patch_stats [n_pts] [w] [K] \
        [--threads 64,128,256] [--device cpu]

Runs on the card unless given --device cpu, and raises where there is
none.
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import entry
from ..core import residuals as res_mod
from ..core.engine import require_device
from ..ops import patch_ablate as pa
from ..ops import patch_warp as pw
from . import device_name, device_us_per_call, ms_per_call

H, WI = 370, 1226


def make_inputs(n_pts: int, w: int, calls: int, device):
    """(planes, patch, [(uv (N, W, 2), valid (N, W))] * calls): the JAX
    tool's problem, its points moved by 1e-4 i for call i."""
    pr = pa.RADIUS
    cam, _, args = entry.make_problem(n_pts, w, H, WI, pr, seed=1,
                                      device=device)
    t_wc, x_world, patch, channels, grads, obs, point_valid, _ = args
    obs = obs & point_valid[:, None]
    inputs = []
    for i in range(calls):
        _, uv, in_front, _, _ = res_mod._observation_geometry_pm(
            cam, t_wc, x_world + 1e-4 * i)
        in_bounds = ((uv[:, 0] >= pr) & (uv[:, 0] <= WI - 2 - pr)
                     & (uv[:, 1] >= pr) & (uv[:, 1] <= H - 2 - pr))
        inputs.append((uv.permute(2, 0, 1).contiguous(),
                       (obs.T & in_front & in_bounds).T.contiguous()))
    return pw.build_planes(channels, grads), patch.contiguous(), inputs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_pts", type=int, nargs="?", default=65536)
    ap.add_argument("w", type=int, nargs="?", default=5)
    ap.add_argument("calls", type=int, nargs="?", default=64)
    ap.add_argument("--threads", default=",".join(map(str, pa.THREADS)))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    threads = [int(t) for t in args.threads.split(",")]
    planes, patch, inputs = make_inputs(args.n_pts, args.w, args.calls, dev)
    uv0, valid0 = inputs[0]
    k1 = pw.patch_stats(planes, uv0, valid0, patch, pa.RADIUS)
    full_is_k1 = bool(torch.equal(
        pa.ablate_stats(planes, uv0, valid0, patch, "full", "own"), k1))
    obs = args.n_pts * args.w
    print(f"[ablate_patch_stats] N={args.n_pts} W={args.w} K={args.calls} "
          f"on {device_name(dev)}; {int(valid0.sum())} valid observations; "
          f"full/own bitwise K1: {full_is_k1}", flush=True)
    results = {}
    for stage in pa.STAGES:
        for window in pa.WINDOWS:
            for t in threads:
                def run():
                    for uv, valid in inputs:
                        pa.ablate_stats(planes, uv, valid, patch, stage,
                                        window, t)

                ms = ms_per_call(run, args.calls, dev)
                dev_us = (device_us_per_call(run, args.calls, "ablate")
                          if dev.type == "cuda" else None)
                # ns per observation from the device time on a card.
                per_obs = (ms * 1e6 if dev_us is None else dev_us * 1e3) / obs
                name = f"{stage}/{window}/{t}"
                results[name] = dict(ms=ms, device_us=dev_us,
                                     ns_per_obs=per_obs)
                dev_txt = ("" if dev_us is None
                           else f", device {dev_us:8.3f} us/launch")
                print(f"{name:22s}: {ms:9.4f} ms/call{dev_txt}  "
                      f"({per_obs:7.3f} ns/obs)", flush=True)
    print(json.dumps({"tool": "ablate_patch_stats",
                      "device": device_name(dev), "n_pts": args.n_pts,
                      "w": args.w, "calls": args.calls,
                      "full_own_bitwise_k1": full_is_k1,
                      "variants": results}), flush=True)
    return dict(full_own_bitwise_k1=full_is_k1, variants=results)


if __name__ == "__main__":
    main()
