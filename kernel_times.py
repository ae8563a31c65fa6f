#!/usr/bin/env python3
"""Time the port's mean-mode kernels K1, K2 and K3 in one or more checkouts.

    python3 kernel_times.py [TREE ...]      (default: this checkout)

Each TREE is the root of a checkout of this repository (for example an
unpacked `git archive` of another commit). For each, in the order given,
a fresh process imports that checkout's `photobundle_torch`, builds its
kernels from its own sources, and times `patch_stats` (K1),
`bicubic_stats` (K2) and, where the checkout has it, `scaled_stats` (K3,
with chip_smoke.py's phase-8 scales) in their default (mean)
normalization at chip_smoke.py's phase-3 inputs (4096 points x 5 frames,
370x1226, seed 1) with patch radius R = 2 and 4: the median time per
call over 50 calls (CUDA events) and the device time per launch over 20
launches (torch.profiler). Give a tree twice, interleaved with another
(A B B A), to see the spread between processes. Prints each kernel
instance's ptxas registers and spills and one JSON line per tree. Needs
a CUDA card.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs

RADII = (2, 4)    # the default patch radius and the largest kernel build


def one(tree: str) -> dict:
    """The numbers of one checkout, in this process."""
    sys.path.insert(0, os.path.abspath(tree))
    from photobundle_torch import entry
    from photobundle_torch.core import residuals as res_mod
    from photobundle_torch.ops import _build
    from photobundle_torch.ops import patch_bicubic as pb
    from photobundle_torch.ops import patch_warp as pw
    try:                        # K3 exists from the warped-grid slice on
        from photobundle_torch.ops import patch_scaled as ps
    except ImportError:
        ps = None

    n_pts, w, h, wi = cs.N_PTS, cs.W, cs.H, cs.WI
    dev = torch.device("cuda", 0)
    sources = ["patch_warp", "patch_bicubic"] + (["patch_scaled"] if ps
                                                   else [])
    builds = _build.build_all(sources)
    for name, built in builds.items():
        table = dict(sorted(cs.ptxas_table(built.log).items()))
        print(f"[kernel_times] {tree} {name} ptxas {{(R, normalization "
              f"code): (registers, spill-store bytes)}}: {table}")
    out = {"tree": tree}
    for pr in RADII:
        cam, _, args = entry.make_problem(n_pts, w, h, wi, pr, seed=cs.SEED,
                                          device=dev)
        t_wc, x_world, patch, channels, grads, obs, _, _ = args
        _, uv, in_front, _, _ = res_mod._observation_geometry_pm(
            cam, t_wc, x_world)
        x, y = uv[:, 0], uv[:, 1]

        def valid_within(lo, hi_x, hi_y):
            inside = (x >= lo) & (x <= hi_x) & (y >= lo) & (y <= hi_y)
            return (obs.T & in_front & inside).T.contiguous()  # (N, W)

        uv_nm = uv.permute(2, 0, 1).contiguous()
        valid_k1 = valid_within(pr, wi - 2 - pr, h - 2 - pr)
        valid_k2 = valid_within(pr + 1, wi - 3 - pr, h - 3 - pr)
        planes = pw.build_planes(channels, grads)
        value_planes = pb.build_value_planes(channels)
        calls = {
            "K1": lambda: pw.patch_stats(planes, uv_nm, valid_k1, patch, pr),
            "K2": lambda: pb.bicubic_stats(value_planes, uv_nm, valid_k2,
                                           patch, pr),
        }
        if ps is not None:
            rho = torch.as_tensor(np.clip(np.random.default_rng(
                cs.RHO_SEED).uniform(cs.RHO_LO, cs.RHO_HI, size=(n_pts, w)),
                0.5, 2.0).astype(np.float32), device=dev)
            ext = rho.T * pr
            inside = ((x >= 1 + ext) & (x <= (wi - 2) - ext)
                      & (y >= 1 + ext) & (y <= (h - 2) - ext))
            valid_k3 = (obs.T & in_front & inside).T.contiguous()
            calls["K3"] = lambda: ps.scaled_stats(planes, uv_nm, rho,
                                                  valid_k3, patch, pr)
        for name, fn in calls.items():
            out[f"{name}_R{pr}_ms"] = cs.median_ms(fn, cs.KERNEL_CALLS)
            out[f"{name}_R{pr}_device_us"] = cs.device_us_per_launch(fn)
    out["nvidia_smi"] = cs.nvidia_smi()
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA card")
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(one(sys.argv[2])), flush=True)
        return
    for tree in sys.argv[1:] or ["."]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        tree], check=True, timeout=600)


if __name__ == "__main__":
    main()
