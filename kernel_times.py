#!/usr/bin/env python3
"""Time the port's mean-mode kernels K1, sorted K1, K2 and K3 in one or
more checkouts.

    python3 kernel_times.py [TREE ...]      (default: this checkout)

Each TREE is the root of a checkout of this repository (for example an
unpacked `git archive` of another commit). For each, in the order given,
a fresh process imports that checkout's `photobundle_torch`, builds its
kernels from its own sources, and times `patch_stats` (K1) and, where the
checkout has them, `sorted_patch_stats` (K1's sort-reuse entry, in the
order lm_solve builds under PB_SORTED_DISPATCH=1), `bicubic_stats` (K2)
and `scaled_stats` (K3, with chip_smoke.py's phase-8 scales) in their
default (mean) normalization at chip_smoke.py's phase-3 inputs (4096
points x 5 frames, 370x1226, seed 1) with patch radius R = 2, 4, 6 and 9
where the checkout's kernel is built for it, and K1 and sorted K1 also at
65 536 points, R = 2 (phase 11's dense windows): the median time per call
over 50 calls (CUDA events), and the device time per launch over 20
launches (torch.profiler, L2 flushed before each launch) in ROUNDS rounds
that take the kernels in turns, forward then backward (A B C, C B A,
...), so that every kernel sees the same drift. Reports each kernel's
median, least and largest device time over the rounds beside its bound
(chip_smoke.py's: bytes at the HBM rate, operations at the f32 rate);
then K1's device time per launch at R = 2 warm (20 launches back to back)
and inside one 8-iteration lm_solve of chip_smoke.py's phase 4 (L2 as the
solve leaves it). Give a tree twice, interleaved with another (A B B A),
to see the spread between processes. Prints each kernel instance's ptxas
registers and spills and one JSON line per tree. Needs a CUDA card.
"""

import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs

# (points, patch radius): the default radius, wider ones where the
# checkout's kernels are built for them, and K1's dense windows.
CASES = ((cs.N_PTS, 2), (cs.N_PTS, 4), (cs.N_PTS, 6), (cs.N_PTS, 9),
         (cs.DENSE_PTS, 2))
ROUNDS = 6


def one(tree: str) -> dict:
    """The numbers of one checkout, in this process."""
    sys.path.insert(0, os.path.abspath(tree))
    from photobundle_torch import entry
    from photobundle_torch.core import lm
    from photobundle_torch.core import residuals as res_mod
    from photobundle_torch.ops import _build, _common
    from photobundle_torch.ops import patch_bicubic as pb
    from photobundle_torch.ops import patch_warp as pw
    try:                        # K3 exists from the warped-grid slice on
        from photobundle_torch.ops import patch_scaled as ps
    except ImportError:
        ps = None
    has_sorted = hasattr(pw, "sorted_patch_stats")

    n_pts, w, h, wi = cs.N_PTS, cs.W, cs.H, cs.WI
    dev = torch.device("cuda", 0)
    sources = ["patch_warp", "patch_bicubic"] + (["patch_scaled"] if ps
                                                   else [])
    builds = _build.build_all(sources)
    for name, built in builds.items():
        table = dict(sorted(cs.ptxas_table(built.log).items()))
        print(f"[kernel_times] {tree} {name} ptxas {{(R, normalization "
              f"code): (registers, spill-store bytes)}}: {table}")
    out = {"tree": tree, "rounds": ROUNDS}
    # The radii the checkout's solve kernels are built for.
    radii = getattr(_common, "SOLVE_RADII", _common.RADII)
    for n_case, pr in CASES:
        if pr not in radii:
            continue
        dense = n_case != n_pts
        cam, offsets, args = entry.make_problem(n_case, w, h, wi, pr,
                                                seed=cs.SEED, device=dev)
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
        win1 = cs.window_texels(uv_nm, valid_k1, pr, 2 * pr + 2, pr, h, wi)
        bound_k1 = cs.kernel_bound(win1, cs.GRAD_TEXEL_BYTES, valid_k1, 1, pr,
                                   "bilinear", "mean")
        calls = {"K1": (lambda: pw.patch_stats(planes, uv_nm, valid_k1,
                                                patch, pr), bound_k1)}
        if has_sorted:
            order = res_mod.sorted_dispatch_order(res_mod.dispatch_key(
                cam, t_wc, x_world, obs, (h, wi)))
            calls["sorted_K1"] = (
                lambda: pw.sorted_patch_stats(planes, uv_nm, valid_k1, patch,
                                              pr, order), bound_k1)
        if not dense:
            calls["K2"] = (
                lambda: pb.bicubic_stats(value_planes, uv_nm, valid_k2, patch,
                                         pr),
                cs.kernel_bound(cs.window_texels(uv_nm, valid_k2, pr,
                                                 2 * pr + 4, pr + 1, h, wi),
                                cs.VALUE_TEXEL_BYTES, valid_k2, 1, pr,
                                "bicubic", "mean"))
        if ps is not None and not dense:
            rho = torch.as_tensor(np.clip(np.random.default_rng(
                cs.RHO_SEED).uniform(cs.RHO_LO, cs.RHO_HI, size=(n_case, w)),
                0.5, 2.0).astype(np.float32), device=dev)
            ext = rho.T * pr
            inside = ((x >= 1 + ext) & (x <= (wi - 2) - ext)
                      & (y >= 1 + ext) & (y <= (h - 2) - ext))
            valid_k3 = (obs.T & in_front & inside).T.contiguous()
            calls["K3"] = (
                lambda: ps.scaled_stats(planes, uv_nm, rho, valid_k3, patch,
                                        pr),
                cs.kernel_bound(cs.scaled_texels(uv_nm, rho, valid_k3, pr, h,
                                                 wi),
                                cs.GRAD_TEXEL_BYTES, valid_k3, 1, pr,
                                "scaled", "mean", with_rho=True))
        names = list(calls)
        keys = {name: f"{name}_R{pr}{f'_N{n_case}' if dense else ''}"
                for name in names}
        for name in names:
            out[f"{keys[name]}_ms"] = cs.median_ms(calls[name][0],
                                                   cs.KERNEL_CALLS)
        times = {name: [] for name in names}
        for r in range(ROUNDS):
            for name in names if r % 2 == 0 else names[::-1]:
                times[name].append(cs.device_us_per_launch(calls[name][0]))
        for name in names:
            us = [t for t in times[name] if t is not None]
            bound_us = calls[name][1]["bound_ms"] * 1e3
            key = keys[name]
            out[f"{key}_bound_us"] = bound_us
            out[f"{key}_device_us"] = statistics.median(us) if us else None
            out[f"{key}_device_us_min"] = min(us) if us else None
            out[f"{key}_device_us_max"] = max(us) if us else None
            print(f"[kernel_times] {tree} {key}: device us per launch over "
                  f"{ROUNDS} rounds median "
                  f"{cs.us_text(out[f'{key}_device_us'])}, range "
                  f"{cs.us_text(out[f'{key}_device_us_min'])} .. "
                  f"{cs.us_text(out[f'{key}_device_us_max'])} | bound "
                  f"{bound_us:.3f} us | median per call "
                  f"{out[f'{key}_ms']:.4f} ms", flush=True)
        if pr == 2 and not dense:
            out["K1_R2_warm_us"] = cs.device_us_per_launch(calls["K1"][0],
                                                           flush=False)
            situ, n_situ = cs.insitu_us(lambda: lm.lm_solve(
                cam, *args, offsets, huber_delta=cs.HUBER_DELTA,
                gradient_mode="sampled", max_iterations=cs.ITERS,
                function_tolerance=0.0, parameter_tolerance=0.0,
                backend="cuda"), "patch_stats_kernel")
            out["K1_R2_insitu_us"] = situ
            print(f"[kernel_times] {tree} K1_R2: warm (back to back) "
                  f"{cs.us_text(out['K1_R2_warm_us'])}, inside an "
                  f"{cs.ITERS}-iteration solve {cs.us_text(situ)} per "
                  f"launch over {n_situ} traced launches", flush=True)
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
