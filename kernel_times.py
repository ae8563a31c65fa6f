#!/usr/bin/env python3
"""Time the port's kernels K1, sorted K1, K2, K3, the sample store, K7
and K8 in one or more checkouts.

    python3 kernel_times.py [--radii R,...] [--store-radii R,...]
                            [--descriptor-radii R,...] [--dense-radii R,...]
                            [--kernels NAME,...] [TREE ...]
                                  (default: this checkout)

Each TREE is the root of a checkout of this repository (for example an
unpacked `git archive` of another commit). For each, in the order given,
a fresh process imports that checkout's `photobundle_torch`, builds its
kernels from its own sources, and times `patch_stats` (K1) and, where the
checkout has them, `sorted_patch_stats` (K1's sort-reuse entry, in the
order lm_solve builds under PB_SORTED_DISPATCH=1), `bicubic_stats` (K2,
mean and affine normalization) and `scaled_stats` (K3 in the mean mode,
K5 in the affine mode, with chip_smoke.py's phase-8 scales) at
chip_smoke.py's phase-3 inputs (4096 points x 5 frames, 370x1226, seed 1)
with patch radius R = 2, 4, 6, 9, 10 and 19 (or those of --radii) where
the checkout's kernel takes it; the sample store (`patch_samples.store`,
layouts rows, block and raw) at R = 2 and 9 (or --store-radii); K7
(`patch_stats.stats_rows`, full and cost_only, at --radii where the
checkout's K7 takes them); K8
(`patch_ablate.ablate_stats`, full/own and loads/own at 64 threads) at
R = 2; and K1, sorted K1 and K8 also at 65 536 points,
R = 2 (phase 11's dense windows; K1 and sorted K1 at --dense-radii),
with the blocks of sorted K1 by branch where the checkout's kernel
reports it; K1's batch axis (`K1_batch`, where the
checkout's `patch_stats` takes one) at R = 2 on chip_smoke.py phase 16's
windows at B = 1, 2 and 4, and sorted K1's (`sorted_K1_batch`, each
window in its own order as phase 16 orders them); sorted K1 and K1 with
the IntensityAndGradient channels (`sorted_K1_C3_R<R>`, `K1_C3_R<R>`)
at --descriptor-radii on chip_smoke.py phase 20 (B)'s inputs, the order
`chip_smoke.uv_dispatch_key` of their coordinates; the descriptor
kernels (`K1_C3_R2`, `K1_C3_R19`, `K1_C8_R2`, `K1_C8_R19`: K1 with the
IntensityAndGradient and BitPlanes channels, C = 3 and 8, at R = 2 and
19; `K2_C3_R2`, `K2_C3_R19`: K2 with C = 3; other radii with
--descriptor-radii; `--kernels K1_C,K2_C` keeps them) on chip_smoke.py phase
20 (B)'s inputs (`chip_smoke.descriptor_calls`, mean normalization).
--kernels keeps the kernels whose names
start with one of the given prefixes (K1 always runs, but where only the
LM body's own kernels are named) and builds only their sources. The LM
body's own kernels: `row_dot` (ops/ordered_sum) times every call of one
eager LM body (chip_smoke.py's `record_body_sums`) at 4096 points x 5
poses, B = 4, and at 65 536 x 5 and 32 768 x 32, B = 1 (each call's
inputs as the tree's own body gave them), L2 flushed before each call,
their device times summed over the body; `chol` (ops/chol_solve) times
the solve on chip_smoke.py's `chol_systems` at W = 5 (B = 1, 4, 8), 10
(B = 4), 32 (B = 1, 4) and 45 (B = 1) in f32, and W = 5 (B = 4) and 32
(B = 1) in f64 (equal hashes across trees: bitwise equal solutions).
For each: the
median time per call over 50 calls (CUDA events), and the device time per
launch over 20 launches (torch.profiler, L2 flushed before each launch by
writing 256 MiB) in ROUNDS rounds that take the kernels in turns, forward
then backward (A B C, C B A, ...), so that every kernel sees the same
drift; for the stores also once after a flush that reads 256 MiB instead
(L2 then holds clean lines, no dirty ones to write back). Reports each
kernel's median, least and largest device time over the rounds beside its
bound (chip_smoke.py's: bytes at the HBM rate, operations at the f32
rate) and a hash of its output bytes (identical inputs in every tree, so
equal hashes show two trees' outputs bitwise equal); then K1's device
time per launch at R = 2 warm (20 launches back to back), and K1's and
K2's inside one 8-iteration lm_solve of chip_smoke.py's phase 4
(bilinear, then bicubic; L2 as the solve leaves it). Give a tree twice,
interleaved with another (A B B A), to see the spread between processes.
Prints each kernel instance's ptxas registers and spills and one JSON
line per tree. Needs a CUDA card.
"""

import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs

# The patch radii timed at 4096 points (where the checkout's kernels take
# them; `--radii 3,5` times others), then K1's dense windows at R = 2.
RADII = (2, 4, 6, 9, 10, 19)
STORE_RADII = (2, 9)
ROUNDS = 6
K8_THREADS = 64


# Each kernel source and the names of the kernels timed from it.
# The LM body's own kernels (no TPU kernel stands behind them), timed
# apart from the patch kernels.
BODY_KERNELS = ("row_dot", "chol")
BODY_SIZES = ((cs.N_PTS, cs.W, cs.BODY_BATCH),
              *((n, w, 1) for n, w in cs.ORDERED_SIZES))
CHOL_CASES = ((5, 1, "f32"), (5, 4, "f32"), (5, 8, "f32"), (10, 4, "f32"),
              (32, 1, "f32"), (32, 4, "f32"), (45, 1, "f32"), (5, 4, "f64"),
              (32, 1, "f64"))
SOURCE_KERNELS = {"patch_warp": ("K1", "sorted_K1", "K1_batch", "K1_C"),
                  "patch_bicubic": ("K2_mean", "K2_affine", "K2_C"),
                  "patch_scaled": ("K3", "K5"),
                  "patch_samples": ("store_rows", "store_block",
                                    "store_raw"),
                  "patch_stats": ("K7_full", "K7_cost_only"),
                  "patch_ablate": ("K8_full_own", "K8_loads_own")}


def kernel_radii(common, samples) -> dict:
    """The patch radii each kernel of a checkout takes (older checkouts
    name one range for all, or only the sample stores', or K7's as
    RADII)."""
    shared = getattr(common, "SOLVE_RADII", getattr(common, "RADII", ()))
    return {"K1": getattr(common, "FIXED_RADII", shared),
            "K2": (range(1, common.BICUBIC_MAX + 1)
                   if hasattr(common, "BICUBIC_MAX") else shared),
            "K3": getattr(common, "WARPED_RADII", shared),
            "K7": (range(1, common.STATS_MAX + 1)
                   if hasattr(common, "STATS_MAX") else common.RADII),
            "store": samples.RADII}


def use_tree(tree: str):
    """Make `import photobundle_torch` take the checkout at `tree`: put it
    first on the path and forget the package this process imported
    already (chip_smoke.py imports this checkout's at its top). Returns
    the tree's package."""
    import importlib

    sys.path.insert(0, os.path.abspath(tree))
    for name in [m for m in sys.modules if m == "photobundle_torch"
                 or m.startswith("photobundle_torch.")]:
        del sys.modules[name]
    package = importlib.import_module("photobundle_torch")
    where = os.path.dirname(os.path.abspath(package.__file__))
    if where != os.path.join(os.path.abspath(tree), "photobundle_torch"):
        raise RuntimeError(f"{tree}: imported photobundle_torch from {where}")
    return package


def launches_us(fns, match: str):
    """Device time of each launch of fns' kernels (names holding `match`),
    in order, one fn after another with L2 flushed before each: one
    torch.profiler trace, taken again (up to three times) until it holds
    one launch per fn. None if no trace does."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for fn in fns:
                cs.flush_l2()
                fn()
            torch.cuda.synchronize()
        evts = sorted((e for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and match in e.name),
                      key=lambda e: e.time_range.start)
        if len(evts) == len(fns):
            return [e.time_range.elapsed_us() for e in evts]
    return None


def body_one(tree: str, prefixes) -> dict:
    """The LM body's own kernels of one checkout, in this process."""
    use_tree(tree)
    from photobundle_torch import entry
    from photobundle_torch.ops import _build
    from photobundle_torch.ops import chol_solve as chol
    from photobundle_torch.ops import ordered_sum as osm

    dev = torch.device("cuda", 0)
    builds = _build.build_all(["ordered_sum", "chol_solve"])
    for name, built in builds.items():
        print(f"[kernel_times] {tree} {name}:", flush=True)
        cs.print_ptxas_typed(name, built)
    out = {"tree": tree, "rounds": ROUNDS}
    cases = {}
    if "row_dot" in prefixes:
        for n_pts, w, b in BODY_SIZES:
            cam, offsets, args = entry.make_problem(
                n_pts, w, cs.H, cs.WI, cs.PATCH_RADIUS, seed=cs.SEED,
                device=dev)
            recorded = cs.record_body_sums(cam, offsets, args, b)
            fns = [lambda a=a, c=c: osm.row_dot(a, c)
                   for a, c, _ in recorded]
            t_bytes = t_ops = 0.0
            for a, c, o in recorded:
                t_bytes += (a.numel() + (0 if c is None else c.numel())
                            + o.numel()) * a.element_size()
                t_ops += o.numel() * a.shape[-1] * (1 if c is None else 2)
            bound_us = max(t_bytes / cs.H100_BYTES_PER_S,
                           t_ops / cs.H100_F32_FLOPS) * 1e6
            cases[f"row_dot_{n_pts}x{w}_B{b}"] = (
                fns, "row_dot", bound_us,
                torch.cat([o.flatten() for _, _, o in recorded]))
    if "chol" in prefixes:
        for w, b, dt in CHOL_CASES:
            s, rhs = cs.chol_systems(w, b, dev, 100 * w + b)
            if dt == "f64":
                s, rhs = s.double(), rhs.double()
            n = 6 * w
            bound = cs.bytes_ops_bound(
                b * (n * (n + 1) // 2 + 2 * n) * s.element_size(),
                b * (n ** 3 / 3 + 2 * n * n), b * n * s.element_size())
            cases[f"chol_W{w}_B{b}_{dt}"] = (
                [lambda s=s, rhs=rhs: chol.chol_solve(s, rhs)], "chol_solve",
                bound["bound_ms"] * 1e3, chol.chol_solve(s, rhs))
            if b == 1 and dt == "f32":
                lib = {"cholesky_ex + cholesky_solve": lambda s=s, rhs=rhs:
                       torch.cholesky_solve(rhs[..., None],
                                            torch.linalg.cholesky_ex(s)[0]),
                       "torch.linalg.solve": lambda s=s, rhs=rhs:
                       torch.linalg.solve(s, rhs)}
                for label, fn in lib.items():
                    us, _ = cs.library_us_per_call(fn)
                    out[f"chol_W{w}_B{b}_{label}_us"] = us
                    print(f"[kernel_times] {tree} chol W = {w}, B = 1: "
                          f"{label} {cs.us_text(us)}", flush=True)
    names = list(cases)
    times = {name: [] for name in names}
    for r in range(ROUNDS):
        for name in names if r % 2 == 0 else names[::-1]:
            fns, match = cases[name][:2]
            times[name].append(launches_us(fns, match))
    for name in names:
        fns, match, bound_us, result = cases[name]
        rounds = [t for t in times[name] if t is not None]
        sums = [sum(t) for t in rounds]
        out[f"{name}_device_us"] = statistics.median(sums) if sums else None
        out[f"{name}_device_us_min"] = min(sums) if sums else None
        out[f"{name}_device_us_max"] = max(sums) if sums else None
        out[f"{name}_bound_us"] = bound_us
        out[f"{name}_launches"] = len(fns)
        out[f"{name}_hash"] = cs.output_hash(result)
        heaviest = ""
        if len(fns) > 1 and rounds:
            per = [statistics.median(t[i] for t in rounds)
                   for i in range(len(fns))]
            out[f"{name}_per_call_us"] = per
            top = max(range(len(fns)), key=per.__getitem__)
            heaviest = f" | heaviest call {top}: {per[top]:.2f} us"
        print(f"[kernel_times] {tree} {name}: {len(fns)} launch(es), device "
              f"us summed, over {ROUNDS} rounds median "
              f"{cs.us_text(out[f'{name}_device_us'])}, range "
              f"{cs.us_text(out[f'{name}_device_us_min'])} .. "
              f"{cs.us_text(out[f'{name}_device_us_max'])} | bound "
              f"{bound_us:.3f} us{heaviest} | output hash "
              f"{out[f'{name}_hash']}", flush=True)
    out["nvidia_smi"] = cs.nvidia_smi()
    return out


def time_calls(tree: str, calls: dict, keys: dict, out: dict) -> None:
    """Hash, time per call and device time per launch (ROUNDS rounds, L2
    flushed) of each of `calls`, {name: (call, bound, kernel name match)},
    into `out` under keys[name]; prints a line for each."""
    names = list(calls)
    for name in names:
        out[f"{keys[name]}_hash"] = cs.output_hash(calls[name][0]())
        out[f"{keys[name]}_ms"] = cs.median_ms(calls[name][0],
                                               cs.KERNEL_CALLS)
    times = {name: [] for name in names}
    for r in range(ROUNDS):
        for name in names if r % 2 == 0 else names[::-1]:
            times[name].append(cs.device_us_per_launch(
                calls[name][0], match=calls[name][2]))
    for name in names:
        us = [t for t in times[name] if t is not None]
        bound_us = calls[name][1]["bound_ms"] * 1e3
        key = keys[name]
        if name.startswith("store"):
            out[f"{key}_clean_us"] = cs.device_us_per_launch(
                calls[name][0], match="samples", flush="read")
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
              f"{out[f'{key}_ms']:.4f} ms | output hash "
              f"{out[f'{key}_hash']}"
              + (f" | after a read flush "
                 f"{cs.us_text(out[f'{key}_clean_us'])}"
                 if f"{key}_clean_us" in out else ""), flush=True)


def sorted_branches(tree, pw, key, call_args, n, w) -> None:
    """Prints the blocks of one sorted launch by branch, where the tree's
    kernel reports its branch (SortedBranch in csrc/patch_warp.cu; a tree
    without it flags 1 for a staged union box)."""
    staged = torch.zeros(pw.sorted_blocks(n, w), dtype=torch.uint8,
                         device=call_args[0].device)
    pw.sorted_patch_stats(*call_args, staged=staged)
    counts = torch.bincount(staged.long(), minlength=3).tolist()
    print(f"[kernel_times] {tree} {key}: blocks by branch (0 gathered, 1 "
          f"union box, 2 own windows): {counts}", flush=True)


def one(tree: str, radii_timed, store_radii, prefixes,
        descriptor_radii=cs.DESCRIPTOR_RADII, dense_radii=(2,)) -> dict:
    """The numbers of one checkout, in this process."""
    if prefixes and all(p in BODY_KERNELS for p in prefixes):
        return body_one(tree, prefixes)
    use_tree(tree)
    from photobundle_torch import entry
    from photobundle_torch.core import lm
    from photobundle_torch.core import residuals as res_mod
    from photobundle_torch.image import patches as patches_mod
    from photobundle_torch.ops import _build, _common
    from photobundle_torch.ops import patch_ablate as pa
    from photobundle_torch.ops import patch_bicubic as pb
    from photobundle_torch.ops import patch_samples as smp
    from photobundle_torch.ops import patch_stats as k7
    from photobundle_torch.ops import patch_warp as pw
    try:                        # K3 exists from the warped-grid slice on
        from photobundle_torch.ops import patch_scaled as ps
    except ImportError:
        ps = None
    has_sorted = hasattr(pw, "sorted_patch_stats")

    n_pts, w, h, wi = cs.N_PTS, cs.W, cs.H, cs.WI
    dev = torch.device("cuda", 0)

    def wanted(name):
        return name == "K1" or not prefixes or name.startswith(prefixes)

    sources = [src for src, names in SOURCE_KERNELS.items()
               if any(map(wanted, names))
               and (ps is not None or src != "patch_scaled")]
    builds = _build.build_all(sources)
    for name, built in builds.items():
        table = dict(sorted(cs.ptxas_instances(built.log).items()))
        print(f"[kernel_times] {tree} {name} ptxas {{(kernel, template "
              f"arguments): (registers, spill-store bytes)}}: {table}")
    out = {"tree": tree, "rounds": ROUNDS}
    radii = kernel_radii(_common, smp)
    cases = [(n_pts, r) for r in sorted(set(radii_timed) | set(store_radii))]
    for n_case, pr in cases + [(cs.DENSE_PTS, r) for r in dense_radii]:
        if pr not in radii["K1"]:
            continue
        dense = n_case != n_pts
        solve_radius = dense or pr in radii_timed
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
                                                patch, pr), bound_k1,
                        "stats")}
        patch_aff = patches_mod.affine_normalize(patch).contiguous()
        if has_sorted and solve_radius and wanted("sorted_K1"):
            order = res_mod.sorted_dispatch_order(res_mod.dispatch_key(
                cam, t_wc, x_world, obs, (h, wi)))
            calls["sorted_K1"] = (
                lambda: pw.sorted_patch_stats(planes, uv_nm, valid_k1, patch,
                                              pr, order), bound_k1,
                "stats")
            sorted_branches(tree, pw, f"sorted_K1_R{pr}"
                            f"{f'_N{n_case}' if dense else ''}",
                            (planes, uv_nm, valid_k1, patch, pr, order),
                            n_case, w)
        if (pr == 2 and not dense and has_sorted
                and wanted("sorted_K1_batch")
                and "batch axis" in (pw.sorted_patch_stats.__doc__ or "")):
            kernel, _, sargs, _, sbounds, _ = cs.axis_inputs(
                "sorted_patch_stats", planes, value_planes, uv_nm,
                (obs.T & in_front).T.contiguous(), patch, pr,
                cs.BATCH_KERNEL)
            for b in (1, 2, cs.BATCH_KERNEL):
                part = tuple(a[:b] for a in sargs)
                calls[f"sorted_K1_batch{b}"] = (
                    lambda part=part: kernel(*part),
                    cs.summed_bound(sbounds[:b]), "sorted")
        if (pr == 2 and not dense and wanted("K1_batch")
                and "batch axis" in (pw.patch_stats.__doc__ or "")):
            batch = cs.batched_inputs(planes, uv_nm,
                                      (obs.T & in_front).T.contiguous(),
                                      patch, pr, cs.BATCH_KERNEL)
            for b in (1, 2, cs.BATCH_KERNEL):
                part = tuple(a[:b] for a in batch)
                calls[f"K1_batch{b}"] = (
                    lambda part=part: pw.patch_stats(*part, pr),
                    cs.summed_bound([cs.kernel_bound(
                        cs.window_texels(part[1][k], part[2][k], pr,
                                         2 * pr + 2, pr, h, wi),
                        cs.GRAD_TEXEL_BYTES, part[2][k], 1, pr, "bilinear",
                        "mean") for k in range(b)]), "stats")
        if not dense and pr in radii_timed and pr in radii["K2"]:
            texels_k2 = cs.window_texels(uv_nm, valid_k2, pr, 2 * pr + 4,
                                         pr + 1, h, wi)
            for norm, desc in (("mean", patch), ("affine", patch_aff)):
                if not wanted(f"K2_{norm}"):
                    continue
                calls[f"K2_{norm}"] = (
                    lambda desc=desc, norm=norm: pb.bicubic_stats(
                        value_planes, uv_nm, valid_k2, desc, pr, norm),
                    cs.kernel_bound(texels_k2, cs.VALUE_TEXEL_BYTES,
                                    valid_k2, 1, pr, "bicubic", norm),
                    "stats")
        if (ps is not None and not dense and pr in radii_timed
                and pr in radii["K3"]):
            rho = torch.as_tensor(np.clip(np.random.default_rng(
                cs.RHO_SEED).uniform(cs.RHO_LO, cs.RHO_HI, size=(n_case, w)),
                0.5, 2.0).astype(np.float32), device=dev)
            ext = rho.T * pr
            inside = ((x >= 1 + ext) & (x <= (wi - 2) - ext)
                      & (y >= 1 + ext) & (y <= (h - 2) - ext))
            valid_k3 = (obs.T & in_front & inside).T.contiguous()
            texels_k3 = cs.scaled_texels(uv_nm, rho, valid_k3, pr, h, wi)
            for name, norm, desc in (("K3", "mean", patch),
                                     ("K5", "affine", patch_aff)):
                if not wanted(name):
                    continue
                calls[name] = (
                    lambda desc=desc, norm=norm: ps.scaled_stats(
                        planes, uv_nm, rho, valid_k3, desc, pr, norm),
                    cs.kernel_bound(texels_k3, cs.GRAD_TEXEL_BYTES, valid_k3,
                                    1, pr, "scaled", norm, with_rho=True),
                    "stats")
        if not dense and pr in radii_timed and pr in radii["K7"]:
            desc = patch.reshape(n_case, 1, 2 * pr + 1, 2 * pr + 1)
            for mode, src in (("full", planes), ("cost_only", value_planes)):
                if wanted(f"K7_{mode}"):
                    calls[f"K7_{mode}"] = (
                        lambda src=src, cost_only=mode == "cost_only":
                        k7.stats_rows(src, uv_nm, valid_k1, desc, pr,
                                      cost_only),
                        cs.k7_bound(win1, valid_k1, pr, mode == "cost_only"),
                        "stats_kernel")
        if not dense and pr in store_radii and pr in radii["store"]:
            for layout in smp.LAYOUTS:
                if wanted(f"store_{layout}"):
                    calls[f"store_{layout}"] = (
                        lambda layout=layout: smp.store(
                            planes, uv_nm, valid_k1, pr, layout),
                        cs.samples_bound(win1, valid_k1, pr, layout),
                        "samples")
        if pr == 2:
            for stage in ("full", "loads"):
                name = f"K8_{stage}_own"
                if wanted(name):
                    calls[name] = (
                        lambda stage=stage: pa.ablate_stats(
                            planes, uv_nm, valid_k1, patch, stage, "own",
                            K8_THREADS),
                        cs.ablate_bound(uv_nm, valid_k1, pr, stage, "own",
                                        K8_THREADS), "ablate")
        keys = {name: f"{name}_R{pr}{f'_N{n_case}' if dense else ''}"
                for name in calls}
        time_calls(tree, calls, keys, out)
        if pr == 2 and not dense and (not prefixes or "K1" in prefixes):
            out["K1_R2_warm_us"] = cs.device_us_per_launch(calls["K1"][0],
                                                           flush=False)
            for name, mode, match in (("K1", "sampled", "patch_stats_kernel"),
                                      ("K2", "bicubic", "bicubic")):
                situ, n_situ, _ = cs.insitu_us(lambda: lm.lm_solve(
                    cam, *args, offsets, huber_delta=cs.HUBER_DELTA,
                    gradient_mode=mode, max_iterations=cs.ITERS,
                    function_tolerance=0.0, parameter_tolerance=0.0,
                    backend="cuda"), match, cs.ITERS + 1)
                out[f"{name}_R2_insitu_us"] = situ
                print(f"[kernel_times] {tree} {name}_R2: inside an "
                      f"{cs.ITERS}-iteration {mode} solve {cs.us_text(situ)} "
                      f"per launch over {n_situ} traced launches", flush=True)
            print(f"[kernel_times] {tree} K1_R2: warm (back to back) "
                  f"{cs.us_text(out['K1_R2_warm_us'])}", flush=True)
    if has_sorted and wanted("sorted_K1_C"):
        # Sorted K1 beside K1 with three channels: "sorted_K1_C3_R2".
        calls, keys = {}, {}
        for pr in descriptor_radii:
            channels, planes, uv_nm, valid_nm, patch = cs.descriptor_instance(
                dev, cs.DESCRIPTORS[0], pr)
            c = channels.shape[1]
            order = res_mod.sorted_dispatch_order(
                cs.uv_dispatch_key(uv_nm, valid_nm))
            bound = cs.kernel_bound(
                cs.window_texels(uv_nm, valid_nm, pr, 2 * pr + 2, pr, h, wi),
                cs.GRAD_TEXEL_BYTES, valid_nm, c, pr, "bilinear", "mean")
            args = (planes, uv_nm, valid_nm, patch, pr)
            for name, call in (
                    (f"sorted_K1_C{c}_R{pr}",
                     lambda args=args, order=order:
                     pw.sorted_patch_stats(*args, order)),
                    (f"K1_C{c}_R{pr}",
                     lambda args=args: pw.patch_stats(*args))):
                calls[name] = (call, bound, "stats")
                keys[name] = name
            sorted_branches(tree, pw, f"sorted_K1_C{c}_R{pr}", (*args, order),
                            n_pts, w)
        time_calls(tree, calls, keys, out)
    if wanted("K1_C") or wanted("K2_C"):
        # The descriptor kernels on chip_smoke.py phase 20 (B)'s inputs:
        # "K1 C=3 R=2" -> K1_C3_R2.
        calls, keys = {}, {}
        for label, (call, _, _, bound, _) in cs.descriptor_calls(
                dev, descriptor_radii).items():
            name = "_".join(label.replace("=", "").split())
            if wanted(name):
                calls[name] = (call, bound, "stats")
                keys[name] = name
        time_calls(tree, calls, keys, out)
    out["nvidia_smi"] = cs.nvidia_smi()
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA card")
    args = sys.argv[1:]
    opts = {"--radii": ",".join(map(str, RADII)),
            "--store-radii": ",".join(map(str, STORE_RADII)),
            "--descriptor-radii": ",".join(map(str, cs.DESCRIPTOR_RADII)),
            "--dense-radii": "2",
            "--kernels": ""}
    while args[:1] and args[0] in opts:
        opts[args[0]], args = args[1], args[2:]
    if args[:1] == ["--one"]:
        print(json.dumps(one(
            args[1], tuple(int(r) for r in opts["--radii"].split(",")),
            tuple(int(r) for r in opts["--store-radii"].split(",")),
            tuple(k for k in opts["--kernels"].split(",") if k),
            tuple(int(r) for r in opts["--descriptor-radii"].split(",")),
            tuple(int(r) for r in opts["--dense-radii"].split(",")))),
            flush=True)
        return
    for tree in args or ["."]:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        *[x for kv in opts.items() for x in kv], "--one",
                        tree], check=True, timeout=900)


if __name__ == "__main__":
    main()
