"""KITTI-scale synthetic golden: a 370x1226 stereo sequence through the
textured box room (`tools/synthetic.py`) on a seq-00-style block loop
(straights and 90-degree turns), BM-seeded depth, the command line's
`run` per configuration, and the init / refined ATE and RPE table.

Twin of tools/golden_kitti.py, with its configurations, error models,
arguments, provenance records and printed table:

    python -m photobundle_torch.tools.golden_kitti               # walk
    python -m photobundle_torch.tools.golden_kitti --error-model iid
    python -m photobundle_torch.tools.golden_kitti --frames 80

Error models:
  'walk' - random-walk VO drift. ATE is dominated by the accumulated
      component, which a windowed method cannot observe (the window's
      first poses are frozen at drifted values); only the per-pair
      relative error is correctable.
  'iid'  - independent per-frame jitter around the ground truth: fully
      observable within a window, the error photometric alignment
      corrects, and the regime where a W=5 refinement must win.

The dataset is rendered once and kept under --root (a `.rendered_<n>`
marker serves any run of at most n frames); stereo depth is cached across
configurations (cfg.depthCacheDir). The renderer: 'torch' renders in
float32 on the card (`make_render_box_torch`), 'numpy' in float64 on the
host; 'auto' takes torch on the card and numpy with --device cpu. Both
stay below the PNG's quantization (tests/test_torch_golden.py). Runs on
the card unless given --device cpu, and raises where there is none.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import hashlib
import json
import os
import time

import numpy as np

from .. import cli as cli_mod
from ..config import PBAConfig, _field_pytype
from ..core.engine import require_device
from ..entry import drift_poses
from ..io import kitti as kitti_mod
from ..io import trajectory as traj_mod
from . import build_path
from .synthetic import perturb_poses, write_box_kitti_dataset


def dataset_content_hash(root: str) -> str:
    """sha256 of the sha256s of every PNG of sequence 00, cut to 16 hex
    characters, and the PNG count: the provenance key that ties a golden
    table to the dataset it was measured on (a renderer change shows as a
    new key, not as a silent shift of the numbers)."""
    pngs = sorted(glob.glob(os.path.join(root, "sequences", "00",
                                         "image_*", "*.png")))
    h = hashlib.sha256()
    for p in pngs:
        with open(p, "rb") as f:
            h.update(hashlib.sha256(f.read()).digest())
    return f"{h.hexdigest()[:16]}/{len(pngs)}png"


def record_provenance(root: str, params: dict) -> dict:
    """Write render_provenance.json (render parameters + content hash)."""
    rec = dict(params, content_hash=dataset_content_hash(root))
    with open(os.path.join(root, "render_provenance.json"), "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
    return rec


def load_or_check_provenance(root: str) -> dict:
    """The recorded provenance, its content hash recomputed: a mismatch
    is flagged (a changed dataset must not publish under the old key).
    Datasets without a record get renderer='pre-provenance'."""
    path = os.path.join(root, "render_provenance.json")
    actual = dataset_content_hash(root)
    if not os.path.exists(path):
        return record_provenance(root, dict(renderer="pre-provenance"))
    with open(path) as f:
        rec = json.load(f)
    if rec.get("content_hash") != actual:
        print(f"WARNING: dataset {root} content hash {actual} != recorded "
              f"{rec.get('content_hash')} — dataset changed since render; "
              "re-keying", flush=True)
        rec = dict(rec, content_hash=actual, mutated=True)
    return rec


REFERENCE_EXACT = dict(
    slidingWindowSize=5, numFixedPoses=1, depthPriorWeight=0.0,
    motionPriorWeight=0.0, maxPoseCorrection=0.0, interpolation="bicubic",
    # cv::StereoBM's default X-Sobel prefilter (8-bit cap 31 ~ 0.12); the
    # default is 0 (raw SAD), so parity rows set it explicitly.
    preFilterCap=0.12)

CONFIGS = {
    # The Ceres-parity stack (configs/reference_exact.cfg): every
    # deviating default pinned off, bicubic sampling.
    "reference_exact": dict(REFERENCE_EXACT),
    # Reference-shape window with the shipped (production) defaults.
    "reference_W5": dict(slidingWindowSize=5),
    # Motion prior at the reference shape.
    "W5_prior": dict(slidingWindowSize=5, motionPriorWeight=2.0),
    # + observability gate on weakly-supported frames.
    "W5_prior_obsgate": dict(slidingWindowSize=5, motionPriorWeight=2.0,
                             minObsPerFrame=16),
    # Larger window + motion prior.
    "W10_prior": dict(slidingWindowSize=10, motionPriorWeight=5.0),
    # Coarse-to-fine: 3-level schedule at the reference window.
    "W5_coarse2fine": dict(slidingWindowSize=5, pyramidLevels=3,
                           coarseToFine=True),
    # Production W=5: motion prior + absolute pose prior (the sliding
    # chain re-anchors each window on its own refinement; posePriorWeight
    # fuses the VO input's absolute anchoring back in).
    "W5_production": dict(slidingWindowSize=5, motionPriorWeight=2.0,
                          posePriorWeight=4.0),
    # Production + coarse-to-fine.
    "W5_production_c2f": dict(slidingWindowSize=5, motionPriorWeight=2.0,
                              posePriorWeight=4.0, pyramidLevels=3,
                              coarseToFine=True),
    # Production + redescending loss: tukey zeroes gross photometric
    # outliers (occlusion boundaries at the box obstacles); delta = 0.3
    # sits between inlier residual norms and occlusion-level outliers.
    "W5_production_tukey": dict(slidingWindowSize=5, motionPriorWeight=2.0,
                                posePriorWeight=4.0, robustLoss="tukey",
                                robustThreshold=0.3),
    # Production + self-consistent patch-grid scaling (rho identically 1
    # in the reference frame): the model-fidelity lever for sharp texture.
    "W5_production_pwscale": dict(slidingWindowSize=5, motionPriorWeight=2.0,
                                  posePriorWeight=4.0, patchWarp="scale"),
    # c2f + hard rotational anchoring to the VO input (VO rotation drifts
    # far less than translation): the walk-regime configuration.
    "W5_production_rot": dict(slidingWindowSize=5, motionPriorWeight=2.0,
                              posePriorWeight=4.0, pyramidLevels=3,
                              coarseToFine=True, posePriorRotWeight=256.0),
}


def parse_set(items) -> dict:
    """--set key=value overrides, typed by PBAConfig's fields."""
    fields = {f.name: f for f in dataclasses.fields(PBAConfig)}
    extra = {}
    for kv in items:
        k, v = kv.split("=", 1)
        ty = _field_pytype(fields[k])
        extra[k] = (v.lower() in ("1", "true", "yes") if ty is bool
                    else ty(v))
    return extra


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="golden_kitti")
    ap.add_argument("--root", default=build_path("golden_kitti_box"))
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--error-model", choices=("walk", "iid"), default="walk")
    ap.add_argument("--drift-trans", type=float, default=None,
                    help="per-frame translation error sigma (m); default "
                         "0.008 (walk) / 0.02 (iid)")
    ap.add_argument("--drift-rot", type=float, default=None)
    ap.add_argument("--configs", default=",".join(CONFIGS),
                    help="comma-separated subset of configs to run")
    ap.add_argument("--set", action="append", default=[],
                    help="extra key=value config override applied on top "
                         "of every selected config (sweeps)")
    ap.add_argument("--seed", type=int, default=99,
                    help="VO error realization seed")
    ap.add_argument("--supersample", type=int, default=1,
                    help="render at SxS subpixel samples per pixel and "
                         "box-average (pixel integration; sharp textures "
                         "without view-dependent aliasing). Use a "
                         "distinct --root per setting.")
    ap.add_argument("--min-wavelength", type=float, default=0.25,
                    help="shortest texture wavelength (m); the default is "
                         "the point-sampled render's alias limit at 80 m; "
                         "go lower only with --supersample >= 2")
    ap.add_argument("--trajectory", choices=("block", "lateral"),
                    default="block",
                    help="'lateral' = strafe facing a wall (strong parallax "
                         "for every point). Use a distinct --root per "
                         "setting.")
    ap.add_argument("--obstacles", choices=("default", "none"),
                    default="default",
                    help="'none' removes the occluding boxes")
    ap.add_argument("--step", type=float, default=None,
                    help="per-frame translation (m); defaults: 0.8 block, "
                         "0.3 lateral")
    ap.add_argument("--renderer", choices=("auto", "numpy", "torch",
                                           "torch2"),
                    default="auto",
                    help="'torch' renders float32 frames on --device; "
                         "'torch2' also averages and quantizes there; "
                         "'auto' = torch on the card, numpy on the CPU")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    if args.drift_trans is None:
        args.drift_trans = 0.008 if args.error_model == "walk" else 0.02
    if args.drift_rot is None:
        args.drift_rot = 0.0005 if args.error_model == "walk" else 0.001
    if args.out_dir is None:
        args.out_dir = build_path(f"golden_kitti_out_{args.error_model}")

    # Render once and slice: a dataset rendered at M frames serves every
    # run with --frames <= M (the engine reads numFrames frames and the
    # ground truth is sliced below).
    existing = [int(m.rsplit("_", 1)[1])
                for m in glob.glob(os.path.join(args.root, ".rendered_*"))
                if m.rsplit("_", 1)[1].isdigit()]
    if not existing or max(existing) < args.frames:
        print(f"rendering {args.frames}-frame golden dataset -> {args.root} "
              "(one-time, cached; reused for any smaller --frames)...",
              flush=True)
        t0 = time.time()
        renderer = args.renderer
        if renderer == "auto":
            renderer = "torch" if dev.type == "cuda" else "numpy"
        rng = np.random.default_rng(12)
        step = (args.step if args.step is not None
                else (0.3 if args.trajectory == "lateral" else 0.8))
        write_box_kitti_dataset(args.root, 0, rng, n_frames=args.frames,
                                supersample=args.supersample,
                                min_wavelength=args.min_wavelength,
                                trajectory=args.trajectory,
                                obstacles=args.obstacles,
                                renderer=renderer, step=step, device=dev)
        with open(os.path.join(args.root, f".rendered_{args.frames}"),
                  "w") as f:
            f.write("ok")
        record_provenance(args.root, dict(
            renderer=renderer, supersample=args.supersample,
            min_wavelength=args.min_wavelength, trajectory=args.trajectory,
            obstacles=args.obstacles, step=step, frames=args.frames,
            texture_seed=12))
        print(f"rendered in {time.time() - t0:.0f}s", flush=True)

    gt = traj_mod.load_poses_kitti(
        os.path.join(args.root, "poses", "00.txt"))
    gt = traj_mod.Trajectory(gt.poses[:args.frames])
    rng = np.random.default_rng(args.seed)
    make_err = drift_poses if args.error_model == "walk" else perturb_poses
    init = make_err(rng, gt.poses.astype(np.float32),
                    trans_sigma=args.drift_trans,
                    rot_sigma=args.drift_rot, keep_first=2)
    os.makedirs(args.out_dir, exist_ok=True)
    init_path = os.path.join(args.out_dir, "vo_init.txt")
    traj_mod.write_poses_kitti(init_path, traj_mod.Trajectory(
        init.astype(np.float64)))
    init_traj = traj_mod.load_poses_kitti(init_path)
    ate_init = traj_mod.ate_rmse(init_traj, gt, align=False)
    rpe_init, rper_init = traj_mod.rpe(init_traj, gt, delta=1)
    print(f"[{args.error_model}] init ATE {ate_init:.4f} m, "
          f"RPE(1) {rpe_init:.4f} m / {np.degrees(rper_init):.3f} deg "
          f"({args.frames} frames)")

    extra = parse_set(args.set)
    rows = []
    for name in args.configs.split(","):
        overrides = dict(CONFIGS[name], **extra)
        if extra:
            # The printed label carries the overrides: golden_aggregate
            # groups rows by label, and an unmarked override would merge
            # with (or shadow) the base configuration's cells.
            name = name + "".join(f"+{k}={v}" for k, v in sorted(
                extra.items()))
        cfg = PBAConfig(dataDir=args.root, sequence=0,
                        numFrames=args.frames,
                        stereoAlgorithm="BM", numDisparities=128,
                        minDisparity=1, speckleWindowSize=120,
                        depthCacheDir=os.path.join(args.root, "depth_cache"),
                        **overrides)
        # The first configuration computes the stereo depth (BM, the
        # speckle filter); later ones with the same stereo settings read
        # the depth cache.
        dataset = kitti_mod.create_dataset(cfg, device=dev)
        out = os.path.join(args.out_dir, f"refined_{name}.txt")
        t0 = time.time()
        refined = cli_mod.run(cfg, dataset, init_traj, output=out,
                              jsonl_path=out + ".jsonl", progress=False,
                              device=dev)
        dt = time.time() - t0
        ate_ref = traj_mod.ate_rmse(refined, gt, align=False)
        rpe_ref, rper_ref = traj_mod.rpe(refined, gt, delta=1)
        red = 100.0 * (1.0 - ate_ref / ate_init)
        rows.append((name, ate_ref, red, rpe_ref, rper_ref, dt))
        print(f"{name:18s}: ATE {ate_ref:.4f} m ({red:+.1f}%), "
              f"RPE(1) {rpe_ref:.4f} m / {np.degrees(rper_ref):.3f} deg, "
              f"{dt:.0f}s ({args.frames / dt:.1f} keyframes/s)", flush=True)

    prov = load_or_check_provenance(args.root)
    prov_key = "/".join(
        str(prov.get(k)) for k in ("renderer", "supersample",
                                   "min_wavelength", "content_hash"))
    print(f"\nBASELINE.md table ({args.error_model} error model, "
          f"seed {args.seed}, {args.frames} frames, "
          f"init ATE {ate_init:.4f}, "
          f"init RPE(1) {rpe_init:.4f} m,\n"
          f"provenance {prov_key}):")
    print("| Config | refined ATE | reduction | RPE(1) trans | RPE(1) rot |")
    print("|---|---|---|---|---|")
    for name, ate_ref, red, rpe_ref, rper_ref, dt in rows:
        print(f"| {name} | {ate_ref:.4f} | {red:+.1f}% | {rpe_ref:.4f} | "
              f"{np.degrees(rper_ref):.3f} deg |")
    return {"ate_init": ate_init, "rpe_init": rpe_init,
            "rows": {name: dict(ate=ate_ref, reduction=red, rpe=rpe_ref,
                                rpe_rot=rper_ref, seconds=dt)
                     for name, ate_ref, red, rpe_ref, rper_ref, dt in rows},
            "out_dir": args.out_dir, "provenance": prov_key}


if __name__ == "__main__":
    main()
