"""Reference-shape (W=5) accuracy diagnosis on the KITTI-scale golden:
sweep the levers that could eat the photometric signal (depth-prior
strength, Huber threshold, depth source, depth range, patch size,
coarse-to-fine) on a slice of the golden sequence, and report the
refined ATE of each variant against the input's.

Twin of tools/diagnose_w5.py. Reads the dataset `golden_kitti` renders
(--root, the same default); the variant 'gt_depth' replaces BM stereo by
the exact rendered depth (`gt_depth_dataset`).

    python -m photobundle_torch.tools.diagnose_w5 [--frames 60] \
        [--error-model iid] [--variants defaults,gt_depth] [--device cpu]

Runs on the card unless given --device cpu, and raises where there is
none.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from .. import cli as cli_mod
from ..config import PBAConfig
from ..core.engine import require_device
from ..entry import drift_poses, make_texture
from ..io import kitti as kitti_mod
from ..io import trajectory as traj_mod
from . import build_path
from .synthetic import perturb_poses, render_box

VARIANTS = {
    "defaults": dict(),
    "prior0": dict(depthPriorWeight=0.0),
    "prior1": dict(depthPriorWeight=1.0),
    "huber02": dict(robustThreshold=0.02),
    "near40": dict(maxDepth=40.0),
    "walls_only": dict(minDepth=25.0, maxDepth=95.0),
    "bigpatch": dict(patchRadius=3),
    "c2f": dict(pyramidLevels=3, coarseToFine=True),
    "gt_depth": dict(),   # exact rendered depth instead of BM stereo
}


def gt_depth_dataset(root, cfg, n_frames, device="cuda"):
    """The golden's frames with the EXACT rendered depth (the golden
    generator's texture seed), as a PrecomputedDepthDataset."""
    ks = kitti_mod.KittiStereoDataset(
        root=root, sequence=0,
        cfg=cfg.replace(dataLoader="python", numFrames=n_frames),
        device=device)
    rng = np.random.default_rng(12)
    tex = make_texture(rng, n_waves=96, min_wavelength=0.25,
                       max_wavelength=4.0)
    gt = traj_mod.load_poses_kitti(os.path.join(root, "poses", "00.txt"))
    images, depths = [], []
    for i in range(n_frames):
        img = kitti_mod._imread_gray(ks.left_files[i])
        _, depth = render_box(tex, ks.camera, gt.poses[i].astype(np.float32),
                              img.shape, max_depth=cfg.maxDepth)
        images.append(img)
        depths.append(depth)
    return kitti_mod.PrecomputedDepthDataset(images=images, depths=depths,
                                             camera=ks.camera)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="diagnose_w5")
    ap.add_argument("--root", default=build_path("golden_kitti_box"))
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--out-dir", default=build_path("diag_w5"))
    ap.add_argument("--drift-trans", type=float, default=0.008)
    ap.add_argument("--drift-rot", type=float, default=0.0005)
    ap.add_argument("--error-model", choices=("walk", "iid"), default="walk",
                    help="'walk' = random-walk VO drift (ATE dominated by "
                         "the accumulated, unobservable component); "
                         "'iid' = per-frame jitter (observable within a "
                         "window)")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    gt_full = traj_mod.load_poses_kitti(
        os.path.join(args.root, "poses", "00.txt"))
    gt = traj_mod.Trajectory(gt_full.poses[:args.frames])
    rng = np.random.default_rng(99)
    make_err = drift_poses if args.error_model == "walk" else perturb_poses
    init = make_err(rng, gt.poses.astype(np.float32),
                    trans_sigma=args.drift_trans,
                    rot_sigma=args.drift_rot, keep_first=2)
    init_traj = traj_mod.Trajectory(init.astype(np.float64))
    ate_init = traj_mod.ate_rmse(init_traj, gt, align=False)
    os.makedirs(args.out_dir, exist_ok=True)
    print(f"{args.frames} frames, init ATE {ate_init:.4f} m")

    out_rows = {}
    for name in args.variants.split(","):
        overrides = VARIANTS[name]
        cfg = PBAConfig(dataDir=args.root, sequence=0,
                        numFrames=args.frames,
                        stereoAlgorithm="BM", numDisparities=128,
                        minDisparity=1, speckleWindowSize=120,
                        depthCacheDir=os.path.join(args.root, "depth_cache"),
                        **overrides)
        if name == "gt_depth":
            dataset = gt_depth_dataset(args.root, cfg, args.frames, dev)
        else:
            dataset = kitti_mod.create_dataset(cfg, device=dev)
        out = os.path.join(args.out_dir, f"refined_{name}.txt")
        t0 = time.time()
        refined = cli_mod.run(cfg, dataset, init_traj, output=out,
                              progress=False, device=dev)
        ate_ref = traj_mod.ate_rmse(refined, gt, align=False)
        red = 100.0 * (1.0 - ate_ref / ate_init)
        out_rows[name] = dict(ate=ate_ref, reduction=red)
        print(f"{name:10s}: refined ATE {ate_ref:.4f} m ({red:+.1f}%), "
              f"{time.time() - t0:.0f}s", flush=True)
    return {"ate_init": ate_init, "variants": out_rows}


if __name__ == "__main__":
    main()
