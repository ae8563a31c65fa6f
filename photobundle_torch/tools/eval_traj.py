"""Trajectory evaluation: ATE, RPE, and KITTI odometry segment errors.

Twin of tools/eval_traj.py:

    python -m photobundle_torch.tools.eval_traj <estimate.txt> \
        <ground_truth.txt> [init.txt]

Prints one JSON line per trajectory (the paper's evaluation protocol: the
KITTI odometry error of the initialization and after photometric
refinement). Host code only.
"""

from __future__ import annotations

import json
import sys

from ..io.trajectory import (ate_rmse, kitti_rotation_error,
                             kitti_translation_error, load_poses_kitti, rpe)


def report(name, est, gt) -> dict:
    t_rpe, r_rpe = rpe(est, gt)
    rec = {
        "trajectory": name,
        "ate_rmse_m": round(ate_rmse(est, gt), 6),
        "rpe_trans_m": round(t_rpe, 6),
        "rpe_rot_rad": round(r_rpe, 6),
        "kitti_t_err_pct": round(kitti_translation_error(est, gt), 4),
        "kitti_r_err_deg_per_100m": round(kitti_rotation_error(est, gt), 4),
    }
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> list:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        raise SystemExit("usage: eval_traj <estimate.txt> "
                         "<ground_truth.txt> [init.txt]")
    est = load_poses_kitti(argv[0])
    gt = load_poses_kitti(argv[1])
    out = []
    if len(argv) > 2:
        out.append(report("initialization", load_poses_kitti(argv[2]), gt))
    out.append(report("refined", est, gt))
    return out


if __name__ == "__main__":
    main()
