"""RPE(1) attribution for a golden run: where per-pair relative-pose error
enters the refined trajectory.

Twin of tools/diagnose_rpe.py. Reads what a golden run writes:
  refined_<config>.txt        the refined trajectory
  refined_<config>.txt.jsonl  per-window solve records (obs_per_frame,
                              trans/rot_correction per slot)
plus the ground-truth poses and the VO input, and reports, per
consecutive frame pair, the refined-vs-truth relative translation error
attributed to the window solve that last moved the pair (the solve where
the older frame sat at slot numFixedPoses), beside that window's
observation support and applied corrections. Host code only.

    python -m photobundle_torch.tools.diagnose_rpe \
        --run build/golden_kitti_out_walk/refined_reference_W5.txt \
        --gt build/golden_kitti_box/poses/00.txt \
        --init build/golden_kitti_out_walk/vo_init.txt
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ..io import trajectory as traj_mod


def pair_errors(est, gt, n):
    """Per-pair relative translation error |t_rel_est - t_rel_gt| (m)."""
    errs = np.zeros(n - 1)
    for i in range(n - 1):
        rel_est = np.linalg.inv(est.poses[i]) @ est.poses[i + 1]
        rel_gt = np.linalg.inv(gt.poses[i]) @ gt.poses[i + 1]
        err = np.linalg.inv(rel_gt) @ rel_est
        errs[i] = np.linalg.norm(err[:3, 3])
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="diagnose_rpe")
    ap.add_argument("--run", required=True,
                    help="refined trajectory (with .jsonl beside it)")
    ap.add_argument("--gt", required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--num-fixed", type=int, default=2,
                    help="numFixedPoses of the run (slot of the last "
                         "active solve of each pose)")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    refined = traj_mod.load_poses_kitti(args.run)
    gt = traj_mod.load_poses_kitti(args.gt)
    init = traj_mod.load_poses_kitti(args.init)
    n = min(len(refined), len(gt), len(init))

    records = {}
    with open(args.run + ".jsonl") as f:
        for line in f:
            rec = json.loads(line)
            fids = rec["frame_ids"]
            # Last record per leading frame id wins (resume overwrites).
            records[tuple(fids)] = rec
    # Index: frame id -> record where it sat at slot `num_fixed` (its last
    # ACTIVE solve; later windows only carry it frozen).
    by_active_slot = {}
    for fids, rec in records.items():
        if len(fids) > args.num_fixed:
            by_active_slot[fids[args.num_fixed]] = rec

    e_ref = pair_errors(refined, gt, n)
    e_init = pair_errors(init, gt, n)
    print(f"pairs: {n-1}; RPE(1) init {np.sqrt((e_init**2).mean()):.4f} m, "
          f"refined {np.sqrt((e_ref**2).mean()):.4f} m")

    rows = []
    for i in range(n - 1):
        rec = by_active_slot.get(i) or by_active_slot.get(i + 1)
        if rec is None:
            continue
        obs = np.asarray(rec.get("obs_per_frame", []))
        corr = np.asarray(rec.get("trans_correction", []))
        rows.append((i, e_ref[i], e_init[i],
                     int(obs.min()) if obs.size else -1,
                     int(rec["num_points"]),
                     float(corr.max()) if corr.size else np.nan,
                     rec.get("termination", "?")))
    rows.sort(key=lambda r: -r[1])

    print(f"\nworst {args.top} refined pairs:")
    print("pair i  e_ref    e_init   min_obs  n_pts  max_corr  term")
    for r in rows[:args.top]:
        print(f"{r[0]:6d}  {r[1]:.4f}  {r[2]:.4f}  {r[3]:7d}  {r[4]:5d} "
              f" {r[5]:8.4f}  {r[6]}")

    # Cross-tab: how much of the total squared RPE lives in weakly-supported
    # windows vs well-supported ones?
    if not rows:
        print("\n(no frame pair maps to a solve record: too few frames, "
              "or the JSONL lacks the per-slot fields)")
        return 0
    arr = np.array([(r[1], r[3], r[4], r[5]) for r in rows])
    tot = (arr[:, 0] ** 2).sum()
    print("\nshare of refined RPE^2 by window support:")
    for thresh in (0, 8, 32, 128, 512):
        m = arr[:, 1] <= thresh
        share = (arr[m, 0] ** 2).sum() / tot * 100.0 if tot > 0 else 0.0
        print(f"  windows with min_obs <= {thresh:4d}: {m.sum():4d} pairs, "
              f"{share:5.1f}% of RPE^2")
    for thresh in (0.05, 0.1, 0.2, 0.5):
        m = arr[:, 3] >= thresh
        share = (arr[m, 0] ** 2).sum() / tot * 100.0 if tot > 0 else 0.0
        print(f"  windows with max_corr >= {thresh:.2f} m: {m.sum():4d} "
              f"pairs, {share:5.1f}% of RPE^2")

    # Correction magnitude vs achieved pair error: if corrections are much
    # larger than the VO's actual per-pair error, the solver is moving
    # poses in weakly-observable directions (noise), not correcting error.
    med_corr = np.nanmedian(arr[:, 3])
    print(f"\nmedian applied max-correction: {med_corr:.4f} m; "
          f"median init pair error: {np.median(e_init):.4f} m")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
