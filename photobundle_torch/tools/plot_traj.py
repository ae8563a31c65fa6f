"""Trajectory and solve diagnostics plots: the paper's evaluation figures.

Twin of tools/plot_traj.py (`eval_traj` prints the tables, this renders
the figures):

  (a) bird's-eye XZ trajectory overlay (KITTI convention: x right, z fwd)
  (b) per-frame absolute position error, init vs refined
  (c) per-window photometric cost, initial vs final   (needs --jsonl)
  (d) per-window max pose correction                  (needs --jsonl)

    python -m photobundle_torch.tools.plot_traj refined.txt gt.txt \
        [init.txt] [--jsonl solve.jsonl] [--out traj.png]

Colors are the CVD-safe Okabe-Ito hues in fixed entity order (ground truth
gray, initialization orange, refined blue) with line-style secondary
encoding (dashed / dotted / solid), so identity never rides on color
alone. matplotlib's Agg backend; host code only.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ..io.trajectory import load_poses_kitti

# Fixed entity order — a missing init must not repaint the others.
C_GT, C_INIT, C_REF = "#555555", "#E69F00", "#0072B2"
GRID = dict(color="#dddddd", linewidth=0.6)


def _style(ax):
    ax.grid(True, **GRID)
    ax.set_axisbelow(True)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)


def _positions(traj) -> np.ndarray:
    return np.asarray(traj.poses)[:, :3, 3]


def main(argv=None) -> int:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ap = argparse.ArgumentParser(prog="plot_traj",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("refined")
    ap.add_argument("gt")
    ap.add_argument("init", nargs="?", default=None)
    ap.add_argument("--jsonl", default=None,
                    help="per-window solve records (cli.py --log)")
    ap.add_argument("--out", default="traj.png")
    args = ap.parse_args(argv)

    ref = _positions(load_poses_kitti(args.refined))
    gt = _positions(load_poses_kitti(args.gt))
    init = _positions(load_poses_kitti(args.init)) if args.init else None
    n = min(len(ref), len(gt))
    recs = None
    if args.jsonl:
        # JSONL files append across runs; keep the LAST record per window
        # leader frame (golden_kitti's convention).
        by_frame = {}
        with open(args.jsonl) as f:
            for line in f:
                r = json.loads(line)
                by_frame[r["frame"]] = r
        recs = [by_frame[k] for k in sorted(by_frame)]

    ncols = 2 if recs else 1
    fig, axes = plt.subplots(2, ncols, figsize=(6.5 * ncols, 9))
    axes = np.atleast_2d(axes.reshape(2, ncols))

    # (a) bird's-eye overlay — equal aspect, one axis pair.
    ax = axes[0, 0]
    ax.plot(gt[:n, 0], gt[:n, 2], "--", color=C_GT, linewidth=2,
            label="ground truth")
    if init is not None:
        ax.plot(init[:n, 0], init[:n, 2], ":", color=C_INIT, linewidth=2,
                label="VO initialization")
    ax.plot(ref[:n, 0], ref[:n, 2], "-", color=C_REF, linewidth=2,
            label="refined")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title("trajectory (bird's-eye)")
    ax.set_aspect("equal", adjustable="datalim")
    ax.legend(frameon=False)
    _style(ax)

    # (b) per-frame absolute position error (unaligned — the refinement
    # contract is "improve the given trajectory in its own gauge").
    ax = axes[1, 0]
    e_ref = np.linalg.norm(ref[:n] - gt[:n], axis=1)
    if init is not None:
        e_init = np.linalg.norm(init[:n] - gt[:n], axis=1)
        ax.plot(e_init, ":", color=C_INIT, linewidth=2,
                label=f"init (rms {np.sqrt(np.mean(e_init**2)):.4f} m)")
    ax.plot(e_ref, "-", color=C_REF, linewidth=2,
            label=f"refined (rms {np.sqrt(np.mean(e_ref**2)):.4f} m)")
    ax.set_xlabel("frame")
    ax.set_ylabel("position error [m]")
    ax.set_title("per-frame absolute error")
    ax.legend(frameon=False)
    _style(ax)

    if recs:
        frames = [r["frame"] for r in recs]
        # (c) per-window photometric cost — log scale, identity colors.
        ax = axes[0, 1]
        ax.plot(frames, [r["initial_cost"] for r in recs], ":",
                color=C_INIT, linewidth=2, label="initial cost")
        ax.plot(frames, [r["final_cost"] for r in recs], "-",
                color=C_REF, linewidth=2, label="final cost")
        ax.set_yscale("log")
        ax.set_xlabel("window leader frame")
        ax.set_ylabel("photometric cost")
        ax.set_title("per-window solve cost")
        ax.legend(frameon=False)
        _style(ax)

        # (d) per-window max pose correction — single series, no legend.
        ax = axes[1, 1]
        corr = [max(r.get("trans_correction", [0.0]) or [0.0])
                for r in recs]
        ax.plot(frames, corr, "-", color=C_REF, linewidth=2)
        ax.set_xlabel("window leader frame")
        ax.set_ylabel("max pose correction [m]")
        ax.set_title("per-window max pose correction")
        _style(ax)

    fig.tight_layout()
    fig.savefig(args.out, dpi=130)
    plt.close(fig)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
