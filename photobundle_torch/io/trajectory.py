"""Trajectory container, KITTI pose-file I/O, and odometry error metrics.

Twin of photobundle_tpu/io/trajectory.py (host numpy). Reference
counterparts: `Trajectory` + `loadPosesKittiFormat` /
`writePosesKittiFormat` (pb:src/trajectory.h, pb:src/pose_utils.*). The
KITTI odometry pose format is one row per frame: the top 3x4 of the 4x4
world-from-camera matrix, row-major, whitespace-separated.

Metrics: ATE (absolute trajectory error, after SE3/Sim3 alignment) and the
standard KITTI relative translation/rotation errors — the acceptance
criterion of BASELINE.md is ATE parity with the C++ reference.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


class Trajectory:
    """Ordered list of 4x4 world-from-camera poses with frame ids."""

    def __init__(self, poses: np.ndarray | None = None,
                 frame_ids: Sequence[int] | None = None):
        self.poses = np.zeros((0, 4, 4), np.float64) if poses is None else np.asarray(poses, np.float64)
        if frame_ids is None:
            frame_ids = list(range(len(self.poses)))
        self.frame_ids = list(frame_ids)

    def __len__(self):
        return len(self.poses)

    def __getitem__(self, i):
        return self.poses[i]

    def append(self, pose: np.ndarray, frame_id: int | None = None):
        self.poses = np.concatenate([self.poses, np.asarray(pose, np.float64)[None]], 0)
        self.frame_ids.append(len(self.poses) - 1 if frame_id is None else frame_id)

    def update(self, frame_ids: Sequence[int], poses: np.ndarray):
        """Overwrite poses for the given frame ids (extends if unseen) — how
        the engine's per-window refined poses are folded into the running
        trajectory (reference: Result accumulation in pb:src/photoba.cc)."""
        index = {f: i for i, f in enumerate(self.frame_ids)}
        for f, p in zip(list(frame_ids), poses):
            f = int(f)
            if f < 0:
                continue
            if f in index:
                self.poses[index[f]] = p
            else:
                self.append(p, f)

    def positions(self) -> np.ndarray:
        return self.poses[:, :3, 3]


def load_poses_kitti(path: str) -> Trajectory:
    """Read a KITTI-format pose file (3x4 row-major rows)."""
    rows = np.loadtxt(path, dtype=np.float64)
    if rows.ndim == 1:
        rows = rows[None]
    n = rows.shape[0]
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, :4] = rows.reshape(n, 3, 4)
    return Trajectory(poses)


def write_poses_kitti(path: str, traj: Trajectory) -> None:
    """Write poses in KITTI format (%.9e, 12 values per row).

    tmp + os.replace so concurrent readers (a unit stealer reading a dead
    worker's partial output, the resume path) never see a half-written
    file."""
    rows = traj.poses[:, :3, :4].reshape(len(traj), 12)
    tmp = f"{path}.tmp.{os.getpid()}"
    np.savetxt(tmp, rows, fmt="%.9e")
    os.replace(tmp, path)


def _umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (optionally Sim3) alignment y ~ s R x + t."""
    mx = x.mean(0)
    my = y.mean(0)
    xc = x - mx
    yc = y - my
    cov = yc.T @ xc / len(x)
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1
    r = u @ s @ vt
    var_x = (xc ** 2).sum(1).mean()
    scale = float(np.trace(np.diag(d) @ s) / var_x) if with_scale else 1.0
    t = my - scale * r @ mx
    return scale, r, t


def ate_rmse(est: Trajectory, gt: Trajectory, align: bool = True,
             with_scale: bool = False) -> float:
    """Absolute trajectory error (RMSE of positions) after alignment."""
    n = min(len(est), len(gt))
    p_est = est.positions()[:n]
    p_gt = gt.positions()[:n]
    if align and n >= 3:
        s, r, t = _umeyama_alignment(p_est, p_gt, with_scale)
        p_est = (s * (r @ p_est.T)).T + t
    return float(np.sqrt(((p_est - p_gt) ** 2).sum(-1).mean()))


def rpe(est: Trajectory, gt: Trajectory, delta: int = 1):
    """Relative pose error over frame gaps of `delta`:
    (translation RMSE [m], rotation RMSE [rad])."""
    n = min(len(est), len(gt))
    dts, drs = [], []
    for i in range(n - delta):
        rel_est = np.linalg.inv(est.poses[i]) @ est.poses[i + delta]
        rel_gt = np.linalg.inv(gt.poses[i]) @ gt.poses[i + delta]
        err = np.linalg.inv(rel_gt) @ rel_est
        dts.append(np.linalg.norm(err[:3, 3]))
        c = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)
        drs.append(np.arccos(c))
    if not dts:
        return 0.0, 0.0
    return float(np.sqrt(np.mean(np.square(dts)))), float(np.sqrt(np.mean(np.square(drs))))


def kitti_translation_error(est: Trajectory, gt: Trajectory,
                            lengths=(100, 200, 300, 400, 500, 600, 700, 800)) -> float:
    """KITTI odometry benchmark translational error (%%, averaged over
    subsequence lengths). Simplified single-pass variant."""
    n = min(len(est), len(gt))
    if n < 2:
        return 0.0
    # cumulative distance along ground truth
    p = gt.positions()[:n]
    dist = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(p, axis=0), axis=1))])
    errs = []
    for length in lengths:
        for i in range(0, n, 10):
            js = np.searchsorted(dist, dist[i] + length)
            if js >= n:
                break
            rel_gt = np.linalg.inv(gt.poses[i]) @ gt.poses[js]
            rel_est = np.linalg.inv(est.poses[i]) @ est.poses[js]
            err = np.linalg.inv(rel_gt) @ rel_est
            errs.append(np.linalg.norm(err[:3, 3]) / max(length, 1e-9))
    return float(np.mean(errs) * 100.0) if errs else 0.0


def kitti_rotation_error(est: Trajectory, gt: Trajectory,
                         lengths=(100, 200, 300, 400, 500, 600, 700, 800)) -> float:
    """KITTI odometry benchmark rotational error (deg / 100 m, averaged
    over subsequence lengths) — the paper's second accuracy axis."""
    n = min(len(est), len(gt))
    if n < 2:
        return 0.0
    p = gt.positions()[:n]
    dist = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(p, axis=0), axis=1))])
    errs = []
    for length in lengths:
        for i in range(0, n, 10):
            js = np.searchsorted(dist, dist[i] + length)
            if js >= n:
                break
            rel_gt = np.linalg.inv(gt.poses[i]) @ gt.poses[js]
            rel_est = np.linalg.inv(est.poses[i]) @ est.poses[js]
            err = np.linalg.inv(rel_gt) @ rel_est
            c = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)
            errs.append(np.degrees(np.arccos(c)) / max(length, 1e-9))
    return float(np.mean(errs) * 100.0) if errs else 0.0
