"""End-to-end command-line check on a synthetic KITTI-format stereo
sequence.

Twin of tools/verify_e2e.py, the same draws (numpy seed 3): a textured
sphere (`entry.make_texture`, `entry.render_view`) seen along a 12-frame
ground-truth track at 120x200 (fx = 120, baseline 0.2 m), written as a
KITTI odometry sequence (stereo PNGs through the port's stdlib writer,
calib.txt, times.txt, poses/00.txt), a VO input drifted 4 mm and 0.8
mrad per frame (`entry.drift_poses`), and a configuration of the JAX
script's small sizes. Runs `python -m photobundle_torch.cli` on it as a
subprocess and asserts that (a) every window's cost is non-increasing and
(b) the refined trajectory's ATE is below the drifted input's; then
prints VERIFY OK.

    python -m photobundle_torch.tools.verify_e2e [--root DIR] [--device cpu]

The sequence goes to build/verify_e2e unless --root is given. Runs the
command line on the card unless given --device cpu, and raises where
there is none.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np

from .. import entry
from ..core.engine import require_device
from ..io import png
from ..io import trajectory as traj_mod
from . import build_path

H, W, FX, BASE, NF = 120, 200, 120.0, 0.2, 12
CONFIG = """dataDir = {root}
sequence = 0
numFrames = {nf}
descriptor = Intensity
patchRadius = 2
slidingWindowSize = 5
maxNumPoints = 512
maxPointsPerFrame = 128
maxIterations = 25
pyramidLevels = 1
refinementLevel = 0
numDisparities = 48
sadWindowSize = 9
minDepth = 0.5
maxDepth = 50.0
depthPriorWeight = 0.1
"""


def write_sequence(root: str):
    """The JAX script's sequence and VO input under `root` (emptied
    first). Returns (ground-truth poses, VO poses), (NF, 4, 4) f32."""
    shutil.rmtree(root, ignore_errors=True)
    seq = os.path.join(root, "sequences", "00")
    os.makedirs(os.path.join(seq, "image_0"))
    os.makedirs(os.path.join(seq, "image_1"))
    os.makedirs(os.path.join(root, "poses"))

    rng = np.random.default_rng(3)
    intrinsics = (FX, FX, W / 2 - 0.5, H / 2 - 0.5)
    tex = entry.make_texture(rng)
    poses = []
    t_wc = np.eye(4, dtype=np.float32)
    for _ in range(NF):
        poses.append(t_wc.copy())
        xi = np.concatenate([
            rng.standard_normal(3) * 0.05 + np.array([0.05, 0, 0]),
            rng.standard_normal(3) * 0.002]).astype(np.float32)
        t_wc = (t_wc @ entry._se3_exp_np(xi)).astype(np.float32)
    poses = np.stack(poses)

    for i, p in enumerate(poses):
        img_l, _ = entry.render_view(tex, intrinsics, p, (H, W))
        pr = p.copy()
        pr[:3, 3] = p[:3, 3] + p[:3, :3] @ np.array([BASE, 0, 0])
        img_r, _ = entry.render_view(tex, intrinsics, pr, (H, W))
        for sub, im in (("image_0", img_l), ("image_1", img_r)):
            png.write_png_gray(os.path.join(seq, sub, f"{i:06d}.png"),
                               np.clip(im * 255, 0, 255).astype(np.uint8))

    with open(os.path.join(seq, "calib.txt"), "w") as f:
        f.write(f"P0: {FX} 0 {W/2-0.5} 0 0 {FX} {H/2-0.5} 0 0 0 1 0\n")
        f.write(f"P1: {FX} 0 {W/2-0.5} {-FX*BASE} 0 {FX} {H/2-0.5} 0 0 0 "
                f"1 0\n")
    with open(os.path.join(seq, "times.txt"), "w") as f:
        f.writelines(f"{i*0.1:.6f}\n" for i in range(NF))
    entry.write_poses(os.path.join(root, "poses", "00.txt"), poses)
    vo = entry.drift_poses(rng, poses, trans_sigma=0.004, rot_sigma=0.0008)
    entry.write_poses(os.path.join(root, "vo_init.txt"), vo)
    with open(os.path.join(root, "run.cfg"), "w") as f:
        f.write(CONFIG.format(root=root, nf=NF))
    return poses, vo


def check(root: str, poses, vo) -> dict:
    """The JAX script's assertions on a finished run under `root`: the
    ATEs and every window's cost. Raises AssertionError if either
    fails."""
    gt = traj_mod.Trajectory(poses)
    ref = traj_mod.load_poses_kitti(os.path.join(root, "refined.txt"))
    a_init = traj_mod.ate_rmse(traj_mod.Trajectory(vo), gt)
    a_ref = traj_mod.ate_rmse(ref, gt)
    print(f"ATE init={a_init:.5f} refined={a_ref:.5f} "
          f"improvement={a_init / a_ref:.2f}x")
    with open(os.path.join(root, "solve.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    dec = all(r["final_cost"] <= r["initial_cost"] + 1e-9 for r in recs)
    print(f"windows solved: {len(recs)}, all costs nonincreasing: {dec}")
    assert recs and dec and a_ref < a_init, "verification failed"
    return {"ate_init": a_init, "ate_refined": a_ref, "windows": len(recs)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="verify_e2e")
    ap.add_argument("--root", default=build_path("verify_e2e"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    root = os.path.abspath(args.root)
    poses, vo = write_sequence(root)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=repo)
    r = subprocess.run(
        [sys.executable, "-m", "photobundle_torch.cli", "--device", dev.type,
         "--config", os.path.join(root, "run.cfg"),
         "--poses", os.path.join(root, "vo_init.txt"),
         "--output", os.path.join(root, "refined.txt"),
         "--log", os.path.join(root, "solve.jsonl")],
        env=env, capture_output=True, text=True, timeout=1500)
    print("\n".join(r.stdout.splitlines()[-4:]))
    if r.returncode != 0:
        print(r.stderr[-3000:])
        raise SystemExit(1)
    rec = check(root, poses, vo)
    print("VERIFY OK", flush=True)
    return rec


if __name__ == "__main__":
    main()
