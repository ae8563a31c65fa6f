"""Within-card data parallelism: total keyframes/s of B concurrent
sequences through the batched engine (core/batched.py).

Twin of tools/bench_batched.py: 370x1226 frames of a sum of 40 random
sinusoids (numpy seed 0), each sequence's frame k the same texture shifted
by k px and brightened by 0.001 per sequence, one random depth map
(uniform 5-60 m), the camera moving 0.5 m along x per frame;
maxNumPoints=4096, maxPointsPerFrame=1024, slidingWindowSize=5,
patchRadius=2, maxIterations=30, functionTolerance=1e-6. Every frame after
the window fills runs one batched window solve; the time of `add_frames`
(ingest of B frames, the solve, the result fetch) is taken on the host
clock for frames 6..11 (the solve's graphs are captured at frame 4) and
its median reported. One JSON line per batch size: total keyframes/s
(B / median step) and ms per step.

    python -m photobundle_torch.tools.bench_batched [--batches 1,2,4,8] \
        [--frames 12] [--device cpu]

Runs on the card unless given --device cpu, and raises where there is
none.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import PBAConfig
from ..core.batched import BatchedPhotometricBundleAdjustment
from ..core.engine import require_device
from ..geometry.camera import Camera
from . import device_name

H, WI = 370, 1226
TIMED_FROM = 6          # the first frame whose step is timed


def scene(frames: int, shape=(H, WI)):
    """(frames of the texture, depth map): the JAX tool's draws at its
    370x1226 (another `shape` for a small run)."""
    h, wi = shape
    rng = np.random.default_rng(0)
    base = np.zeros((h + 40, wi + 40), np.float32)
    ys, xs = np.meshgrid(np.arange(h + 40), np.arange(wi + 40),
                         indexing="ij")
    for _ in range(40):
        f1, f2, ph = (rng.uniform(0.02, 0.5), rng.uniform(0.02, 0.5),
                      rng.uniform(0, 6))
        base += np.sin(f1 * xs + f2 * ys + ph).astype(np.float32)
    base = 0.5 + base / 60
    images = [np.ascontiguousarray(base[k:k + h, k:k + wi])
              for k in range(frames)]
    depth = rng.uniform(5, 60, (h, wi)).astype(np.float32)
    return images, depth


def kitti_camera(shape=(H, WI)) -> Camera:
    """KITTI 00's left camera (the JAX tools' intrinsics), scaled to
    `shape`'s width and height where it is not 370x1226."""
    sy, sx = shape[0] / H, shape[1] / WI
    return Camera.create(fx=718.856 * sx, fy=718.856 * sx, cx=607.19 * sx,
                         cy=185.21 * sy, baseline=0.537)


def measure(batch: int, device="cuda", frames: int = 12,
            scene_data=None) -> dict:
    """Run `frames` frames of `batch` sequences; the JSON record."""
    device = require_device(device)
    cam = kitti_camera()
    cfg = PBAConfig(maxNumPoints=4096, maxPointsPerFrame=1024,
                    slidingWindowSize=5, patchRadius=2, maxIterations=30,
                    functionTolerance=1e-6)
    bp = BatchedPhotometricBundleAdjustment(cam, (H, WI), cfg, batch,
                                            device=device)
    images, depth = scene_data or scene(frames)
    t = np.eye(4, dtype=np.float32)
    times, solved = [], 0
    for i, img in enumerate(images[:frames]):
        t = t.copy()
        t[0, 3] += 0.5
        imgs = [img + 0.001 * k for k in range(batch)]
        t0 = time.perf_counter()
        rs = bp.add_frames(imgs, [depth] * batch, [t] * batch)
        if rs is not None:
            solved += 1
            if i >= TIMED_FROM:
                times.append(time.perf_counter() - t0)
    if not times:
        raise ValueError(f"{frames} frames time no step (from frame "
                         f"{TIMED_FROM} on)")
    med = float(np.median(times))
    return {"batch": batch, "keyframes_per_s_total": batch / med,
            "ms_per_step": med * 1e3, "steps_timed": len(times),
            "solves": solved, "device": device_name(device)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bench_batched")
    p.add_argument("--batches", default="1,2,4,8",
                   help="comma-separated batch sizes")
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    data = scene(args.frames)
    for b in (int(x) for x in args.batches.split(",")):
        print(json.dumps(measure(b, args.device, args.frames, data)),
              flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
