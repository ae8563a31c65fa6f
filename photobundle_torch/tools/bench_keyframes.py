"""End-to-end engine throughput: keyframes/s including ingestion.

Twin of tools/bench_keyframes.py: 14 synthetic 370x1226 frames (the
scene of `bench_batched`: a sum of 40 random sinusoids, numpy seed 0,
frame k shifted by k px, one random depth map, 0.5 m per frame along x)
through the full `add_frame` path (pyramid, descriptors, tracking,
selection, the sliding-window LM solve) with maxNumPoints=4096,
maxPointsPerFrame=1024, slidingWindowSize=5, patchRadius=2,
maxIterations=30, functionTolerance=1e-6 and pipelined results (each
result is fetched one frame late). The host time of each `add_frame`
that returns a result from frame 6 on (the solve's graphs are captured
earlier) is taken and the median reported as one JSON line.

    python -m photobundle_torch.tools.bench_keyframes [--frames 14] \
        [--height 370 --width 1226] [--device cpu]

Runs on the card unless given --device cpu, and raises where there is
none.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..config import PBAConfig
from ..core.engine import PhotometricBundleAdjustment, require_device
from . import device_name
from .bench_batched import H, TIMED_FROM, WI, kitti_camera, scene


def measure(device="cuda", frames: int = 14, shape=(H, WI)) -> dict:
    """The engine over `frames` frames of the scene at `shape`; the JSON
    record."""
    device = require_device(device)
    cam = kitti_camera(shape)
    cfg = PBAConfig(maxNumPoints=4096, maxPointsPerFrame=1024,
                    slidingWindowSize=5, patchRadius=2, maxIterations=30,
                    functionTolerance=1e-6, pipelineResults=True)
    pba = PhotometricBundleAdjustment(cam, shape, cfg, device=device)
    images, depth = scene(frames, shape)
    t = np.eye(4, dtype=np.float32)
    solve_times = []
    for i, img in enumerate(images):
        t = t.copy()
        t[0, 3] += 0.5
        t0 = time.perf_counter()
        r = pba.add_frame(img, depth, t)
        if r is not None and i >= TIMED_FROM:
            solve_times.append(time.perf_counter() - t0)
    pba.flush_result()
    if not solve_times:
        raise ValueError(f"{frames} frames time no step (from frame "
                         f"{TIMED_FROM} on)")
    med = float(np.median(solve_times))
    return {
        "metric": "keyframes_per_s_end_to_end",
        "value": round(1.0 / med, 3),
        "unit": f"keyframes/s (ingest+track+select+{cfg.maxIterations}-iter "
                f"solve, {cfg.maxNumPoints} pts, {shape[0]}x{shape[1]})",
        "ms_per_keyframe": round(med * 1e3, 1),
        "steps_timed": len(solve_times),
        "device": device_name(device),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="bench_keyframes")
    p.add_argument("--frames", type=int, default=14)
    p.add_argument("--height", type=int, default=H)
    p.add_argument("--width", type=int, default=WI)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    rec = measure(args.device, args.frames, (args.height, args.width))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
