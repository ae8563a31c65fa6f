"""Command line: refine a VO trajectory of a KITTI-format sequence.

Twin of photobundle_tpu/cli.py (the reference's `photoba` driver): parse
options, build the dataset and the engine, run the frame loop, write the
refined trajectory.

    python -m photobundle_torch.cli --config configs/kitti_production.cfg \\
        --poses vo.txt --output refined.txt [--device cpu] [key=value ...]

Runs on the card unless `--device cpu` is given (and raises where there is
none). Adds over the reference: JSONL solve records, a per-phase timing
report, checkpoint/resume (the trajectory written after every window, a
restarted run resuming after the last completed one) and bitwise-exact
engine snapshots (`--snapshot-every`).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np
import torch

from .config import ConfigFile, PBAConfig
from .core.engine import PhotometricBundleAdjustment, require_device
from .io import kitti as kitti_mod
from .io import trajectory as traj_mod
from .utils import logging as log
from .utils.timer import Timer


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="photobundle-torch",
                                description="photometric bundle adjustment "
                                            "on PyTorch + CUDA")
    p.add_argument("--config", required=True, help="path to .cfg file")
    p.add_argument("--output", default="refined_poses.txt",
                   help="output KITTI-format trajectory")
    p.add_argument("--poses", default=None,
                   help="initial VO trajectory (KITTI format); defaults to "
                        "the dataset's ground-truth pose file")
    p.add_argument("--log", default=None, help="JSONL solve-record path")
    p.add_argument("--points-dir", default=None,
                   help="directory for per-window refined point clouds (npz)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the run here")
    p.add_argument("--resume", action="store_true",
                   help="resume from an existing output/checkpoint")
    p.add_argument("--snapshot-every", type=int, default=0,
                   help="write a full engine-state snapshot every K windows "
                        "(bitwise-exact resume; 0 = off, resume re-ingests)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the stereo and the engine "
                        "(default: the card; 'cpu' runs on the host)")
    p.add_argument("overrides", nargs="*",
                   help="key=value config overrides (reference CLI behavior)")
    return p


def load_config(args) -> PBAConfig:
    cfg_file = ConfigFile(args.config)
    for ov in args.overrides:
        key, _, value = ov.partition("=")
        cfg_file.set(key.strip(), value.strip())
    return PBAConfig.from_config_file(cfg_file)


def run(cfg: PBAConfig, dataset, init_traj: traj_mod.Trajectory,
        output: str = "refined_poses.txt", jsonl_path: str | None = None,
        resume: bool = False, progress: bool = True,
        points_dir: str | None = None, on_window=None,
        snapshot_every: int = 0, device="cuda"):
    """The frame loop on `device`. Returns the refined Trajectory."""
    timer = Timer()
    h, w = dataset.image_shape
    pba = PhotometricBundleAdjustment(dataset.camera, (h, w), cfg,
                                      device=device)

    refined = traj_mod.Trajectory(init_traj.poses.copy(),
                                  list(init_traj.frame_ids))

    # Keyframe-gate replay (cfg.minKeyframeMotion): the gate is a pure
    # function of the INIT trajectory, so its decisions for any prefix can
    # be reconstructed deterministically; resume depends on this.
    def replay_gate(upto: int):
        """Gate decisions for dataset frames [0, upto): returns
        (last_kf, anchor_of, ingested_ids)."""
        last, anchors, ingested = None, {}, []
        for j in range(upto):
            if cfg.minKeyframeMotion > 0 and last is not None:
                d = np.linalg.norm(init_traj.poses[j][:3, 3]
                                   - init_traj.poses[last][:3, 3])
                if d < cfg.minKeyframeMotion:
                    anchors[j] = last
                    continue
            last = j
            ingested.append(j)
        return last, anchors, ingested

    start = 0
    last_kf = None           # frame id of the last ingested keyframe
    anchor_of = {}           # skipped frame id -> anchoring keyframe id
    ckpt = output + ".ckpt"
    snap = output + ".state.npz"
    if resume and os.path.exists(ckpt):
        with open(ckpt) as f:
            done = int(f.read().strip())   # last COMPLETED dataset frame
        # The interrupted run's output holds the refined poses of every
        # completed window (tail = init): re-seed `refined` from it, so the
        # refined prefix is not written back as raw VO poses.
        if os.path.exists(output):
            prev = traj_mod.load_poses_kitti(output)
            if len(prev) == len(refined):
                refined = traj_mod.Trajectory(prev.poses.copy(),
                                              list(refined.frame_ids))
            else:
                log.warn("resume: %s has %d poses, expected %d; "
                         "starting from the VO init", output, len(prev),
                         len(refined))
        if snapshot_every > 0 and os.path.exists(snap):
            # Bitwise-exact resume: the snapshot records its own ingest
            # counter (it may be older than the .ckpt frame). The next
            # DATASET frame is one past the newest frame id in the ring,
            # not the ingest count, which falls behind dataset indices when
            # the keyframe gate skips.
            pba.load_state(snap)
            start = int(pba.window.frame_ids.max()) + 1
            log.info("resuming from snapshot at frame %d", start)
        else:
            log.info("resuming from frame %d", done)
            # Windows overlapping the resume point are re-solved; the
            # engine rebuilds as the last W-1 INGESTED keyframes before
            # `done` (gate replay; the dense frames when the gate is off)
            # are re-ingested.
            w_sz = cfg.slidingWindowSize
            _, _, ingested = replay_gate(done + 1)
            tail = [f for f in ingested if f <= done][-(w_sz - 1):]
            start = tail[0] if tail else 0
        # Seed the gate state at the resume point so decisions (and the
        # skipped-frame post-pass) match an uninterrupted run.
        last_kf, anchor_of, _ = replay_gate(start)

    if start > 0 and hasattr(dataset, "seek"):
        dataset.seek(start)
    writer = log.JsonlWriter(jsonl_path) if jsonl_path else None
    n = min(len(dataset), len(init_traj))

    def handle(result):
        if result is None:
            return
        # Under cfg.pipelineResults results arrive one frame late; the
        # result's own last frame id is the progress marker.
        i = int(result.frame_ids[-1])
        refined.update(result.frame_ids, result.poses)
        if writer:
            writer.write(log.window_record(result, {"frame": i}))
        if points_dir:
            os.makedirs(points_dir, exist_ok=True)
            np.savez_compressed(
                os.path.join(points_dir, f"window_{i:06d}.npz"),
                xyz=result.points_xyz, ref_frame=result.points_frame,
                frame_ids=result.frame_ids, poses=result.poses)
        if progress:
            log.info("%s", result.message())
            if cfg.solverVerbose:
                for k in range(result.iterations):
                    log.info("  it %2d  cost %.6e  lambda %.3e  |dx| %.3e  %s",
                             k, result.cost_log[k], result.lambda_log[k],
                             result.step_log[k],
                             "accept" if result.accept_log[k] else "reject")
        with timer.time("io.checkpoint"):
            traj_mod.write_poses_kitti(output, refined)
            if snapshot_every > 0 and i % snapshot_every == 0:
                pba.save_state(snap)
            # tmp + os.replace: a concurrent reader (resume) never sees an
            # empty or partial frame counter.
            tmp = f"{ckpt}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(str(i))
            os.replace(tmp, ckpt)
        if on_window is not None:
            on_window()

    # Keyframe selection (cfg.minKeyframeMotion): the reference ingests
    # every frame, and so does the default. With the gate on, near-
    # stationary frames are skipped (their stereo is never computed) and
    # anchored to the last ingested keyframe; their refined pose is the
    # keyframe's refined pose composed with the VO relative pose (the
    # post-pass below). last_kf / anchor_of were seeded by replay_gate()
    # when resuming.
    try:
        for i in range(start, n):
            if cfg.minKeyframeMotion > 0 and last_kf is not None:
                dt_vo = np.linalg.norm(init_traj.poses[i][:3, 3]
                                       - init_traj.poses[last_kf][:3, 3])
                if dt_vo < cfg.minKeyframeMotion:
                    anchor_of[i] = last_kf
                    if hasattr(dataset, "seek"):
                        dataset.seek(i + 1)  # drop the skipped frame's work
                    continue
            last_kf = i
            with timer.time("dataset.get_frame"):
                frame = dataset.get_frame(i)
            with timer.time("engine.add_frame"):
                result = pba.add_frame(frame.image, frame.depth,
                                       init_traj.poses[i],
                                       depth_valid=frame.depth_valid,
                                       frame_id=i)
            handle(result)
        handle(pba.flush_result())
    finally:
        if writer:
            writer.close()

    if anchor_of:
        index = {f: k for k, f in enumerate(refined.frame_ids)}
        for i, a in anchor_of.items():
            rel = np.linalg.inv(init_traj.poses[a]) @ init_traj.poses[i]
            refined.poses[index[i]] = refined.poses[index[a]] @ rel
    traj_mod.write_poses_kitti(output, refined)
    if os.path.exists(ckpt):
        os.remove(ckpt)
    log.info("timing report:\n%s", timer.report())
    return refined


def _profile(trace_dir: str):
    """A torch.profiler session (host, and the card where there is one)
    that writes a Chrome trace into `trace_dir` when it ends."""
    os.makedirs(trace_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(trace_dir))


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = require_device(args.device)
    cfg = load_config(args)
    dataset = kitti_mod.create_dataset(cfg, device=device)
    pose_file = args.poses or dataset.pose_file()
    if not os.path.exists(pose_file):
        log.fatal("initial pose file not found: %s", pose_file)
    init_traj = traj_mod.load_poses_kitti(pose_file)
    prof = (_profile(args.profile_dir) if args.profile_dir
            else contextlib.nullcontext())
    with prof:
        refined = run(cfg, dataset, init_traj, output=args.output,
                      jsonl_path=args.log, resume=args.resume,
                      points_dir=args.points_dir,
                      snapshot_every=args.snapshot_every, device=device)
    log.info("wrote %d refined poses to %s", len(refined), args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
