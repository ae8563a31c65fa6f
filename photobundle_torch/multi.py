"""Multi-sequence / multi-worker refinement (the DP axis across
processes).

Twin of photobundle_tpu/multi.py, driving the port's `cli.run`:
independent refinement jobs (KITTI sequences, or segments of them) are
refined concurrently by worker processes. The reference is strictly
single-sequence, single-process.

    python -m photobundle_torch.multi --config configs/kitti_stereo.cfg \\
        --sequences 0,1,2 --output-dir out/ --workers 2 [--device cpu] \\
        [--frames-per-unit 500] [--elastic-dir /shared/sched] [--poses-dir D]

Work units (sequence segments) go through the elastic LeaseScheduler
(parallel/scheduler.py): workers claim units, heartbeat while refining, and
steal units from dead workers, so losing a worker mid-run only costs that
worker's in-flight unit, which a survivor re-runs. With --elastic-dir on
shared storage the same command scales across hosts. Each worker runs its
units on `--device` (the card by default; 'cpu' on the host), and all the
local workers share that device.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys

import numpy as np

from . import cli as cli_mod
from .config import ConfigFile, PBAConfig
from .core.engine import require_device
from .io import kitti as kitti_mod
from .io import trajectory as traj_mod
from .parallel.scheduler import LeaseScheduler, WorkUnit, make_units
from .utils import logging as log


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="photobundle-torch-multi")
    p.add_argument("--config", required=True)
    p.add_argument("--sequences", required=True,
                   help="comma-separated sequence numbers, e.g. 0,1,2")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--workers", type=int, default=1,
                   help="local worker processes to spawn (1 = run inline)")
    p.add_argument("--frames-per-unit", type=int, default=-1,
                   help="chunk sequences into units of this many frames")
    p.add_argument("--elastic-dir", default=None,
                   help="scheduler directory (shared storage for multi-host);"
                        " default <output-dir>/.sched")
    p.add_argument("--poses-dir", default=None,
                   help="directory of initial VO pose files <NN>.txt; "
                        "defaults to the dataset's poses/")
    p.add_argument("--lease-timeout", type=float, default=120.0)
    p.add_argument("--device", default="cuda",
                   help="torch device each worker runs on (default: the "
                        "card; 'cpu' runs on the host)")
    p.add_argument("--worker-id", default=None, help=argparse.SUPPRESS)
    p.add_argument("overrides", nargs="*")
    return p


def _unit_output(outdir: str, u: WorkUnit) -> str:
    if u.num_frames < 0:
        return os.path.join(outdir, f"{u.sequence:02d}.txt")
    return os.path.join(outdir, f"{u.sequence:02d}_{u.first_frame:06d}.txt")


def _load_cfg(args) -> PBAConfig:
    cf = ConfigFile(args.config)
    for ov in args.overrides:
        k, _, v = ov.partition("=")
        cf.set(k.strip(), v.strip())
    return PBAConfig.from_config_file(cf)


def refine_unit(cfg: PBAConfig, u: WorkUnit, args,
                heartbeat=None) -> str:
    """Refine one work unit on `args.device`; returns the output path."""
    ucfg = cfg.replace(sequence=u.sequence, firstFrame=u.first_frame,
                       numFrames=u.num_frames)
    dataset = kitti_mod.create_dataset(ucfg, device=args.device)
    pose_file = (os.path.join(args.poses_dir, f"{u.sequence:02d}.txt")
                 if args.poses_dir else dataset.pose_file())
    init = traj_mod.load_poses_kitti(pose_file)
    # Slice the unit's rows out of the full-sequence initialization.
    lo = u.first_frame
    hi = len(init) if u.num_frames < 0 else min(len(init), lo + u.num_frames)
    unit_init = traj_mod.Trajectory(init.poses[lo:hi])
    out = _unit_output(args.output_dir, u)
    cli_mod.run(ucfg, dataset, unit_init, output=out,
                jsonl_path=out + ".jsonl", resume=True, progress=False,
                on_window=heartbeat, device=args.device)
    return out


def worker_main(args) -> int:
    cfg = _load_cfg(args)
    os.makedirs(args.output_dir, exist_ok=True)
    sched_dir = args.elastic_dir or os.path.join(args.output_dir, ".sched")
    wid = args.worker_id or f"{os.uname().nodename}.{os.getpid()}"
    sched = LeaseScheduler(sched_dir, wid, lease_timeout_s=args.lease_timeout)
    seqs = [int(s) for s in args.sequences.split(",")]
    sched.publish(_units_for(cfg, args, seqs))
    done = 0
    for u in sched.claims():
        log.info("[%s] refining unit %d: seq %02d frames %d..%s", wid, u.uid,
                 u.sequence, u.first_frame,
                 "end" if u.num_frames < 0 else u.first_frame + u.num_frames)
        refine_unit(cfg, u, args, heartbeat=lambda: sched.heartbeat())
        sched.complete(u)
        done += 1
    log.info("[%s] no work left (%d units refined here)", wid, done)
    return 0


def _sequence_length(cfg: PBAConfig, seq: int) -> int:
    return len(glob.glob(os.path.join(
        cfg.dataDir, "sequences", f"{seq:02d}", "image_0", "*.png")))


def _units_for(cfg: PBAConfig, args, seqs) -> list:
    """The canonical unit list: workers and merge_outputs must derive unit
    boundaries the same way (tails shorter than the sliding window are
    folded into the preceding chunk; they could never fill a window)."""
    return make_units(
        seqs, args.frames_per_unit,
        sequence_lengths={s: _sequence_length(cfg, s) for s in seqs}
        if args.frames_per_unit > 0 else None,
        min_frames=cfg.slidingWindowSize)


def merge_outputs(args) -> None:
    """Concatenate per-unit trajectories into one <NN>.txt per sequence.

    Raises if any unit's output is missing: a silent skip would emit a
    merged trajectory shorter than the sequence (frames dropped without
    warning) when a worker died before refining its unit."""
    cfg = _load_cfg(args)
    if args.frames_per_unit < 0:
        return  # whole-sequence units already wrote <NN>.txt
    seqs = sorted({int(x) for x in args.sequences.split(",")})
    units = _units_for(cfg, args, seqs)
    for s in seqs:
        rows = []
        for u in units:
            if u.sequence != s:
                continue
            path = _unit_output(args.output_dir, u)
            if not os.path.exists(path):
                raise RuntimeError(
                    f"merge: missing unit output {path} (seq {s:02d} frames "
                    f"{u.first_frame}..{u.first_frame + u.num_frames}); "
                    "a worker likely died before refining it: re-run to "
                    "let a surviving worker pick it up")
            rows.append(traj_mod.load_poses_kitti(path).poses)
        if rows:
            merged = traj_mod.Trajectory(np.concatenate(rows, axis=0))
            traj_mod.write_poses_kitti(
                os.path.join(args.output_dir, f"{s:02d}.txt"), merged)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    require_device(args.device)
    if args.workers <= 1:
        rc = worker_main(args)
        merge_outputs(args)
        return rc
    # Spawn local worker processes; each claims from the shared scheduler.
    procs = []
    for k in range(args.workers):
        cmd = [sys.executable, "-m", "photobundle_torch.multi",
               "--config", args.config, "--sequences", args.sequences,
               "--output-dir", args.output_dir, "--workers", "1",
               "--frames-per-unit", str(args.frames_per_unit),
               "--lease-timeout", str(args.lease_timeout),
               "--device", args.device, "--worker-id", f"w{k}"]
        if args.elastic_dir:
            cmd += ["--elastic-dir", args.elastic_dir]
        if args.poses_dir:
            cmd += ["--poses-dir", args.poses_dir]
        cmd += list(args.overrides)
        procs.append(subprocess.Popen(cmd))
    rc = 0
    for p in procs:
        rc |= p.wait()
    merge_outputs(args)
    return rc


if __name__ == "__main__":
    sys.exit(main())
