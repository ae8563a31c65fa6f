"""Witness of the golden's reference_exact row, on the CPU: both packages'
`golden_kitti` on one render of the box room at a reduced size, then the
port's window solves from each pre-solve state the JAX engine recorded.

    JAX_PLATFORMS=cpu python tests/golden_witness.py --shape 185 613 \
        --fx 353.5 --frames 24 --out build/golden_witness

The render goes to <out>/data (kept: a second run reuses it). Prints each
package's refined ATE and, per window, the pose corrections and the
observations per frame; then, from the JAX engine's states, per ingest
whether the port's point table is exact, and per solve both packages'
iterations and initial / final costs, whether the observations per frame
agree, and the largest pose gap. Not a test: the reference_exact chain
parts between the packages wherever a window's scale is free.
"""

import argparse
import importlib.util
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [REPO, HERE]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

import synthetic as jsyn  # noqa: E402,F401  (tools/golden_kitti imports it)
from photobundle_tpu.config import PBAConfig as JConfig  # noqa: E402
from photobundle_tpu.core.engine import PhotometricBundleAdjustment as JPBA  # noqa: E402
from photobundle_tpu.io import kitti as jkitti  # noqa: E402
from photobundle_torch import convert  # noqa: E402
from photobundle_torch.core.engine import PhotometricBundleAdjustment as TPBA  # noqa: E402
from photobundle_torch.io import trajectory as traj  # noqa: E402
from photobundle_torch.tools import golden_kitti, synthetic  # noqa: E402
from test_torch_ingest import port_ingest  # noqa: E402
from torch_parity import EngineTrace, port_camera, port_config  # noqa: E402

CONFIG = "reference_exact"


def jax_golden_kitti():
    spec = importlib.util.spec_from_file_location(
        "jax_golden_kitti", os.path.join(REPO, "tools", "golden_kitti.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def render(root: str, shape, fx: float, frames: int) -> None:
    marker = os.path.join(root, f".rendered_{frames}")
    if os.path.exists(marker):
        return
    synthetic.write_box_kitti_dataset(root, 0, np.random.default_rng(12),
                                      n_frames=frames, shape=shape, fx=fx,
                                      device="cpu")
    with open(marker, "w") as f:
        f.write("ok")
    golden_kitti.record_provenance(root, dict(
        renderer="numpy", supersample=1, min_wavelength=0.25, frames=frames,
        texture_seed=12))


def chains(root: str, out: str, frames: int) -> None:
    gt = traj.load_poses_kitti(os.path.join(root, "poses", "00.txt"))
    for name in ("jax", "torch"):
        out_dir = os.path.join(out, name)
        argv = ["--root", root, "--frames", str(frames), "--error-model",
                "iid", "--configs", CONFIG, "--out-dir", out_dir]
        if name == "jax":
            sys.argv = ["golden_kitti.py", *argv]
            jax_golden_kitti().main()
        else:
            golden_kitti.main([*argv, "--device", "cpu"])
        run = os.path.join(out_dir, f"refined_{CONFIG}.txt")
        ate = traj.ate_rmse(traj.load_poses_kitti(run), gt, align=False)
        print(f"== {name}: refined ATE {ate:.4f} m")
        with open(run + ".jsonl") as f:
            for line in f:
                r = json.loads(line)
                print(f"   window {r['frame_ids'][0]}: costs "
                      f"{r['initial_cost']:.6f} -> {r['final_cost']:.6f}, "
                      f"moved {np.round(r['trans_correction'], 4).tolist()}"
                      f" m, observations {r['obs_per_frame']}")


def windows(root: str, out: str, frames: int) -> None:
    cfg = JConfig(dataDir=root, sequence=0, numFrames=frames,
                  stereoAlgorithm="BM", numDisparities=128, minDisparity=1,
                  speckleWindowSize=120,
                  depthCacheDir=os.path.join(root, "depth_cache"),
                  **golden_kitti.CONFIGS[CONFIG])
    ds = jkitti.create_dataset(cfg)
    init = traj.load_poses_kitti(os.path.join(out, "jax", "vo_init.txt"))
    jpba = JPBA(ds.camera, ds.image_shape, cfg)
    trace = EngineTrace(jpba)
    for i in range(frames):
        f = ds.get_frame(i)
        jpba.add_frame(f.image, f.depth, init.poses[i],
                       depth_valid=f.depth_valid, frame_id=i)
    tpba = TPBA(port_camera(ds.camera), ds.image_shape, port_config(cfg),
                device="cpu")
    exact = 0
    for rec in trace.ingests:
        (jp, _), (tp, _) = rec["after"], port_ingest(tpba, rec)
        exact += all(np.array_equal(getattr(tp, n), getattr(jp, n))
                     for n in ("active", "obs", "ref_frame"))
    print(f"== ingests from the JAX engine's states: {exact} of "
          f"{len(trace.ingests)} point tables exact")
    for k, rec in enumerate(list(trace.solves)):
        points, win = convert.engine_state_from_numpy(*rec["before"])
        tw, _, got, _ = tpba._optimize(win, points)
        want, jw = rec["stats"], rec["after"][1]
        gap = np.abs(tw.t_wc.numpy() - jw.t_wc)[:, :3, 3].max()
        same = np.array_equal(got.obs_per_frame.numpy(), want.obs_per_frame)
        print(f"   solve {k}: iterations {int(want.iterations)} / "
              f"{int(got.iterations)}, costs {float(want.initial_cost):.6f}"
              f" / {float(got.initial_cost):.6f} -> "
              f"{float(want.final_cost):.6f} / {float(got.final_cost):.6f}"
              f" (JAX / port), observations equal {same}, poses apart "
              f"{gap:.4g} m")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs=2, default=(185, 613))
    ap.add_argument("--fx", type=float, default=None,
                    help="default: 707 scaled by the width")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "golden_witness"))
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    shape = tuple(args.shape)
    fx = args.fx if args.fx is not None else 707.0 * shape[1] / 1226
    root = os.path.join(args.out, "data")
    render(root, shape, fx, args.frames)
    chains(root, args.out, args.frames)
    windows(root, args.out, args.frames)


if __name__ == "__main__":
    main()
