"""The slice as a whole: the port's command line against the JAX package's.

- A KITTI-format stereo sequence on disk (120x200, 8 frames, the way
  tools/verify_e2e.py writes one), refined by `photobundle_tpu.cli.run`
  and the port's `cli.run(device="cpu")` in configs/kitti_production.cfg
  (BM stereo, speckle filter, a 3-level coarse-to-fine schedule, motion
  and pose priors) cut to a small size by key=value overrides, with
  dataLoader=python on both sides. Both must lower the ATE of the drifted
  VO input, to within 2 % of that input's ATE of each other; per frame
  the depth maps agree to the stereo tolerance of
  tests/test_torch_stereo.py; the two refined trajectories agree within a
  quarter of the VO input's ATE. That bound is loose on purpose: f32
  differences between the packages (1e-6 in the first window's initial
  cost here) change where the 1e-6 function tolerance stops a solve (19
  and 18 iterations), and every window warm-starts the next.
- tests/test_engine.py's CLI cases on the port: the keyframe gate, resume
  from the checkpoint (with and without the gate), and, the port's own,
  resume from an engine snapshot, which writes the uninterrupted run's
  trajectory file byte for byte.
- `main`: JSONL records, point clouds, a torch.profiler trace, and a card
  that is not there.
"""

import json
import os

import numpy as np
import pytest
import torch

from photobundle_tpu import cli as jcli
from photobundle_tpu.io import kitti as jkitti
from photobundle_torch import cli, entry
from photobundle_torch.io import kitti
from photobundle_torch.io import trajectory as traj

from synthetic import make_sequence, perturb_poses
from test_engine import small_cfg
from test_torch_io import assert_frames_match
from torch_parity import few_threads, port_camera, port_config  # noqa: F401

PRODUCTION = os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                          "kitti_production.cfg")
N_FRAMES = 8
PARITY_SHARE = 0.25     # ATE(port, JAX) <= this x ATE(VO input, truth)
ACCURACY_SHARE = 0.02   # |ATE(port) - ATE(JAX)| <= this x ATE(VO input)


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """The scene on disk, its ground truth and a drifted VO input (5 mm and
    0.5 mrad per frame, seed 1, as chip_smoke.py drifts it)."""
    root = str(tmp_path_factory.mktemp("kitti"))
    _, poses = entry.write_kitti_sequence(
        root, np.random.default_rng(3), n_frames=N_FRAMES, shape=(120, 200),
        fx=120.0, baseline=0.2, motion_scale=0.05)
    vo = entry.drift_poses(np.random.default_rng(1), poses, 0.005, 0.0005, 1)
    entry.write_poses(os.path.join(root, "vo.txt"), vo)
    return root, poses, vo


SMALL = dict(numFrames=N_FRAMES, maxNumPoints=512, maxPointsPerFrame=128,
             numDisparities=48, maxIterations=12, coarseIterations=6,
             minDepth=0.5, maxDepth=50, dataLoader="python")


def argv(root, out, *flags, **overrides):
    """The command line: the production configuration, cut to size by
    key=value overrides."""
    kv = dict(SMALL, dataDir=root, **overrides)
    return ["--config", PRODUCTION, "--poses", os.path.join(root, "vo.txt"),
            "--output", out, *flags, *(f"{k}={v}" for k, v in kv.items())]


@pytest.fixture(scope="module")
def runs(sequence, tmp_path_factory):
    """Both packages' CLI runs on the sequence: (config, dataset, refined
    trajectory, JSONL records) per package."""
    root = sequence[0]
    out_dir = tmp_path_factory.mktemp("out")
    init = traj.load_poses_kitti(os.path.join(root, "vo.txt"))
    res = {}
    for name, mod, data, kw in (("jax", jcli, jkitti, {}),
                                ("torch", cli, kitti, dict(device="cpu"))):
        out = str(out_dir / f"{name}.txt")
        cfg = mod.load_config(mod.build_argparser().parse_args(argv(root,
                                                                    out)))
        ds = data.create_dataset(cfg, **kw)
        log = str(out_dir / f"{name}.jsonl")
        refined = mod.run(cfg, ds, init, output=out, jsonl_path=log,
                          progress=False, **kw)
        with open(log) as f:
            records = [json.loads(line) for line in f]
        res[name] = (cfg, ds, refined, records)
    return res


def test_cli_matches_jax_on_a_kitti_sequence(sequence, runs):
    _, poses, vo = sequence
    gt = traj.Trajectory(poses.astype(np.float64))
    ate_init = traj.ate_rmse(traj.Trajectory(vo.astype(np.float64)), gt)
    cfg, _, refined, records = runs["torch"]
    assert cfg.coarseToFine and cfg.pyramidLevels == 3
    assert cfg.stereoAlgorithm == "BM" and cfg.speckleWindowSize == 120
    assert cfg.motionPriorWeight == 2 and cfg.posePriorWeight == 4
    ates = {}
    for name, (_, _, ref, recs) in runs.items():
        assert len(ref) == N_FRAMES
        assert len(recs) == N_FRAMES - 4
        assert [r["frame"] for r in recs] == list(range(4, N_FRAMES))
        for r in recs:
            assert r["final_cost"] <= r["initial_cost"], (name, r)
        ates[name] = traj.ate_rmse(ref, gt)
        assert ates[name] < ate_init, (name, ate_init, ates[name])
    assert abs(ates["torch"] - ates["jax"]) <= ACCURACY_SHARE * ate_init, (
        ates, ate_init)
    between = traj.ate_rmse(refined, runs["jax"][2], align=False)
    assert between <= PARITY_SHARE * ate_init, (between, ates, ate_init)
    assert [r["frame_ids"] for r in records] == [r["frame_ids"] for r
                                                 in runs["jax"][3]]


def test_cli_depths_match_jax(runs):
    """Each frame's stereo depth, as both datasets produce it."""
    ds, jds = runs["torch"][1], runs["jax"][1]
    for i in range(0, N_FRAMES, 3):
        assert_frames_match(ds.get_frame(i), jds.get_frame(i))


@pytest.fixture(scope="module")
def scene():
    return make_sequence(np.random.default_rng(3), n_frames=10,
                         shape=(96, 144))


def gated(scene):
    """tests/test_engine.py's stationary segment: frames 4..6 repeat 3."""
    cam, images, depths, poses_gt = scene
    imgs = list(images[:4]) + [images[3]] * 3 + list(images[4:])
    dpts = list(depths[:4]) + [depths[3]] * 3 + list(depths[4:])
    gt = np.concatenate([poses_gt[:4], np.repeat(poses_gt[3:4], 3, axis=0),
                         poses_gt[4:]], axis=0)
    init = perturb_poses(np.random.default_rng(5), gt, trans_sigma=0.03,
                         rot_sigma=0.003, keep_first=2)
    init[4:7] = init[3]
    ds = kitti.PrecomputedDepthDataset(images=imgs, depths=dpts,
                                       camera=port_camera(cam))
    return ds, gt, traj.Trajectory(init.astype(np.float64))


def test_min_keyframe_motion(scene, tmp_path):
    ds, gt, init_traj = gated(scene)
    cfg = port_config(small_cfg(minKeyframeMotion=0.02, maxIterations=8))
    refined = cli.run(cfg, ds, init_traj, output=str(tmp_path / "r.txt"),
                      progress=False, device="cpu")
    assert len(refined) == len(ds)
    for i in (4, 5, 6):
        np.testing.assert_allclose(refined.poses[i], refined.poses[3],
                                   atol=1e-12)
    gt_traj = traj.Trajectory(gt.astype(np.float64))
    assert (traj.ate_rmse(refined, gt_traj, align=False)
            < traj.ate_rmse(init_traj, gt_traj, align=False))


def crash_after(n):
    calls = {"n": 0}

    def on_window():
        calls["n"] += 1
        if calls["n"] >= n:
            raise RuntimeError("simulated crash")
    return on_window


def test_cli_resume_preserves_refined_prefix(scene, tmp_path):
    cam, images, depths, poses_gt = scene
    init = perturb_poses(np.random.default_rng(11), poses_gt,
                         trans_sigma=0.03, rot_sigma=0.003, keep_first=2)
    init_traj = traj.Trajectory(init.astype(np.float64))
    ds = kitti.PrecomputedDepthDataset(images=list(images),
                                       depths=list(depths),
                                       camera=port_camera(cam))
    cfg = port_config(small_cfg(maxIterations=8))
    out = str(tmp_path / "refined.txt")
    with pytest.raises(RuntimeError, match="simulated crash"):
        cli.run(cfg, ds, init_traj, output=out, progress=False,
                on_window=crash_after(4), device="cpu")
    assert os.path.exists(out + ".ckpt")
    crash = traj.load_poses_kitti(out)
    assert not np.allclose(crash.poses[2], init_traj.poses[2])
    resumed = cli.run(cfg, ds, init_traj, output=out, progress=False,
                      resume=True, device="cpu")
    assert not os.path.exists(out + ".ckpt")
    # done = 7 (4th window), W = 5: re-ingest starts at frame 4.
    np.testing.assert_allclose(resumed.poses[:4], crash.poses[:4],
                               atol=1e-12)
    assert not np.allclose(resumed.poses[3], init_traj.poses[3])


def test_cli_resume_with_keyframe_gate(scene, tmp_path):
    ds, _, init_traj = gated(scene)
    cfg = port_config(small_cfg(minKeyframeMotion=0.02, maxIterations=8))
    out = str(tmp_path / "refined.txt")
    with pytest.raises(RuntimeError, match="simulated crash"):
        cli.run(cfg, ds, init_traj, output=out, progress=False,
                on_window=crash_after(5), device="cpu")
    resumed = cli.run(cfg, ds, init_traj, output=out, progress=False,
                      resume=True, device="cpu")
    assert len(resumed) == len(ds)
    for i in (4, 5, 6):
        np.testing.assert_allclose(resumed.poses[i], resumed.poses[3],
                                   atol=1e-12)


def test_cli_snapshot_resume_is_bitwise(scene, tmp_path):
    """--snapshot-every: a run that crashed resumes from the engine snapshot
    and writes exactly the uninterrupted run's trajectory."""
    cam, images, depths, poses_gt = scene
    init = perturb_poses(np.random.default_rng(11), poses_gt,
                         trans_sigma=0.03, rot_sigma=0.003, keep_first=2)
    init_traj = traj.Trajectory(init.astype(np.float64))
    ds = kitti.PrecomputedDepthDataset(images=list(images),
                                       depths=list(depths),
                                       camera=port_camera(cam))
    cfg = port_config(small_cfg(maxIterations=4))
    whole = cli.run(cfg, ds, init_traj, output=str(tmp_path / "whole.txt"),
                    progress=False, snapshot_every=1, device="cpu")
    out = str(tmp_path / "refined.txt")
    with pytest.raises(RuntimeError, match="simulated crash"):
        cli.run(cfg, ds, init_traj, output=out, progress=False,
                on_window=crash_after(3), snapshot_every=1, device="cpu")
    assert os.path.exists(out + ".state.npz")
    resumed = cli.run(cfg, ds, init_traj, output=out, progress=False,
                      resume=True, snapshot_every=1, device="cpu")
    # The resumed prefix comes back from the crashed run's text output
    # (%.9e), so the files are compared, and the arrays to that rounding.
    assert open(out).read() == open(str(tmp_path / "whole.txt")).read()
    np.testing.assert_allclose(resumed.poses, whole.poses, rtol=1e-9)


def test_main_writes_records_points_and_a_trace(sequence, tmp_path):
    """`python -m photobundle_torch.cli` as a user calls it, on the CPU:
    key=value overrides, the JSONL log, per-window point clouds and a
    torch.profiler trace."""
    root = sequence[0]
    out = str(tmp_path / "refined.txt")
    rc = cli.main(argv(root, out, "--device", "cpu", "--log",
                       str(tmp_path / "s.jsonl"), "--points-dir",
                       str(tmp_path / "pts"), "--profile-dir",
                       str(tmp_path / "trace"), numFrames=6,
                       maxNumPoints=256, maxPointsPerFrame=64,
                       numDisparities=32, maxIterations=4,
                       coarseToFine="false", pyramidLevels=1,
                       speckleWindowSize=0))
    assert rc == 0
    assert len(traj.load_poses_kitti(out)) == N_FRAMES
    with open(tmp_path / "s.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["frame"] for r in recs] == [4, 5]
    assert sorted(os.listdir(tmp_path / "pts")) == ["window_000004.npz",
                                                    "window_000005.npz"]
    assert any(name.endswith(".json") for name in
               os.listdir(tmp_path / "trace"))


def test_main_without_a_card_raises(sequence, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv(sequence[0], str(tmp_path / "r.txt")))
