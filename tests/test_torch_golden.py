"""The KITTI-scale golden: the port's box room (photobundle_torch/tools/
synthetic.py) and its tools (golden_kitti, golden_aggregate, diagnose_rpe,
diagnose_w5) against the JAX side's (tests/synthetic.py, tools/).

- The numpy renderer equals tests/synthetic.render_box exactly; the
  float32 torch renderer, here on the CPU, meets tests/test_tools.py's
  bounds against it (image < 1/255, depth relative < 1e-4 on > 90 % of
  pixels, validity masks disagreeing on < 1 %).
- `write_box_kitti_dataset` at 48x96 (6 frames, fx = 60) from one seed
  writes the same decoded pixels and identical calib.txt, times.txt and
  poses/00.txt as the JAX side's writer.
- `golden_kitti` on that dataset (its `.rendered_6` marker and
  provenance written first, so neither package re-renders), iid error
  model, W5_production and reference_exact, in both packages: every
  window's cost is non-increasing, and both printed tables parse in both
  golden_aggregate copies, which print the same. W5_production's refined
  ATEs agree within tests/test_torch_cli.py's ACCURACY_SHARE (2 %) of the
  input's ATE. reference_exact (K2's bicubic sampling, one fixed pose, no
  prior) leaves the scale of a window free: from one pre-solve state the
  two packages end at costs within 1 % and poses up to 5.5 cm apart (here,
  at 48x96), and the chains part from there. Its parity is held window
  by window instead: from each pre-solve state of the JAX engine's run
  (observations within 1e-4 px of a sampling margin cleared, as
  tests/test_torch_engine.py does) the port's solve counts the same
  observations per frame and residuals, starts at its cost within 1e-5
  and ends no more than REFERENCE_COST_RTOL (2 %) above its final cost.
- golden_aggregate prints what tools/golden_aggregate.py prints on
  tests/test_tools.py's logs, the collision warning included;
  diagnose_rpe runs on the golden's output; diagnose_w5's exact-depth
  dataset holds the rendered depth.
"""

import glob
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import synthetic as jsyn
import jax.numpy as jnp
import photobundle_tpu.cli as jcli
from photobundle_tpu.geometry.camera import Camera as JCamera
from photobundle_torch import convert
from photobundle_torch.core.engine import PhotometricBundleAdjustment as TPBA
from photobundle_torch.geometry.camera import Camera
from photobundle_torch.io import png
from photobundle_torch.io import trajectory as traj
from photobundle_torch.tools import (diagnose_rpe, diagnose_w5,
                                     golden_aggregate, golden_kitti,
                                     synthetic)

from test_torch_cli import ACCURACY_SHARE
from test_torch_engine import without_observations_at_margins
from torch_parity import EngineTrace, few_threads  # noqa: F401
from torch_parity import port_camera, port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE, FX, FRAMES = (48, 96), 60.0, 6
CONFIG = "W5_production"
CONFIGS = ("W5_production", "reference_exact")
# reference_exact's window solves from one state: the port's final cost
# may exceed the JAX engine's by this share. The solves end in a flat
# valley at the function tolerance, a few iterations apart: from the JAX
# engine's states of the 24-frame golden at 93x307 and 185x613 the port
# ended between 2.3 % below and 0.68 % above it.
REFERENCE_COST_RTOL = 2e-2


def test_numpy_renderer_equals_the_jax_sides():
    rng = np.random.default_rng(3)
    tex = synthetic.make_texture(rng, n_waves=32, min_wavelength=0.2,
                                 max_wavelength=3.0)
    obstacles = synthetic.default_obstacles()[:5]
    assert all(np.array_equal(a, b) for pa, pb in zip(
        obstacles, jsyn.default_obstacles()[:5]) for a, b in zip(pa, pb))
    pose = np.eye(4, dtype=np.float32)
    pose[0, 3], pose[2, 3] = -28.0, -28.0
    img, depth = synthetic.render_box(
        tex, Camera.create(90.0, 90.0, 29.5, 19.5, 0.5), pose, (40, 60),
        obstacles=obstacles)
    img_j, depth_j = jsyn.render_box(
        tex, JCamera.create(fx=90.0, fy=90.0, cx=29.5, cy=19.5,
                            baseline=0.5), pose, (40, 60),
        obstacles=obstacles)
    assert np.array_equal(img, img_j) and np.array_equal(depth, depth_j)
    assert np.array_equal(synthetic.kitti_like_trajectory(9),
                          jsyn.kitti_like_trajectory(9))
    assert np.array_equal(synthetic.lateral_trajectory(4),
                          jsyn.lateral_trajectory(4))


@pytest.mark.parametrize("obstacles", [5, 0])
def test_torch_renderer_matches_numpy(obstacles):
    """tests/test_tools.py's renderer bounds, on the CPU."""
    rng = np.random.default_rng(3)
    tex = synthetic.make_texture(rng, n_waves=32, min_wavelength=0.2,
                                 max_wavelength=3.0)
    cam = Camera.create(90.0, 90.0, 29.5, 19.5, 0.5)
    boxes = synthetic.default_obstacles()[:obstacles] or None
    pose = np.eye(4, dtype=np.float32)
    pose[0, 3], pose[2, 3] = -28.0, -28.0
    img_np, depth_np = synthetic.render_box(tex, cam, pose, (40, 60),
                                            obstacles=boxes)
    render = synthetic.make_render_box_torch((40, 60), obstacles=boxes,
                                             device="cpu")
    img_t, depth_t = render(tex, cam, pose)
    assert img_t.dtype == np.float32 and depth_t.dtype == np.float32
    assert np.max(np.abs(img_t - img_np)) < 1.0 / 255.0
    valid = (depth_np > 0) & (depth_t > 0)
    assert valid.mean() > 0.9
    assert np.max(np.abs(depth_t - depth_np)[valid] / depth_np[valid]) < 1e-4
    assert np.mean((depth_np > 0) != (depth_t > 0)) < 0.01
    # The device-side box average and quantization ('torch2').
    quant = synthetic.make_render_box_torch((40, 60), obstacles=boxes,
                                            downsample=2, quantize=True,
                                            device="cpu")
    u8, none = quant(tex, cam, pose)
    host = np.clip(img_t.reshape(20, 2, 30, 2).mean(axis=(1, 3)) * 255, 0,
                   255).astype(np.uint8)
    assert none is None and u8.dtype == np.uint8 and u8.shape == (20, 30)
    assert np.max(np.abs(u8.astype(int) - host.astype(int))) <= 1


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The tiny golden written by each package's writer, each with its
    render marker and provenance (so golden_kitti does not re-render)."""
    out = {}
    for name, write in (("torch", synthetic.write_box_kitti_dataset),
                        ("jax", jsyn.write_box_kitti_dataset)):
        root = str(tmp_path_factory.mktemp(f"box_{name}"))
        kw = dict(device="cpu") if name == "torch" else {}
        write(root, 0, np.random.default_rng(12), n_frames=FRAMES,
              shape=SHAPE, fx=FX, **kw)
        with open(os.path.join(root, f".rendered_{FRAMES}"), "w") as f:
            f.write("ok")
        golden_kitti.record_provenance(root, dict(
            renderer="numpy", supersample=1, min_wavelength=0.25,
            frames=FRAMES, texture_seed=12))
        out[name] = root
    return out


def test_box_dataset_matches_the_jax_writer(datasets):
    t, j = datasets["torch"], datasets["jax"]
    pngs = sorted(glob.glob(os.path.join(t, "sequences", "00", "image_*",
                                         "*.png")))
    assert len(pngs) == 2 * FRAMES
    for p in pngs:
        other = p.replace(t, j)
        assert np.array_equal(png.read_png_gray(p), png.read_png_gray(other))
    for name in ("sequences/00/calib.txt", "sequences/00/times.txt",
                 "poses/00.txt"):
        with open(os.path.join(t, name)) as a, open(os.path.join(j, name)) as b:
            assert a.read() == b.read(), name
    assert golden_kitti.dataset_content_hash(t).endswith(f"/{2 * FRAMES}png")


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def goldens(datasets, tmp_path_factory):
    """Both packages' golden_kitti on the port's dataset in CONFIGS:
    {package: (printed output, out_dir)}, and "engines": the JAX run's
    engines with their EngineTraces, {config: (engine, trace)}."""
    root = datasets["torch"]
    res, engines = {}, []

    def traced_engine(*args, **kwargs):
        pba = jcli_engine(*args, **kwargs)
        engines.append((pba, EngineTrace(pba)))
        return pba

    jcli_engine = jcli.PhotometricBundleAdjustment
    for name in ("jax", "torch"):
        out_dir = str(tmp_path_factory.mktemp(f"golden_{name}"))
        argv = ["--root", root, "--frames", str(FRAMES), "--error-model",
                "iid", "--configs", ",".join(CONFIGS), "--out-dir", out_dir]
        log = os.path.join(out_dir, "golden.log")
        with open(log, "w") as f:
            saved = sys.stdout, sys.argv
            sys.stdout = f
            try:
                if name == "jax":
                    sys.argv = ["golden_kitti.py", *argv]
                    jcli.PhotometricBundleAdjustment = traced_engine
                    assert _jax_tool("golden_kitti").main() == 0
                else:
                    golden_kitti.main([*argv, "--device", "cpu"])
            finally:
                sys.stdout, sys.argv = saved
                jcli.PhotometricBundleAdjustment = jcli_engine
        with open(log) as f:
            res[name] = (f.read(), out_dir)
    assert len(engines) == len(CONFIGS)
    res["engines"] = dict(zip(CONFIGS, engines))
    return res


def outputs(goldens):
    return [(name, goldens[name]) for name in ("jax", "torch")]


@pytest.mark.parametrize("config", CONFIGS)
def test_golden_kitti_matches_jax(datasets, goldens, config):
    gt = traj.load_poses_kitti(os.path.join(datasets["torch"], "poses",
                                            "00.txt"))
    ates = {}
    for name, (text, out_dir) in outputs(goldens):
        init = traj.load_poses_kitti(os.path.join(out_dir, "vo_init.txt"))
        ate_init = traj.ate_rmse(init, gt, align=False)
        refined = traj.load_poses_kitti(os.path.join(out_dir,
                                                     f"refined_{config}.txt"))
        ates[name] = traj.ate_rmse(refined, gt, align=False)
        with open(os.path.join(out_dir, f"refined_{config}.txt.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        assert [r["frame_ids"][0] for r in recs] == list(range(FRAMES - 4))
        for r in recs:
            assert r["final_cost"] <= r["initial_cost"], (name, r)
        assert f"| {config} | {ates[name]:.4f} |" in text
        assert "BASELINE.md table (iid error model, seed 99, 6 frames" in text
    if config == "W5_production":
        assert abs(ates["torch"] - ates["jax"]) <= ACCURACY_SHARE * ate_init, (
            ates, ate_init)
        return
    # reference_exact: window by window from the JAX engine's states.
    jpba, trace = goldens["engines"][config]
    assert jpba.cfg.interpolation == "bicubic" and jpba.cfg.numFixedPoses == 1
    solves = list(trace.solves)     # the run's (the re-solves add more)
    assert len(solves) == FRAMES - 4
    tpba = TPBA(port_camera(jpba.camera_full), jpba.image_shape,
                port_config(jpba.cfg), device="cpu")
    for rec in solves:
        points_np, window_np = without_observations_at_margins(
            tpba, *rec["before"])
        _, _, want, _ = jpba._optimize(
            type(window_np)(*map(jnp.asarray, window_np)),
            type(points_np)(*map(jnp.asarray, points_np)))
        points, win = convert.engine_state_from_numpy(points_np, window_np)
        _, _, got, _ = tpba._optimize(win, points)
        np.testing.assert_array_equal(got.obs_per_frame.numpy(),
                                      np.asarray(want.obs_per_frame))
        assert int(got.n_residuals) == int(want.n_residuals)
        np.testing.assert_allclose(float(got.initial_cost),
                                   float(want.initial_cost), rtol=1e-5)
        assert float(got.final_cost) <= (1 + REFERENCE_COST_RTOL) * float(
            want.final_cost), (float(got.final_cost), float(want.final_cost))
        assert float(got.final_cost) < float(got.initial_cost)


def test_both_aggregates_parse_both_tables(goldens, tmp_path, capsys):
    for name, (text, _) in outputs(goldens):
        (tmp_path / f"{name}.log").write_text(text)
    logs = str(tmp_path / "*.log")
    assert golden_aggregate.main(["--logs", logs]) == 0
    port = capsys.readouterr()
    ref = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                       "golden_aggregate.py"),
                          "--logs", logs], capture_output=True, text=True)
    assert ref.returncode == 0, ref.stderr
    assert port.out == ref.stdout and port.err == ref.stderr
    assert f"| {CONFIG} | " in port.out
    # One provenance and seed: the packages' rows fall in one cell, and
    # their reductions (to 0.1 %) collide or agree.
    red = {(n, c): float(t.split(f"| {c} | ")[1].split(" | ")[1][:-1])
           for n, (t, _) in outputs(goldens) for c in CONFIGS}
    assert ("colliding rows" in port.err) == any(
        red["jax", c] != red["torch", c] for c in CONFIGS)


def test_golden_aggregate_prints_what_the_jax_script_prints(tmp_path,
                                                            capsys):
    """tests/test_tools.py's logs, and its collision."""
    head = ("BASELINE.md table (iid error model, seed {s}, init ATE {a}, "
            "init RPE(1) 0.0442 m,\nprovenance jax/2/0.1/deadbeef/200png):\n"
            "| Config | refined ATE | reduction | RPE(1) trans | RPE(1) rot |\n"
            "|---|---|---|---|---|\n")
    (tmp_path / "a.log").write_text(
        head.format(s=7, a="0.0325")
        + "| W5_production | 0.0234 | +28.0% | 0.0215 | 0.192 deg |\n"
        "| W5_production_tukey | 0.0212 | +34.8% | 0.0205 | 0.106 deg |\n")
    (tmp_path / "b.log").write_text(
        head.format(s=9, a="0.0346")
        + "| W5_production | 0.0244 | +29.5% | 0.0208 | 0.331 deg |\n"
        "| W5_production_tukey | 0.0226 | +34.6% | 0.0200 | 0.132 deg |\n")
    logs = str(tmp_path / "*.log")

    def both():
        assert golden_aggregate.main(["--logs", logs]) == 0
        port = capsys.readouterr()
        ref = subprocess.run(
            [sys.executable, os.path.join(REPO, "tools",
                                          "golden_aggregate.py"),
             "--logs", logs], capture_output=True, text=True)
        assert ref.returncode == 0, ref.stderr
        assert port.out == ref.stdout and port.err == ref.stderr
        return port

    port = both()
    assert "2W/0L" in port.out and "+34.7%" in port.out
    assert "WARNING" not in port.err
    (tmp_path / "c.log").write_text(
        head.format(s=7, a="0.0325")
        + "| W5_production | 0.0300 | +8.0% | 0.0215 | 0.192 deg |\n")
    assert "colliding rows" in both().err
    assert golden_aggregate.main(["--logs", str(tmp_path / "none*")]) == 1


def test_diagnose_rpe_on_the_golden(datasets, goldens, capsys):
    _, out_dir = goldens["torch"]
    run = os.path.join(out_dir, f"refined_{CONFIG}.txt")
    assert diagnose_rpe.main([
        "--run", run, "--gt", os.path.join(datasets["torch"], "poses",
                                           "00.txt"),
        "--init", os.path.join(out_dir, "vo_init.txt")]) == 0
    out = capsys.readouterr().out
    assert f"pairs: {FRAMES - 1}; RPE(1) init" in out
    assert "worst 12 refined pairs:" in out
    assert "share of refined RPE^2 by window support:" in out
    assert "median applied max-correction:" in out


def test_diagnose_w5_exact_depth(datasets):
    """gt_depth_dataset: the golden's images with the rendered depth."""
    root = datasets["torch"]
    cfg = golden_kitti.PBAConfig(dataDir=root, numFrames=FRAMES)
    ds = diagnose_w5.gt_depth_dataset(root, cfg, 2, device="cpu")
    assert len(ds) == 2 and ds.image_shape == SHAPE
    tex = synthetic.make_texture(np.random.default_rng(12), n_waves=96,
                                 min_wavelength=0.25, max_wavelength=4.0)
    pose = traj.load_poses_kitti(os.path.join(root, "poses", "00.txt"))
    frame = ds.get_frame(1)
    _, depth = synthetic.render_box(
        tex, ds.camera, pose.poses[1].astype(np.float32), SHAPE,
        max_depth=cfg.maxDepth)
    assert np.array_equal(frame.depth, depth)
    left = os.path.join(root, "sequences", "00", "image_0", "000001.png")
    assert np.array_equal(frame.image, png.read_png_gray(left).astype(
        np.float32) * np.float32(1.0 / 255.0))
    assert torch.is_tensor(ds.camera.fx)
