"""The shipped configurations through both packages' command lines.

Each of configs/kitti_stereo.cfg, kitti_large_window.cfg,
kitti_sgbm_bicubic.cfg and kitti_minimum_slice.cfg refines the same
KITTI-format sequence on disk (120x200, the scene and the drifted VO input
of tests/test_torch_cli.py) through `photobundle_tpu.cli.run` and the
port's `cli.run(device="cpu")`. Each file is cut to size only by the
overrides of `test_torch_cli.SMALL` and by the frame count: W + 1 frames,
two window solves. No other key of a configuration changes.

- The command lines, by test_torch_cli.py's criteria: both runs lower the
  VO input's ATE (where the JAX run itself does not, only the next bound
  is held), their ATEs agree within ACCURACY_SHARE of the input's, and the
  two refined trajectories lie within PARITY_SHARE of the input's ATE of
  each other.
- Each frame's stereo depth, as the two datasets produced it during the
  runs (BM or SGBM, the configuration's), to tests/test_torch_stereo.py's
  tolerance: validity differs on at most 0.5 % of the pixels, and where
  both accept, the disparities (fx * baseline / depth) agree within
  5e-3 px.
- The JAX run's engine is traced (torch_parity.EngineTrace): every port
  ingest from the JAX engine's recorded state gives its point flags
  exactly, and the port's first window solve from the JAX pre-solve state
  is held to tests/test_torch_engine.py's bounds.

Why two windows: a window warm-starts the next, and these solves are
ill-conditioned enough that f32 differences between the packages part the
chain from its third window on. Replaying the JAX engine's states in the
port over 8 frames (12 for the wide window) shows no port fault there:
every ingest's point flags are exact, and every solve from the JAX state
starts within 2e-6 of its cost (the observations equal but for bicubic
ones at a margin, which the first-window test clears), yet
kitti_minimum_slice's third window, kitti_large_window's third and
kitti_sgbm_bicubic's fourth end ~0.5 % apart in cost after a different
accept log, and the chained ATEs then differ by more than
ACCURACY_SHARE.
"""

import contextlib
import json
import os

import numpy as np
import pytest

from photobundle_tpu import cli as jcli
from photobundle_tpu.io import kitti as jkitti
from photobundle_torch import cli, convert, entry
from photobundle_torch.core.engine import PhotometricBundleAdjustment as TPBA
from photobundle_torch.io import kitti
from photobundle_torch.io import trajectory as traj

from test_torch_cli import ACCURACY_SHARE, PARITY_SHARE, SMALL
from test_torch_engine import without_observations_at_margins
from test_torch_ingest import EXACT_POINTS, port_ingest
from test_torch_stereo import DISP_ATOL, VALIDITY_SHARE
from torch_parity import EngineTrace, port_camera
from torch_parity import few_threads  # noqa: F401

CONFIG_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "configs")
CONFIGS = ("kitti_stereo", "kitti_large_window", "kitti_sgbm_bicubic",
           "kitti_minimum_slice")
SEQUENCE_FRAMES = 11          # W + 1 for the widest window (10)


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """tests/test_torch_cli.py's scene on disk, with its drifted VO input
    (5 mm and 0.5 mrad per frame, seed 1)."""
    root = str(tmp_path_factory.mktemp("kitti"))
    _, poses = entry.write_kitti_sequence(
        root, np.random.default_rng(3), n_frames=SEQUENCE_FRAMES,
        shape=(120, 200), fx=120.0, baseline=0.2, motion_scale=0.05)
    vo = entry.drift_poses(np.random.default_rng(1), poses, 0.005, 0.0005, 1)
    entry.write_poses(os.path.join(root, "vo.txt"), vo)
    return root, poses, vo


class Recorded:
    """A dataset whose frames are kept as the run reads them."""

    def __init__(self, ds):
        self.ds, self.frames = ds, {}

    def __len__(self):
        return len(self.ds)

    def __getattr__(self, name):
        return getattr(self.ds, name)

    def get_frame(self, i):
        self.frames[i] = frame = self.ds.get_frame(i)
        return frame


@contextlib.contextmanager
def traced_jax_engine(traces):
    """While open, every engine the JAX command line builds is traced
    (EngineTrace), its trace and the engine appended to `traces`."""
    engine = jcli.PhotometricBundleAdjustment

    def build(*args, **kwargs):
        pba = engine(*args, **kwargs)
        traces.append((EngineTrace(pba), pba))
        return pba

    jcli.PhotometricBundleAdjustment = build
    try:
        yield
    finally:
        jcli.PhotometricBundleAdjustment = engine


def frames_of(cfg) -> int:
    return cfg.slidingWindowSize + 1


_runs = {}


@pytest.fixture
def runs(sequence, tmp_path_factory, request):
    """Both packages' runs of one configuration (the test's `config`
    parameter), once per module: per package (config, recorded dataset,
    refined trajectory, JSONL records), and the JAX engine's trace."""
    name = request.node.callspec.params["config"]
    if name in _runs:
        return _runs[name]
    root = sequence[0]
    out_dir = tmp_path_factory.mktemp(name)
    init = traj.load_poses_kitti(os.path.join(root, "vo.txt"))
    path = os.path.join(CONFIG_DIR, f"{name}.cfg")
    shipped = cli.load_config(cli.build_argparser().parse_args(
        ["--config", path]))
    kv = dict(SMALL, dataDir=root, numFrames=frames_of(shipped))
    res, traces = {}, []
    for pkg, mod, data, kw in (("jax", jcli, jkitti, {}),
                               ("torch", cli, kitti, dict(device="cpu"))):
        out = str(out_dir / f"{pkg}.txt")
        argv = ["--config", path, "--output", out,
                *(f"{k}={v}" for k, v in kv.items())]
        cfg = mod.load_config(mod.build_argparser().parse_args(argv))
        ds = Recorded(data.create_dataset(cfg, **kw))
        log = str(out_dir / f"{pkg}.jsonl")
        with (traced_jax_engine(traces) if pkg == "jax"
              else contextlib.nullcontext()):
            refined = mod.run(cfg, ds, init, output=out, jsonl_path=log,
                              progress=False, **kw)
        with open(log) as f:
            records = [json.loads(line) for line in f]
        res[pkg] = (cfg, ds, refined, records)
    (res["trace"],) = traces
    _runs[name] = res
    return res


@pytest.mark.parametrize("config", CONFIGS)
def test_config_matches_jax(sequence, runs, config):
    _, poses, vo = sequence
    cfg = runs["torch"][0]
    n = frames_of(cfg)
    gt = traj.Trajectory(poses[:n].astype(np.float64))
    ate_init = traj.ate_rmse(traj.Trajectory(vo[:n].astype(np.float64)), gt)
    ates, refined = {}, {}
    for pkg in ("jax", "torch"):
        _, _, ref, recs = runs[pkg]
        # The output holds the VO input's length; the run refines n frames.
        assert len(ref) == len(vo)
        refined[pkg] = traj.Trajectory(ref.poses[:n])
        assert np.isfinite(refined[pkg].poses).all()
        assert [r["frame"] for r in recs] == [n - 2, n - 1], (pkg, recs)
        for r in recs:
            assert r["final_cost"] <= r["initial_cost"], (pkg, r)
        ates[pkg] = traj.ate_rmse(refined[pkg], gt)
    if ates["jax"] < ate_init:
        assert ates["torch"] < ate_init, (ate_init, ates)
    assert abs(ates["torch"] - ates["jax"]) <= ACCURACY_SHARE * ate_init, (
        ates, ate_init)
    between = traj.ate_rmse(refined["torch"], refined["jax"], align=False)
    assert between <= PARITY_SHARE * ate_init, (between, ates, ate_init)
    assert ([r["frame_ids"] for r in runs["torch"][3]]
            == [r["frame_ids"] for r in runs["jax"][3]])


@pytest.mark.parametrize("config", CONFIGS)
def test_config_depths_match_jax(runs, config):
    """Every frame's stereo depth as the two runs read it."""
    (cfg, ds, _, _), (_, jds, _, _) = runs["torch"], runs["jax"]
    assert sorted(ds.frames) == sorted(jds.frames) == list(range(len(ds)))
    fb = float(ds.camera.fx) * float(ds.camera.baseline)
    for i, f in ds.frames.items():
        jf = jds.frames[i]
        np.testing.assert_array_equal(f.image, jf.image)
        differ = (f.depth_valid != jf.depth_valid).mean()
        assert differ <= VALIDITY_SHARE, (cfg.stereoAlgorithm, i, differ)
        both = f.depth_valid & jf.depth_valid
        assert both.mean() > 0.25
        np.testing.assert_allclose(fb / f.depth[both], fb / jf.depth[both],
                                   atol=DISP_ATOL)


def port_engine(runs):
    cfg, ds = runs["torch"][:2]
    return TPBA(port_camera(ds.camera), ds.image_shape, cfg, device="cpu")


@pytest.mark.parametrize("config", CONFIGS)
def test_config_ingests_match_jax(runs, config):
    """Every ingest of the JAX run, repeated by the port from the JAX
    engine's state: the point table's flags exactly."""
    trace, _ = runs["trace"]
    tpba = port_engine(runs)
    assert len(trace.ingests) == frames_of(tpba.cfg)
    for k, rec in enumerate(trace.ingests):
        (jp, _), (tp, _) = rec["after"], port_ingest(tpba, rec)
        for name in EXACT_POINTS:
            np.testing.assert_array_equal(getattr(tp, name),
                                          getattr(jp, name),
                                          err_msg=f"ingest {k}: {name}")


@pytest.mark.parametrize("config", CONFIGS)
def test_config_first_window_matches_jax(runs, config):
    """The first window solve of the JAX run, repeated by the port from the
    JAX engine's pre-solve state (observations within 1e-4 px of a border
    margin cleared, as tests/test_torch_engine.py clears them): the same
    termination, iterations, accept log and observations, initial cost
    within 1e-5, final cost within 1e-4, poses within 1e-4."""
    trace, jpba = runs["trace"]
    tpba = port_engine(runs)
    assert len(trace.solves) == 2
    points_np, window_np = without_observations_at_margins(
        tpba, *trace.solves[0]["before"])
    import jax.numpy as jnp

    jw, _, want, jpv = jpba._optimize(
        type(window_np)(*map(jnp.asarray, window_np)),
        type(points_np)(*map(jnp.asarray, points_np)))
    points, win = convert.engine_state_from_numpy(points_np, window_np)
    tw, _, got, tpv = tpba._optimize(win, points)
    assert int(got.termination) == int(want.termination)
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_array_equal(got.accept_log.numpy(),
                                  np.asarray(want.accept_log))
    np.testing.assert_array_equal(tpv.numpy(), np.asarray(jpv))
    assert int(got.n_residuals) == int(want.n_residuals)
    np.testing.assert_array_equal(got.obs_per_frame.numpy(),
                                  np.asarray(want.obs_per_frame))
    np.testing.assert_allclose(float(got.initial_cost),
                               float(want.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(got.final_cost), float(want.final_cost),
                               rtol=1e-4)
    np.testing.assert_allclose(tw.t_wc.numpy(), np.asarray(jw.t_wc),
                               atol=1e-4)
