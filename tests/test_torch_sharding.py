"""Device meshes of the port (photobundle_torch/parallel) against its own
single-rank solves and the JAX package's sharded solvers.

One torch.distributed world of 4 gloo ranks on the CPU is spawned once
for the module (tests/torch_mesh.py): the ranks import the port only and
run its points=4, ('frames' 2 x 'points' 2) and ('windows' 2 x 'points'
2) layouts on numpy inputs written here, and the engine, the batched
engine and the command line under mesh configurations. This process
holds their results against the port's single-rank functions on the
same inputs and against the JAX package's sharded solvers on conftest's
8 CPU devices, with the tolerances tests/test_sharding.py states:

- poses 1e-4 (abs and rel), points 1e-3, final cost rtol 1e-3, equal
  iteration counts (the sharded sums reduce in another order);
- the engines: trajectories within 5e-5 of the single engine (the batched
  engine 1e-3, its JAX test's bound);
- every rank's results bitwise equal (the replicated reduced solve and
  accept/reject branch; tests/test_multiprocess.py).

The identity context leaves the unsharded solve bitwise as it is, with
the same runs; a mesh configuration without a world raises naming
torchrun (tests/test_torch_engine.py, tests/test_torch_batched.py).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photobundle_tpu.parallel import make_mesh as jmake_mesh
from photobundle_tpu.parallel.sharded import (
    ShardedLMSolver as JShardedLMSolver, make_batched_sharded_solver as
    jmake_batched, make_frames_mesh as jmake_frames_mesh,
    make_frames_sharded_solver as jmake_frames)
from photobundle_torch import cli, entry
from photobundle_torch.config import ConfigFile, PBAConfig
from photobundle_torch.core import lm
from photobundle_torch.core.engine import PhotometricBundleAdjustment as TPBA

import torch_mesh
from synthetic import make_sequence, perturb_poses
from test_engine import small_cfg
from test_sharding import make_inputs
from torch_parity import few_threads, port_camera, port_config, port_problem  # noqa: F401

KW = dict(huber_delta=1e9, gradient_mode="sampled")
POSE_TOL, POINT_TOL, COST_RTOL = 1e-4, 1e-3, 1e-3
ENGINE_ATOL, BATCHED_ENGINE_ATOL = 5e-5, 1e-3
INPUT_SETS = {    # name -> (numpy seed, points)
    "A64": (0, 64), "A128": (0, 128), "B32a": (0, 32), "B32b": (5, 32)}
BATCHED_CFG = """
    slidingWindowSize = 4
    maxNumPoints = 128
    maxPointsPerFrame = 32
    maxIterations = 8
    patchRadius = 2
    meshWindows = 2
    meshPoints = 2
    minSaliency = 0.0005
    depthPriorWeight = 0.1
"""
CLI_FRAMES = 6


def engine_configs():
    """The engine configurations of the ranks (mesh) and of the single
    engines (mesh 1): tests/test_sharding.py's."""
    points = small_cfg(maxNumPoints=256, maxPointsPerFrame=64,
                       maxIterations=10, motionPriorWeight=2.0,
                       posePriorWeight=4.0)
    frames = small_cfg(slidingWindowSize=4, maxNumPoints=256,
                       maxPointsPerFrame=64, maxIterations=8,
                       coarseToFine=True, pyramidLevels=3,
                       coarseIterations=4)
    warp = small_cfg(maxNumPoints=256, maxPointsPerFrame=64,
                     maxIterations=10, motionPriorWeight=2.0,
                     posePriorWeight=4.0, patchWarp="scale")
    return {"engine_points": (port_config(points), dict(meshPoints=4)),
            "engine_frames": (port_config(frames),
                              dict(meshFrames=2, meshPoints=2)),
            "engine_warp": (port_config(warp), dict(meshPoints=4))}


def port_args(cam, off, args):
    """tests/test_sharding.make_inputs' (cam, offsets, args) -> the
    port's lm_solve arguments."""
    port = port_problem((cam, *args[:6], off))
    return (*port[:7], *(torch.as_tensor(np.array(a)) for a in args[6:]),
            port[7])


def _single_engine(cfg, scene, init, n_frames=8):
    cam, images, depths, _ = scene
    pba = TPBA(port_camera(cam), images[0].shape, cfg, device="cpu")
    return np.stack([r.poses for i in range(n_frames)
                     if (r := pba.add_frame(images[i], depths[i],
                                            init[i])) is not None])


def _cli_argv(root, out, **mesh):
    """The command line on the sequence under `root` (its run.cfg), the
    mesh as key=value overrides."""
    return ["--device", "cpu", "--config", os.path.join(root, "run.cfg"),
            "--poses", os.path.join(root, "vo.txt"), "--output", out,
            *(f"{k}={v}" for k, v in mesh.items())]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the ranks on inputs written here, compute this process's
    references while they run, and return (ranks' results, references,
    inputs)."""
    outdir = str(tmp_path_factory.mktemp("mesh"))
    inputs, problems = {}, {}
    for name, (seed, n) in INPUT_SETS.items():
        cam, off, args = make_inputs(np.random.default_rng(seed), n_pts=n)
        problems[name] = (cam, off, args)
        inputs[f"{name}/cam"] = np.array([float(v) for v in cam],
                                         np.float32)
        inputs[f"{name}/offsets"] = np.asarray(off)
        for key, a in zip(("t_wc", "x", "patch", "channels", "grads", "obs",
                           "valid", "frozen"), args):
            inputs[f"{name}/{key}"] = np.asarray(a)
    scene = make_sequence(np.random.default_rng(3), n_frames=8,
                          shape=(96, 144))
    cam, images, depths, poses = scene
    inputs["scene/cam"] = np.array([float(v) for v in cam], np.float32)
    inputs["scene/images"], inputs["scene/depths"] = (np.stack(images),
                                                      np.stack(depths))
    inits = {"points": perturb_poses(np.random.default_rng(5), poses, 0.02,
                                     0.002, keep_first=2),
             "frames": perturb_poses(np.random.default_rng(6), poses, 0.02,
                                     0.002, keep_first=2)}
    rng7 = np.random.default_rng(7)
    inits["batched_a"] = perturb_poses(rng7, poses, 0.01, 0.002, keep_first=2)
    inits["batched_b"] = perturb_poses(rng7, poses, 0.02, 0.003, keep_first=2)
    inputs.update({f"init/{k}": v for k, v in inits.items()})
    # tests/test_sharding.py's priors case: random reference slots and a
    # crude inverse-depth seed on the 32-point problem.
    x32 = np.asarray(problems["B32a"][2][1])
    inputs["priors/ref_slot"] = np.random.default_rng(0).integers(
        0, 4, size=32).astype(np.int32)
    inputs["priors/seed"] = (1.0 / np.maximum(x32[:, 2], 0.1)).astype(
        np.float32)

    root = os.path.join(outdir, "kitti")
    _, gt = entry.write_kitti_sequence(
        root, np.random.default_rng(3), n_frames=CLI_FRAMES, shape=(64, 96),
        fx=64.0, baseline=0.2, motion_scale=0.05)
    entry.write_poses(os.path.join(root, "vo.txt"), entry.drift_poses(
        np.random.default_rng(1), gt, 0.005, 0.0005, 1))
    with open(os.path.join(root, "run.cfg"), "w") as f:
        f.write("".join(f"{k} = {v}\n" for k, v in dict(
            dataDir=root, numFrames=CLI_FRAMES, maxNumPoints=128,
            maxPointsPerFrame=32, slidingWindowSize=4, maxIterations=6,
            numDisparities=16, dataLoader="python", minDepth=0.5,
            maxDepth=50).items()))
    cli_out = os.path.join(outdir, "refined_mesh.txt")

    configs = {name: dataclasses.asdict(cfg.replace(**mesh))
               for name, (cfg, mesh) in engine_configs().items()}
    configs["batched_engine"] = dataclasses.asdict(
        PBAConfig.from_config_file(ConfigFile(text=BATCHED_CFG)))
    configs["cli"] = dict(
        argv=_cli_argv(root, cli_out, meshFrames=2, meshPoints=2))
    configs["snapshot"] = os.path.join(outdir, "frames_state.npz")
    np.savez(os.path.join(outdir, "inputs.npz"), **inputs)
    with open(os.path.join(outdir, "configs.json"), "w") as f:
        json.dump(configs, f)

    procs = torch_mesh.start(outdir)
    try:
        refs = _references(problems, scene, inits, root, outdir,
                           {k.split("/")[1]: v for k, v in inputs.items()
                            if k.startswith("priors/")})
    finally:
        ranks = torch_mesh.wait(procs, outdir)
    refs["cli_out"] = cli_out
    refs["snapshot"] = configs["snapshot"]
    return ranks, refs


def _references(problems, scene, inits, root, outdir, inputs_priors):
    """The port's single-rank results and the JAX sharded solvers' on the
    ranks' inputs."""
    refs = {}
    priors = port_args(*problems["B32a"])
    refs["priors"] = lm.lm_solve(
        *priors, depth_prior=(torch.from_numpy(inputs_priors["ref_slot"]),
                              torch.from_numpy(inputs_priors["seed"]), 2.0),
        motion_prior_weight=1.0, max_iterations=6, **KW)
    for name, iters in (("A64", 8), ("A128", 25)):
        t, x, st = lm.lm_solve(*port_args(*problems[name]),
                               max_iterations=iters, **KW)
        refs[name] = (t.numpy(), x.numpy(), lm.LMStats(
            *(v.numpy() for v in st)))
    cam, off, args = problems["A64"]
    jkw = dict(max_iterations=8, **KW)
    js = JShardedLMSolver(jmake_mesh(points=4, windows=1), cam, off,
                          n_points=64, **jkw)(*args)
    refs["jax_points"] = jax.device_get(js)
    jf = jmake_frames(jmake_frames_mesh(frames=2, points=4), cam, off,
                      n_points=64, window_size=4, **jkw)(*args)
    refs["jax_frames"] = jax.device_get(jf)
    ba, bb = problems["B32a"][2], problems["B32b"][2]
    jb = jmake_batched(jmake_mesh(points=4, windows=2), cam, off,
                       n_points=32, huber_delta=1e9, max_iterations=6)(
        *(jnp.stack([a, b]) for a, b in zip(ba, bb)))
    refs["jax_batched"] = jax.device_get(jb)
    for key in ("B32a", "B32b"):
        refs[key] = lm.lm_solve(*port_args(*problems[key]), huber_delta=1e9,
                                max_iterations=6)
    for name, (cfg, _) in engine_configs().items():
        init = inits["frames" if name == "engine_frames" else "points"]
        refs[name] = _single_engine(cfg, scene, init)
    single = PBAConfig.from_config_file(ConfigFile(text=BATCHED_CFG)).replace(
        meshWindows=1, meshPoints=1)
    refs["batched_engine"] = [_single_engine(single, scene,
                                             inits[f"batched_{k}"])
                              for k in "ab"]
    refs["cli_single"] = os.path.join(outdir, "refined_single.txt")
    assert cli.main(_cli_argv(root, refs["cli_single"])) == 0
    return refs


def _all_ranks_equal(ranks, prefix):
    keys = [k for k in ranks[0] if k.startswith(prefix)]
    assert keys, prefix
    for r in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


def _solve_close(t, x, cost, iters, t_ref, x_ref, cost_ref, iters_ref):
    np.testing.assert_allclose(t, t_ref, atol=POSE_TOL, rtol=POSE_TOL)
    np.testing.assert_allclose(x, x_ref, atol=POINT_TOL, rtol=POINT_TOL)
    np.testing.assert_allclose(float(cost), float(cost_ref), rtol=COST_RTOL)
    assert int(iters) == int(iters_ref)


def test_sharded_matches_single_device(world):
    ranks, refs = world
    _all_ranks_equal(ranks, "A64/")
    r = ranks[0]
    got = (r["A64/t_wc"], r["A64/x"], r["A64/final_cost"],
           r["A64/iterations"])
    t, x, st = refs["A64"]
    _solve_close(*got, t, x, st.final_cost, st.iterations)
    jt, jx, jst = refs["jax_points"]
    _solve_close(*got, jt, jx, jst.final_cost, jst.iterations)


def test_sharded_improves_poses(world):
    ranks, _ = world
    _all_ranks_equal(ranks, "A128/")
    r = ranks[0]
    assert float(r["A128/final_cost"]) < 0.3 * float(r["A128/initial_cost"])


def test_sharded_rejects_bad_capacity(world):
    ranks, _ = world
    for r in ranks:
        assert "not divisible by points axis 4" in str(r["capacity/raised"])
        assert float(r["capacity/after"][0]) == torch_mesh.WORLD


def test_frames_sharded_matches_single_device(world):
    ranks, refs = world
    _all_ranks_equal(ranks, "frames/")
    r = ranks[0]
    got = (r["frames/t_wc"], r["frames/x"], r["frames/final_cost"],
           r["frames/iterations"])
    t, x, st = refs["A64"]
    _solve_close(*got, t, x, st.final_cost, st.iterations)
    jt, jx, jst = refs["jax_frames"]
    _solve_close(*got, jt, jx, jst.final_cost, jst.iterations)
    np.testing.assert_array_equal(r["frames/obs_per_frame"],
                                  st.obs_per_frame)
    assert int(r["frames/n_residuals"]) == int(st.n_residuals)


def test_frames_sharded_with_priors_matches(world):
    """The depth prior's global reference slots, compared in each frame
    shard's own frames, and the motion prior's replicated pose math on
    ('frames' 4, 'points' 1), against the port's single solve."""
    ranks, refs = world
    _all_ranks_equal(ranks, "priors/")
    t, _, st = refs["priors"]
    np.testing.assert_allclose(ranks[0]["priors/t_wc"], t.numpy(),
                               atol=POSE_TOL, rtol=POSE_TOL)
    np.testing.assert_allclose(float(ranks[0]["priors/final_cost"]),
                               float(st.final_cost), rtol=COST_RTOL)


def test_engine_mesh_points_patchwarp_matches_single_device(world):
    """patchWarp='scale' under the points mesh: the warp's reference
    geometry comes from the full replicated poses."""
    ranks, refs = world
    _all_ranks_equal(ranks, "engine_warp/poses")
    got = ranks[0]["engine_warp/poses"]
    assert got.shape == refs["engine_warp"].shape and len(got) > 0
    np.testing.assert_allclose(got, refs["engine_warp"], atol=ENGINE_ATOL)


def test_ranks_import_no_jax(world):
    ranks, _ = world
    assert not any(bool(r["jax_imported"]) for r in ranks)


def test_batched_multi_window_solver(world):
    ranks, refs = world
    _all_ranks_equal(ranks, "batched/")
    r = ranks[0]
    assert r["batched/t_wc"].shape == (2, 4, 4, 4)
    assert r["batched/x"].shape == (2, 32, 3)
    assert (r["batched/final_cost"] <= r["batched/initial_cost"] + 1e-9).all()
    jt = refs["jax_batched"][0]
    for k, key in enumerate(("B32a", "B32b")):
        t = refs[key][0].numpy()
        np.testing.assert_allclose(r["batched/t_wc"][k], t, atol=POSE_TOL,
                                   rtol=POSE_TOL)
        np.testing.assert_allclose(r["batched/t_wc"][k], jt[k],
                                   atol=POSE_TOL, rtol=POSE_TOL)


def test_mesh_frames_cfg_validation():
    with pytest.raises(ValueError, match="divisible by meshFrames"):
        PBAConfig(slidingWindowSize=5, meshFrames=2).validate()


def test_engine_mesh_frames_coarse_to_fine_matches_single_device(world):
    ranks, refs = world
    _all_ranks_equal(ranks, "engine_frames/poses")
    got = ranks[0]["engine_frames/poses"]
    assert got.shape == refs["engine_frames"].shape and len(got) > 0
    np.testing.assert_allclose(got, refs["engine_frames"], atol=ENGINE_ATOL)
    # The window's image leaves rest sharded: W / meshFrames slots a rank.
    assert ranks[0]["engine_frames/channels"].shape[0] == 2


def test_engine_mesh_frames_snapshot_round_trip(world):
    """save_state under meshFrames writes the whole window once (rank 0,
    the image leaves gathered over 'frames'), and load_state gives every
    rank back its own slots, bitwise."""
    ranks, refs = world
    assert all(bool(r["engine_frames/restored"]) for r in ranks)
    with np.load(refs["snapshot"]) as data:
        assert data["window.channels"].shape[0] == 4
        np.testing.assert_array_equal(
            data["window.channels"][:2], ranks[0]["engine_frames/channels"])
        np.testing.assert_array_equal(
            data["window.channels"][2:], ranks[2]["engine_frames/channels"])


def test_engine_mesh_points_matches_single_device(world):
    ranks, refs = world
    got = ranks[0]["engine_points/poses"]
    assert got.shape == refs["engine_points"].shape and len(got) > 0
    np.testing.assert_allclose(got, refs["engine_points"], atol=ENGINE_ATOL)


def test_ranks_full_engine_identical_trajectories(world):
    """tests/test_multiprocess.py's: the full engine over a mesh spanning
    the ranks refines the identical trajectory on every rank."""
    ranks, _ = world
    assert ranks[0]["engine_points/poses"].shape[0] >= 3
    _all_ranks_equal(ranks, "engine_points/poses")


def test_engine_mesh_windows_from_cfg(world):
    """The batched engine over ('windows' 2, 'points' 2) from the
    configuration against per-sequence single engines."""
    ranks, refs = world
    _all_ranks_equal(ranks, "batched_engine/")
    got = ranks[0]["batched_engine/poses"]        # (solves, B, W, 4, 4)
    assert got.shape[0] > 0
    for b, single in enumerate(refs["batched_engine"]):
        assert single.shape == got[:, b].shape
        np.testing.assert_allclose(got[:, b], single,
                                   atol=BATCHED_ENGINE_ATOL)


def test_cli_under_a_mesh(world):
    """The command line with meshFrames=2 x meshPoints=2 from its
    key=value overrides, started in the world as torchrun starts it: rank
    0 wrote the trajectory (every rank's bitwise rank 0's, or main
    raises), within 5e-4 of the single-process run (the JAX multi-process
    engine test's bound)."""
    from photobundle_torch.io import trajectory as traj

    ranks, refs = world
    assert all(int(r["cli/code"]) == 0 for r in ranks)
    got = traj.load_poses_kitti(refs["cli_out"]).poses
    want = traj.load_poses_kitti(refs["cli_single"]).poses
    assert got.shape == want.shape == (CLI_FRAMES, 4, 4)
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_identity_context_leaves_the_solve_unchanged(rng):
    """The identity ShardCtx (points_only_ctx(None), every hook the
    identity) runs the sharded code path and leaves the unsharded solve
    bitwise as it is, with the same runs."""
    call = port_args(*make_inputs(rng, n_pts=24))
    out = []
    for ctx in (None, lm.points_only_ctx(None)):
        lm.reset_runs()
        t, x, st = lm.lm_solve(*call, max_iterations=6, shard_ctx=ctx, **KW)
        out.append((t, x, st, dict(lm.runs)))
    (t0, x0, s0, r0), (t1, x1, s1, r1) = out
    assert torch.equal(t0, t1) and torch.equal(x0, x1)
    for a, b in zip(s0, s1):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert r0 == r1


def test_sharded_capture_refusals():
    """A gloo group cannot be captured: capture=True raises before
    anything runs, and capture=None takes the eager loop (no card here:
    capture needs one)."""
    class Gloo:
        capturable = False

        def __call__(self, *t):
            return t[0] if len(t) == 1 else t

    ctx = lm.points_only_ctx(Gloo())
    assert not lm.capturable(ctx) and lm.capturable(None)
    config = lm.setup(*port_args(*make_inputs(np.random.default_rng(1),
                                              n_pts=8)),
                      huber_delta=1.0, shard_ctx=ctx)[1]
    with pytest.raises(ValueError, match="capture"):
        lm._runner(torch.device("cuda"), config, True)
    assert lm._runner(torch.device("cuda"), config, None) is lm._run_eager



def test_demo_in_the_world(world):
    """demo_multiprocess in the world: every rank's poses and points
    bitwise rank 0's (or it raises), and the cost falls."""
    ranks, _ = world
    initial, final, accepted = ranks[0]["demo/costs"]
    assert final <= initial and accepted >= 1


def test_comm_model_matches_the_collectives():
    """comm_model's bytes per body against the collectives the solvers
    issue (its --verify, in a one-rank gloo world of its own process), and
    its table at the slice's size."""
    import subprocess
    import sys

    from photobundle_torch.tools import comm_model

    out = subprocess.run([sys.executable, "-m",
                          "photobundle_torch.tools.comm_model", "--verify"],
                         cwd=torch_mesh.REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "COMM MODEL VERIFY OK" in out.stdout
    vols = comm_model.analytic_volumes(4096, 5, 1, 2)
    assert sum(vols.values()) == 4600
    wire = comm_model.wire_bytes(vols, 1, 2)
    assert sum(wire.values()) == 4600        # 2 (n-1)/n = 1 at n = 2
