"""One torch.distributed world of gloo ranks on the CPU for the mesh tests
(tests/test_torch_sharding.py): `spawn` starts WORLD processes of this
file, each joining the world and running every job of `JOBS` on the
inputs the parent wrote (`inputs.npz`, `configs.json`), and each writing
its results to `rank<k>.npz`. The ranks import the port only, never jax:
the parent test process holds their results against the port's
single-rank functions and the JAX package's.

    python tests/torch_mesh.py <rank> <world> <port> <dir>
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLD = 4
THREADS = 1                  # intra-op threads per rank
TIMEOUT_S = 400


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start(outdir: str):
    """Start the WORLD ranks on the inputs under `outdir`; returns their
    processes (see `wait`)."""
    port = _free_port()
    path = os.pathsep.join(filter(None, (REPO,
                                         os.environ.get("PYTHONPATH"))))
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS=str(THREADS))
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(k), str(WORLD),
         str(port), outdir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, start_new_session=True)
        for k in range(WORLD)]


def wait(procs, outdir: str):
    """Wait for the ranks (TIMEOUT_S), raise with a failed rank's output,
    and return each rank's results as a dict of numpy arrays."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for k, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {k} exited {p.returncode}:\n"
                                 f"{out[-4000:]}")
    results = []
    for k in range(WORLD):
        with np.load(os.path.join(outdir, f"rank{k}.npz")) as data:
            results.append({key: data[key] for key in data.files})
    return results


# ---------------------------------------------------------------------- #
# the ranks
# ---------------------------------------------------------------------- #
def _problem(inputs, name):
    """The port's (cam, offsets, args) of input set `name`."""
    from photobundle_torch import convert
    from photobundle_torch.geometry.camera import Camera

    keys = ("t_wc", "x", "patch", "channels", "grads", "obs", "valid",
            "frozen")
    cam = Camera.create(*(float(v) for v in inputs[f"{name}/cam"]))
    return (cam, convert.to_torch(inputs[f"{name}/offsets"]),
            tuple(convert.to_torch(inputs[f"{name}/{k}"]) for k in keys))


def _stats(prefix, stats):
    return {f"{prefix}/{k}": v.numpy() for k, v in stats._asdict().items()}


def job_points(inputs, configs):
    """ShardedLMSolver over points=WORLD on 64 points (8 iterations) and on
    128 points (25 iterations)."""
    from photobundle_torch.parallel import make_mesh
    from photobundle_torch.parallel.sharded import ShardedLMSolver

    mesh = make_mesh(points=WORLD)
    out = {}
    for name, n, iters in (("A64", 64, 8), ("A128", 128, 25)):
        cam, off, args = _problem(inputs, name)
        solver = ShardedLMSolver(mesh, cam, off, n_points=n, huber_delta=1e9,
                                 gradient_mode="sampled",
                                 max_iterations=iters)
        t, x, stats = solver(*args)
        out.update({f"{name}/t_wc": t.numpy(), f"{name}/x": x.numpy(),
                    **_stats(name, stats)})
    return out


def job_capacity(inputs, configs):
    """A capacity the points axis does not divide raises before any
    collective: the world's next collective still lines up."""
    import torch
    import torch.distributed as dist

    from photobundle_torch.parallel import make_mesh
    from photobundle_torch.parallel.sharded import ShardedLMSolver

    mesh = make_mesh(points=WORLD)
    cam, off, _ = _problem(inputs, "A64")
    try:
        ShardedLMSolver(mesh, cam, off, n_points=63, huber_delta=1.0)
        raised = ""
    except ValueError as e:
        raised = str(e)
    after = torch.ones(1)
    dist.all_reduce(after)
    return {"capacity/raised": np.array(raised),
            "capacity/after": after.numpy()}


def job_frames(inputs, configs):
    """make_frames_sharded_solver on a ('frames' 2, 'points' WORLD/2)
    mesh, 64 points, W = 4."""
    from photobundle_torch.parallel.sharded import (
        make_frames_mesh, make_frames_sharded_solver)

    mesh = make_frames_mesh(frames=2, points=WORLD // 2)
    cam, off, args = _problem(inputs, "A64")
    solver = make_frames_sharded_solver(
        mesh, cam, off, n_points=64, window_size=4, huber_delta=1e9,
        gradient_mode="sampled", max_iterations=8)
    t, x, stats = solver(*args)
    return {"frames/t_wc": t.numpy(), "frames/x": x.numpy(),
            **_stats("frames", stats)}


def job_frames_priors(inputs, configs):
    """The frames layout with the inverse-depth prior (global reference
    slots compared in each shard's frames) and the motion prior
    (replicated pose math) on ('frames' WORLD, 'points' 1): one frame a
    rank, 32 points, 6 iterations."""
    from photobundle_torch import convert
    from photobundle_torch.parallel.sharded import (
        make_frames_mesh, make_frames_sharded_solver)

    mesh = make_frames_mesh(frames=WORLD, points=1)
    cam, off, args = _problem(inputs, "B32a")
    solver = make_frames_sharded_solver(
        mesh, cam, off, n_points=32, window_size=4, huber_delta=1e9,
        gradient_mode="sampled", depth_prior_weight=2.0,
        motion_prior_weight=1.0, max_iterations=6)
    t, x, stats = solver(*args, convert.to_torch(inputs["priors/ref_slot"]),
                         convert.to_torch(inputs["priors/seed"]))
    return {"priors/t_wc": t.numpy(), **_stats("priors", stats)}


def job_batched(inputs, configs):
    """make_batched_sharded_solver on a ('windows' 2, 'points' WORLD/2)
    mesh: two windows of 32 points."""
    import torch

    from photobundle_torch.parallel import make_mesh
    from photobundle_torch.parallel.sharded import \
        make_batched_sharded_solver

    mesh = make_mesh(points=WORLD // 2, windows=2)
    cam, off, args_a = _problem(inputs, "B32a")
    _, _, args_b = _problem(inputs, "B32b")
    solver = make_batched_sharded_solver(mesh, cam, off, n_points=32,
                                         huber_delta=1e9, max_iterations=6)
    t, x, stats = solver(*(torch.stack(p) for p in zip(args_a, args_b)))
    return {"batched/t_wc": t.numpy(), "batched/x": x.numpy(),
            **_stats("batched", stats)}


def _engine_poses(cfg_kw, inputs, init_key, n_frames):
    from photobundle_torch.config import PBAConfig
    from photobundle_torch.core.engine import PhotometricBundleAdjustment
    from photobundle_torch.geometry.camera import Camera

    cam = Camera.create(*(float(v) for v in inputs["scene/cam"]))
    images, depths = inputs["scene/images"], inputs["scene/depths"]
    pba = PhotometricBundleAdjustment(cam, images[0].shape,
                                      PBAConfig(**cfg_kw), device="cpu")
    poses = [r.poses for i in range(n_frames)
             if (r := pba.add_frame(images[i], depths[i],
                                    inputs[init_key][i])) is not None]
    return pba, np.stack(poses)


def _snapshot_round_trip(pba, cfg_kw, inputs, path):
    """save_state under the frames layout (every rank calls it, rank 0
    writes the gathered window) and load_state into a fresh engine of the
    same mesh: whether the restored state is bitwise the saved one."""
    import torch
    import torch.distributed as dist

    from photobundle_torch.config import PBAConfig
    from photobundle_torch.core.engine import PhotometricBundleAdjustment
    from photobundle_torch.geometry.camera import Camera

    pba.save_state(path)
    dist.barrier()
    cam = Camera.create(*(float(v) for v in inputs["scene/cam"]))
    other = PhotometricBundleAdjustment(
        cam, inputs["scene/images"][0].shape, PBAConfig(**cfg_kw),
        device="cpu")
    other.load_state(path)
    return all(torch.equal(a, b) for a, b in
               zip((*pba.window, *pba.points), (*other.window, *other.points)))


def job_engines(inputs, configs):
    """The engine with meshPoints=WORLD (priors on), and with meshFrames=2
    x meshPoints=WORLD/2 under coarse-to-fine; the trajectories, and the
    frames layout's resting image leaves."""
    out = {}
    _, out["engine_points/poses"] = _engine_poses(
        configs["engine_points"], inputs, "init/points", 8)
    pba, out["engine_frames/poses"] = _engine_poses(
        configs["engine_frames"], inputs, "init/frames", 8)
    out["engine_frames/channels"] = pba.window.channels.numpy()
    out["engine_frames/restored"] = np.array(_snapshot_round_trip(
        pba, configs["engine_frames"], inputs, configs["snapshot"]))
    _, out["engine_warp/poses"] = _engine_poses(
        configs["engine_warp"], inputs, "init/points", 8)
    return out


def job_batched_engine(inputs, configs):
    """The batched engine over ('windows' 2, 'points' WORLD/2) from the
    configuration (meshWindows, meshPoints), B = 2."""
    from photobundle_torch.config import PBAConfig
    from photobundle_torch.core.batched import \
        BatchedPhotometricBundleAdjustment
    from photobundle_torch.geometry.camera import Camera

    cam = Camera.create(*(float(v) for v in inputs["scene/cam"]))
    images, depths = inputs["scene/images"], inputs["scene/depths"]
    inits = inputs["init/batched_a"], inputs["init/batched_b"]
    bp = BatchedPhotometricBundleAdjustment(
        cam, images[0].shape, PBAConfig(**configs["batched_engine"]), 2,
        device="cpu")
    poses = [[r.poses for r in rs]
             for i in range(len(images))
             if (rs := bp.add_frames([images[i]] * 2, [depths[i]] * 2,
                                     [init[i] for init in inits]))]
    return {"batched_engine/poses": np.array(poses)}


def job_cli(inputs, configs):
    """photobundle_torch.cli under the world (as torchrun starts it) with
    meshFrames=2 x meshPoints=WORLD/2 from the configuration: rank 0
    writes the trajectory, and main checks every rank's is rank 0's."""
    from photobundle_torch import cli

    return {"cli/code": np.array(cli.main(configs["cli"]["argv"]))}


def job_tools(inputs, configs):
    """demo_multiprocess in the world (points = WORLD)."""
    import torch

    from photobundle_torch.tools import demo_multiprocess

    initial, final, accepted = demo_multiprocess.run(torch.device("cpu"))
    return {"demo/costs": np.array([initial, final, accepted])}


JOBS = (job_points, job_capacity, job_frames, job_frames_priors,
        job_batched, job_engines, job_batched_engine, job_cli, job_tools)


def main(rank: int, world: int, port: int, outdir: str) -> None:
    import torch

    torch.set_num_threads(THREADS)
    from photobundle_torch.parallel import mesh

    mesh.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                device="cpu")
    with np.load(os.path.join(outdir, "inputs.npz")) as data:
        inputs = {k: data[k] for k in data.files}
    with open(os.path.join(outdir, "configs.json")) as f:
        configs = json.load(f)
    results, seconds = {}, {}
    for job in JOBS:
        t0 = time.perf_counter()
        results.update(job(inputs, configs))
        seconds[job.__name__] = time.perf_counter() - t0
    results["seconds"] = np.array(json.dumps(seconds))
    results["jax_imported"] = np.array(any(
        m == "jax" or m.startswith(("jax.", "jaxlib", "photobundle_tpu"))
        for m in sys.modules))
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **results)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
