"""Margins of `test_torch_engine.py::test_window_solve_matches_reference_from_carried_state`
per torch intra-op thread count, on the CPU: the JAX engine's recorded
pre-solve states of the test's scene, solved by the reference and by the
port on each thread count.

    JAX_PLATFORMS=cpu python tests/edge_margins.py --configs bitplanes \
        --threads 1 2 4 8

Prints, per configuration, window, backend and thread count, the largest
distance of the port's points, poses and final cost from the reference's
in units of the test's bounds (points atol 1e-3 + rtol 1e-4, poses 1e-4,
final cost 1e-4 relative; above 1 fails), the point that sets the first,
and whether the accept logs agree. Not a test: it reads how close the
port's f32 rounding leaves each solve to the bounds.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import conftest  # noqa: E402,F401  (JAX on the CPU, as under pytest)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_engine as tte  # noqa: E402
from photobundle_tpu.core.engine import PhotometricBundleAdjustment as JPBA  # noqa: E402
from photobundle_torch import convert  # noqa: E402
from photobundle_torch.core.engine import PhotometricBundleAdjustment as TPBA  # noqa: E402
from synthetic import make_sequence, perturb_poses  # noqa: E402
from test_engine import small_cfg  # noqa: E402
from torch_parity import (EngineTrace, intra_op_threads, port_camera,  # noqa: E402
                          port_config)


def recorded(scene, name):
    """The test's `solves` fixture for one configuration: (cfg, JAX
    engine, recorded solves)."""
    cam, images, depths, _, init = scene
    cfg = small_cfg(maxIterations=tte.SOLVE_ITERS, functionTolerance=0.0,
                    parameterTolerance=0.0, **tte.CONFIGS[name])
    jpba = JPBA(cam, images[0].shape, cfg)
    source = JPBA(cam, images[0].shape, small_cfg(
        maxIterations=tte.SOLVE_ITERS, functionTolerance=0.0,
        parameterTolerance=0.0)) if name in tte.SOLVE_ONLY else jpba
    trace = EngineTrace(source)
    for i in range(6):
        source.add_frame(images[i], depths[i], init[i])
    return cfg, jpba, trace.solves


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", nargs="+", default=["bitplanes"],
                    choices=sorted(tte.CONFIGS))
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4, 8])
    args = ap.parse_args()
    cam, images, depths, poses = make_sequence(
        np.random.default_rng(3), n_frames=tte.N_FRAMES, shape=(96, 144))
    init = perturb_poses(np.random.default_rng(11), poses, trans_sigma=0.03,
                         rot_sigma=0.003, keep_first=2)
    scene = (cam, images, depths, poses, init)
    for name in args.configs:
        cfg, jpba, recs = recorded(scene, name)
        for window in (0, 1):
            for backend in ("torch", "cuda"):
                tpba = TPBA(port_camera(cam), images[0].shape,
                            port_config(cfg).replace(solverBackend=backend),
                            device="cpu")
                points_np, window_np = tte.without_observations_at_margins(
                    tpba, *recs[window]["before"])
                jw, jp, want, _ = jpba._optimize(
                    type(window_np)(*map(jnp.asarray, window_np)),
                    type(points_np)(*map(jnp.asarray, points_np)))
                want_x = np.asarray(jp.x_world)
                for n in args.threads:
                    points, win = convert.engine_state_from_numpy(points_np,
                                                                  window_np)
                    with intra_op_threads(n):
                        tw, tp, got, _ = tpba._optimize(win, points)
                    pts = (np.abs(tp.x_world.numpy() - want_x)
                           / (1e-3 + 1e-4 * np.abs(want_x))).max(axis=1)
                    pose = np.abs(tw.t_wc.numpy()
                                  - np.asarray(jw.t_wc)).max() / 1e-4
                    cost = abs(float(got.final_cost) / float(want.final_cost)
                               - 1.0) / 1e-4
                    same = np.array_equal(got.accept_log.numpy(),
                                          np.asarray(want.accept_log))
                    print(f"{name} window {window} {backend} threads {n}: "
                          f"points {pts.max():.3f} (point {pts.argmax()}), "
                          f"poses {pose:.3f}, final cost {cost:.3f}, "
                          f"accept logs equal {same}", flush=True)


if __name__ == "__main__":
    main()
