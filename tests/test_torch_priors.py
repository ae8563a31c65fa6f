"""The port's window solve with the motion and pose priors against the JAX
engine's, at the small rotation angles where se3_log cancels.

The priors take se3_log of relative poses that a step moves by 1e-4 to
1e-3 rad, where (1 - A/(2B)) / theta^2 keeps few digits: one ulp of
cos theta there moves the prior's residual by orders of magnitude, and
below 2.44e-4 rad f32 1 - cos theta rounds to 0, the prior cost is NaN
and the step is rejected (in both packages). So the port must round sin
and cos as the reference does (geometry/se3.py::_sin_cos), or its solve
rejects steps the reference accepts. The second window of
tests/test_engine.py's scene meets that band: the JAX engine's recorded
pre-solve state (one chain, with configs/kitti_large_window.cfg's motion
prior, 5) is solved by both packages with that prior, with
configs/kitti_production.cfg's (2) and with the production pair (motion
2, pose 4), 8 fixed iterations, on both port backends. With f32 sin and
cos the port rejected the first five steps of the motion prior 5 case,
where the reference accepts three (final costs 6.4 % apart).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from photobundle_tpu.core.engine import PhotometricBundleAdjustment as JPBA
from photobundle_torch import convert
from photobundle_torch.core.engine import PhotometricBundleAdjustment as TPBA

from synthetic import make_sequence, perturb_poses
from test_engine import small_cfg
from torch_parity import EngineTrace, port_camera, port_config
from torch_parity import few_threads  # noqa: F401  (module fixture)

SOLVE_ITERS = 8
PRIORS = {
    "motion_2": dict(motionPriorWeight=2.0),
    "motion_5": dict(motionPriorWeight=5.0),
    "production": dict(motionPriorWeight=2.0, posePriorWeight=4.0),
}


def solve_cfg(**kw):
    return small_cfg(maxIterations=SOLVE_ITERS, functionTolerance=0.0,
                     parameterTolerance=0.0, **kw)


@pytest.fixture(scope="module")
def chain():
    """tests/test_engine.py's scene through the JAX engine with the motion
    prior 5: the camera, the frame shape and the pre-solve state of its
    second window solve."""
    cam, images, depths, poses = make_sequence(np.random.default_rng(3),
                                               n_frames=6, shape=(96, 144))
    init = perturb_poses(np.random.default_rng(11), poses, trans_sigma=0.03,
                         rot_sigma=0.003, keep_first=2)
    jpba = JPBA(cam, images[0].shape, solve_cfg(**PRIORS["motion_5"]))
    trace = EngineTrace(jpba)
    for i in range(6):
        jpba.add_frame(images[i], depths[i], init[i])
    return cam, images[0].shape, trace.solves[1]["before"]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("prior", sorted(PRIORS))
def test_prior_window_solve_matches_reference(chain, prior, backend):
    cam, shape, (points_np, window_np) = chain
    cfg = solve_cfg(**PRIORS[prior])
    jpba = JPBA(cam, shape, cfg)
    jw, _, want, _ = jpba._optimize(
        type(window_np)(*map(jnp.asarray, window_np)),
        type(points_np)(*map(jnp.asarray, points_np)))
    tpba = TPBA(port_camera(cam), shape,
                port_config(cfg).replace(solverBackend=backend),
                device="cpu")
    points, win = convert.engine_state_from_numpy(points_np, window_np)
    tw, _, got, _ = tpba._optimize(win, points)
    assert int(got.iterations) == int(want.iterations) == SOLVE_ITERS
    np.testing.assert_array_equal(got.accept_log.numpy(),
                                  np.asarray(want.accept_log))
    np.testing.assert_allclose(float(got.final_cost), float(want.final_cost),
                               rtol=1e-4)
    np.testing.assert_allclose(tw.t_wc.numpy(), np.asarray(jw.t_wc),
                               atol=2.2e-4)
