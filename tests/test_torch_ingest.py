"""Frame ingest of the port's engine against the JAX package's, one frame at
a time from the reference engine's carried-over state.

The JAX engine runs the synthetic sphere sequence of tests/test_engine.py
(96x144, `small_cfg`) once per configuration, recording the state before
and after each frame's ingest (tests/torch_parity.EngineTrace). For every
frame the port's ingest (push, cull, track, select) starts from the exact
state the reference started from, fed the same transported image, and
must end in the same state: equal point occupancy, observations,
reference frames and ages (the selected point set equals the
reference's), and positions, descriptor patches and depth seeds within
1e-6 (f32 rounding of the same arithmetic). Chaining frames would
compound f32 differences through the window solves, so no frame depends
on the port's previous one."""

import numpy as np
import pytest
import torch

from photobundle_tpu.core.engine import PhotometricBundleAdjustment as JPBA
from photobundle_torch import convert
from photobundle_torch.core import selection as tsel
from photobundle_torch.core import state as tstate
from photobundle_torch.core.engine import PhotometricBundleAdjustment as TPBA

from synthetic import make_sequence, perturb_poses
from test_engine import small_cfg
from torch_parity import EngineTrace, port_camera, port_config

N_FRAMES = 8

CONFIGS = {
    # The engine's default ingest (Intensity), float images.
    "intensity-f32": (dict(), False),
    # Three channels, both geometric gates, and the uint8 transport with
    # its shared 1/255 reciprocal.
    "gradient-gates-u8": (dict(descriptor="IntensityAndGradient",
                               occlusionThreshold=0.2,
                               depthEdgeThreshold=0.15), True),
}


@pytest.fixture(scope="module")
def scene():
    cam, images, depths, poses = make_sequence(np.random.default_rng(3),
                                               n_frames=N_FRAMES,
                                               shape=(96, 144))
    init = perturb_poses(np.random.default_rng(11), poses, trans_sigma=0.03,
                         rot_sigma=0.003, keep_first=2)
    return cam, images, depths, init


@pytest.fixture(scope="module")
def traces(scene):
    """Per configuration: the JAX engine's trace and the port's engine."""
    cam, images, depths, init = scene
    out = {}
    for name, (kw, as_u8) in CONFIGS.items():
        cfg = small_cfg(maxIterations=6, **kw)
        jpba = JPBA(cam, images[0].shape, cfg)
        trace = EngineTrace(jpba)
        for i in range(N_FRAMES):
            img = images[i]
            if as_u8:
                img = np.round(img * 255.0).astype(np.uint8)
            jpba.add_frame(img, depths[i], init[i])
        tpba = TPBA(port_camera(cam), images[0].shape, port_config(cfg))
        out[name] = (trace, tpba)
    return out


def port_ingest(tpba, rec):
    """The port's ingest from a recorded pre-ingest state and arguments."""
    points, window = convert.engine_state_from_numpy(*rec["before"])
    image, depth, t_wc, frame_id, age_id = rec["args"]
    count = int(rec["before"][1].count)
    window, points = tpba._ingest(
        window, points, torch.tensor(image), torch.tensor(depth),
        torch.tensor(t_wc), int(frame_id), int(age_id), count)
    return convert.engine_state_to_numpy(points, window)


EXACT_POINTS = ("active", "obs", "ref_frame", "last_seen")
CLOSE_POINTS = ("x_world", "patch", "inv_depth_seed")
EXACT_WINDOW = ("frame_ids", "count", "depth_ok", "t_wc", "t_vo", "depth")
CLOSE_WINDOW = ("channels", "grads", "saliency")


@pytest.mark.parametrize("frame", range(N_FRAMES))
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_ingest_matches_reference_from_carried_state(traces, config, frame):
    trace, tpba = traces[config]
    rec = trace.ingests[frame]
    (jp, jw), (tp, tw) = rec["after"], port_ingest(tpba, rec)
    for name in EXACT_POINTS:
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name),
                                      err_msg=name)
    for name in CLOSE_POINTS:
        np.testing.assert_allclose(getattr(tp, name), getattr(jp, name),
                                   atol=1e-6, rtol=1e-6, err_msg=name)
    for name in EXACT_WINDOW:
        np.testing.assert_array_equal(getattr(tw, name), getattr(jw, name),
                                      err_msg=name)
    for name in CLOSE_WINDOW:
        np.testing.assert_allclose(getattr(tw, name), getattr(jw, name),
                                   atol=1e-6, rtol=0, err_msg=name)
    if frame > 0:
        # The frame added points and tracked old ones: the comparison is
        # not of an empty table.
        assert tp.active.sum() > 20 and (tp.obs.sum(1) >= 2).sum() > 0


def test_the_trace_covers_slides_and_culls(traces):
    trace, _ = traces["intensity-f32"]
    counts = [int(r["before"][1].count) for r in trace.ingests]
    assert counts == [0, 1, 2, 3, 4, 5, 5, 5]
    # Points were culled once the ring slid (ref frames left the window).
    before = trace.ingests[-1]["before"][0]
    assert (before.ref_frame[before.active] >= 1).all()


def test_state_round_trip():
    cfg = port_config(small_cfg())
    points = tstate.init_point_table(cfg)
    window = tstate.init_window(cfg, (12, 16))
    p2, w2 = convert.engine_state_from_numpy(
        *convert.engine_state_to_numpy(points, window))
    for a, b in zip((*points, *window), (*p2, *w2)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_push_slides_the_ring_and_the_observation_mask():
    """tests/test_state.py on the port: the ring fills, then slides, and
    the observation columns roll with it (the host count decides)."""
    cfg = port_config(small_cfg(maxNumPoints=8, slidingWindowSize=3))
    win = tstate.init_window(cfg, (4, 5))
    pts = tstate.init_point_table(cfg)

    def push(win, pts, fid, count):
        return tstate.push_frame(win, torch.full((1, 4, 5), float(fid)),
                                 torch.zeros((1, 4, 5, 2)),
                                 torch.zeros((4, 5)), torch.eye(4), fid,
                                 torch.zeros((4, 5)),
                                 torch.zeros((4, 5), dtype=torch.bool), pts,
                                 count)

    for fid in range(3):
        win, pts = push(win, pts, fid, fid)
    assert win.frame_ids.tolist() == [0, 1, 2] and int(win.count) == 3
    pts = pts._replace(obs=pts.obs.clone().index_fill_(1, torch.tensor(0),
                                                       True))
    pts.obs[0, 2] = True
    win, pts = push(win, pts, 3, 3)
    assert win.frame_ids.tolist() == [1, 2, 3] and int(win.count) == 3
    assert float(win.channels[0, 0, 0, 0]) == 1.0
    assert pts.obs[0].tolist() == [False, True, False]
    assert not pts.obs[:, 2].any()
    pts = pts._replace(active=torch.ones(8, dtype=torch.bool),
                       ref_frame=torch.arange(1, 9, dtype=torch.int32))
    culled = tstate.cull_points(pts, torch.tensor(1))
    assert culled.active.tolist() == [True] + [False] * 7


def test_selection_ties_take_the_lower_pixel_first():
    """Equal quantized saliencies are ranked by pixel index, as
    `lax.top_k` does; `torch.topk` promises no order."""
    cfg = port_config(small_cfg(maxNumPoints=16))
    pts = tstate.init_point_table(cfg)
    h, w = 20, 24
    sal = torch.zeros((h, w))
    peaks = [(5, 6), (5, 12), (10, 6), (10, 12), (14, 18)]
    for y, x in peaks:
        sal[y, x] = 0.5                            # all tied
    from photobundle_torch.geometry.camera import Camera
    cam = Camera.create(50.0, 50.0, 11.5, 9.5)
    sel = tsel.select_new_points(
        pts, cam, torch.eye(4), torch.rand((1, h, w)), sal,
        torch.full((h, w), 5.0), torch.ones((h, w), dtype=torch.bool),
        torch.zeros((16, 2)), torch.zeros(16, dtype=torch.bool), 7, 0,
        torch.zeros((1, 2)), max_new=3, nms_radius=1, min_saliency=0.1,
        mask_radius=1, min_depth=0.1, max_depth=30.0, border=3)
    assert int(sel.num_added) == 3
    got = sel.points.x_world[:3, :2] / 5.0 * 50.0 + torch.tensor([11.5, 9.5])
    want = torch.tensor([[6.0, 5.0], [12.0, 5.0], [6.0, 10.0]])
    assert torch.allclose(got, want, atol=1e-4)
    assert sel.points.ref_frame[:3].tolist() == [7, 7, 7]
