"""The port's batched ingest (core/batched.py: B sequences' frame ingests as
one pass over a batch axis) against the JAX package's batched engine and
against the port's single ingest.

- (a) From the stacked state the JAX batched engine carried into each
  frame (its `_ingest`, `jax.vmap` of `_ingest_impl` on XLA, recorded as
  numpy), the port's batched ingest of the same frames ends where the
  reference's does, sequence by sequence, with tests/test_torch_ingest.py's
  bounds: equal point sets, observations, ids and depths; positions,
  patches, depth seeds and images within 1e-6. Three sequences, both of
  that file's configurations, every frame through the ring's slides and
  the culls.
- (b) The batched ingest is bitwise B single ingests of the port, every
  field of the window and the point table, every frame, at B = 1 and 3,
  with frames whose B images arrive as a mix of uint8 and float32, in
  configurations that cover the three descriptors, the depth gates, a
  coarser refinement level and affine normalization.
- (c) `add_frames` tracks and selects once per frame whatever B, and
  slices and restacks no state on its ingest.
- (d) Equal saliencies take the lower pixel first in every batch row, each
  row with its own ties, and each row selects what it selects alone.
"""

import numpy as np
import pytest
import torch

from photobundle_tpu.core.batched import (
    BatchedPhotometricBundleAdjustment as JBPBA)
from photobundle_torch import convert
from photobundle_torch.core import batched as tbatched
from photobundle_torch.core import lm as tlm
from photobundle_torch.core import selection as tsel
from photobundle_torch.core import state as tstate
from photobundle_torch.core import tracking as ttrack
from photobundle_torch.core.batched import (
    BatchedPhotometricBundleAdjustment as BPBA)

from synthetic import make_sequence, perturb_poses
from test_engine import small_cfg
from test_torch_ingest import (CLOSE_POINTS, CLOSE_WINDOW, CONFIGS,
                               EXACT_POINTS, EXACT_WINDOW)
from torch_parity import few_threads  # noqa: F401  (module fixture)
from torch_parity import port_camera, port_config, state_np, to_np

N_FRAMES = 8
SEEDS = (3, 21, 7)


@pytest.fixture(scope="module")
def sequences():
    """Three sequences of one camera (make_sequence's intrinsics depend on
    the shape alone), each with its own scene, track and perturbed VO."""
    out = []
    for seed in SEEDS:
        cam, images, depths, poses = make_sequence(
            np.random.default_rng(seed), n_frames=N_FRAMES, shape=(96, 144))
        init = perturb_poses(np.random.default_rng(seed + 8), poses,
                             trans_sigma=0.03, rot_sigma=0.003, keep_first=2)
        out.append((images, depths, init))
    return cam, out


# ---------------------------------------------------------------------------
# (a) against jax.vmap(_ingest_impl)


class BatchedIngestTrace:
    """Records, as numpy, what the JAX batched engine's ingest program saw
    and returned (torch_parity.EngineTrace for `bpba._ingest`)."""

    def __init__(self, bpba):
        self.ingests = []
        ingest = bpba._ingest

        def traced(window, points, *args):
            before = state_np(points, window)
            host_args = [to_np(a) for a in args]
            window, points, diag = ingest(window, points, *args)
            self.ingests.append(dict(before=before, args=host_args,
                                     after=state_np(points, window)))
            return window, points, diag

        bpba._ingest = traced


@pytest.fixture(scope="module")
def jax_traces(sequences):
    cam, seqs = sequences
    out = {}
    for name, (kw, as_u8) in CONFIGS.items():
        cfg = small_cfg(maxIterations=4, **kw)
        jbpba = JBPBA(cam, seqs[0][0][0].shape, cfg, len(seqs))
        trace = BatchedIngestTrace(jbpba)
        for i in range(N_FRAMES):
            images = [s[0][i] for s in seqs]
            if as_u8:
                images = [np.round(im * 255.0).astype(np.uint8)
                          for im in images]
            jbpba.add_frames(images, [s[1][i] for s in seqs],
                             [s[2][i] for s in seqs])
        out[name] = (cfg, trace)
    return out


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_batched_ingest_matches_vmapped_reference(sequences, jax_traces,
                                                  config):
    cam, seqs = sequences
    cfg, trace = jax_traces[config]
    bpba = BPBA(port_camera(cam), seqs[0][0][0].shape, port_config(cfg),
                len(seqs), device="cpu")
    counts = [int(r["before"][1].count[0]) for r in trace.ingests]
    assert counts == [0, 1, 2, 3, 4, 5, 5, 5]
    for frame, rec in enumerate(trace.ingests):
        points, window = convert.batched_engine_state_from_numpy(
            *rec["before"])
        images, depths, t_wcs, frame_id, age_id = rec["args"]
        window, points = bpba._ingest(
            window, points, torch.tensor(images), torch.tensor(depths),
            torch.tensor(t_wcs), int(frame_id), int(age_id),
            counts[frame])
        tp, tw = convert.engine_state_to_numpy(points, window)
        jp, jw = rec["after"]
        for k in range(len(seqs)):
            where = f"frame {frame}, sequence {k}: "
            for name in EXACT_POINTS:
                np.testing.assert_array_equal(
                    getattr(tp, name)[k], getattr(jp, name)[k],
                    err_msg=where + name)
            for name in CLOSE_POINTS:
                np.testing.assert_allclose(
                    getattr(tp, name)[k], getattr(jp, name)[k], atol=1e-6,
                    rtol=1e-6, err_msg=where + name)
            for name in EXACT_WINDOW:
                np.testing.assert_array_equal(
                    getattr(tw, name)[k], getattr(jw, name)[k],
                    err_msg=where + name)
            for name in CLOSE_WINDOW:
                np.testing.assert_allclose(
                    getattr(tw, name)[k], getattr(jw, name)[k], atol=1e-6,
                    rtol=0, err_msg=where + name)
            if frame > 0:
                assert tp.active[k].sum() > 20
    # The rings slid and culled: the last frame starts from tables whose
    # points all reference frames still in the window.
    before = trace.ingests[-1]["before"][0]
    assert (before.ref_frame[before.active] >= 2).all()


# ---------------------------------------------------------------------------
# (b) bitwise the single ingest


BITWISE_CONFIGS = {
    **{name: kw for name, (kw, _) in CONFIGS.items()},
    # BitPlanes (eight channels), a coarser refinement level (the 2x2 mean
    # of the pyramid) and affine normalization (its norm over P).
    "bitplanes-level1-affine": dict(descriptor="BitPlanes",
                                    refinementLevel=1, pyramidLevels=2,
                                    patchNormalization="affine"),
}


def _mixed_images(seqs, i, b):
    """Frame i of b sequences: sequence k's image as uint8 on the frames
    where i + k is even, else float32 (mixed frames whenever b > 1)."""
    out = []
    for k in range(b):
        im = seqs[k][0][i]
        out.append(np.round(im * 255.0).astype(np.uint8) if (i + k) % 2 == 0
                   else im)
    return out


def _assert_bitwise(got, want, where):
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, where + name
        np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                      err_msg=where + name)  # NaN-aware


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("config", sorted(BITWISE_CONFIGS))
def test_batched_ingest_is_bitwise_single_ingests(sequences, config, b):
    cam, seqs = sequences
    cfg = port_config(small_cfg(maxIterations=3, **BITWISE_CONFIGS[config]))
    bpba = BPBA(port_camera(cam), seqs[0][0][0].shape, cfg, b,
                device="cpu")
    proto = bpba._proto
    records = []
    ingest = bpba._ingest

    def traced(window, points, *args):
        out = ingest(window, points, *args)
        records.append(((window, points), args, out))
        return out

    bpba._ingest = traced
    mixed = 0
    for i in range(N_FRAMES):
        images = _mixed_images(seqs, i, b)
        depths = [s[1][i] for s in seqs[:b]]
        t_wcs = [s[2][i] for s in seqs[:b]]
        bpba.add_frames(images, depths, t_wcs)
        (window, points), (_, _, _, frame_id, age_id, count), out = \
            records[-1]
        mixed += len({im.dtype for im in images}) > 1
        for k in range(b):
            image, depth = proto._host_frame(images[k], depths[k])
            want = proto._ingest(
                tbatched._slice(window, k), tbatched._slice(points, k),
                torch.as_tensor(image), torch.as_tensor(depth),
                torch.as_tensor(np.asarray(t_wcs[k], np.float32)),
                frame_id, age_id, count)
            got = [tbatched._slice(tree, k) for tree in out]
            for g, w_ in zip(got, want):
                _assert_bitwise(g, w_, f"frame {i}, sequence {k}: ")
        assert int(out[1].active.sum()) > 0
        # The carried state is contiguous: row k sits where it sits in a
        # stack of k single states.
        assert all(t.is_contiguous() for tree in out for t in tree)
    assert mixed == (N_FRAMES if b > 1 else 0)


# ---------------------------------------------------------------------------
# (c) one pass per frame


def test_add_frames_ingests_in_one_pass(sequences, monkeypatch):
    cam, seqs = sequences
    cfg = port_config(small_cfg())
    b = len(seqs)
    bpba = BPBA(port_camera(cam), seqs[0][0][0].shape, cfg, b, device="cpu")
    calls = {"track": 0, "select": 0, "slice": 0, "stacked": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(ttrack, "track_into_frame",
                        counted("track", ttrack.track_into_frame))
    monkeypatch.setattr(tsel, "select_new_points",
                        counted("select", tsel.select_new_points))
    monkeypatch.setattr(tbatched, "_slice", counted("slice",
                                                    tbatched._slice))
    monkeypatch.setattr(tlm, "stacked", counted("stacked", tlm.stacked))
    # Frames before the window fills: ingest alone, no solve.
    for i in range(cfg.slidingWindowSize - 1):
        assert bpba.add_frames([s[0][i] for s in seqs],
                               [s[1][i] for s in seqs],
                               [s[2][i] for s in seqs]) is None
        assert calls == {"track": i + 1, "select": i + 1, "slice": 0,
                         "stacked": 0}
    assert bpba.points.active.shape == (b, cfg.maxNumPoints)
    assert (bpba.points.active.sum(1) > 20).all()


# ---------------------------------------------------------------------------
# (d) ties


def test_batched_selection_ties_take_the_lower_pixel_first():
    """test_torch_ingest.py's tie test over a batch of three rows, each
    with its own tied peaks: every row takes its three lowest pixel
    indices, and each row's table is bitwise its single selection."""
    from photobundle_torch.geometry.camera import Camera

    cfg = port_config(small_cfg(maxNumPoints=16))
    h, w = 20, 24
    peaks = [[(5, 6), (5, 12), (10, 6), (10, 12), (14, 18)],
             [(14, 18), (10, 12), (6, 15), (6, 9), (12, 4)],
             [(8, 8), (8, 14), (8, 11), (13, 5), (13, 17)]]
    want_xy = [[(6, 5), (12, 5), (6, 10)],
               [(9, 6), (15, 6), (12, 10)],
               [(8, 8), (11, 8), (14, 8)]]
    b = len(peaks)
    sal = torch.zeros((b, h, w))
    for k, row in enumerate(peaks):
        for y, x in row:
            sal[k, y, x] = 0.5 + 0.125 * k      # tied within the row
    cam = Camera.create(50.0, 50.0, 11.5, 9.5)
    pts = tstate.init_point_table(cfg)
    channels = torch.rand((b, 1, h, w), generator=torch.Generator()
                          .manual_seed(0))
    t_wc = torch.eye(4).expand(b, 4, 4).clone()
    t_wc[:, 0, 3] = torch.tensor([0.0, 0.5, -0.25])
    args = dict(max_new=3, nms_radius=1, min_saliency=0.1, mask_radius=1,
                min_depth=0.1, max_depth=30.0, border=3)
    common = (torch.full((h, w), 5.0), torch.ones((h, w), dtype=torch.bool),
              torch.zeros((16, 2)), torch.zeros(16, dtype=torch.bool))
    sel = tsel.select_new_points(
        tstate.PointTable(*(f.expand(b, *f.shape).clone() for f in pts)),
        cam, t_wc, channels, sal,
        *(a.expand(b, *a.shape) for a in common), 7, 0, torch.zeros((1, 2)),
        **args)
    assert sel.num_added.tolist() == [3, 3, 3]
    for k in range(b):
        got = ((sel.points.x_world[k, :3, :2] - t_wc[k, :2, 3]) / 5.0 * 50.0
               + torch.tensor([11.5, 9.5]))
        assert torch.allclose(got, torch.tensor(want_xy[k], dtype=torch.float32),
                              atol=1e-4), k
        assert sel.points.ref_frame[k, :3].tolist() == [7, 7, 7]
        alone = tsel.select_new_points(pts, cam, t_wc[k], channels[k],
                                       sal[k], *common, 7, 0,
                                       torch.zeros((1, 2)), **args)
        _assert_bitwise(tstate.PointTable(*(f[k] for f in sel.points)),
                        alone.points, f"row {k}: ")
