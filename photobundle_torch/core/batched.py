"""Batched multi-sequence engine: B sliding windows on one card.

Twin of photobundle_tpu/core/batched.py (BASELINE config 3, "concurrent
sequence refinement"): B sequences share one camera and one frame clock
(frame i of every sequence is ingested together, so the age clock is the
shared ingest ordinal), and their engines' states, the point tables and
window rings, are stacked along a leading axis.

- Ingest is one pass over the batch axis (the twin of the reference's
  `jax.vmap(_ingest_impl)`): the single engine's `_ingest` runs once on
  the stacked state with the B frames stacked, every step written over
  leading axes (the image and descriptor functions, the ring push, the
  cull, tracking and selection), so its launches and host syncs do not
  grow with B. Each sequence's slice of the result is bitwise the single
  engine's ingest of that sequence: no step mixes rows, and no float
  reduction or 3x3 product rounds by the batch's shape.
- The window solves run as one program: each sequence's `_optimize_plan`
  (core/engine.py: the coarse levels, the fine-cost guard, the
  maxPoseCorrection gate, the reanchor of excluded points) advances in
  lockstep, and each LM solve they ask for is one `lm.lm_solve_batched`
  over all B windows: one start and one body whose every operation
  carries the batch axis (the twin of jax.vmap(_optimize_impl)), two CUDA
  graphs per problem key on a card. The configuration's kernel (K1,
  sorted K1, K2, K3/K5 or K4's row store) launches once per evaluation
  for the whole batch, over its batch axis (csrc/patch_batch.cuh); every
  window keeps its own lam, nu, iteration count, termination and logs,
  and the host reads whether every window has ended once per
  lm.LM_READBACK bodies.
- One batched device-to-host copy returns the B WindowResults.

Every window's results are bitwise those of a single engine fed the same
frames: the single engine's solve is the batch of one of the same body,
whose operations round alike at every B (core/lm.py), each kernel's batch
axis computes each window as its own launch does, and each plan's own
steps are the single engine's. (torch.func.vmap of the single solve, tried
first, rounds its batched reductions and products by B; on the card its
point sets left the single engines' at the fourth window.)

Results are returned when the windows' solves end (cfg.pipelineResults is
not applied, as in the reference's batched engine).

Device meshes: cfg.meshWindows x cfg.meshPoints on an initialized
torch.distributed world of that many ranks (parallel/mesh.py; without one
it raises). Ingest stays replicated (every rank ingests all B
sequences); a 'windows' group solves B / meshWindows windows as one
program, each window's points split over the 'points' group
(parallel/sharded.wrap_batched_optimize), and the results are gathered,
so `add_frames` returns all B results on every rank.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..config import PBAConfig
from ..geometry.camera import Camera
from . import lm
from .engine import (_INV_255, PhotometricBundleAdjustment, WindowResult,
                     _Fetch)


def _slice(tree, b: int):
    """Sequence b's view of a stacked NamedTuple. Its reductions run in
    orders fixed by their lengths (ops/ordered_sum), not by where the
    view starts."""
    return type(tree)(*(f[b] for f in tree))


class BatchedPhotometricBundleAdjustment:
    """B concurrent sliding-window engines on one device.

        bpba = BatchedPhotometricBundleAdjustment(camera, (H, W), cfg, B)
        for i in range(n_frames):
            results = bpba.add_frames(images_B, depths_B, t_init_B)
            for b, r in enumerate(results or []):
                trajectories[b][r.frame_ids] = r.poses

    `device` holds the state and runs every step: the card by default (it
    raises when there is none), device="cpu" for the CPU.
    """

    def __init__(self, camera: Camera, image_shape, cfg: PBAConfig,
                 batch: int, device="cuda"):
        cfg.validate()
        if batch < 1:
            raise ValueError(f"batch must be >= 1, not {batch}")
        if cfg.meshFrames > 1:
            raise ValueError("the batched engine shards over meshWindows "
                             "and meshPoints; meshFrames must be 1")
        mw, mp = cfg.meshWindows, cfg.meshPoints
        sharded_cfg = mw > 1 or mp > 1
        self.batch = batch
        self.cfg = cfg
        # A single engine provides the steps; its own state is unused. It
        # builds no mesh: the ('windows', 'points') wiring is done here.
        self._proto = PhotometricBundleAdjustment(
            camera, image_shape,
            cfg.replace(meshPoints=1, meshWindows=1) if sharded_cfg else cfg,
            device=device)
        self._mesh = None
        self._sharded_optimize = None
        if sharded_cfg:
            from ..parallel import mesh as mesh_mod
            from ..parallel import sharded

            if batch % mw != 0:
                raise ValueError(
                    f"batch {batch} not divisible by meshWindows {mw}")
            self._mesh = mesh_mod.make_mesh(points=mp, windows=mw)
            sharded.check_point_capacity(cfg.maxNumPoints, self._mesh)
            self._sharded_optimize = sharded.wrap_batched_optimize(
                self._optimize, self._mesh)
        self.device = self._proto.device
        self.backend = self._proto.backend
        self.window = lm.stacked([self._proto.window] * batch)
        self.points = lm.stacked([self._proto.points] * batch)
        self._frame_count = 0
        self._ingest_seq = 0
        self._window_count = 0

    def add_frames(self, images, depths, t_wcs, depth_valids=None,
                   frame_id: Optional[int] = None
                   ) -> Optional[List[WindowResult]]:
        """Ingest frame i of every sequence (B images, depths and initial
        poses, as `PhotometricBundleAdjustment.add_frame` takes them);
        returns B WindowResults when the windows are full (they fill in
        lockstep), else None."""
        b = self.batch
        if not len(images) == len(depths) == len(t_wcs) == b:
            raise ValueError(f"add_frames takes {b} images, depths and "
                             f"poses")
        valids = [None] * b if depth_valids is None else depth_valids
        proto = self._proto
        if frame_id is None:
            frame_id = self._frame_count
        self._frame_count = frame_id + 1
        age_id = self._ingest_seq
        self._ingest_seq += 1
        count = self._window_count
        self._window_count = min(count + 1, self.cfg.slidingWindowSize)

        frames = [proto._host_frame(images[k], depths[k], valids[k])
                  for k in range(b)]
        image = self._frame_images([im for im, _ in frames])
        depth = self._put(np.stack([d for _, d in frames]))
        t_wc = self._put(np.stack([np.asarray(t, np.float32) for t in t_wcs]))
        self.window, self.points = self._ingest(
            self.window, self.points, image, depth, t_wc, int(frame_id),
            age_id, count)

        if self._window_count < self.cfg.slidingWindowSize:
            return None
        t0 = time.perf_counter()
        t_pre = self.window.t_wc
        solve = self._sharded_optimize or self._optimize
        self.window, self.points, stats, point_valid = solve(
            self.window, self.points)
        fetched = _Fetch([*stats, self.window.frame_ids, self.window.t_wc,
                          point_valid, self.points.x_world,
                          self.points.ref_frame, t_pre]).result()
        return [proto._make_result([a[k] for a in fetched], t0)
                for k in range(b)]

    def _put(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device, in one copy. A pageable
        copy waits for the stream; staging through pinned memory instead
        made a one-sequence step slower on an H100 (PERF.md, section 6)."""
        return torch.as_tensor(array).to(self.device)

    def _frame_images(self, images) -> torch.Tensor:
        """The B transported images (`_host_frame`'s, each uint8 or f32) as
        one (B, H, W) tensor on the device: uint8 when all are, which
        `_ingest` scales; else f32, the uint8 rows scaled on the device by
        the shared reciprocal as `_ingest` scales them (the f32 rows times
        1, which is exact), so each row is what its single ingest sees."""
        stack = np.stack(images)
        u8 = np.array([im.dtype == np.uint8 for im in images])
        if u8.all() or not u8.any():
            return self._put(stack)
        scale = np.where(u8, np.float32(_INV_255), np.float32(1.0))
        return (self._put(stack.astype(np.float32))
                * self._put(scale.astype(np.float32)[:, None, None]))

    def _ingest(self, window, points, images, depths, t_wcs, frame_id: int,
                age_id: int, count: int):
        """Frame `frame_id` of every sequence, ingested as one pass over
        the batch axis of the stacked state: the single engine's `_ingest`
        on (B, ...) tensors (images and depths (B, H, W), poses (B, 4,
        4)). Returns (window, points); the inputs are not modified."""
        return self._proto._ingest(window, points, images, depths, t_wcs,
                                   frame_id, age_id, count)

    def _optimize(self, window, points, shard_ctx=None):
        """The window solves of the stacked state (its leading axis; a
        mesh's windows group passes its own windows, their point rows, and
        the points context `shard_ctx`): each window's `_optimize_plan`,
        their LM solves batched. Returns the stacked (window, points,
        stats, point_valid); the inputs are not modified."""
        b = window.t_wc.shape[0]
        plans = [self._proto._optimize_plan(_slice(window, k),
                                            _slice(points, k), shard_ctx)
                 for k in range(b)]
        requests = [next(plan) for plan in plans]
        while True:
            t_wc, x_world, stats = lm.lm_solve_batched(requests)
            done, requests = [], []
            for k, plan in enumerate(plans):
                try:
                    requests.append(plan.send(
                        (t_wc[k], x_world[k], _slice(stats, k))))
                except StopIteration as end:
                    done.append(end.value)
            if done:
                # Every window's plan asks for the same solves (one
                # configuration), so all end together. A plan changes its
                # poses and points alone: the rest of the state stays.
                assert len(done) == b and not requests
                windows, pts, stats, valid = zip(*done)
                return (window._replace(
                            t_wc=torch.stack([w.t_wc for w in windows])),
                        points._replace(
                            x_world=torch.stack([q.x_world for q in pts])),
                        lm.stacked(stats), torch.stack(valid))
