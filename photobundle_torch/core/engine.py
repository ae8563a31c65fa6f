"""PhotometricBundleAdjustment — the sliding-window engine.

Twin of photobundle_tpu/core/engine.py on one device: `add_frame(image,
depth, T_wc)` ingests a frame (descriptor build, window push, tracking,
culling, selection) and, once the window is full, runs the LM + Schur
solve (after coarse pyramid levels with cfg.coarseToFine) and returns the
refined window poses.

All state (point table, window ring) is a tuple of fixed-shape tensors on
the engine's device. The host keeps mirrors of the few counters the
control flow branches on (frame count, ingest ordinal, window fill), so
ingest reads nothing back from the device. A solve reads its termination
code once per LM iteration (core/lm.py) and, at its end, fetches the
window result in one batched device-to-host copy; with
cfg.pipelineResults that copy runs behind the next frame's work and the
result arrives one frame late. `save_state` / `load_state` snapshot the
whole state for a bitwise-exact resume.

Not ported yet (raises NotImplementedError; ROADMAP.md queue 1 item 13):
device meshes (meshPoints / meshFrames > 1).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..config import PBAConfig
from ..geometry import se3
from ..geometry.camera import Camera
from ..geometry import camera as cam_mod
from ..image import descriptor as descriptor_mod
from ..image import interp
from ..image import patches as patches_mod
from ..image import pyramid as pyramid_mod
from . import lm, residuals, selection, state, tracking

# The shared f32 reciprocal of the 8-bit image scale. Images are normalized
# by multiplying with it, never by dividing by 255: a one-ulp difference
# between two normalizations reorders saliency ties and so the selection.
_INV_255 = float(np.float32(1.0 / 255.0))


@dataclass
class WindowResult:
    """Per-window solve record (the JAX package's `WindowResult`)."""

    frame_ids: np.ndarray          # (W,) global frame ids in the window
    poses: np.ndarray              # (W, 4, 4) refined world-from-camera
    initial_cost: float = 0.0
    final_cost: float = 0.0
    iterations: int = 0
    accepted_steps: int = 0
    termination: str = ""
    num_points: int = 0
    num_residuals: int = 0
    cost_log: np.ndarray = field(default_factory=lambda: np.zeros(0))
    lambda_log: np.ndarray = field(default_factory=lambda: np.zeros(0))
    step_log: np.ndarray = field(default_factory=lambda: np.zeros(0))
    accept_log: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))
    solve_time_s: float = 0.0
    # Refined points that took part in this solve: (M, 3) world positions
    # and their reference frame ids.
    points_xyz: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    points_frame: np.ndarray = field(default_factory=lambda: np.zeros(0, int))
    # How far the solve moved each window pose, and how many observations
    # supported each slot.
    trans_correction: np.ndarray = field(default_factory=lambda: np.zeros(0))
    rot_correction: np.ndarray = field(default_factory=lambda: np.zeros(0))
    obs_per_frame: np.ndarray = field(default_factory=lambda: np.zeros(0, int))

    def message(self) -> str:
        return (
            f"window {self.frame_ids.tolist()}: cost {self.initial_cost:.6g} -> "
            f"{self.final_cost:.6g} in {self.iterations} iters "
            f"({self.accepted_steps} accepted), {self.num_points} pts / "
            f"{self.num_residuals} obs, {self.termination}"
        )


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to photobundle_torch yet (ROADMAP.md {item}); "
        f"run it with photobundle_tpu")


def require_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device must exist (no quiet
    fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("photobundle_torch runs on a CUDA card by "
                           "default and this machine has none; pass "
                           "device='cpu' to run on the CPU")
    return device


class _Fetch:
    """Device -> host in ONE copy: every tensor is flattened into one f64
    buffer (exact for f32, int32 and bool) and split again on the host.

    The buffer is a snapshot taken when the fetch is created (the
    concatenation copies on the device, in stream order), so later work,
    such as the next frame's ingest, cannot change what it returns. From a
    card the copy goes to pinned memory without blocking and `result()`
    waits for it alone (a CUDA event)."""

    def __init__(self, tensors):
        self._specs = [(tuple(t.shape), t.dtype) for t in tensors]
        flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
        self._event = None
        if flat.device.type == "cuda":
            self._host = torch.empty(flat.shape, dtype=flat.dtype,
                                     pin_memory=True)
            self._host.copy_(flat, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = flat

    def result(self):
        if self._event is not None:
            self._event.synchronize()
        host = self._host.numpy()
        out, at = [], 0
        for shape, dtype in self._specs:
            k = int(np.prod(shape, dtype=np.int64))
            np_dtype = {torch.bool: bool, torch.int32: np.int32,
                        torch.int64: np.int64}.get(dtype, np.float32)
            out.append(host[at:at + k].reshape(shape).astype(np_dtype))
            at += k
        return out


class PhotometricBundleAdjustment:
    """Sliding-window photometric BA engine.

        pba = PhotometricBundleAdjustment(camera, (H, W), cfg)
        for i, (image, depth, t_init) in enumerate(frames):
            result = pba.add_frame(image, depth, t_init)
            if result is not None:
                trajectory[result.frame_ids] = result.poses

    `camera` is the full-resolution `Camera`; `device` holds the state and
    runs every step: the card by default (it raises when there is none),
    device="cpu" for the CPU. The solver backend is
    `cfg.resolve_backend(device)`: the hand-written kernels on a card, the
    gather path elsewhere.
    """

    def __init__(self, camera: Camera, image_shape, cfg: PBAConfig,
                 device="cuda"):
        cfg.validate()
        self.cfg = cfg
        self.device = require_device(device)
        if cfg.meshPoints > 1 or cfg.meshFrames > 1:
            raise _not_ported("meshPoints / meshFrames > 1 (device meshes)",
                              "queue 1 item 13, multi-GPU")
        self.backend = cfg.resolve_backend(self.device)
        self.camera_full = camera.to(self.device)
        lvl = cfg.refinementLevel
        self.level_scale = 0.5 ** lvl
        self.camera = (self.camera_full.scaled(self.level_scale) if lvl > 0
                       else self.camera_full)
        h, w = image_shape
        self.image_shape = (h, w)
        self.level_shape = (h // (2 ** lvl), w // (2 ** lvl))
        # Coarse-to-fine schedule: the number of coarse levels solved
        # before the refinement-level solve (levels refinementLevel + k,
        # coarsest first), clamped so the coarsest image keeps >= 24 px on
        # both axes.
        self._n_coarse = 0
        if cfg.coarseToFine:
            k = cfg.pyramidLevels - cfg.refinementLevel - 1
            while k > 0 and min(self.level_shape[0] >> k,
                                self.level_shape[1] >> k) < 24:
                k -= 1
            self._n_coarse = k
        self.offsets = patches_mod.patch_offsets(cfg.patchRadius,
                                                 device=self.device)

        # Depth-prior scale in disparity-pixel units; monocular (baseline 0)
        # falls back to an fx * 0.3 m virtual baseline.
        fx, baseline = float(self.camera.fx), float(self.camera.baseline)
        self._prior_scale = cfg.depthPriorWeight * max(fx * baseline, 0.3 * fx)

        self.window = state.init_window(cfg, self.level_shape, self.device)
        self.points = state.init_point_table(cfg, self.device)
        self._frame_count = 0
        self._ingest_seq = 0    # ingested-frame ordinal: the age clock
        self._window_count = 0  # host mirror of window.count
        self._pending = None    # (fetch, t0) under pipelineResults

    # ------------------------------------------------------------------ #
    # device steps
    # ------------------------------------------------------------------ #
    def _prepare_level(self, image, depth, depth_ok):
        """Full-res image -> descriptor channels/grads/saliency + depth at
        the refinement level. Only the levels down to it are built."""
        cfg = self.cfg
        img_l = pyramid_mod.build_pyramid(image, cfg.refinementLevel + 1)[-1]
        lvl = descriptor_mod.build_descriptor_level(
            img_l, cfg.descriptor, cfg.sigmaPriorToCensusTransform,
            cfg.sigmaBitPlanes, cfg.gradientSigma)
        s = 2 ** cfg.refinementLevel
        return lvl, depth[::s, ::s], depth_ok[::s, ::s]

    def _ingest(self, window, points, image, depth, t_wc, frame_id: int,
                age_id: int, count: int):
        """Push the frame, cull, track and select. `count` is the window
        fill before the push (the host mirror). Returns (window, points);
        the inputs are not modified."""
        cfg = self.cfg
        if image.dtype == torch.uint8:
            image = image.to(torch.float32) * _INV_255
        depth = depth.to(torch.float32)
        depth_ok = depth > 0
        lvl, depth_l, ok_l = self._prepare_level(image, depth, depth_ok)
        window, points = state.push_frame(
            window, lvl.channels, lvl.grads, lvl.saliency, t_wc, frame_id,
            depth_l, ok_l, points, count)
        points = state.cull_points(points, window.frame_ids[0])
        slot = min(count + 1, window.size) - 1

        tr = tracking.track_into_frame(
            points, self.camera, t_wc, lvl.channels, frame_id, slot,
            self.offsets,
            min_score=cfg.minScore,
            max_frame_distance=cfg.maxFrameDistance,
            age_id=age_id,
            border_margin=cfg.patchRadius + 1,
            depth_new=depth_l,
            depth_ok_new=ok_l,
            occlusion_threshold=cfg.occlusionThreshold,
        )
        sel = selection.select_new_points(
            tr.points, self.camera, t_wc, lvl.channels, lvl.saliency,
            depth_l, ok_l, tr.uv, tr.tracked, frame_id, slot, self.offsets,
            max_new=cfg.maxPointsPerFrame,
            nms_radius=cfg.nonMaxSuppRadius,
            min_saliency=cfg.minSaliency,
            mask_radius=cfg.maskBlockRadius,
            min_depth=cfg.minDepth,
            max_depth=cfg.maxDepth,
            border=cfg.patchRadius + 2,
            edge_radius=cfg.patchRadius,
            edge_threshold=cfg.depthEdgeThreshold,
            normalize=cfg.resolve_normalization(),
            age_id=age_id,
        )
        return window, sel.points

    def solve_terms(self, window, points):
        """The per-point terms of a window solve: (point_valid, ref_slot,
        depth_prior, patch_warp), as `lm.lm_solve` takes them. A point
        takes part when it is active with >= 2 window observations;
        ref_slot is its reference frame's window slot, -1 when that frame
        has left the window."""
        cfg = self.cfg
        n_obs = torch.sum(points.obs, dim=1)
        point_valid = points.active & (n_obs >= 2)
        same = points.ref_frame[:, None] == window.frame_ids[None, :]
        ref_slot = torch.argmax(same.to(torch.int32), dim=1).to(torch.int32)
        ref_slot = torch.where(same.any(dim=1), ref_slot, -1)
        depth_prior = ((ref_slot, points.inv_depth_seed, self._prior_scale)
                       if cfg.depthPriorWeight > 0 else None)
        # The warp takes the depth prior's ref_slot tensor itself: every
        # consumer of reference slots in one solve must see the same slots.
        warp = cfg.resolve_patch_warp()
        patch_warp = (warp, ref_slot) if warp is not None else None
        return point_valid, ref_slot, depth_prior, patch_warp

    def _coarse_level(self, k: int, window, t_wc, x_world, ref_slot,
                      point_valid):
        """Coarse level k of the schedule, derived from the window: the
        channels blurred and decimated k times (build_pyramid's kernel),
        their gradients, the camera scaled by 0.5**k, and each point's
        reference descriptor re-extracted from its reference frame's
        coarse image at its current projection (t_wc, x_world). Returns
        (camera, patch, channels, grads, point_valid) of the level."""
        cfg = self.cfg
        ch = window.channels
        for _ in range(k):
            ch = pyramid_mod.downsample2(pyramid_mod.gaussian_blur5(ch))
        src = (pyramid_mod.gaussian_blur_sigma(ch, cfg.gradientSigma)
               if cfg.gradientSigma > 0 else ch)
        gx, gy = interp.image_gradients(src)
        cam = self.camera.scaled(0.5 ** k)
        found, ok = [], []
        for f in range(window.size):
            t_cw = se3.se3_inverse(t_wc[f])
            uv, in_front = cam_mod.project(
                cam, x_world @ t_cw[:3, :3].T + t_cw[:3, 3])
            p, inside = patches_mod.extract_patches(ch[f], uv, self.offsets)
            found.append(p)
            ok.append(inside & in_front)
        slot = torch.clamp(ref_slot, min=0).long()
        pts = torch.arange(slot.shape[0], device=slot.device)
        patch = patches_mod.normalize_patches(torch.stack(found)[slot, pts],
                                              cfg.resolve_normalization())
        valid = point_valid & torch.stack(ok)[slot, pts] & (ref_slot >= 0)
        return cam, patch, ch, torch.stack([gx, gy], dim=-1), valid

    def _optimize(self, window, points):
        """One full window solve: the coarse levels of the schedule (each
        warm-starting the next), the fine-cost guard, then the solve at the
        refinement level on the stored descriptors. Returns (window,
        points, stats, point_valid), stats of the last level; the inputs
        are not modified."""
        cfg = self.cfg
        w = cfg.slidingWindowSize
        dev = self.device
        frozen = torch.arange(w, device=dev) < cfg.numFixedPoses
        point_valid, ref_slot, depth_prior, patch_warp = self.solve_terms(
            window, points)
        pose_prior = ((window.t_vo, cfg.posePriorWeight,
                       cfg.posePriorRotWeight)
                      if (cfg.posePriorWeight > 0
                          or cfg.posePriorRotWeight > 0) else None)
        # Motion-prior anchor: the initialization's relative poses, shared
        # by every level of the schedule.
        anchor = (se3.se3_inverse(window.t_wc[:-1]) @ window.t_wc[1:]
                  if cfg.motionPriorWeight > 0 else None)
        gradient_mode = cfg.resolve_gradient_mode()
        normalize = cfg.resolve_normalization()

        def solve(cam, prior_scale, max_iterations, t_wc, x_world, patch,
                  channels, grads, valid):
            prior = ((ref_slot, points.inv_depth_seed, prior_scale)
                     if cfg.depthPriorWeight > 0 else None)
            return lm.lm_solve(
                cam, t_wc, x_world, patch, channels, grads, points.obs,
                valid, frozen, self.offsets,
                huber_delta=cfg.robustThreshold,
                robust_kind=cfg.robustLoss,
                gradient_mode=gradient_mode,
                backend=self.backend,
                normalize=normalize,
                depth_prior=prior,
                patch_warp=patch_warp,
                motion_prior_weight=cfg.motionPriorWeight,
                motion_prior_anchor=anchor,
                pose_prior=pose_prior,
                max_iterations=max_iterations,
                initial_lambda=cfg.initialLambda,
                min_lambda=cfg.minLambda,
                max_lambda=cfg.maxLambda,
                function_tolerance=cfg.functionTolerance,
                parameter_tolerance=cfg.parameterTolerance,
                gradient_tolerance=cfg.gradientTolerance,
                min_obs_per_frame=cfg.minObsPerFrame,
            )

        # Coarse-to-fine warm start, coarsest level first. Poses and points
        # are world-frame: each level's result seeds the next as it is.
        t_cur, x_cur = window.t_wc, points.x_world
        for k in range(self._n_coarse, 0, -1):
            cam, patch, channels, grads, valid = self._coarse_level(
                k, window, t_cur, x_cur, ref_slot, point_valid)
            t_cur, x_cur, _ = solve(cam, self._prior_scale * 0.5 ** k,
                                    cfg.coarseIterations, t_cur, x_cur,
                                    patch, channels, grads, valid)
        if self._n_coarse > 0:
            # Guard: a coarse level optimizes its own objective and can
            # walk the fine one up (few or fresh points). Keep the warm
            # start only if it lowers the full fine-level objective, prior
            # terms included; both evaluations share one sampling ctx.
            ctx = (residuals.make_cuda_ctx(window.channels, window.grads,
                                           gradient_mode)
                   if self.backend == "cuda" else None)

            def fine_cost(t_wc, x_world):
                warp = None
                if patch_warp is not None:
                    warp = (patch_warp[0], *residuals.patch_warp_ref_geometry(
                        t_wc, x_world, ref_slot))
                res = residuals.evaluate_compressed(
                    self.camera, t_wc, x_world, points.patch,
                    window.channels, window.grads,
                    points.obs & point_valid[:, None], self.offsets,
                    cfg.robustThreshold, gradient_mode,
                    depth_prior=depth_prior, backend=self.backend, ctx=ctx,
                    normalize=normalize, robust_kind=cfg.robustLoss,
                    patch_warp=warp)
                return res.cost + lm.prior_cost(
                    t_wc, motion_prior_weight=cfg.motionPriorWeight,
                    rel0=anchor, pose_prior=pose_prior)

            use_warm = (fine_cost(t_cur, x_cur)
                        < fine_cost(window.t_wc, points.x_world))
            t_cur = torch.where(use_warm, t_cur, window.t_wc)
            x_cur = torch.where(use_warm, x_cur, points.x_world)

        t_wc, x_world, stats = solve(self.camera, self._prior_scale,
                                     cfg.maxIterations, t_cur, x_cur,
                                     points.patch, window.channels,
                                     window.grads, point_valid)
        # Window trust gate: a solve that moved any pose implausibly far
        # is rejected whole and the VO initialization kept. The coarse
        # levels exist to allow larger corrections: the gate scales by 2^k.
        if cfg.maxPoseCorrection > 0:
            gate = cfg.maxPoseCorrection * float(2 ** self._n_coarse)
            corr = torch.linalg.norm(t_wc[:, :3, 3] - window.t_wc[:, :3, 3],
                                     dim=-1)
            sane = torch.max(corr) <= gate
            t_wc = torch.where(sane, t_wc, window.t_wc)
            x_world = torch.where(sane, x_world, points.x_world)

        # Points left out of the solve were positioned with their reference
        # frame's pre-solve pose: move them rigidly with that frame
        # (X <- T_new T_old^{-1} X) so they stay consistent.
        delta = t_wc @ se3.se3_inverse(window.t_wc)           # (W, 4, 4)
        moved = se3.transform_points(delta[torch.clamp(ref_slot, min=0)],
                                     x_world)
        reanchor = points.active & ~point_valid & (ref_slot >= 0)
        x_world = torch.where(reanchor[:, None], moved, x_world)
        return (window._replace(t_wc=t_wc), points._replace(x_world=x_world),
                stats, point_valid)

    # ------------------------------------------------------------------ #
    # host API
    # ------------------------------------------------------------------ #
    def add_frame(self, image: np.ndarray, depth: np.ndarray,
                  t_wc: np.ndarray, depth_valid: Optional[np.ndarray] = None,
                  frame_id: Optional[int] = None) -> Optional[WindowResult]:
        """Ingest one frame; returns a WindowResult when a solve ran.

        image: (H, W) grayscale, any scale (normalized to [0, 1] internally).
        depth: (H, W) metric depth; <= 0 marks invalid.
        t_wc:  (4, 4) initial world-from-camera pose (e.g. from VO).
        frame_id: global frame index (defaults to an internal counter).
        """
        # Host -> device transport: 8-bit images travel as uint8 (cfg
        # transportCompress), validity rides inside depth (invalid = 0).
        image = np.asarray(image)
        if image.dtype != np.uint8:
            image = np.asarray(image, np.float32)
            if image.max() > 2.0:  # 8-bit-scaled input
                image = image * np.float32(1.0 / 255.0)
            if self.cfg.transportCompress:
                s = image * 255.0
                r = np.rint(s)
                if np.abs(s - r).max() < 1e-3:  # exactly 8-bit data
                    image = r.astype(np.uint8)
        depth = np.asarray(depth, np.float32)
        if depth_valid is not None:
            depth = np.where(depth_valid, depth, 0.0)
        if self.cfg.transportDepth16:
            depth = depth.astype(np.float16)
        if frame_id is None:
            frame_id = self._frame_count
        self._frame_count = frame_id + 1
        age_id = self._ingest_seq
        self._ingest_seq += 1
        count = self._window_count
        self._window_count = min(count + 1, self.cfg.slidingWindowSize)

        put = lambda a: torch.as_tensor(a).to(self.device)  # noqa: E731
        self.window, self.points = self._ingest(
            self.window, self.points, put(image), put(depth),
            put(np.asarray(t_wc, np.float32)), int(frame_id), age_id, count)

        if self._window_count < self.cfg.slidingWindowSize:
            return None

        t0 = time.perf_counter()
        t_pre = self.window.t_wc
        self.window, self.points, stats, point_valid = self._optimize(
            self.window, self.points)
        # ONE batched device fetch per window. Under cfg.pipelineResults it
        # runs behind the next frame's work: this call returns the previous
        # window's result (results lag one frame; frame_ids stay exact).
        fetch = _Fetch([*stats, self.window.frame_ids, self.window.t_wc,
                        point_valid, self.points.x_world,
                        self.points.ref_frame, t_pre])
        if not self.cfg.pipelineResults:
            return self._make_result(fetch.result(), t0)
        prev, self._pending = self._pending, (fetch, t0)
        return None if prev is None else self._make_result(prev[0].result(),
                                                           prev[1])

    def flush_result(self) -> Optional[WindowResult]:
        """The window result still in flight under pipelineResults (None
        if there is none): call once after the frame loop so the last
        window is not lost."""
        if self._pending is None:
            return None
        (fetch, t0), self._pending = self._pending, None
        return self._make_result(fetch.result(), t0)

    def _make_result(self, fetched, t0: float) -> WindowResult:
        """A WindowResult from a window fetch; its solve time runs from
        `t0` (the solve's start) to now."""
        k = len(lm.LMStats._fields)
        stats = lm.LMStats(*fetched[:k])
        frame_ids, poses, pv, xw, rf, t_pre = fetched[k:]
        dt = time.perf_counter() - t0
        it = int(stats.iterations)
        dtc = poses[:, :3, 3] - t_pre[:, :3, 3]
        # Rotation correction angle from the relative rotation's trace.
        rrel = np.einsum("wij,wik->wjk", t_pre[:, :3, :3], poses[:, :3, :3])
        ctheta = np.clip((np.trace(rrel, axis1=1, axis2=2) - 1.0) / 2.0,
                         -1.0, 1.0)
        return WindowResult(
            frame_ids=frame_ids,
            poses=poses,
            initial_cost=float(stats.initial_cost),
            final_cost=float(stats.final_cost),
            iterations=it,
            accepted_steps=int(stats.accepted_steps),
            termination=lm.TERMINATION_NAMES.get(int(stats.termination), "?"),
            num_points=int(pv.sum()),
            num_residuals=int(stats.n_residuals),
            cost_log=stats.cost_log[:it],
            lambda_log=stats.lambda_log[:it],
            step_log=stats.step_log[:it],
            accept_log=stats.accept_log[:it],
            solve_time_s=dt,
            points_xyz=xw[pv],
            points_frame=rf[pv],
            trans_correction=np.linalg.norm(dtc, axis=-1),
            rot_correction=np.arccos(ctheta),
            obs_per_frame=stats.obs_per_frame,
        )

    @property
    def num_active_points(self) -> int:
        return int(self.points.num_active())

    def save_state(self, path: str) -> None:
        """Write the whole engine state (point table, window ring, frame
        and ingest counters) to one npz under the JAX package's key names
        (`points.<field>`, `window.<field>`, `frame_count`, `ingest_seq`).
        Written to a temporary file and renamed, so a reader never sees a
        partial snapshot."""
        state_np = {f"points.{k}": v.cpu().numpy()
                    for k, v in self.points._asdict().items()}
        state_np.update({f"window.{k}": v.cpu().numpy()
                         for k, v in self.window._asdict().items()})
        state_np["frame_count"] = np.asarray(self._frame_count)
        state_np["ingest_seq"] = np.asarray(self._ingest_seq)
        tmp = path + ".tmp.npz"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **state_np)
        os.replace(tmp, path)

    def load_state(self, path: str) -> None:
        """Restore a `save_state` snapshot (its shapes must match this
        engine's configuration); the engine then continues exactly as the
        one that wrote it."""
        with np.load(path) as data:
            def field(name, like):
                arr = data[name]
                if arr.shape != tuple(like.shape):
                    raise ValueError(f"snapshot {path}: {name} has shape "
                                     f"{arr.shape}, this engine "
                                     f"{tuple(like.shape)}")
                return torch.as_tensor(arr).to(self.device, like.dtype)

            self.points = type(self.points)(*(
                field(f"points.{k}", v)
                for k, v in self.points._asdict().items()))
            self.window = type(self.window)(*(
                field(f"window.{k}", v)
                for k, v in self.window._asdict().items()))
            self._frame_count = int(data["frame_count"])
            self._ingest_seq = int(data["ingest_seq"])
        self._window_count = int(self.window.count)
