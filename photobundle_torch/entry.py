"""Problem generators and solve entry point (twin of __graft_entry__.py).

`make_problem` builds the synthetic smooth-texture window problem of the
JAX package's `_make_problem` from the same numpy draws, so both packages
get identical inputs for one seed. `entry` returns one full window solve
and its arguments.

`make_sequence` renders the textured-sphere scene of the repository's
tests (`tests/synthetic.py`) without jax: a camera track, its images and
ground-truth depths, from the same numpy draws. It takes the image shape,
the intrinsics and a texture scale, so the same scene can be rendered at
KITTI's size and focal length; `drift_poses` gives a VO-like drifted
initialization of the track. `write_kitti_sequence` writes the same scene,
seen by a stereo pair, as a KITTI-format sequence on disk (the layout
`io/kitti.py` reads).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .core import lm
from .core.engine import require_device
from .geometry import camera as cam_mod
from .geometry import se3
from .image import interp, patches
from .io import png


def make_problem(n_pts: int, w: int, h: int, wi: int, patch_radius: int,
                 seed: int = 0, device="cpu"):
    """Synthetic smooth-texture BA problem.

    Returns (cam, offsets, (t_wc, x_world, patch, channels, grads, obs,
    point_valid, frozen)) on `device`: W frames of H x Wi single-channel
    images, N points seen in every frame, the first two poses frozen."""
    rng = np.random.default_rng(seed)
    cam = cam_mod.Camera.create(fx=0.7 * wi, fy=0.7 * wi, cx=wi / 2 - 0.5,
                                cy=h / 2 - 0.5, baseline=0.5, device=device)
    # Smooth random images (pixel-domain sinusoids).
    ys, xs = np.meshgrid(np.arange(h), np.arange(wi), indexing="ij")
    imgs = []
    for f in range(w):
        img = np.zeros((h, wi), np.float32)
        r2 = np.random.default_rng(seed + 100)
        for _ in range(24):
            fx_ = r2.uniform(0.02, 0.4)
            fy_ = r2.uniform(0.02, 0.4)
            ph = r2.uniform(0, 6.28) + 0.05 * f
            img += np.sin(fx_ * xs + fy_ * ys + ph).astype(np.float32)
        imgs.append(0.5 + img / 24.0)
    channels = torch.as_tensor(np.stack(imgs), device=device)[:, None]
    gx, gy = interp.image_gradients(channels)
    grads = torch.stack([gx, gy], dim=-1)

    offsets = patches.patch_offsets(patch_radius, device=device)
    uv = rng.uniform([12, 12], [wi - 12, h - 12],
                     size=(n_pts, 2)).astype(np.float32)
    z = rng.uniform(4.0, 30.0, size=(n_pts,)).astype(np.float32)
    x_world = cam_mod.backproject(cam, torch.as_tensor(uv, device=device),
                                  torch.as_tensor(z, device=device))
    # frame 0 at identity: camera and world coordinates coincide

    patch, _ = patches.extract_patches(channels[0],
                                       torch.as_tensor(uv, device=device),
                                       offsets)
    patch = patches.mean_normalize(patch)

    xi = rng.standard_normal((w, 6)).astype(np.float32) * 0.01
    xi[0] = 0
    t_wc = se3.se3_exp(torch.as_tensor(xi, device=device))
    obs = torch.ones((n_pts, w), dtype=torch.bool, device=device)
    frozen = torch.tensor([True, True] + [False] * (w - 2), device=device)
    point_valid = torch.ones((n_pts,), dtype=torch.bool, device=device)
    return cam, offsets, (t_wc, x_world, patch, channels, grads, obs,
                          point_valid, frozen)


def entry(device="cuda"):
    """(fn, example_args): one full BA window solve on `device`, through
    the fused kernel (backend 'cuda'; its plain version on the CPU). Runs
    on the card unless device='cpu' is asked for; raises when there is no
    card."""
    cam, offsets, args = make_problem(2048, 5, 192, 320, patch_radius=2,
                                      device=require_device(device))

    def ba_solve_step(t_wc, x_world, patch, channels, grads, obs,
                      point_valid, frozen):
        return lm.lm_solve(
            cam, t_wc, x_world, patch, channels, grads, obs,
            point_valid, frozen, offsets,
            huber_delta=0.05, gradient_mode="sampled", backend="cuda",
            max_iterations=10,
        )

    return ba_solve_step, args


SPHERE_C = np.array([0.0, 0.0, 10.0])
SPHERE_R = 6.0


def make_texture(rng, n_waves=64, min_wavelength=0.4, max_wavelength=2.5):
    """Smooth analytic 3D texture: a random mixture of 3D sinusoids.
    Returns (freqs (K, 3), phases (K,), amps (K,)) in f64."""
    wl = rng.uniform(min_wavelength, max_wavelength, size=n_waves)
    d = rng.standard_normal((n_waves, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    freqs = (2 * np.pi / wl)[:, None] * d
    phases = rng.uniform(0, 2 * np.pi, size=n_waves)
    amps = rng.uniform(0.3, 1.0, size=n_waves) / np.sqrt(n_waves)
    return freqs, phases, amps


def sample_texture3d(tex, pts):
    """World points (..., 3) -> texture value in ~[0, 1], f32."""
    freqs, phases, amps = tex
    phase = np.asarray(pts, np.float64) @ freqs.T + phases   # (..., K)
    return (0.5 + 0.5 * np.tanh(np.sin(phase) @ amps)).astype(np.float32)


def render_view(tex, intrinsics, t_wc: np.ndarray, shape,
                mark_misses: bool = False):
    """Image + ground-truth z-depth of the sphere seen from pose t_wc
    (4x4), by exact ray-sphere intersection (front surface).
    intrinsics = (fx, fy, cx, cy). A ray that misses the sphere sees the
    texture at its closest approach; its depth is that point's, as in
    tests/synthetic.py, or with `mark_misses` 0 (invalid: no surface, as
    a stereo matcher finds none), which a field of view wider than the
    sphere needs so that no point is seeded off it."""
    h, w = shape
    fx, fy, cx, cy = intrinsics
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    d_cam = np.stack([(xs - cx) / fx, (ys - cy) / fy,
                      np.ones_like(xs, np.float64)], axis=-1)
    r = t_wc[:3, :3].astype(np.float64)
    o = t_wc[:3, 3].astype(np.float64)
    d_world = d_cam @ r.T                       # (H, W, 3), unnormalized
    oc = o - SPHERE_C
    a = (d_world ** 2).sum(-1)
    b = 2.0 * (d_world @ oc)
    c = oc @ oc - SPHERE_R ** 2
    disc = b * b - 4 * a * c
    t = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a)  # front intersection
    img = sample_texture3d(tex, o + t[..., None] * d_world)
    depth = t * d_cam[..., 2]
    if mark_misses:
        depth = np.where(disc >= 0, depth, 0.0)
    return img, depth.astype(np.float32)


def _each_view(fn, items) -> list:
    """[fn(item) for item in items], the items in threads: rendering and
    PNG encoding are numpy and zlib work that releases the GIL, and each
    result is the loop's."""
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(fn, items))


def _se3_exp_np(xi: np.ndarray) -> np.ndarray:
    return se3.se3_exp(torch.as_tensor(xi)).numpy()


def _track(rng, n_frames, motion_scale, rot_scale):
    """The camera track: world-from-camera poses (n_frames, 4, 4) f32."""
    poses = []
    t_wc = np.eye(4, dtype=np.float32)
    for _ in range(n_frames):
        poses.append(t_wc.copy())
        xi = np.concatenate([
            rng.standard_normal(3) * motion_scale
            + np.array([motion_scale, 0, 0]),
            rng.standard_normal(3) * rot_scale,
        ]).astype(np.float32)
        t_wc = (t_wc @ _se3_exp_np(xi)).astype(np.float32)
    return np.stack(poses)


def make_sequence(rng, n_frames=6, shape=(96, 144), motion_scale=0.1,
                  rot_scale=0.002, fx=100.0, fy=None, cx=None, cy=None,
                  baseline=0.2, texture_scale=1.0, mark_misses=False):
    """Ground-truth camera track + rendered frames of the textured sphere.

    Returns (cam, images, depths, poses_gt) with cam a CPU `Camera` and
    world-from-camera poses. The principal point defaults to the image
    centre. `texture_scale` multiplies the texture's wavelengths: at
    fx = 100 the default features span ~10-80 px, and 100 / fx keeps that
    pixel size at another focal length. `mark_misses` gives rays past the
    sphere depth 0 (see `render_view`)."""
    h, w = shape
    fy = fx if fy is None else fy
    cx = w / 2 - 0.5 if cx is None else cx
    cy = h / 2 - 0.5 if cy is None else cy
    cam = cam_mod.Camera.create(fx=fx, fy=fy, cx=cx, cy=cy,
                                baseline=baseline)
    tex = make_texture(rng, min_wavelength=0.4 * texture_scale,
                       max_wavelength=2.5 * texture_scale)
    intrinsics = tuple(float(v) for v in cam[:4])
    poses = _track(rng, n_frames, motion_scale, rot_scale)
    images, depths = zip(*_each_view(
        lambda t_wc: render_view(tex, intrinsics, t_wc, shape, mark_misses),
        poses))
    return cam, list(images), list(depths), poses


def write_kitti_sequence(root: str, rng, n_frames=12, shape=(96, 144),
                         motion_scale=0.1, rot_scale=0.002, fx=100.0,
                         cx=None, cy=None, baseline=0.2, texture_scale=1.0,
                         mark_misses=False, sequence: int = 0):
    """`make_sequence`'s scene (the same draws of `rng`) seen by a stereo
    pair, written as a KITTI odometry sequence under `root`: left and
    right 8-bit PNGs (the right camera is the left one moved by
    R [baseline, 0, 0]), calib.txt (P0, P1), times.txt (10 Hz) and the
    ground-truth track in poses/<NN>.txt. Returns (cam, poses_gt)."""
    h, w = shape
    cx = w / 2 - 0.5 if cx is None else cx
    cy = h / 2 - 0.5 if cy is None else cy
    cam = cam_mod.Camera.create(fx=fx, fy=fx, cx=cx, cy=cy,
                                baseline=baseline)
    tex = make_texture(rng, min_wavelength=0.4 * texture_scale,
                       max_wavelength=2.5 * texture_scale)
    intrinsics = tuple(float(v) for v in cam[:4])
    poses = _track(rng, n_frames, motion_scale, rot_scale)
    seq = os.path.join(root, "sequences", f"{sequence:02d}")
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(seq, sub), exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    views = []
    for i, t_wc in enumerate(poses):
        t_right = t_wc.copy()
        t_right[:3, 3] = t_wc[:3, 3] + t_wc[:3, :3] @ np.array(
            [baseline, 0.0, 0.0], np.float32)
        views += [(os.path.join(seq, sub, f"{i:06d}.png"), pose)
                  for sub, pose in (("image_0", t_wc), ("image_1", t_right))]

    def write(view):
        img, _ = render_view(tex, intrinsics, view[1], shape, mark_misses)
        png.write_png_gray(view[0],
                           np.clip(img * 255, 0, 255).astype(np.uint8))

    _each_view(write, views)
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        f.write(f"P0: {fx} 0 {cx} 0 0 {fx} {cy} 0 0 0 1 0\n")
        f.write(f"P1: {fx} 0 {cx} {-fx * baseline} 0 {fx} {cy} 0 0 0 1 0\n")
    with open(os.path.join(seq, "times.txt"), "w") as f:
        f.writelines(f"{i * 0.1:.6f}\n" for i in range(n_frames))
    write_poses(os.path.join(root, "poses", f"{sequence:02d}.txt"), poses)
    return cam, poses


def write_poses(path: str, poses) -> None:
    """Poses (n, 4, 4) as a KITTI pose file (3x4 row-major rows)."""
    with open(path, "w") as f:
        for p in poses:
            f.write(" ".join(f"{v:.9f}" for v in p[:3].reshape(-1)) + "\n")


def drift_poses(rng, poses, trans_sigma=0.01, rot_sigma=0.002, keep_first=1):
    """VO-like error: a random-walk drift composed into the trajectory, so
    each frame's relative motion carries a small error that accumulates."""
    out = poses.copy()
    err = np.eye(4, dtype=np.float64)
    for i in range(keep_first, len(poses)):
        xi = np.concatenate([
            rng.standard_normal(3) * trans_sigma,
            rng.standard_normal(3) * rot_sigma,
        ]).astype(np.float32)
        err = err @ _se3_exp_np(xi).astype(np.float64)
        out[i] = (err @ poses[i].astype(np.float64)).astype(poses.dtype)
    return out
