"""The KITTI-scale synthetic golden: a textured box room.

Twin of the golden half of tests/synthetic.py. A large box room (ground,
four walls, a "sky" plane) with textured obstacles beside a seq-00-style
block loop, rendered by exact ray-plane and ray-box intersection and the
closed-form 3D texture of `entry.make_texture`, so any trajectory inside
it stays multi-view photometrically consistent and its depth is known:

  render_box                numpy, float64 (the reference renderer)
  make_render_box_torch     the same geometry and texture in float32 on
                            a torch device (the card's golden renderer),
                            optionally box-averaged and quantized there
  kitti_like_trajectory,    the cameras' tracks
  lateral_trajectory
  write_box_kitti_dataset   stereo PNG pairs (the port's stdlib writer),
                            calib.txt, times.txt and poses/<NN>.txt in
                            KITTI odometry layout
  perturb_poses             iid per-frame pose jitter (`entry.drift_poses`
                            is the random-walk drift)

The float32 renderer keeps TF32 off (the package turns it off at import):
the texture's phases are matmuls of world points with wave vectors, and
TF32's ~10 mantissa bits would scramble them at the room's 60 m extent.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..entry import _se3_exp_np, make_texture, sample_texture3d
from ..geometry.camera import Camera
from ..io import png

BOX_HALF = 60.0           # half-extent (m) of the textured box room
BOX_GROUND = 1.65         # camera height above ground (KITTI-like)
BOX_CEIL = -25.0          # "sky" plane (camera y is DOWN-positive)
# The six faces of the room: (axis, plane coordinate).
_FACES = ((0, -BOX_HALF), (0, BOX_HALF), (2, -BOX_HALF), (2, BOX_HALF),
          (1, BOX_GROUND), (1, BOX_CEIL))


def perturb_poses(rng, poses, trans_sigma=0.01, rot_sigma=0.002,
                  keep_first=1):
    """Right-perturb each pose by an independent random twist (iid
    jitter)."""
    out = poses.copy()
    for i in range(keep_first, len(poses)):
        xi = np.concatenate([
            rng.standard_normal(3) * trans_sigma,
            rng.standard_normal(3) * rot_sigma,
        ]).astype(np.float32)
        out[i] = poses[i] @ _se3_exp_np(xi)
    return out


def default_obstacles(rng=None, n: int = 36):
    """Textured AABB 'buildings/parked cars' scattered beside the block-loop
    route (which runs along x,z in [-28, 41]): depth variety and strong
    near-field parallax; without them the bare room leaves the yaw /
    lateral-translation valley of forward motion weakly constrained."""
    rng = np.random.default_rng(7) if rng is None else rng
    route = [(-28.0, z) for z in np.linspace(-24, 36, 8)]
    route += [(x, 40.7) for x in np.linspace(-12, 38, 6)]
    route += [(41.0, z) for z in np.linspace(36, -20, 7)]
    boxes = []
    for i in range(n):
        cx, cz = route[i % len(route)]
        side = 1.0 if (i // len(route)) % 2 == 0 else -1.0
        off = rng.uniform(4.0, 12.0)
        w = rng.uniform(1.0, 4.0)
        d = rng.uniform(1.0, 4.0)
        h = rng.uniform(1.5, 6.0)
        # Offset perpendicular-ish: alternate x/z placement.
        if i % 2 == 0:
            lo = np.array([cx + side * off, BOX_GROUND - h, cz - d / 2])
            hi = np.array([cx + side * off + w, BOX_GROUND, cz + d / 2])
        else:
            lo = np.array([cx - w / 2, BOX_GROUND - h, cz + side * off])
            hi = np.array([cx + w / 2, BOX_GROUND, cz + side * off + d])
        boxes.append((lo, hi))
    return boxes


def _ray_aabb(o, d_world, lo, hi):
    """Slab test: entry t for rays o + t*d vs one AABB; +inf where missed.
    d components of exactly 0 handled via +/-inf slabs."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (lo - o) / d_world
        t2 = (hi - o) / d_world
    tmin = np.nanmax(np.minimum(t1, t2), axis=-1)
    tmax = np.nanmin(np.maximum(t1, t2), axis=-1)
    hit = (tmax >= tmin) & (tmax > 0.1) & (tmin > 0.1)
    return np.where(hit, tmin, np.inf)


def render_box(tex, cam, t_wc: np.ndarray, shape, max_depth: float = 250.0,
               obstacles=None):
    """Image + z-depth of the textured box room (ground at y=+BOX_GROUND,
    walls at x,z = +/-BOX_HALF, ceiling at y=BOX_CEIL; camera x right, y
    down, z forward) seen from pose t_wc (4x4). Viewed from inside a
    convex box every ray exits through exactly one face: depth = min
    positive ray-plane t, then the obstacles. Depth past max_depth is 0
    (invalid)."""
    h, w = shape
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    fx, fy, cx, cy = (float(cam.fx), float(cam.fy), float(cam.cx),
                      float(cam.cy))
    d_cam = np.stack(
        [(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs, np.float64)],
        axis=-1)
    r = t_wc[:3, :3].astype(np.float64)
    o = t_wc[:3, 3].astype(np.float64)
    d_world = d_cam @ r.T                        # (H, W, 3)

    big = 1e9
    t_best = np.full((h, w), big)
    for axis, value in _FACES:
        d_ax = d_world[..., axis]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (value - o[axis]) / d_ax
        t = np.where(np.isfinite(t) & (t > 0.1), t, big)
        t_best = np.minimum(t_best, t)
    if obstacles:
        for lo_b, hi_b in obstacles:
            t_best = np.minimum(t_best, _ray_aabb(o, d_world, lo_b, hi_b))
    x_world = o + t_best[..., None] * d_world
    img = sample_texture3d(tex, x_world)
    depth = (t_best * d_cam[..., 2]).astype(np.float32)
    return img, np.where(depth < max_depth, depth, 0.0).astype(np.float32)


def make_render_box_torch(shape, obstacles=None, max_depth: float = 250.0,
                          downsample: int = 1, quantize: bool = False,
                          device="cuda"):
    """`render_box` in float32 on `device` (twin of the JAX package's
    jitted renderer): the same ray-plane / ray-box geometry and sinusoid
    texture. float32 suffices for the golden's multi-view consistency:
    the worst phase error at BOX_HALF and a 0.1 m wavelength is ~6e-4 rad,
    an intensity error ~1e-4, an order below the PNG's 1/255.

    With `quantize` the image is box-averaged by `downsample` and
    quantized to uint8 on the device, and the depth is not computed
    (renderer 'torch2': the device's mean may differ from the host's by
    an ulp, so pixels may flip by 1/255 against 'torch', a distinct
    dataset provenance). Returns render(tex, cam, t_wc) -> (img, depth)
    as numpy arrays, (img_u8, None) with `quantize`."""
    h, w = shape
    dev = torch.device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    boxes = None
    if obstacles:
        boxes = (torch.as_tensor(np.stack([lo for lo, _ in obstacles]),
                                 **f32),
                 torch.as_tensor(np.stack([hi for _, hi in obstacles]),
                                 **f32))
    ys, xs = torch.meshgrid(torch.arange(h, **f32), torch.arange(w, **f32),
                            indexing="ij")
    big = torch.tensor(1e9, **f32)

    def render(tex, cam, t_wc):
        freqs, phases, amps = (torch.as_tensor(np.asarray(a, np.float32),
                                               device=dev) for a in tex)
        fx, fy, cx, cy = (torch.tensor(float(v), **f32)
                          for v in (cam.fx, cam.fy, cam.cx, cam.cy))
        pose = torch.as_tensor(np.asarray(t_wc, np.float32), device=dev)
        d_cam = torch.stack([(xs - cx) / fx, (ys - cy) / fy,
                             torch.ones_like(xs)], dim=-1)
        o = pose[:3, 3]
        d_world = d_cam @ pose[:3, :3].T
        t_best = torch.full((h, w), 1e9, **f32)
        for axis, value in _FACES:
            t = (value - o[axis]) / d_world[..., axis]
            t = torch.where(torch.isfinite(t) & (t > 0.1), t, big)
            t_best = torch.minimum(t_best, t)
        if boxes is not None:
            for lo, hi in zip(*boxes):
                t1 = (lo - o) / d_world
                t2 = (hi - o) / d_world
                tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
                tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
                hit = (tmax >= tmin) & (tmax > 0.1) & (tmin > 0.1)
                t_best = torch.minimum(t_best, torch.where(hit, tmin, big))
        x_world = o + t_best[..., None] * d_world
        phase = x_world @ freqs.T + phases
        img = 0.5 + 0.5 * torch.tanh(torch.sin(phase) @ amps)
        if quantize:
            s = int(downsample)
            if s > 1:
                img = img.reshape(h // s, s, w // s, s).mean(dim=(1, 3))
            return (torch.clamp(img * 255.0, 0, 255).to(torch.uint8)
                    .cpu().numpy(), None)
        depth = t_best * d_cam[..., 2]
        depth = torch.where(depth < max_depth, depth, 0.0)
        return img.cpu().numpy(), depth.cpu().numpy()

    return render


def kitti_like_trajectory(n_frames: int, step: float = 0.8,
                          straight: int = 70, turn: int = 25) -> np.ndarray:
    """seq-00-style block-loop motion: alternating straights and 90-degree
    right turns (rounded corners), starting at (-28, 0, -28) heading +z;
    stays well inside the BOX_HALF=60 room for any n_frames."""
    poses = []
    t_wc = np.eye(4, dtype=np.float64)
    t_wc[0, 3] = -28.0
    t_wc[2, 3] = -28.0
    yaw_rate = (np.pi / 2) / turn
    i = 0
    while len(poses) < n_frames:
        phase = i % (straight + turn)
        yaw = yaw_rate if phase >= straight else 0.0
        poses.append(t_wc.astype(np.float32).copy())
        xi = np.array([0.0, 0.0, step, 0.0, yaw, 0.0], np.float32)
        t_wc = t_wc @ _se3_exp_np(xi).astype(np.float64)
        i += 1
    return np.stack(poses)


def lateral_trajectory(n_frames: int, step: float = 0.3,
                       z_pos: float = 10.0, x0: float = -25.0) -> np.ndarray:
    """Pure lateral strafe: the camera faces +z (the z=+BOX_HALF wall, 50 m
    ahead from z_pos=10) and translates along world +x, so parallax is
    ~fx*step/z for every point, without forward motion's degeneracy (the
    parity positive-control trajectory)."""
    poses = []
    for i in range(n_frames):
        t = np.eye(4, dtype=np.float32)
        t[0, 3] = x0 + i * step
        t[2, 3] = z_pos
        poses.append(t)
    return np.stack(poses)


RENDERERS = ("numpy", "torch", "torch2")


def write_box_kitti_dataset(root, sequence, rng, n_frames=200,
                            shape=(370, 1226), fx=707.0, baseline=0.537,
                            step=0.8, min_wavelength=0.25,
                            max_wavelength=4.0, obstacles="default",
                            supersample=1, trajectory="block",
                            renderer="numpy", device="cuda"):
    """KITTI-scale golden dataset: the textured box room seen along the
    block loop (or the lateral strafe) at KITTI's calibration scale (fx =
    707, b = 0.537 m, 370x1226), stereo PNG pairs + calib / times / poses
    in odometry layout. Returns (poses, camera).

    supersample > 1 renders at S x resolution and box-averages down,
    modelling a pixel's footprint instead of point sampling: the point-
    sampled render aliases below ~2.5 px wavelength, view-dependently,
    which breaks the multi-view consistency the golden depends on.
    renderer: 'numpy' (`render_box`), 'torch' (`make_render_box_torch`
    on `device`, averaged and quantized on the host) or 'torch2'
    (averaged and quantized on the device). Frames already on disk are
    skipped (each is a pure function of texture and pose), so an
    interrupted render resumes."""
    if renderer not in RENDERERS:
        raise ValueError(f"renderer must be one of {RENDERERS}, not "
                         f"'{renderer}'")
    h, w = shape
    cam = Camera.create(fx=fx, fy=fx, cx=w / 2 - 0.5, cy=h / 2 - 0.5,
                        baseline=baseline)
    seq_dir = os.path.join(root, "sequences", f"{sequence:02d}")
    os.makedirs(os.path.join(seq_dir, "image_0"), exist_ok=True)
    os.makedirs(os.path.join(seq_dir, "image_1"), exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)

    tex = make_texture(rng, n_waves=96, min_wavelength=min_wavelength,
                       max_wavelength=max_wavelength)
    if trajectory == "lateral":
        poses = lateral_trajectory(n_frames, step=step)
    else:
        poses = kitti_like_trajectory(n_frames, step=step)
    if obstacles == "default":
        obstacles = default_obstacles()
    elif obstacles == "none":
        obstacles = None

    s = int(supersample)
    cam_ss = cam.scaled(float(s)) if s > 1 else cam
    shape_ss = (shape[0] * s, shape[1] * s)
    on_device = None
    if renderer != "numpy":
        on_device = make_render_box_torch(
            shape_ss, obstacles=obstacles, downsample=s,
            quantize=renderer == "torch2", device=device)

    def render(pose):
        if renderer == "torch2":
            return on_device(tex, cam_ss, pose)[0]      # uint8 already
        if on_device is not None:
            im, _ = on_device(tex, cam_ss, pose)
        else:
            im, _ = render_box(tex, cam_ss, pose, shape_ss,
                               obstacles=obstacles)
        if s > 1:
            im = im.reshape(shape[0], s, shape[1], s).mean(axis=(1, 3))
        return np.clip(im * 255, 0, 255).astype(np.uint8)

    for i, p in enumerate(poses):
        out_l = os.path.join(seq_dir, "image_0", f"{i:06d}.png")
        out_r = os.path.join(seq_dir, "image_1", f"{i:06d}.png")
        if os.path.exists(out_l) and os.path.exists(out_r):
            continue
        pr = p.copy()
        pr[:3, 3] = p[:3, 3] + p[:3, :3] @ np.array([baseline, 0, 0],
                                                    np.float32)
        png.write_png_gray(out_l, render(p))
        png.write_png_gray(out_r, render(pr))

    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        f.write(f"P0: {fx} 0 {w/2-0.5} 0 0 {fx} {h/2-0.5} 0 0 0 1 0\n")
        f.write(f"P1: {fx} 0 {w/2-0.5} {-fx*baseline} 0 {fx} {h/2-0.5} 0 "
                f"0 0 1 0\n")
    with open(os.path.join(seq_dir, "times.txt"), "w") as f:
        f.writelines(f"{i*0.1:.6f}\n" for i in range(n_frames))
    with open(os.path.join(root, "poses", f"{sequence:02d}.txt"), "w") as f:
        for p in poses:
            f.write(" ".join(f"{v:.9f}" for v in p[:3].reshape(-1)) + "\n")
    return poses, cam
