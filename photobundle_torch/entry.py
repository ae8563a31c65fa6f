"""Problem generator and solve entry point (twin of __graft_entry__.py).

`make_problem` builds the synthetic smooth-texture window problem of the
JAX package's `_make_problem` from the same numpy draws, so both packages
get identical inputs for one seed. `entry` returns one full window solve
and its arguments.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import lm
from .geometry import camera as cam_mod
from .geometry import se3
from .image import interp, patches


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


def entry(device="cpu"):
    """(fn, example_args): one full BA window solve on `device`, through
    the fused kernel (backend 'cuda'; its plain version on the CPU)."""
    cam, offsets, args = make_problem(2048, 5, 192, 320, patch_radius=2,
                                      device=device)

    def ba_solve_step(t_wc, x_world, patch, channels, grads, obs,
                      point_valid, frozen):
        return lm.lm_solve(
            cam, t_wc, x_world, patch, channels, grads, obs,
            point_valid, frozen, offsets,
            huber_delta=0.05, gradient_mode="sampled", backend="cuda",
            max_iterations=10,
        )

    return ba_solve_step, args
