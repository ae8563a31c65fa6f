"""numpy <-> port conversion of a whole window problem.

The JAX package and the port are held against each other by solving the
very same problem: `problem_from_numpy` takes a problem as numpy arrays
(for instance the JAX package's `(cam, offsets, args)`, converted with
`np.asarray`) and returns the port's; `stats_to_numpy` brings an
`LMStats` back. This module does not import jax: anything `np.asarray`
accepts will do.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.lm import LMStats
from .geometry.camera import Camera


def to_torch(a, device="cpu") -> torch.Tensor:
    """One array -> a tensor on `device`, dtype kept (bools stay bool)."""
    return torch.as_tensor(np.array(a), device=device)


def problem_from_numpy(cam, offsets, arrays, device="cpu"):
    """(cam, offsets, (t_wc, x_world, patch, channels, grads, obs,
    point_valid, frozen)) -> the same on `device` as the port's types.

    `cam` is any object with fx, fy, cx, cy, baseline fields; the arrays
    may be any sequence of array-likes (the order of `entry.make_problem`'s
    result, which is that of the JAX package's `_make_problem`)."""
    cam_t = Camera.create(*(float(np.asarray(getattr(cam, k)))
                            for k in Camera._fields), device=device)
    return (cam_t, to_torch(offsets, device),
            tuple(to_torch(a, device) for a in arrays))


def stats_to_numpy(stats: LMStats) -> LMStats:
    """LMStats of tensors -> LMStats of numpy arrays (on the host)."""
    return LMStats(*(t.detach().cpu().numpy() for t in stats))
