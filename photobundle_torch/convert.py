"""numpy <-> port conversion of a whole window problem.

The JAX package and the port are held against each other by solving the
very same problem: `problem_from_numpy` takes a problem as numpy arrays
(for instance the JAX package's `(cam, offsets, args)`, converted with
`np.asarray`) and returns the port's; `stats_to_numpy` brings an
`LMStats` back. `engine_state_from_numpy` / `engine_state_to_numpy` carry
an engine's state (`PointTable`, `Window`) across, so that the port's
ingest or solve can start from the JAX engine's exact state;
`batched_engine_state_from_numpy` carries a batched engine's state (every
field on a leading batch axis) across, and `engine_state_to_numpy` brings
one back as it is. This module
does not import jax: anything `np.asarray` accepts will do.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.lm import LMStats
from .core.state import PointTable, Window
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


def engine_state_from_numpy(points, window, device="cpu"):
    """(points, window), any objects with the fields of `PointTable` and
    `Window` (for instance the JAX engine's, fetched to numpy) -> the
    port's `PointTable` and `Window` on `device`, dtypes kept."""
    return (PointTable(*(to_torch(getattr(points, k), device)
                         for k in PointTable._fields)),
            Window(*(to_torch(getattr(window, k), device)
                     for k in Window._fields)))


def engine_state_to_numpy(points: PointTable, window: Window):
    """The port's (PointTable, Window) -> the same NamedTuples of numpy
    arrays on the host."""
    return (PointTable(*(t.detach().cpu().numpy() for t in points)),
            Window(*(t.detach().cpu().numpy() for t in window)))


def stack_engine_states(states):
    """B (points, window) pairs of numpy arrays -> one pair with every
    field stacked on a leading batch axis: the layout of a batched
    engine's state (the JAX package's and core/batched.py's)."""
    points, windows = zip(*states)
    return (type(points[0])(*(np.stack(f) for f in zip(*points))),
            type(windows[0])(*(np.stack(f) for f in zip(*windows))))


def batched_engine_state_from_numpy(points, window, device="cpu"):
    """A stacked engine state, every field with the same leading batch
    axis B (the JAX batched engine's, fetched to numpy, or
    `stack_engine_states`) -> the port's stacked `PointTable` and
    `Window` on `device`, as `BatchedPhotometricBundleAdjustment` holds
    them."""
    sizes = {np.shape(getattr(points, k))[:1] for k in PointTable._fields}
    sizes |= {np.shape(getattr(window, k))[:1] for k in Window._fields}
    if len(sizes) != 1 or sizes == {()}:
        raise ValueError(f"a stacked engine state has one leading batch "
                         f"axis on every field, not {sorted(sizes)}")
    return engine_state_from_numpy(points, window, device)
