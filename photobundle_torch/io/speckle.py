"""Speckle filter of a disparity map (cv::filterSpeckles semantics).

A copy of photobundle_tpu/native/__init__.py::speckle_filter_numpy, the
pure-Python twin of the JAX package's native `pb_speckle_filter`: the port
builds no native library yet (ROADMAP.md queue 1 item 10), so this is its
only speckle filter (~1 s per 370x1226 frame on one host core).
"""

from __future__ import annotations

import numpy as np


def speckle_filter_numpy(disp: np.ndarray, valid: np.ndarray, *,
                         max_diff: float = 1.0, min_region: int = 50):
    """Invalidate connected disparity components smaller than `min_region`
    pixels: 4-neighbours join a component when both are valid and their
    disparities differ by at most `max_diff`. Same DFS traversal as the
    native filter (same neighbour order, same popped-pixel similarity
    test). Returns (disparity with removed pixels set to 0, validity)."""
    disp = np.ascontiguousarray(disp, np.float32).copy()
    valid = np.ascontiguousarray(valid, bool).copy()
    h, w = disp.shape
    d = disp.ravel()
    v = valid.ravel()
    label = np.full(h * w, -1, np.int32)
    cur = 0
    for seed in range(h * w):
        if not v[seed] or label[seed] >= 0:
            continue
        stack = [seed]
        label[seed] = cur
        members = []
        while stack:
            p = stack.pop()
            members.append(p)
            y, x = divmod(p, w)
            dp = d[p]
            for q in ((p - w if y > 0 else -1),
                      (p + w if y < h - 1 else -1),
                      (p - 1 if x > 0 else -1),
                      (p + 1 if x < w - 1 else -1)):
                if q < 0 or not v[q] or label[q] >= 0:
                    continue
                if abs(d[q] - dp) > max_diff:
                    continue
                label[q] = cur
                stack.append(q)
        if len(members) < min_region:
            idx = np.asarray(members, np.int64)
            v[idx] = False
            d[idx] = 0.0
        cur += 1
    return d.reshape(h, w), v.reshape(h, w)
