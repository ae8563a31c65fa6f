"""Dependency-free shared constants (twin of photobundle_tpu/constants.py).

PATCH_SCALE_MIN/MAX: the patch-grid warp clamp (cfg.patchWarp). The warped
grid is not ported yet; the values live here so the later warp kernels
and the residual model share one definition, as in the JAX package.
"""

PATCH_SCALE_MIN = 0.5
PATCH_SCALE_MAX = 2.0
