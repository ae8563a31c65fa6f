"""Dependency-free shared constants (twin of photobundle_tpu/constants.py).

PATCH_SCALE_MIN/MAX: the patch-grid warp clamp (cfg.patchWarp), shared by
the residual model (core/residuals.patch_warp_frame) and the warped-grid
kernel's wrapper (ops/patch_scaled), as in the JAX package;
csrc/patch_scaled.cu repeats the two values.
"""

PATCH_SCALE_MIN = 0.5
PATCH_SCALE_MAX = 2.0
