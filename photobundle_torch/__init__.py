"""photobundle_torch: the PyTorch + CUDA port of photobundle_tpu.

Same module layout and function names as the JAX package
(`photobundle_tpu/`), which stays in the repository as the reference each
ported piece is tested against. This package imports `torch` and never
`jax` or `photobundle_tpu`.

Layer map (ported so far: the sliding-window engine, its frame ingest and
its window solve):
    core.engine    — PhotometricBundleAdjustment.add_frame: ingest, then
                     the window solve once the window is full
    config         — PBAConfig and the .cfg parser (backend 'auto' |
                     'cuda' | 'torch')
    entry          — problem and scene generators + solve entry point
                     (twin of __graft_entry__)
    convert        — numpy <-> port conversion of a problem or an
                     engine's state
    geometry       — SE(3), pinhole camera
    image          — pyramid, descriptors, saliency, bilinear and
                     Catmull-Rom sampling, patches
    core           — state, tracking, selection, residuals, Schur
                     complement, Levenberg-Marquardt
    ops            — hand-written CUDA kernels (csrc/) and their loaders
"""

import torch as _torch

# Geometry needs full f32. The JAX package forces "highest" matmul
# precision because TPU matmuls default to bf16 operands
# (photobundle_tpu/__init__.py); the CUDA twin of that hazard is TF32,
# which keeps ~10 mantissa bits: at KITTI world coordinates a pose product
# would round translations by centimetres. Turn it off for matmuls and
# cuDNN alike.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .geometry.camera import Camera  # noqa: E402

__version__ = "0.1.0"

__all__ = ["Camera", "__version__"]
