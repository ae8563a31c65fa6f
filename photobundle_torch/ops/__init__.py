"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Ported: `patch_warp.patch_stats`, the twin of the JAX package's main-path
Pallas kernel `photobundle_tpu/ops/patch_warp.py::_warp_kernel_packed`.
The JAX package's other Pallas kernels are still to be ported (ROADMAP.md,
queue 2).
"""
