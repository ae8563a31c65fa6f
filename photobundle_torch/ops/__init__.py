"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Ported: `patch_warp.patch_stats` (K1), the twin of the JAX package's
bilinear main-path Pallas kernel
`photobundle_tpu/ops/patch_warp.py::_warp_kernel_packed`, and
`patch_bicubic.bicubic_stats` (K2), the twin of its Catmull-Rom kernel
`_bicubic_kernel`. The JAX package's other Pallas kernels are still to be
ported (ROADMAP.md, queue 2).
"""
