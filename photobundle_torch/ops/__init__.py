"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each fuses patch sampling, normalization (off, mean or affine: the
epilogue in csrc/patch_epilogue.cuh) and the six Gauss-Newton sums, and
stands for Pallas kernels of `photobundle_tpu/ops/patch_warp.py`:

- `patch_warp.patch_stats`: bilinear on the fixed grid, K1
  (`_warp_kernel_packed`), and with affine normalization K4
  (`_warp_kernel` + the JAX package's XLA epilogue);
- `patch_warp.sorted_patch_stats`: K1 with the observations in a sorted
  point order and each block's windows staged in shared memory, K1's
  `sort_reuse=True` variant (sorted dispatch, PB_SORTED_DISPATCH=1);
- `patch_bicubic.bicubic_stats`: Catmull-Rom, K2 (`_bicubic_kernel`);
- `patch_scaled.scaled_stats`: bilinear on the per-observation scaled grid
  (cfg.patchWarp='scale'), K3 (`_warp_kernel_scaled_packed`), and with
  affine normalization K5 (`_gather_kernel_scaled` + XLA's resample).

The JAX package's other Pallas kernels (K6 and K7's `cost_only` mode) are
still to be ported (ROADMAP.md, queue 2).
"""
