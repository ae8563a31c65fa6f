"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

The solve's kernels fuse patch sampling, normalization (off, mean or
affine: the epilogue in csrc/patch_epilogue.cuh) and the six Gauss-Newton
sums, and stand for Pallas kernels of `photobundle_tpu/ops/patch_warp.py`:

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

The other kernels answer the JAX package's remaining Pallas kernels:

- `patch_samples.warp_patches`: bilinear samples stored per observation,
  K4's row store (`_warp_kernel`, the unfused solve path under
  PB_GROUPED_STATS=0) and K6 (`_warp_kernel_block`, its 'block' and 'raw'
  layouts);
- `patch_stats.patch_stats`: K7 (`photobundle_tpu/ops/patch_stats.py`),
  the fused sample + centre + sums kernel with its `cost_only` mode;
- `patch_ablate.ablate_stats`: K8 (`tools/ablate_packed_kernel.py`), K1
  with its stages switched off, run by
  `photobundle_torch.tools.ablate_patch_stats`.

Every kernel that samples the fixed grid bilinearly shares
csrc/patch_bilinear.cuh, so their samples are bitwise alike.

Two kernels stand behind no Pallas kernel (the JAX package runs these
steps in XLA): the LM body's own, which let a batched window solve round
each window as its own solve does (core/lm.py):

- `ordered_sum.row_dot`: every sum of the body longer than three terms,
  in an order fixed by the row's length;
- `chol_solve.chol_solve`: the reduced camera systems' Cholesky
  factor-and-solve, one block per window.
"""
