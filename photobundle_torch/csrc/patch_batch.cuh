// The batch axis shared by the patch kernels of the batched window solve
// (csrc/patch_warp.cu, both entries; csrc/patch_bicubic.cu;
// csrc/patch_scaled.cu; csrc/patch_samples.cu).
//
// The twin of the grid axis that jax.vmap of the JAX package's batched
// solve adds to each pallas_call (photobundle_tpu/core/batched.py vmaps
// _optimize_impl): a launch takes B windows of the same shapes, and the
// block row blockIdx.y is window b, which reads and writes its own slices
// of every tensor: planes (B, W, C, H, Wi[, texel]), the per-observation
// tensors (B, N, W[, ...]), patch (B, N, C, P) and the output (B, ...).
// Each block row offsets its pointers by these and runs the unchanged
// single-window code, so the results of window b are bitwise those of a
// single-window launch on its slices (B = 1: blockIdx.y = 0, no offset).
#pragma once

#include <cuda_runtime.h>

#include <algorithm>

namespace pb {

struct WindowOffsets {
  long long planes;   // texels (float4, or f32 values)
  long long obs;      // per-observation elements: uv, rho, valid; a
                      // (6, W, N) output takes 6 * obs
  long long patch;    // floats
};

__device__ __forceinline__ WindowOffsets window_offsets(int n, int w, int c,
                                                        int h, int wi,
                                                        int p) {
  const long long b = blockIdx.y;
  const long long obs = static_cast<long long>(n) * w;
  return {b * w * c * h * wi, b * obs, b * n * c * p};
}

// Blocks along x of a launch whose blocks loop over `groups` groups and
// whose grid holds `per_sm` blocks an SM over its `b` windows on grid y
// (per_sm 0: one block a group). The SM count is read once (the port
// drives one card a process).
inline unsigned resident_blocks(long long groups, int per_sm, int b) {
  if (per_sm == 0) return static_cast<unsigned>(groups);
  static const int sms = [] {
    int device = 0, count = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    return count;
  }();
  const long long resident = std::max(1LL, 1LL * sms * per_sm / b);
  return static_cast<unsigned>(std::min(groups, resident));
}

}  // namespace pb
