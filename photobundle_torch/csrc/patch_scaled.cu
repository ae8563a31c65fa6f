// Warped-grid patch sampling + Gauss-Newton statistics for Hopper (sm_90a).
//
// Replaces photobundle_tpu/ops/patch_warp.py::_warp_kernel_scaled_packed
// (K3, launched by warp_patches_grouped_scaled: cfg.patchWarp='scale' with
// mean or no normalization) and, with the affine epilogue,
// ::_gather_kernel_scaled (K5, launched by warp_patches_scaled, whose raw
// windows XLA resamples with one-hot bilinear weights and normalizes:
// patchWarp='scale' with patchNormalization='affine'). Same contract as
// K1 (csrc/patch_warp.cu), on a per-observation scaled grid: for every
// observation (point p, window frame f) with scale rho = rho[p, f],
// clamped to [PATCH_SCALE_MIN, PATCH_SCALE_MAX] = [0.5, 2],
//   1. bilinearly samples value, d/dx and d/dy at the patch grid
//      uv + rho * (k - R), k = 0..2R per axis: every patch row has its own
//      floor and phase fy, every column its own floor and phase fx,
//      blended as the TPU kernel does, rows first (r0 (1 - fy) + r1 fy,
//      patch_warp.py:821), then columns ((1 - fx) F + fx N, :839),
//   2. normalizes each channel's patch (off, mean or affine) and subtracts
//      the reference descriptor,
//   3. reduces to the six sums [gx*gx, gx*gy, gy*gy, gx*r, gy*r, r*r],
//      summed over channels (the epilogue in csrc/patch_epilogue.cuh),
// and stores them un-whitened at out[k, f, p] (k = 0..5). Invalid
// observations store exact zeros and are never sampled: their coordinates
// (possibly NaN) never reach floorf and their rho is never read.
//
// Sample positions are a product and a sum, each rounded once
// (__fmul_rn, __fadd_rn; the library is also built with -fmad=false), as
// the gather path and the plain version round uv + rho * (k - R): a fused
// multiply-add would move floor(uv + rho * (k - R)) across an integer at
// some observations and change a whole tap row. The blends, too, round as
// the plain version's separate products and sums do, so kernel and plain
// version sample bitwise alike. Tap rows are clamped to [0, H - 2] and columns
// to [0, Wi - 2] (the TPU launcher's clip); the solve's margins
// (1 + rho R <= u <= Wi - 2 - rho R) keep valid observations' taps inside.
//
// Inputs: K1's planes (W, C, H, Wi) float4 = (value, d/dx, d/dy, 0), so the
// TPU path's wide panel layout has no counterpart here; uv (N, W) float2;
// rho (N, W) f32; valid (N, W) bytes; patch (N, C, P) f32.
//
// What bounds it on this card: at the solver's full-size window (4096
// points x 5 frames, ~20k observations) each observation touches
// (2R+1..4R+2)^2 float4 texels depending on rho (~0.4-2.3 KB at R = 2) and
// stores 24 B: ~10-40 MB of reads out of an L2-resident plane set, a few
// microseconds of bandwidth; ~70 flops per patch pixel, well under a
// microsecond. Like K1 it is bound by per-thread latency (dependent
// gathers, ~150 threads per SM) and launch overhead.
//
// What the design does about it: one thread per observation, R and the
// normalization mode template parameters. The 2R+1 column taps and phases
// are computed once per observation and sit in registers; every patch
// loop is unrolled, so the texel loads of a whole pass are independent
// and in flight together, each row's tap and phase computed where the row
// is reached. Register use grows with R (ptxas spills in the affine mode
// from R = 2 on), which costs less than it saves: rolling the row loop to
// keep registers flat made the kernel 1.9x slower at R = 2
// (kernel_times.py). The epilogue re-samples the patch once per pass (two
// for mean, three for affine) from L1. Threads are frame-major; no
// atomics, so results are bitwise reproducible.

#include <cuda_runtime.h>

#include "patch_epilogue.cuh"

namespace {

constexpr int kThreads = 64;
constexpr float kScaleMin = 0.5f;   // constants.PATCH_SCALE_MIN
constexpr float kScaleMax = 2.0f;   // constants.PATCH_SCALE_MAX

// Floor tap and phase of one patch row or column at u + rho * o, the tap
// clamped to [0, hi] and the phase to [0, 1].
__device__ __forceinline__ void tap(float u, float rho, int o, int hi,
                                    int* t, float* ph) {
  const float pos = __fadd_rn(u, __fmul_rn(rho, static_cast<float>(o)));
  *t = min(max(static_cast<int>(floorf(pos)), 0), hi);
  *ph = fminf(fmaxf(pos - static_cast<float>(*t), 0.f), 1.f);
}

template <int R, int NORM>
__global__ void __launch_bounds__(kThreads)
scaled_stats_kernel(const float4* __restrict__ planes,
                    const float2* __restrict__ uv,
                    const float* __restrict__ rho,
                    const unsigned char* __restrict__ valid,
                    const float* __restrict__ patch,
                    float* __restrict__ out,
                    int n, int w, int c, int h, int wi) {
  constexpr int PS = 2 * R + 1;
  constexpr int P = PS * PS;
  const long long total = static_cast<long long>(n) * w;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int f = static_cast<int>(idx / n);
  const int p = static_cast<int>(idx - static_cast<long long>(f) * n);
  const long long obs = static_cast<long long>(p) * w + f;

  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (valid[obs]) {
    const float2 q = uv[obs];
    const float r = fminf(fmaxf(rho[obs], kScaleMin), kScaleMax);
    int tx[PS];
    float fx[PS];
#pragma unroll
    for (int k = 0; k < PS; ++k) tap(q.x, r, k - R, wi - 2, &tx[k], &fx[k]);

    for (int ch = 0; ch < c; ++ch) {
      const float4* img =
          planes + (static_cast<long long>(f) * c + ch) * h * wi;
      auto sweep = [&](auto&& emit) {
        const float4* base = pb::opaque(img);
#pragma unroll
        for (int ky = 0; ky < PS; ++ky) {
          int ty;
          float gy1;
          tap(q.y, r, ky - R, h - 2, &ty, &gy1);
          const float4* row = base + static_cast<long long>(ty) * wi;
          const float gy0 = 1.f - gy1;
#pragma unroll
          for (int kx = 0; kx < PS; ++kx) {
            const float4* t = row + tx[kx];
            const float4 a = __ldg(t);
            const float4 b = __ldg(t + 1);
            const float4 cc = __ldg(t + wi);
            const float4 d = __ldg(t + wi + 1);
            // Rows first (the floor column F and the next column N)...
            const float fv = a.x * gy0 + cc.x * gy1;
            const float fgx = a.y * gy0 + cc.y * gy1;
            const float fgy = a.z * gy0 + cc.z * gy1;
            const float nv = b.x * gy0 + d.x * gy1;
            const float ngx = b.y * gy0 + d.y * gy1;
            const float ngy = b.z * gy0 + d.z * gy1;
            // ...then the columns.
            const float gx1 = fx[kx];
            const float gx0 = 1.f - gx1;
            emit(ky * PS + kx, gx0 * fv + gx1 * nv, gx0 * fgx + gx1 * ngx,
                 gx0 * fgy + gx1 * ngy);
          }
        }
      };
      const float* desc = patch + (static_cast<long long>(p) * c + ch) * P;
      pb::channel_stats<P, NORM>(sweep, desc, acc);
    }
  }
  const long long o = static_cast<long long>(f) * n + p;
#pragma unroll
  for (int k = 0; k < 6; ++k) out[k * total + o] = acc[k];
}

template <int R, int NORM>
void launch(const void* planes, const void* uv, const void* rho,
            const void* valid, const void* patch, void* out, int n, int w,
            int c, int h, int wi, cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * w;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  scaled_stats_kernel<R, NORM><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float4*>(planes), static_cast<const float2*>(uv),
      static_cast<const float*>(rho),
      static_cast<const unsigned char*>(valid),
      static_cast<const float*>(patch), static_cast<float*>(out), n, w, c, h,
      wi);
}

}  // namespace

extern "C" int pb_scaled_stats(const void* planes, const void* uv,
                               const void* rho, const void* valid,
                               const void* patch, void* out, int n, int w,
                               int c, int h, int wi, int radius, int norm,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = pb::dispatch(radius, norm, [&](auto r, auto m) {
    launch<decltype(r)::value, decltype(m)::value>(
        planes, uv, rho, valid, patch, out, n, w, c, h, wi, s);
  });
  return bad ? bad : static_cast<int>(cudaGetLastError());
}

extern "C" const char* pb_scaled_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
