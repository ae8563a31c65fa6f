// Bilinear sampling on the fixed integer patch grid, shared by the kernels
// that sample a (2R+2)^2 window of float4 texels (value, d/dx, d/dy, 0):
// K1 and its sorted variant (csrc/patch_warp.cu), the sample stores
// (csrc/patch_samples.cu), K7 (csrc/patch_stats.cu) and the K1 ablation
// (csrc/patch_ablate.cu). One definition keeps their samples bitwise
// alike: the window origin and weights of `window_at`, and the tap order
// of the TPU kernels (photobundle_tpu/ops/patch_warp.py:118-119, 430-431):
// w00*a + w01*b + w10*c + w11*d, each product and sum rounded once (the
// kernels are built with -fmad=false, ops/_build.py).
#pragma once

#include <cuda_runtime.h>

#include "patch_epilogue.cuh"

namespace pb {

struct Weights {
  float w00, w01, w10, w11;
};

// Texel loads: from global memory through the read-only cache, or plain
// loads (a block's staged tile in shared memory, a generic pointer).
struct LoadGlobal {
  __device__ __forceinline__ float4 operator()(const float4* p) const {
    return __ldg(p);
  }
};
struct LoadPlain {
  __device__ __forceinline__ float4 operator()(const float4* p) const {
    return *p;
  }
};

// The bilinear combine of four taps in the tap order of the TPU kernel:
// w00*a + w01*b + w10*c + w11*d.
__device__ __forceinline__ float combine(const Weights& q, float a, float b,
                                         float c, float d) {
  return q.w00 * a + q.w01 * b + q.w10 * c + q.w11 * d;
}

// Bilinear samples of value/gx/gy at window cell (ky, kx) of a window whose
// rows are `stride` texels apart.
template <typename Load>
__device__ __forceinline__ float3 sample(const float4* __restrict__ win,
                                         int stride, int ky, int kx,
                                         const Weights& q, Load load) {
  const float4* r0 = win + static_cast<long long>(ky) * stride + kx;
  const float4 a = load(r0);
  const float4 b = load(r0 + 1);
  const float4 c = load(r0 + stride);
  const float4 d = load(r0 + stride + 1);
  return make_float3(combine(q, a.x, b.x, c.x, d.x),
                     combine(q, a.y, b.y, c.y, d.y),
                     combine(q, a.z, b.z, c.z, d.z));
}

// The value sample alone, from value planes (one f32 per texel, loaded
// through the read-only cache): bitwise sample()'s .x on the same values.
__device__ __forceinline__ float sample_value(const float* __restrict__ win,
                                              int stride, int ky, int kx,
                                              const Weights& q) {
  const float* r0 = win + static_cast<long long>(ky) * stride + kx;
  return combine(q, __ldg(r0), __ldg(r0 + 1), __ldg(r0 + stride),
                 __ldg(r0 + stride + 1));
}

// One observation's window origin and bilinear weights. Call it only for a
// valid observation (an invalid one may carry NaN, which must never reach
// floorf or an int cast); the window is clamped inside the image.
__device__ __forceinline__ void window_at(float2 q, int radius, int h,
                                          int wi, int* x0, int* y0,
                                          Weights* wt) {
  const int win = 2 * radius + 2;
  const float flx = floorf(q.x);
  const float fly = floorf(q.y);
  const float fx = q.x - flx;
  const float fy = q.y - fly;
  *x0 = min(max(static_cast<int>(flx) - radius, 0), wi - win);
  *y0 = min(max(static_cast<int>(fly) - radius, 0), h - win);
  const float one_fy = 1.f - fy;
  *wt = Weights{(1.f - fx) * one_fy, fx * one_fy, (1.f - fx) * fy,
                fx * fy};
}

template <int R>
__device__ __forceinline__ void window_at(float2 q, int h, int wi, int* x0,
                                          int* y0, Weights* wt) {
  window_at(q, R, h, wi, x0, y0, wt);
}

// K1's six sums of one observation over its C channels: `win` is channel
// 0's window origin, channels are `chan` texels apart, rows `stride`; the
// normalization is NORM's epilogue (patch_epilogue.cuh). R =
// kRuntimeRadius takes the radius from `radius` and rolls both patch
// loops (the same samples in the same order).
template <int R, int NORM, typename Load>
__device__ __forceinline__ void observation_stats(
    const float4* win, long long chan, int stride, const Weights& wt,
    const float* __restrict__ desc, int c, Load load, float acc[6],
    int radius = R) {
  constexpr int kPS = 2 * R + 1;
  const int ps = R == kRuntimeRadius ? 2 * radius + 1 : kPS;
  const int p = ps * ps;
  for (int ch = 0; ch < c; ++ch) {
    const float4* wc = win + ch * chan;
    auto sweep = [&](auto&& emit) {
      const float4* wv = opaque(wc);
      auto row = [&](int ky) {
        if constexpr (R == kRuntimeRadius) {
#pragma unroll 1
          for (int kx = 0; kx < ps; ++kx) {
            const float3 s = sample(wv, stride, ky, kx, wt, load);
            emit(ky * ps + kx, s.x, s.y, s.z);
          }
        } else {
#pragma unroll
          for (int kx = 0; kx < kPS; ++kx) {
            const float3 s = sample(wv, stride, ky, kx, wt, load);
            emit(ky * kPS + kx, s.x, s.y, s.z);
          }
        }
      };
      if constexpr (R >= kRolledRowRadius || R == kRuntimeRadius) {
#pragma unroll 1
        for (int ky = 0; ky < ps; ++ky) row(ky);
      } else {
#pragma unroll
        for (int ky = 0; ky < kPS; ++ky) row(ky);
      }
    };
    channel_stats<NORM>(sweep, desc + static_cast<long long>(ch) * p, p,
                        acc);
  }
}

}  // namespace pb
