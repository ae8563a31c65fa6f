// Catmull-Rom patch sampling + Gauss-Newton statistics for Hopper (sm_90a).
//
// Replaces photobundle_tpu/ops/patch_warp.py::_bicubic_kernel (launched by
// warp_patches_bicubic, whose (s, gx, gy) the JAX package reduces in XLA:
// core/residuals.py, the bicubic branch of _evaluate_compressed_pallas).
// The statistics are fused here, so the contract is K1's
// (csrc/patch_warp.cu) and the solve's algebra is shared. For every
// observation (point p, window frame f) it
//   1. samples the Catmull-Rom surface (value) and its exact analytic
//      d/dx, d/dy on the integer (2R+1)^2 patch grid at uv[p, f], with one
//      subpixel phase per patch (Ceres' BiCubicInterpolator semantics),
//   2. normalizes each channel's patch and subtracts the reference
//      descriptor: off, mean (each plane centred on its patch mean) or
//      affine (the ZNCC unit norm with its exact Jacobian, which the JAX
//      package applies in XLA to K2's patches: core/residuals.py:830-840),
//   3. reduces to the six sums [gx*gx, gx*gy, gy*gy, gx*r, gy*r, r*r],
//      summed over channels after the per-channel normalization (the
//      epilogue in csrc/patch_epilogue.cuh, shared with K1),
// and stores them un-whitened at out[k, f, p] (k = 0..5). Invalid
// observations store exact zeros and their coordinates (possibly NaN) are
// never floored or cast.
//
// Inputs: planes (W, C, H, Wi) f32 values only (the surface gradients come
// from the values, so no gradient planes are read); uv (N, W) float2;
// valid (N, W) bytes; patch (N, C, P) f32. The (2R+4)^2 window is clamped
// inside the image; the solve's border margins (R+1 <= u <= Wi-3-R) keep
// valid observations' windows unclamped.
//
// What bounds it on this card: at the solver's full-size window (4096
// points x 5 frames) each observation reads an 8x8 f32 window (256 B at
// R = 2) twice and stores 24 B: ~10 MB of L1/L2 traffic out of a 9 MB
// L2-resident plane set, a few microseconds of bandwidth. It does ~1.4k
// FMAs per observation (separable 4-tap passes for value and both
// derivatives, twice), ~30 MFLOP in all: also microseconds. Like K1 it is
// bound by per-thread latency (dependent loads, ~150 threads per SM) and
// by launch overhead.
//
// What the design does about it: one thread per observation, R and the
// normalization mode template parameters (each mode's build carries only
// its own passes' registers) and every loop unrolled, so the window row
// loads of a pass are independent and in flight together. The separable
// passes run row by row: a window row is loaded, filtered along x (value
// and d/dx), and as soon as four filtered rows exist one output row is
// combined along y, so at most four filtered rows need to be live. The
// epilogue sweeps the window once per pass (means first, then centred
// products; affine adds a pass for the norm), which avoids the cancelling
// one-pass form; the later passes hit L1. Threads are frame-major, so
// neighbouring threads store neighbouring outputs. No atomics: each thread
// writes its own sums in a fixed order, so results are bitwise
// reproducible. Taps combine in the JAX kernel's order
// (patch_warp.py:199-203): rows along x, then columns along y.

#include <cuda_runtime.h>

#include "patch_epilogue.cuh"

namespace {

constexpr int kThreads = 64;

// Catmull-Rom weights for taps at offsets (-1, 0, 1, 2) and their d/dt.
__device__ __forceinline__ void catmull_rom(float t, float* w, float* d) {
  const float t2 = t * t;
  const float t3 = t2 * t;
  w[0] = 0.5f * (-t3 + 2.f * t2 - t);
  w[1] = 0.5f * (3.f * t3 - 5.f * t2 + 2.f);
  w[2] = 0.5f * (-3.f * t3 + 4.f * t2 + t);
  w[3] = 0.5f * (t3 - t2);
  d[0] = 0.5f * (-3.f * t2 + 4.f * t - 1.f);
  d[1] = 0.5f * (9.f * t2 - 10.f * t);
  d[2] = 0.5f * (-9.f * t2 + 8.f * t + 1.f);
  d[3] = 0.5f * (3.f * t2 - 2.f * t);
}

__device__ __forceinline__ float taps4(const float* w, float a0, float a1,
                                       float a2, float a3) {
  return w[0] * a0 + w[1] * a1 + w[2] * a2 + w[3] * a3;
}

// One sweep over a channel's patch: calls emit(k, v, gx, gy) for every
// patch pixel k in row-major order. `win` points at the window's top-left
// texel, `wi` is the image row stride.
template <int R, typename Emit>
__device__ __forceinline__ void sweep(const float* __restrict__ win, int wi,
                                      const float* wx, const float* dwx,
                                      const float* wy, const float* dwy,
                                      Emit&& emit) {
  constexpr int PS = 2 * R + 1;
  constexpr int WIN = PS + 3;
  float rv[WIN][PS];   // rows filtered along x: value
  float rd[WIN][PS];   // rows filtered along x: d/dx
#pragma unroll
  for (int r = 0; r < WIN; ++r) {
    float a[WIN];
#pragma unroll
    for (int k = 0; k < WIN; ++k) a[k] = __ldg(win + r * wi + k);
#pragma unroll
    for (int kx = 0; kx < PS; ++kx) {
      rv[r][kx] = taps4(wx, a[kx], a[kx + 1], a[kx + 2], a[kx + 3]);
      rd[r][kx] = taps4(dwx, a[kx], a[kx + 1], a[kx + 2], a[kx + 3]);
    }
    if (r >= 3) {
      const int ky = r - 3;
#pragma unroll
      for (int kx = 0; kx < PS; ++kx) {
        const float v = taps4(wy, rv[ky][kx], rv[ky + 1][kx],
                              rv[ky + 2][kx], rv[ky + 3][kx]);
        const float gx = taps4(wy, rd[ky][kx], rd[ky + 1][kx],
                               rd[ky + 2][kx], rd[ky + 3][kx]);
        const float gy = taps4(dwy, rv[ky][kx], rv[ky + 1][kx],
                               rv[ky + 2][kx], rv[ky + 3][kx]);
        emit(ky * PS + kx, v, gx, gy);
      }
    }
  }
}

template <int R, int NORM>
__global__ void __launch_bounds__(kThreads)
bicubic_stats_kernel(const float* __restrict__ planes,
                     const float2* __restrict__ uv,
                     const unsigned char* __restrict__ valid,
                     const float* __restrict__ patch,
                     float* __restrict__ out,
                     int n, int w, int c, int h, int wi) {
  constexpr int PS = 2 * R + 1;
  constexpr int WIN = PS + 3;
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
    const float flx = floorf(q.x);
    const float fly = floorf(q.y);
    float wx[4], dwx[4], wy[4], dwy[4];
    catmull_rom(q.x - flx, wx, dwx);
    catmull_rom(q.y - fly, wy, dwy);
    const int x0 = min(max(static_cast<int>(flx) - R - 1, 0), wi - WIN);
    const int y0 = min(max(static_cast<int>(fly) - R - 1, 0), h - WIN);

    for (int ch = 0; ch < c; ++ch) {
      const float* win = planes +
                         (static_cast<long long>(f) * c + ch) * h * wi +
                         static_cast<long long>(y0) * wi + x0;
      auto sweep_channel = [&](auto&& emit) {
        sweep<R>(pb::opaque(win), wi, wx, dwx, wy, dwy, emit);
      };
      const float* desc = patch + (static_cast<long long>(p) * c + ch) * P;
      pb::channel_stats<P, NORM>(sweep_channel, desc, acc);
    }
  }
  const long long o = static_cast<long long>(f) * n + p;
#pragma unroll
  for (int k = 0; k < 6; ++k) out[k * total + o] = acc[k];
}

template <int R, int NORM>
void launch(const void* planes, const void* uv, const void* valid,
            const void* patch, void* out, int n, int w, int c, int h, int wi,
            cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * w;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  bicubic_stats_kernel<R, NORM><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(planes), static_cast<const float2*>(uv),
      static_cast<const unsigned char*>(valid),
      static_cast<const float*>(patch), static_cast<float*>(out), n, w, c, h,
      wi);
}

}  // namespace

extern "C" int pb_bicubic_stats(const void* planes, const void* uv,
                                const void* valid, const void* patch,
                                void* out, int n, int w, int c, int h, int wi,
                                int radius, int norm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = pb::dispatch(radius, norm, [&](auto r, auto m) {
    launch<decltype(r)::value, decltype(m)::value>(planes, uv, valid, patch,
                                                   out, n, w, c, h, wi, s);
  });
  return bad ? bad : static_cast<int>(cudaGetLastError());
}

extern "C" const char* pb_bicubic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
