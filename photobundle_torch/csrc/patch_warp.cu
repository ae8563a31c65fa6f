// Fused patch sampling + Gauss-Newton statistics for Hopper (sm_90a).
//
// Replaces photobundle_tpu/ops/patch_warp.py::_warp_kernel_packed (with its
// _packed_epilogue and _make_mseg, launched by warp_patches_grouped and
// reduced by core/residuals._grouped_stats). Same contract, none of the TPU
// layout: for every observation (point p, window frame f) it
//   1. bilinearly samples value, d/dx and d/dy on the integer (2R+1)^2
//      patch grid at uv[p, f] (one subpixel phase per patch),
//   2. normalizes each channel's patch and subtracts the reference
//      descriptor: off, mean (each plane centred on its patch mean) or
//      affine (the ZNCC unit norm with its exact Jacobian; with it this
//      kernel also replaces the JAX package's K4,
//      photobundle_tpu/ops/patch_warp.py::_warp_kernel, whose (s, gx, gy)
//      XLA normalizes and reduces, core/residuals.py:830-850),
//   3. reduces to the six sums [gx*gx, gx*gy, gy*gy, gx*r, gy*r, r*r],
//      summed over channels after the per-channel normalization
//      (the epilogue in csrc/patch_epilogue.cuh),
// and stores them un-whitened at out[k, f, p] (k = 0..5). Invalid
// observations store exact zeros: downstream masking multiplies, and
// NaN * 0 is NaN, so their sums must be finite; their coordinates are
// never floored or cast.
//
// Inputs: planes (W, C, H, Wi) float4 = (value, d/dx, d/dy, 0), built once
// per solve so that one 16-byte load serves all three planes (the GPU twin
// of the TPU panels' lane interleave); uv (N, W) float2; valid (N, W) bytes;
// patch (N, C, P) f32. Window reads are clamped inside the image.
//
// What bounds it on this card: at the solver's full-size window (4096
// points x 5 frames) there are ~20k observations, each reading a
// (2R+2)^2 window of float4 texels (~600 B at R = 2) and storing 24 B. That
// is ~12 MB of reads out of an L2-resident 36 MB plane set: a few
// microseconds of bandwidth. The kernel is bound by latency (dependent
// gathers per thread, only ~150 threads per SM) and by launch overhead, not
// by bandwidth or L2.
//
// What the design does about it: one thread per observation, R and the
// normalization mode template parameters, every patch loop unrolled, so
// the texel loads of a whole pass are independent and in flight at once.
// The epilogue re-samples the window once per pass (two for mean, three
// for affine) from L1 instead of holding the patch in registers across
// passes. Register use still grows with R (ptxas spills from R = 3 on in
// the mean and affine modes), which costs less than it saves: rolling the
// row loop to keep registers flat made the kernel 1.8x slower at R = 2
// (kernel_times.py). Threads are frame-major, so neighbouring threads
// store neighbouring outputs. No atomics and no cross-thread reduction:
// each thread writes its own sums in a fixed order, so results are
// bitwise reproducible run to run. Centring happens before multiplying
// (never the one-pass sum(ab) - P*mean(a)*mean(b) form, which cancels in
// f32).

#include <cuda_runtime.h>

#include "patch_epilogue.cuh"

namespace {

constexpr int kThreads = 64;

struct Weights {
  float w00, w01, w10, w11;
};

// Bilinear combine of value/gx/gy at window cell (ky, kx), in the tap
// order of the TPU kernel: w00*a + w01*b + w10*c + w11*d.
__device__ __forceinline__ float3 sample(const float4* __restrict__ win,
                                         int wi, int ky, int kx,
                                         const Weights& q) {
  const float4* r0 = win + static_cast<long long>(ky) * wi + kx;
  const float4 a = __ldg(r0);
  const float4 b = __ldg(r0 + 1);
  const float4 c = __ldg(r0 + wi);
  const float4 d = __ldg(r0 + wi + 1);
  return make_float3(q.w00 * a.x + q.w01 * b.x + q.w10 * c.x + q.w11 * d.x,
                     q.w00 * a.y + q.w01 * b.y + q.w10 * c.y + q.w11 * d.y,
                     q.w00 * a.z + q.w01 * b.z + q.w10 * c.z + q.w11 * d.z);
}

template <int R, int NORM>
__global__ void __launch_bounds__(kThreads)
patch_stats_kernel(const float4* __restrict__ planes,
                   const float2* __restrict__ uv,
                   const unsigned char* __restrict__ valid,
                   const float* __restrict__ patch,
                   float* __restrict__ out,
                   int n, int w, int c, int h, int wi) {
  constexpr int PS = 2 * R + 1;
  constexpr int WIN = PS + 1;
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
    const float fx = q.x - flx;
    const float fy = q.y - fly;
    const int x0 = min(max(static_cast<int>(flx) - R, 0), wi - WIN);
    const int y0 = min(max(static_cast<int>(fly) - R, 0), h - WIN);
    const float one_fy = 1.f - fy;
    const Weights wt = {(1.f - fx) * one_fy, fx * one_fy, (1.f - fx) * fy,
                        fx * fy};

    for (int ch = 0; ch < c; ++ch) {
      const float4* win = planes +
                          (static_cast<long long>(f) * c + ch) * h * wi +
                          static_cast<long long>(y0) * wi + x0;
      auto sweep = [&](auto&& emit) {
        const float4* wv = pb::opaque(win);
#pragma unroll
        for (int ky = 0; ky < PS; ++ky) {
#pragma unroll
          for (int kx = 0; kx < PS; ++kx) {
            const float3 s = sample(wv, wi, ky, kx, wt);
            emit(ky * PS + kx, s.x, s.y, s.z);
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
void launch(const void* planes, const void* uv, const void* valid,
            const void* patch, void* out, int n, int w, int c, int h, int wi,
            cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * w;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  patch_stats_kernel<R, NORM><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float4*>(planes), static_cast<const float2*>(uv),
      static_cast<const unsigned char*>(valid),
      static_cast<const float*>(patch), static_cast<float*>(out), n, w, c, h,
      wi);
}

}  // namespace

extern "C" int pb_patch_stats(const void* planes, const void* uv,
                              const void* valid, const void* patch, void* out,
                              int n, int w, int c, int h, int wi, int radius,
                              int norm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = pb::dispatch(radius, norm, [&](auto r, auto m) {
    launch<decltype(r)::value, decltype(m)::value>(planes, uv, valid, patch,
                                                   out, n, w, c, h, wi, s);
  });
  return bad ? bad : static_cast<int>(cudaGetLastError());
}

extern "C" const char* pb_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
