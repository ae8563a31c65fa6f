// Fused patch sampling + centring + Gauss-Newton sums, K7, for Hopper
// (sm_90a).
//
// Replaces photobundle_tpu/ops/patch_stats.py::_stats_kernel (launched by
// its patch_stats), in both of its modes. For every observation (point p,
// window frame f), frame-major (row f * N + p):
//   full:      bilinearly sample value s, d/dx gx and d/dy gy on the
//              integer (2R+1)^2 patch grid at uv[p, f] (K1's sampling,
//              csrc/patch_bilinear.cuh), centre each of the three on its
//              own patch mean, r = s_c - d, and store the six sums
//              [gx gx, gx gy, gy gy, gx r, gy r, r r, 0, 0] summed over
//              channels (patch_stats.py:153-163);
//   cost_only: sample the value alone from value planes, r = (s - mean s)
//              - d, and store [0, 0, 0, 0, 0, r r, 0, 0]
//              (patch_stats.py:136-142).
// The value samples, their mean and r are computed by the same operations
// in the same order in both modes, so cost_only's r r equals full's
// bitwise. K7 centres s before subtracting the descriptor; K1's mean mode
// (csrc/patch_epilogue.cuh) centres s - d, so K7 keeps its own epilogue.
// Invalid observations store zeros; their coordinate (possibly NaN) is
// never read. The window is clamped inside the image.
//
// Inputs: full: planes (W, C, H, Wi) float4 = (value, d/dx, d/dy, 0), K1's;
// cost_only: value planes (W, C, H, Wi) f32, a quarter of the bytes (the
// twin of the TPU's value-only panels); uv (N, W) float2; valid (N, W)
// bytes; desc (N, C, P) f32, mean-normalized descriptors.
//
// What bounds it on this card: the bytes of K1 (the distinct window
// texels, from HBM or L2, and 32 B stored per observation), a few
// microseconds at the solver's 4096 x 5 window; cost_only reads a quarter
// of the texel bytes. As K1: one thread per observation, R a template
// parameter and the patch loops unrolled so a pass's loads are in flight
// together; two passes over the window (the means, then the centred
// products), the second re-read from L1 through pb::opaque; no atomics, so
// the sums are bitwise reproducible.

#include <cuda_runtime.h>

#include "patch_bilinear.cuh"

namespace {

constexpr int kThreads = 64;

template <int R, bool COST_ONLY>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const void* __restrict__ planes, const float2* __restrict__ uv,
             const unsigned char* __restrict__ valid,
             const float* __restrict__ desc, float* __restrict__ out, int n,
             int w, int c, int h, int wi) {
  constexpr int PS = 2 * R + 1;
  constexpr int P = PS * PS;
  const long long m = static_cast<long long>(n) * w;
  const long long o =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= m) return;
  const int f = static_cast<int>(o / n);
  const int p = static_cast<int>(o - static_cast<long long>(f) * n);
  const long long obs = static_cast<long long>(p) * w + f;

  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (valid[obs]) {
    int x0, y0;
    pb::Weights q;
    pb::window_at<R>(uv[obs], h, wi, &x0, &y0, &q);
    const float inv_p = 1.f / static_cast<float>(P);
    const long long chan = static_cast<long long>(h) * wi;
    for (int ch = 0; ch < c; ++ch) {
      const long long origin = (static_cast<long long>(f) * c + ch) * chan +
                               static_cast<long long>(y0) * wi + x0;
      const float* d = pb::opaque(desc + (static_cast<long long>(p) * c + ch) * P);
      if constexpr (COST_ONLY) {
        const float* win = static_cast<const float*>(planes) + origin;
        float ms = 0.f;
        const float* w1 = pb::opaque(win);
#pragma unroll
        for (int ky = 0; ky < PS; ++ky) {
#pragma unroll
          for (int kx = 0; kx < PS; ++kx) ms += pb::sample_value(w1, wi, ky, kx, q);
        }
        ms *= inv_p;
        float rr = 0.f;
        const float* w2 = pb::opaque(win);
#pragma unroll
        for (int ky = 0; ky < PS; ++ky) {
#pragma unroll
          for (int kx = 0; kx < PS; ++kx) {
            const float r =
                (pb::sample_value(w2, wi, ky, kx, q) - ms) - __ldg(d + ky * PS + kx);
            rr += r * r;
          }
        }
        acc[5] += rr;
      } else {
        const float4* win = static_cast<const float4*>(planes) + origin;
        float ms = 0.f, mx = 0.f, my = 0.f;
        const float4* w1 = pb::opaque(win);
#pragma unroll
        for (int ky = 0; ky < PS; ++ky) {
#pragma unroll
          for (int kx = 0; kx < PS; ++kx) {
            const float3 s = pb::sample(w1, wi, ky, kx, q, pb::LoadGlobal{});
            ms += s.x;
            mx += s.y;
            my += s.z;
          }
        }
        ms *= inv_p;
        mx *= inv_p;
        my *= inv_p;
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f, s5 = 0.f;
        const float4* w2 = pb::opaque(win);
#pragma unroll
        for (int ky = 0; ky < PS; ++ky) {
#pragma unroll
          for (int kx = 0; kx < PS; ++kx) {
            const float3 s = pb::sample(w2, wi, ky, kx, q, pb::LoadGlobal{});
            const float gx = s.y - mx;
            const float gy = s.z - my;
            const float r = (s.x - ms) - __ldg(d + ky * PS + kx);
            s0 += gx * gx;
            s1 += gx * gy;
            s2 += gy * gy;
            s3 += gx * r;
            s4 += gy * r;
            s5 += r * r;
          }
        }
        acc[0] += s0;
        acc[1] += s1;
        acc[2] += s2;
        acc[3] += s3;
        acc[4] += s4;
        acc[5] += s5;
      }
    }
  }
  float4* row = reinterpret_cast<float4*>(out + o * 8);
  row[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  row[1] = make_float4(acc[4], acc[5], 0.f, 0.f);
}

template <int R, bool COST_ONLY>
void launch(const void* planes, const void* uv, const void* valid,
            const void* desc, void* out, int n, int w, int c, int h, int wi,
            cudaStream_t stream) {
  const long long m = static_cast<long long>(n) * w;
  const unsigned blocks = static_cast<unsigned>((m + kThreads - 1) / kThreads);
  stats_kernel<R, COST_ONLY><<<blocks, kThreads, 0, stream>>>(
      planes, static_cast<const float2*>(uv),
      static_cast<const unsigned char*>(valid),
      static_cast<const float*>(desc), static_cast<float*>(out), n, w, c, h,
      wi);
}

template <int R>
void launch_mode(int cost_only, const void* planes, const void* uv,
                 const void* valid, const void* desc, void* out, int n, int w,
                 int c, int h, int wi, cudaStream_t stream) {
  if (cost_only) {
    launch<R, true>(planes, uv, valid, desc, out, n, w, c, h, wi, stream);
  } else {
    launch<R, false>(planes, uv, valid, desc, out, n, w, c, h, wi, stream);
  }
}

}  // namespace

// out: (W * N, 8) f32, frame-major rows. cost_only: 0 or 1 (planes are
// then value planes). Returns 0 or a CUDA error code
// (cudaErrorInvalidValue, with nothing launched, for a radius outside 1..4).
extern "C" int pb_k7_stats(const void* planes, const void* uv,
                           const void* valid, const void* desc, void* out,
                           int n, int w, int c, int h, int wi, int radius,
                           int cost_only, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 1:
      launch_mode<1>(cost_only, planes, uv, valid, desc, out, n, w, c, h, wi, s);
      break;
    case 2:
      launch_mode<2>(cost_only, planes, uv, valid, desc, out, n, w, c, h, wi, s);
      break;
    case 3:
      launch_mode<3>(cost_only, planes, uv, valid, desc, out, n, w, c, h, wi, s);
      break;
    case 4:
      launch_mode<4>(cost_only, planes, uv, valid, desc, out, n, w, c, h, wi, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pb_k7_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
