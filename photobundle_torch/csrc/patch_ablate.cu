// K1 with its stages switched off: the ablation of the fused patch-stats
// kernel, for Hopper (sm_90a).
//
// Replaces tools/ablate_packed_kernel.py::ablate_kernel (K8), the JAX
// package's TPU twin of K1 with op classes stubbed out, which attributes
// K1's per-observation time to its stages. This is K1's mean-mode kernel
// (csrc/patch_warp.cu) at R = 2 with two compile-time switches:
//
//   STAGE, the last stage the kernel runs (each a definite function):
//     loads    sum of the window's raw texels, (x + y) + z over the
//              (2R+2)^2 window, channels outer (the twin of "no combine":
//              the loads stay live, nothing else runs);
//     combine  sum of the bilinear samples, (s + gx) + gy over the patch
//              ("no center matmul" without the descriptor);
//     subtract the same with the descriptor subtracted from s ("no subd"
//              reversed: the twin stubs it, this adds it);
//     center   K1's two passes: the means of s - d, gx and gy, then the
//              sum of the centred ((s - d) - m) + (gx - mx) + (gy - my)
//              ("no stats tail"; summing all three keeps every centring
//              live);
//     full     K1's six sums, bitwise K1 ("full (baseline)").
//   The partial stages store their one sum in row 0 of K1's (6, W, N)
//   output and zeros in rows 1-5, so every stage stores what K1 stores.
//   SHARED, whose window each thread reads:
//     own      its observation's window, as K1;
//     shared   its block's first observation's window (frame, origin and
//              weights; that observation's coordinate read only where it
//              is valid, (0, 0) otherwise): every thread loads the same
//              texels, the L1-hit ceiling with no divergent loads (the
//              twin of "static y0+pan").
//   Threads per block (64, 128 or 256) are a launch argument, the twin of
//   the TPU's gchunk. The TPU's lane-roll, select, superwindow and matmul
//   knobs answer its lane layout and have no counterpart; sorted dispatch
//   (csrc/patch_warp.cu's second entry) already measures shared windows
//   on real data.
//
// Observations without validity store zeros. What bounds it: K1's bytes;
// its design: K1's (one thread per observation, unrolled patch loops,
// -fmad=false, sums in a fixed order).

#include <cuda_runtime.h>

#include "patch_bilinear.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kR = 2;

enum Stage : int {
  kLoads = 0,
  kCombine = 1,
  kSubtract = 2,
  kCenter = 3,
  kFull = 4
};

template <int STAGE>
__device__ __forceinline__ float partial_stage(const float4* wc, int stride,
                                               const pb::Weights& q,
                                               const float* __restrict__ d,
                                               float acc) {
  constexpr int PS = 2 * kR + 1;
  constexpr int WIN = PS + 1;
  constexpr int P = PS * PS;
  if constexpr (STAGE == kLoads) {
#pragma unroll
    for (int ky = 0; ky < WIN; ++ky) {
#pragma unroll
      for (int kx = 0; kx < WIN; ++kx) {
        const float4 t = __ldg(wc + static_cast<long long>(ky) * stride + kx);
        acc += (t.x + t.y) + t.z;
      }
    }
  } else if constexpr (STAGE == kCombine || STAGE == kSubtract) {
#pragma unroll
    for (int ky = 0; ky < PS; ++ky) {
#pragma unroll
      for (int kx = 0; kx < PS; ++kx) {
        const float3 s = pb::sample(wc, stride, ky, kx, q, pb::LoadGlobal{});
        float v = s.x;
        if constexpr (STAGE == kSubtract) v = v - __ldg(d + ky * PS + kx);
        acc += (v + s.y) + s.z;
      }
    }
  } else {
    static_assert(STAGE == kCenter, "unknown stage");
    const float inv_p = 1.f / static_cast<float>(P);
    float mv = 0.f, mx = 0.f, my = 0.f;
    const float4* w1 = pb::opaque(wc);
    const float* d1 = pb::opaque(d);
#pragma unroll
    for (int ky = 0; ky < PS; ++ky) {
#pragma unroll
      for (int kx = 0; kx < PS; ++kx) {
        const float3 s = pb::sample(w1, stride, ky, kx, q, pb::LoadGlobal{});
        mv += s.x - __ldg(d1 + ky * PS + kx);
        mx += s.y;
        my += s.z;
      }
    }
    mv *= inv_p;
    mx *= inv_p;
    my *= inv_p;
    const float4* w2 = pb::opaque(wc);
    const float* d2 = pb::opaque(d);
#pragma unroll
    for (int ky = 0; ky < PS; ++ky) {
#pragma unroll
      for (int kx = 0; kx < PS; ++kx) {
        const float3 s = pb::sample(w2, stride, ky, kx, q, pb::LoadGlobal{});
        acc += (((s.x - __ldg(d2 + ky * PS + kx)) - mv) + (s.y - mx)) +
               (s.z - my);
      }
    }
  }
  return acc;
}

template <int STAGE, bool SHARED>
__global__ void __launch_bounds__(kMaxThreads)
ablate_kernel(const float4* __restrict__ planes,
              const float2* __restrict__ uv,
              const unsigned char* __restrict__ valid,
              const float* __restrict__ patch, float* __restrict__ out, int n,
              int w, int c, int h, int wi) {
  constexpr int P = (2 * kR + 1) * (2 * kR + 1);
  const long long total = static_cast<long long>(n) * w;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int f = static_cast<int>(idx / n);
  const int p = static_cast<int>(idx - static_cast<long long>(f) * n);
  const long long obs = static_cast<long long>(p) * w + f;
  // The observation whose window this thread reads.
  const long long src =
      SHARED ? static_cast<long long>(blockIdx.x) * blockDim.x : idx;
  const int fs = static_cast<int>(src / n);
  const int ps = static_cast<int>(src - static_cast<long long>(fs) * n);
  const long long obs_s = static_cast<long long>(ps) * w + fs;

  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (valid[obs]) {
    const float2 q =
        (!SHARED || valid[obs_s]) ? uv[obs_s] : make_float2(0.f, 0.f);
    int x0, y0;
    pb::Weights wt;
    pb::window_at<kR>(q, h, wi, &x0, &y0, &wt);
    const long long chan = static_cast<long long>(h) * wi;
    const float4* win = planes + static_cast<long long>(fs) * c * chan +
                        static_cast<long long>(y0) * wi + x0;
    const float* desc = patch + static_cast<long long>(p) * c * P;
    if constexpr (STAGE == kFull) {
      pb::observation_stats<kR, pb::kNormMean>(win, chan, wi, wt, desc, c,
                                               pb::LoadGlobal{}, acc);
    } else {
      for (int ch = 0; ch < c; ++ch) {
        acc[0] = partial_stage<STAGE>(win + ch * chan, wi, wt,
                                      desc + static_cast<long long>(ch) * P,
                                      acc[0]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) out[k * total + idx] = acc[k];
}

template <int STAGE, bool SHARED>
void launch(const void* planes, const void* uv, const void* valid,
            const void* patch, void* out, int n, int w, int c, int h, int wi,
            int threads, cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * w;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  ablate_kernel<STAGE, SHARED><<<blocks, threads, 0, stream>>>(
      static_cast<const float4*>(planes), static_cast<const float2*>(uv),
      static_cast<const unsigned char*>(valid),
      static_cast<const float*>(patch), static_cast<float*>(out), n, w, c, h,
      wi);
}

template <bool SHARED>
int launch_stage(int stage, const void* planes, const void* uv,
                 const void* valid, const void* patch, void* out, int n,
                 int w, int c, int h, int wi, int threads,
                 cudaStream_t stream) {
  switch (stage) {
    case kLoads:
      launch<kLoads, SHARED>(planes, uv, valid, patch, out, n, w, c, h, wi,
                             threads, stream);
      return 0;
    case kCombine:
      launch<kCombine, SHARED>(planes, uv, valid, patch, out, n, w, c, h, wi,
                               threads, stream);
      return 0;
    case kSubtract:
      launch<kSubtract, SHARED>(planes, uv, valid, patch, out, n, w, c, h,
                                wi, threads, stream);
      return 0;
    case kCenter:
      launch<kCenter, SHARED>(planes, uv, valid, patch, out, n, w, c, h, wi,
                              threads, stream);
      return 0;
    case kFull:
      launch<kFull, SHARED>(planes, uv, valid, patch, out, n, w, c, h, wi,
                            threads, stream);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// stage 0..4 (loads, combine, subtract, center, full); shared 0 (own) or 1;
// threads 1..256 per block. out: (6, W, N) f32. Returns 0 or a CUDA error
// code (cudaErrorInvalidValue, with nothing launched, for an unknown
// stage or a thread count out of range).
extern "C" int pb_ablate_stats(const void* planes, const void* uv,
                               const void* valid, const void* patch,
                               void* out, int n, int w, int c, int h, int wi,
                               int stage, int shared, int threads,
                               void* stream) {
  if (threads < 1 || threads > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad =
      shared ? launch_stage<true>(stage, planes, uv, valid, patch, out, n, w,
                                  c, h, wi, threads, s)
             : launch_stage<false>(stage, planes, uv, valid, patch, out, n, w,
                                   c, h, wi, threads, s);
  return bad ? bad : static_cast<int>(cudaGetLastError());
}

extern "C" const char* pb_ablate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
