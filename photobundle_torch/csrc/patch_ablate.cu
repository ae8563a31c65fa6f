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
//              is valid, (0, 0) otherwise), staged once: every thread
//              reads the same texels, the ceiling with one window's copy
//              a block (the twin of "static y0+pan").
//   Threads per block (64, 128 or 256; one instance each), the twin of
//   the TPU's gchunk. The TPU's lane-roll, select, superwindow and matmul
//   knobs answer its lane layout and have no counterpart; sorted dispatch
//   (csrc/patch_warp.cu's second entry) already measures shared windows
//   on real data.
//
// Observations without validity store zeros. What bounds it: K1's bytes.
// Its design is K1's (csrc/patch_warp.cu) at R = 2, where K1 stages: the
// block's windows copied into shared memory with K1's coalesced cp.async
// copy (csrc/patch_stage.cuh; THREADS observations a block, channels
// double-buffered where two buffers fit, else one), then each thread's
// stage from its window in the tile ('shared': the block's one window,
// staged once). So 'loads' measures the copy K1 makes and summing the
// staged texels, and full/own at 64 threads is K1's kernel. Every loop is
// unrolled, -fmad=false, sums in a fixed order.

#include <cuda_runtime.h>

#include "patch_bilinear.cuh"
#include "patch_stage.cuh"

namespace {

constexpr int kR = 2;

enum Stage : int {
  kLoads = 0,
  kCombine = 1,
  kSubtract = 2,
  kCenter = 3,
  kFull = 4
};

// One channel's partial stage on a window whose rows are `stride` texels
// apart, its texels read with `load`.
template <int STAGE, typename Load>
__device__ __forceinline__ float partial_stage(const float4* wc, int stride,
                                               const pb::Weights& q,
                                               const float* __restrict__ d,
                                               float acc, Load load) {
  constexpr int PS = 2 * kR + 1;
  constexpr int WIN = PS + 1;
  constexpr int P = PS * PS;
  if constexpr (STAGE == kLoads) {
#pragma unroll
    for (int ky = 0; ky < WIN; ++ky) {
#pragma unroll
      for (int kx = 0; kx < WIN; ++kx) {
        const float4 t = load(wc + static_cast<long long>(ky) * stride + kx);
        acc += (t.x + t.y) + t.z;
      }
    }
  } else if constexpr (STAGE == kCombine || STAGE == kSubtract) {
#pragma unroll
    for (int ky = 0; ky < PS; ++ky) {
#pragma unroll
      for (int kx = 0; kx < PS; ++kx) {
        const float3 s = pb::sample(wc, stride, ky, kx, q, load);
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
        const float3 s = pb::sample(w1, stride, ky, kx, q, load);
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
        const float3 s = pb::sample(w2, stride, ky, kx, q, load);
        acc += (((s.x - __ldg(d2 + ky * PS + kx)) - mv) + (s.y - mx)) +
               (s.z - my);
      }
    }
  }
  return acc;
}

// The ablated K1: THREADS observations a block (frame-major), their
// windows ('shared': the block's first observation's window) staged one
// channel at a time, then each thread's stage from the tile.
template <int STAGE, bool SHARED, int THREADS>
__global__ void __launch_bounds__(THREADS)
ablate_kernel(const float4* __restrict__ planes,
              const float2* __restrict__ uv,
              const unsigned char* __restrict__ valid,
              const float* __restrict__ patch, float* __restrict__ out, int n,
              int w, int c, int h, int wi) {
  using PL = pb::Plan<kR, SHARED ? 1 : THREADS>;
  constexpr int P = (2 * kR + 1) * (2 * kR + 1);
  extern __shared__ float4 tile[];
  __shared__ long long base[PL::kObs];
  const long long total = static_cast<long long>(n) * w;
  const long long idx =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const bool live = idx < total;
  const int f = live ? static_cast<int>(idx / n) : 0;
  const int p = live ? static_cast<int>(idx - static_cast<long long>(f) * n)
                     : 0;
  const long long obs = static_cast<long long>(p) * w + f;
  const bool ok = live && valid[obs];
  const long long chan = static_cast<long long>(h) * wi;

  pb::Weights wt = {0.f, 0.f, 0.f, 0.f};
  if constexpr (SHARED) {
    // The block's first observation (always live): its coordinate where it
    // is valid, (0, 0) otherwise. Every thread reads the same window.
    const long long src = static_cast<long long>(blockIdx.x) * THREADS;
    const int fs = static_cast<int>(src / n);
    const int ps = static_cast<int>(src - static_cast<long long>(fs) * n);
    const long long obs_s = static_cast<long long>(ps) * w + fs;
    const float2 q = valid[obs_s] ? uv[obs_s] : make_float2(0.f, 0.f);
    int x0, y0;
    pb::window_at<kR>(q, h, wi, &x0, &y0, &wt);
    if (threadIdx.x == 0) {
      base[0] = static_cast<long long>(fs) * c * chan +
                static_cast<long long>(y0) * wi + x0;
    }
  } else {
    base[threadIdx.x] = -1;
    if (ok) {
      int x0, y0;
      pb::window_at<kR>(uv[obs], h, wi, &x0, &y0, &wt);
      base[threadIdx.x] = static_cast<long long>(f) * c * chan +
                          static_cast<long long>(y0) * wi + x0;
    }
  }
  __syncthreads();
  const float* desc = patch + static_cast<long long>(p) * c * P;
  const int own = SHARED ? 0 : threadIdx.x;   // this thread's tile window
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  pb::stage_channel<kR, PL::kObs, THREADS>(tile, planes, base, 0, wi);
  pb::cp_async_commit();
  for (int ch = 0; ch < c; ++ch) {
    if (PL::kBuffers == 2 && ch + 1 < c) {   // ch + 1 in flight meanwhile
      pb::stage_channel<kR, PL::kObs, THREADS>(
          tile + ((ch + 1) & 1) * PL::kObs * PL::kStride, planes, base,
          (ch + 1) * chan, wi);
      pb::cp_async_commit();
      pb::cp_async_wait<1>();
    } else {
      pb::cp_async_wait<0>();
    }
    __syncthreads();
    if (ok) {
      const float4* win =
          tile + ((PL::kBuffers == 2 ? ch & 1 : 0) * PL::kObs + own) *
                     PL::kStride;
      const float* dc = desc + static_cast<long long>(ch) * P;
      if constexpr (STAGE == kFull) {
        pb::observation_stats<kR, pb::kNormMean>(win, 0, PL::kWin, wt, dc, 1,
                                                 pb::LoadPlain{}, acc);
      } else {
        acc[0] = partial_stage<STAGE>(win, PL::kWin, wt, dc, acc[0],
                                      pb::LoadPlain{});
      }
    }
    __syncthreads();   // the buffer is refilled
    if (PL::kBuffers == 1 && ch + 1 < c) {
      pb::stage_channel<kR, PL::kObs, THREADS>(tile, planes, base,
                                               (ch + 1) * chan, wi);
      pb::cp_async_commit();
    }
  }
  if (!live) return;
#pragma unroll
  for (int k = 0; k < 6; ++k) out[k * total + idx] = acc[k];
}

template <int STAGE, bool SHARED, int THREADS>
void launch(const void* planes, const void* uv, const void* valid,
            const void* patch, void* out, int n, int w, int c, int h, int wi,
            cudaStream_t stream) {
  using PL = pb::Plan<kR, SHARED ? 1 : THREADS>;
  const long long total = static_cast<long long>(n) * w;
  const unsigned blocks =
      static_cast<unsigned>((total + THREADS - 1) / THREADS);
  // Above 48 KB a kernel's dynamic shared memory must be opted into; once
  // per instance. A failure surfaces as the launch's error.
  static const cudaError_t opted = cudaFuncSetAttribute(
      ablate_kernel<STAGE, SHARED, THREADS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, PL::kMaxBytes);
  (void)opted;
  ablate_kernel<STAGE, SHARED, THREADS>
      <<<blocks, THREADS, PL::bytes(c), stream>>>(
          static_cast<const float4*>(planes), static_cast<const float2*>(uv),
          static_cast<const unsigned char*>(valid),
          static_cast<const float*>(patch), static_cast<float*>(out), n, w,
          c, h, wi);
}

template <bool SHARED, int THREADS>
int launch_stage(int stage, const void* planes, const void* uv,
                 const void* valid, const void* patch, void* out, int n,
                 int w, int c, int h, int wi, cudaStream_t stream) {
  switch (stage) {
    case kLoads:
      launch<kLoads, SHARED, THREADS>(planes, uv, valid, patch, out, n, w, c,
                                      h, wi, stream);
      return 0;
    case kCombine:
      launch<kCombine, SHARED, THREADS>(planes, uv, valid, patch, out, n, w,
                                        c, h, wi, stream);
      return 0;
    case kSubtract:
      launch<kSubtract, SHARED, THREADS>(planes, uv, valid, patch, out, n, w,
                                         c, h, wi, stream);
      return 0;
    case kCenter:
      launch<kCenter, SHARED, THREADS>(planes, uv, valid, patch, out, n, w,
                                       c, h, wi, stream);
      return 0;
    case kFull:
      launch<kFull, SHARED, THREADS>(planes, uv, valid, patch, out, n, w, c,
                                     h, wi, stream);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int THREADS>
int launch_threads(int stage, int shared, const void* planes, const void* uv,
                   const void* valid, const void* patch, void* out, int n,
                   int w, int c, int h, int wi, cudaStream_t stream) {
  return shared ? launch_stage<true, THREADS>(stage, planes, uv, valid, patch,
                                              out, n, w, c, h, wi, stream)
                : launch_stage<false, THREADS>(stage, planes, uv, valid,
                                               patch, out, n, w, c, h, wi,
                                               stream);
}

}  // namespace

// stage 0..4 (loads, combine, subtract, center, full); shared 0 (own) or 1;
// threads per block 64, 128 or 256. out: (6, W, N) f32. Returns 0 or a
// CUDA error code (cudaErrorInvalidValue, with nothing launched, for an
// unknown stage or thread count).
extern "C" int pb_ablate_stats(const void* planes, const void* uv,
                               const void* valid, const void* patch,
                               void* out, int n, int w, int c, int h, int wi,
                               int stage, int shared, int threads,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int bad;
  switch (threads) {
    case 64:
      bad = launch_threads<64>(stage, shared, planes, uv, valid, patch, out,
                               n, w, c, h, wi, s);
      break;
    case 128:
      bad = launch_threads<128>(stage, shared, planes, uv, valid, patch, out,
                                n, w, c, h, wi, s);
      break;
    case 256:
      bad = launch_threads<256>(stage, shared, planes, uv, valid, patch, out,
                                n, w, c, h, wi, s);
      break;
    default:
      bad = static_cast<int>(cudaErrorInvalidValue);
  }
  return bad ? bad : static_cast<int>(cudaGetLastError());
}

extern "C" const char* pb_ablate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
