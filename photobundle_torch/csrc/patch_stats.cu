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
// in the same order in both modes and in every design below, so
// cost_only's r r equals full's bitwise. K7 centres s before subtracting
// the descriptor; K1's mean mode (csrc/patch_epilogue.cuh) centres s - d,
// so K7 keeps its own epilogue (channel_sums). Every sum is taken over
// centred terms in patch order, never in the one-pass form
// sum(a^2) - P mean(a)^2, which cancels in f32. Invalid observations store
// zeros; their coordinate (possibly NaN) is never read. The window is
// clamped inside the image.
//
// Inputs: full: planes (W, C, H, Wi) float4 = (value, d/dx, d/dy, 0), K1's;
// cost_only: value planes (W, C, H, Wi) f32, a quarter of the bytes (the
// twin of the TPU's value-only panels); uv (N, W) float2; valid (N, W)
// bytes; desc (N, C, P) f32, mean-normalized descriptors.
//
// Patch radii 1..kMaxStatsRadius = 62, the reference's: its kernel reads a
// (2R+2)-px window from a 128-lane panel and returns wherever the panel
// stride 128 - (2R+2) is positive (photobundle_tpu/ops/patch_stats.py
// panel_stride). Compile-time instances to pb::kMaxSolveRadius, above it
// one runtime-radius instance per mode: the one-thread design with rolled
// loops, gathering from global memory as K1's and K2's runtime-radius
// instances do (a 126 x 126 float4 window at R = 62 is 254 KB: it cannot
// be staged).
//
// What bounds it on this card: the bytes of K1 (the distinct window
// texels, from HBM, and 32 B stored per observation), a few microseconds
// at the solver's 4096 x 5 window; cost_only reads a quarter of the texel
// bytes. The first design (one thread per observation, 64 a block,
// sampling the window twice: the means, then the centred products, the
// second pass re-read from L1) ran at 0.18 (full) and 0.14 (cost_only) of
// that bound: ~155 threads per SM keep few loads in flight against a cold
// L2, and every sample is computed twice.
//
// The designs, chosen per mode and radius at compile time (kTileRadii,
// kStagedRadii, kTiledRadii: where one kernel_times.py call, parent and
// change interleaved, measured each at least 3 % faster cold than the
// first design; PERF.md's K7 row; pb_k7_design says which runs):
//   - sampled every pass: the first design, unchanged (full R = 3, 4 and
//     8; cost_only everywhere but R = 3; the runtime-radius instance);
//   - the register tile (cost_only R = 3, 0.96x): one thread per
//     observation samples each channel's window once and holds its
//     samples in registers, and both passes read them (K3's register
//     tile); it ties elsewhere to R = 4 (its limit: rolled rows cannot
//     index registers), in the full mode too: recomputing the samples is
//     not what bounds K7;
//   - staged (full R = 1-2, 0.77x and 0.89x): a block of 64 observations
//     copies its windows into shared memory with K1's coalesced cp.async
//     copy (csrc/patch_stage.cuh, channels double-buffered), then each
//     thread samples its own window there on both passes; 0.97x at R = 3,
//     not kept;
//   - tiled (full R = 5-7 and 9, 0.82-0.88x the first design): a block of
//     kObs observations spreads its gathers over its 256 threads as
//     (observation, patch row) items, each writing its row's samples to a
//     tile in shared memory (odd word stride per observation); then each
//     observation's own thread reduces its tile in patch order (K3's tiled
//     design, csrc/patch_scaled.cu). It loses to staging at R = 1 (0.90x
//     the first design), and loses at R = 2-4 (1.17-1.31x), at R = 8
//     (1.4-1.6x at 64 and at 32 a block; not explained: the tiles take
//     223 KB of an SM's shared memory either way, which leaves L1 little
//     room), and in cost_only wherever measured (1.1-1.8x at R = 1-5 and
//     9: one thread in four reduces).
// The staged and tiled designs load each observation's coordinate beside
// its flag and prefetch its descriptor. Every design computes the same
// samples (the same taps and weights, -fmad=false) and reduces them in
// one thread, in the same order, without atomics, so every design's sums
// are bitwise the first design's; pb_k7_stats_one_thread runs that design
// at any radius for the check.

#include <cuda_runtime.h>

#include "patch_bilinear.cuh"
#include "patch_stage.cuh"

namespace {

constexpr int kOneThread = 64;      // threads (= observations) per block
constexpr int kThreads = 256;       // threads per block, tiled design
constexpr int kMaxStatsRadius = 62;     // ops/_common.STATS_MAX
constexpr int kFull = 0;                // modes: the C entry's cost_only
constexpr int kCostOnly = 1;

// The radii (bit R) at which each mode (full, cost_only) runs each design:
// where one kernel_times.py call measured it at least 3 % faster cold than
// the first design (see the note above); the first design elsewhere.
// kTiled64Radii: the tiled design's radii with 64 observations a block
// (32 at the others).
constexpr unsigned kTileRadii[2] = {0u, 1u << 3};
constexpr unsigned kStagedRadii[2] = {(1u << 1) | (1u << 2), 0u};
constexpr unsigned kTiledRadii[2] = {
    (1u << 5) | (1u << 6) | (1u << 7) | (1u << 9), 0u};
constexpr unsigned kTiled64Radii = (1u << 6) | (1u << 7);
template <int R, int MODE>
constexpr bool kTile = R >= 1 && ((kTileRadii[MODE] >> R) & 1u);
template <int R, int MODE>
constexpr bool kStaged = R >= 1 && ((kStagedRadii[MODE] >> R) & 1u);
template <int R, int MODE>
constexpr bool kTiled = R >= 1 && ((kTiledRadii[MODE] >> R) & 1u);

template <int R, int MODE>
constexpr bool check_designs() {
  static_assert(!kTile<R, MODE> || R < pb::kRolledRowRadius,
                "a register tile needs every patch loop unrolled");
  static_assert(!kStaged<R, MODE> ||
                    (MODE == kFull && R <= pb::kMaxStagedRadius),
                "K1's staged copy moves float4 texels, to kMaxStagedRadius");
  static_assert(!kTiled<R, MODE> ||
                    (!kStaged<R, MODE> && R <= pb::kMaxSolveRadius),
                "the tiled design is exclusive, compile-time radii only");
  return true;
}

__device__ __forceinline__ void store_row(float* __restrict__ out,
                                          long long o, const float acc[6]) {
  float4* row = reinterpret_cast<float4*>(out + o * 8);
  row[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  row[1] = make_float4(acc[4], acc[5], 0.f, 0.f);
}

// The staged and tiled designs read an observation's coordinate beside its
// validity flag (one memory latency before the window loads, not two; it
// is used only where the flag is set) and ask L1 for its descriptor at the
// start, so that the second pass, which reads it, does not wait for it.
__device__ __forceinline__ float2 coordinate(const float2* __restrict__ uv,
                                             bool live, long long obs) {
  return live ? uv[obs] : make_float2(0.f, 0.f);
}

__device__ __forceinline__ void prefetch_descriptor(const float* d, int n) {
  const unsigned long long end = reinterpret_cast<unsigned long long>(d + n);
  for (unsigned long long a = reinterpret_cast<unsigned long long>(d) &
                              ~127ull;
       a < end; a += 128) {
    asm volatile("prefetch.global.L1 [%0];" ::"l"(a));
  }
}

// One channel's sums of one observation, added to acc: sweep(emit) calls
// emit(k, v, gx, gy) for k = 0..P-1 in patch order (cost_only: gx = gy =
// 0), the same samples every time. Two passes: the means, then the
// centred products against the descriptor d (read through an opaque copy,
// so it is loaded where it is used).
template <int MODE, typename Sweep>
__device__ __forceinline__ void channel_sums(const Sweep& sweep,
                                             const float* __restrict__ d,
                                             int P, float acc[6]) {
  const float inv_p = 1.f / static_cast<float>(P);
  if constexpr (MODE == kCostOnly) {
    float ms = 0.f;
    sweep([&](int, float v, float, float) { ms += v; });
    ms *= inv_p;
    float rr = 0.f;
    const float* dp = pb::opaque(d);
    sweep([&](int k, float v, float, float) {
      const float r = (v - ms) - __ldg(dp + k);
      rr += r * r;
    });
    acc[5] += rr;
  } else {
    float ms = 0.f, mx = 0.f, my = 0.f;
    sweep([&](int, float v, float gx, float gy) {
      ms += v;
      mx += gx;
      my += gy;
    });
    ms *= inv_p;
    mx *= inv_p;
    my *= inv_p;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f, s5 = 0.f;
    const float* dp = pb::opaque(d);
    sweep([&](int k, float v, float sx, float sy) {
      const float gx = sx - mx;
      const float gy = sy - my;
      const float r = (v - ms) - __ldg(dp + k);
      s0 += gx * gx;
      s1 += gx * gy;
      s2 += gy * gy;
      s3 += gx * r;
      s4 += gy * r;
      s5 += r * r;
    });
    acc[0] += s0;
    acc[1] += s1;
    acc[2] += s2;
    acc[3] += s3;
    acc[4] += s4;
    acc[5] += s5;
  }
}

// emit(k, v, gx, gy) for the P samples of one channel's window `win`
// (float4 texels, or f32 values for cost_only; rows `stride` apart) in
// patch order. Each call reads the window anew through an opaque copy of
// `win` (a second call re-loads from L1 or shared memory instead of
// holding the window in registers). R = pb::kRuntimeRadius takes the
// radius from `radius` and rolls both loops; from pb::kRolledRowRadius the
// rows roll.
template <int R, int MODE, typename T, typename Load, typename Emit>
__device__ __forceinline__ void sweep_window(const T* win, int stride,
                                             const pb::Weights& wt,
                                             int radius, Load load,
                                             Emit&& emit) {
  constexpr int kPS = 2 * R + 1;
  const int ps = R == pb::kRuntimeRadius ? 2 * radius + 1 : kPS;
  const T* wv = pb::opaque(win);
  auto at = [&](int ky, int kx) {
    if constexpr (MODE == kCostOnly) {
      emit(ky * ps + kx, pb::sample_value(wv, stride, ky, kx, wt), 0.f,
           0.f);
    } else {
      const float3 s = pb::sample(wv, stride, ky, kx, wt, load);
      emit(ky * ps + kx, s.x, s.y, s.z);
    }
  };
  auto row = [&](int ky) {
    if constexpr (R == pb::kRuntimeRadius) {
#pragma unroll 1
      for (int kx = 0; kx < ps; ++kx) at(ky, kx);
    } else {
#pragma unroll
      for (int kx = 0; kx < kPS; ++kx) at(ky, kx);
    }
  };
  if constexpr (R >= pb::kRolledRowRadius || R == pb::kRuntimeRadius) {
#pragma unroll 1
    for (int ky = 0; ky < ps; ++ky) row(ky);
  } else {
#pragma unroll
    for (int ky = 0; ky < kPS; ++ky) row(ky);
  }
}

// One channel of one observation in its own thread: its window sampled on
// both passes, or once into a register tile (kTile) that both passes read.
template <int R, int MODE, typename T, typename Load>
__device__ __forceinline__ void thread_channel(const T* win, int stride,
                                               const pb::Weights& wt,
                                               int radius, Load load,
                                               const float* __restrict__ d,
                                               int P, float acc[6]) {
  if constexpr (kTile<R, MODE>) {
    constexpr int kP = (2 * R + 1) * (2 * R + 1);
    constexpr int kPlanes = MODE == kCostOnly ? 1 : 3;
    float t[kPlanes * kP];
    sweep_window<R, MODE>(win, stride, wt, R, load,
                          [&](int k, float v, float gx, float gy) {
                            t[k] = v;
                            if constexpr (kPlanes == 3) {
                              t[kP + k] = gx;
                              t[2 * kP + k] = gy;
                            }
                          });
    channel_sums<MODE>(
        [&](auto&& emit) {
#pragma unroll
          for (int k = 0; k < kP; ++k) {
            if constexpr (kPlanes == 3) {
              emit(k, t[k], t[kP + k], t[2 * kP + k]);
            } else {
              emit(k, t[k], 0.f, 0.f);
            }
          }
        },
        d, kP, acc);
  } else {
    channel_sums<MODE>(
        [&](auto&& emit) {
          sweep_window<R, MODE>(win, stride, wt, radius, load, emit);
        },
        d, P, acc);
  }
}

// ---------------------------------------------------------------------------
// One thread per observation, gathering its own window from global memory
// (sampled every pass, or the register tile). R = pb::kRuntimeRadius takes
// the radius from `radius`.

template <int R, int MODE>
__global__ void __launch_bounds__(kOneThread)
stats_kernel(const void* __restrict__ planes, const float2* __restrict__ uv,
             const unsigned char* __restrict__ valid,
             const float* __restrict__ desc, float* __restrict__ out, int n,
             int w, int c, int h, int wi, int radius) {
  const int rad = R == pb::kRuntimeRadius ? radius : R;
  const int P = (2 * rad + 1) * (2 * rad + 1);
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
    pb::window_at(uv[obs], rad, h, wi, &x0, &y0, &q);
    const long long chan = static_cast<long long>(h) * wi;
    for (int ch = 0; ch < c; ++ch) {
      const long long origin = (static_cast<long long>(f) * c + ch) * chan +
                               static_cast<long long>(y0) * wi + x0;
      const float* d = desc + (static_cast<long long>(p) * c + ch) * P;
      if constexpr (MODE == kCostOnly) {
        thread_channel<R, MODE>(static_cast<const float*>(planes) + origin,
                                wi, q, rad, pb::LoadGlobal{}, d, P, acc);
      } else {
        thread_channel<R, MODE>(static_cast<const float4*>(planes) + origin,
                                wi, q, rad, pb::LoadGlobal{}, d, P, acc);
      }
    }
  }
  store_row(out, o, acc);
}

// ---------------------------------------------------------------------------
// Staged (full mode, kStagedRadii): K1's staging plan and copy
// (csrc/patch_stage.cuh); thread o owns observation o of the block.

template <int R>
using StagePlan = pb::Plan<R, kOneThread>;

template <int R>
__global__ void __launch_bounds__(kOneThread)
staged_stats_kernel(const float4* __restrict__ planes,
                    const float2* __restrict__ uv,
                    const unsigned char* __restrict__ valid,
                    const float* __restrict__ desc, float* __restrict__ out,
                    int n, int w, int c, int h, int wi) {
  using PL = StagePlan<R>;
  static_assert(PL::kStaged && PL::kBuffers == 2,
                "radius above kMaxStagedRadius, or one channel buffer");
  constexpr int P = (2 * R + 1) * (2 * R + 1);
  extern __shared__ float4 smem[];
  __shared__ long long base[PL::kObs];
  const long long total = static_cast<long long>(n) * w;
  const long long idx =
      static_cast<long long>(blockIdx.x) * PL::kObs + threadIdx.x;
  const bool live = idx < total;
  const int f = live ? static_cast<int>(idx / n) : 0;
  const int p = live ? static_cast<int>(idx - static_cast<long long>(f) * n)
                     : 0;
  const long long obs = static_cast<long long>(p) * w + f;
  const float2 xy = coordinate(uv, live, obs);
  const bool ok = live && valid[obs];
  const float* d = desc + static_cast<long long>(p) * c * P;
  if (live) prefetch_descriptor(d, c * P);

  const long long chan = static_cast<long long>(h) * wi;
  pb::Weights wt = {0.f, 0.f, 0.f, 0.f};
  base[threadIdx.x] = -1;
  if (ok) {
    int x0, y0;
    pb::window_at<R>(xy, h, wi, &x0, &y0, &wt);
    base[threadIdx.x] = static_cast<long long>(f) * c * chan +
                        static_cast<long long>(y0) * wi + x0;
  }
  __syncthreads();
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  pb::stage_channel<R, kOneThread, kOneThread>(smem, planes, base, 0, wi);
  pb::cp_async_commit();
  for (int ch = 0; ch < c; ++ch) {
    if (ch + 1 < c) {      // channel ch + 1 in flight while ch is summed
      pb::stage_channel<R, kOneThread, kOneThread>(
          smem + ((ch + 1) & 1) * PL::kObs * PL::kStride, planes, base,
          (ch + 1) * chan, wi);
      pb::cp_async_commit();
      pb::cp_async_wait<1>();
    } else {
      pb::cp_async_wait<0>();
    }
    __syncthreads();
    if (ok) {
      thread_channel<R, kFull>(
          smem + ((ch & 1) * PL::kObs + threadIdx.x) * PL::kStride, PL::kWin,
          wt, R, pb::LoadPlain{}, d + static_cast<long long>(ch) * P, P,
          acc);
    }
    __syncthreads();   // the buffer is refilled two channels on
  }
  if (!live) return;
  store_row(out, idx, acc);
}

// ---------------------------------------------------------------------------
// Tiled (kTiledRadii): the block's gathers spread over its threads as
// (observation, patch row) items; each observation's samples go to a tile
// of kTileStride floats (odd: P is odd) in shared memory, then its own
// thread reduces them. kObs observations per block: 64 or 32
// (kTiled64Radii).

template <int R, int MODE>
struct TilePlan {
  static constexpr int kPS = 2 * R + 1;
  static constexpr int kP = kPS * kPS;
  static constexpr int kTileStride = (MODE == kCostOnly ? 1 : 3) * kP;
  // samples, window origin (8 B), bilinear weights (16 B)
  static constexpr int kObsBytes = kTileStride * 4 + 8 + 16;
  static constexpr int kObs = (kTiled64Radii >> R) & 1u ? 64 : 32;
  static_assert(kObs * kObsBytes <= pb::kMaxSharedBytes,
                "a block's samples must fit its shared memory");
  static constexpr int kBytes = kObs * kObsBytes;
};

template <int R, int MODE>
__global__ void __launch_bounds__(kThreads)
tiled_stats_kernel(const void* __restrict__ planes,
                   const float2* __restrict__ uv,
                   const unsigned char* __restrict__ valid,
                   const float* __restrict__ desc, float* __restrict__ out,
                   int n, int w, int c, int h, int wi) {
  using PL = TilePlan<R, MODE>;
  constexpr int PS = PL::kPS;
  constexpr int P = PL::kP;
  extern __shared__ float4 smem[];
  float* tile = reinterpret_cast<float*>(smem);      // the samples
  long long* org = reinterpret_cast<long long*>(     // window origin (< 0:
      tile + PL::kObs * PL::kTileStride);             // nothing to sample)
  pb::Weights* wts = reinterpret_cast<pb::Weights*>(org + PL::kObs);
  const int o = threadIdx.x;                 // the observation it owns
  const long long total = static_cast<long long>(n) * w;
  const long long idx = static_cast<long long>(blockIdx.x) * PL::kObs + o;
  const bool owner = o < PL::kObs;
  const bool live = owner && idx < total;
  const int f = live ? static_cast<int>(idx / n) : 0;
  const int p = live ? static_cast<int>(idx - static_cast<long long>(f) * n)
                     : 0;
  const long long obs = static_cast<long long>(p) * w + f;
  const float2 xy = coordinate(uv, live, obs);
  const bool ok = live && valid[obs];
  const long long chan = static_cast<long long>(h) * wi;
  const float* d = desc + static_cast<long long>(p) * c * P;
  if (live) prefetch_descriptor(d, c * P);
  if (owner) {
    org[o] = -1;
    if (ok) {
      int x0, y0;
      pb::Weights q;
      pb::window_at<R>(xy, h, wi, &x0, &y0, &q);
      wts[o] = q;
      org[o] = static_cast<long long>(f) * c * chan +
               static_cast<long long>(y0) * wi + x0;
    }
  }
  __syncthreads();
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int ch = 0; ch < c; ++ch) {
    // Item (observation i / PS, patch row i % PS): the row's PS samples.
    for (int i = threadIdx.x; i < PL::kObs * PS; i += kThreads) {
      const int io = i / PS;
      const int ky = i - io * PS;
      const long long b = org[io];
      if (b < 0) continue;
      const pb::Weights q = wts[io];
      float* dst = tile + io * PL::kTileStride + ky * PS;
      if constexpr (MODE == kCostOnly) {
        const float* win = static_cast<const float*>(planes) + b + ch * chan;
#pragma unroll
        for (int kx = 0; kx < PS; ++kx) {
          dst[kx] = pb::sample_value(win, wi, ky, kx, q);
        }
      } else {
        const float4* win =
            static_cast<const float4*>(planes) + b + ch * chan;
#pragma unroll
        for (int kx = 0; kx < PS; ++kx) {
          const float3 s = pb::sample(win, wi, ky, kx, q, pb::LoadGlobal{});
          dst[kx] = s.x;
          dst[P + kx] = s.y;
          dst[2 * P + kx] = s.z;
        }
      }
    }
    __syncthreads();   // the samples are in
    if (ok) {
      channel_sums<MODE>(
          [&](auto&& emit) {
            // Each pass reads the tile anew, a row at a time: through an
            // opaque offset (or the compiler holds the samples in
            // registers across the passes), with the rows rolled.
            const float* s = tile + pb::opaque_int(o * PL::kTileStride);
#pragma unroll 1
            for (int ky = 0; ky < PS; ++ky) {
#pragma unroll
              for (int kx = 0; kx < PS; ++kx) {
                const int k = ky * PS + kx;
                if constexpr (MODE == kCostOnly) {
                  emit(k, s[k], 0.f, 0.f);
                } else {
                  emit(k, s[k], s[P + k], s[2 * P + k]);
                }
              }
            }
          },
          d + static_cast<long long>(ch) * P, P, acc);
    }
    __syncthreads();   // the tile is free for the next channel
  }
  if (!live) return;
  store_row(out, idx, acc);
}

template <int R, int MODE>
void launch(const void* planes, const void* uv, const void* valid,
            const void* desc, void* out, int n, int w, int c, int h, int wi,
            int radius, cudaStream_t stream) {
  static_assert(check_designs<R, MODE>(), "");
  const long long m = static_cast<long long>(n) * w;
  const auto* q = static_cast<const float2*>(uv);
  const auto* ok = static_cast<const unsigned char*>(valid);
  const auto* d = static_cast<const float*>(desc);
  auto* o = static_cast<float*>(out);
  // Above 48 KB a kernel's dynamic shared memory must be opted into; once
  // per instance (the port drives one card per process). A failure
  // surfaces as the launch's error.
  if constexpr (kTiled<R, MODE>) {
    using PL = TilePlan<R, MODE>;
    static const cudaError_t opted = cudaFuncSetAttribute(
        tiled_stats_kernel<R, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, PL::kBytes);
    (void)opted;
    const unsigned blocks =
        static_cast<unsigned>((m + PL::kObs - 1) / PL::kObs);
    tiled_stats_kernel<R, MODE><<<blocks, kThreads, PL::kBytes, stream>>>(
        planes, q, ok, d, o, n, w, c, h, wi);
  } else if constexpr (kStaged<R, MODE>) {
    using PL = StagePlan<R>;
    static const cudaError_t opted = cudaFuncSetAttribute(
        staged_stats_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        PL::kMaxBytes);
    (void)opted;
    const unsigned blocks =
        static_cast<unsigned>((m + PL::kObs - 1) / PL::kObs);
    staged_stats_kernel<R><<<blocks, kOneThread, PL::bytes(c), stream>>>(
        static_cast<const float4*>(planes), q, ok, d, o, n, w, c, h, wi);
  } else {
    const unsigned blocks =
        static_cast<unsigned>((m + kOneThread - 1) / kOneThread);
    stats_kernel<R, MODE><<<blocks, kOneThread, 0, stream>>>(
        planes, q, ok, d, o, n, w, c, h, wi, radius);
  }
}

// Calls fn(R, MODE), each an std::integral_constant, for a radius in
// 1..kMaxStatsRadius (R = pb::kRuntimeRadius above pb::kMaxSolveRadius) and
// cost_only 0 or 1. Returns 0, or cudaErrorInvalidValue (nothing called).
template <typename Fn>
int dispatch(int radius, int cost_only, Fn&& fn) {
  if (cost_only != 0 && cost_only != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return pb::dispatch<pb::kMaxSolveRadius, true>(
      radius, cost_only,
      [&](auto r, auto m) {
        if constexpr (decltype(m)::value == kFull ||
                      decltype(m)::value == kCostOnly) {
          fn(r, m);
        }
      },
      kMaxStatsRadius);
}

}  // namespace

// out: (W * N, 8) f32, frame-major rows. cost_only: 0 or 1 (planes are
// then value planes). Returns 0 or a CUDA error code
// (cudaErrorInvalidValue, with nothing launched, for a radius outside
// 1..kMaxStatsRadius or another cost_only).
extern "C" int pb_k7_stats(const void* planes, const void* uv,
                           const void* valid, const void* desc, void* out,
                           int n, int w, int c, int h, int wi, int radius,
                           int cost_only, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = dispatch(radius, cost_only, [&](auto r, auto m) {
    launch<decltype(r)::value, decltype(m)::value>(
        planes, uv, valid, desc, out, n, w, c, h, wi, radius, s);
  });
  return bad ? bad : static_cast<int>(cudaGetLastError());
}

// The first design with a run-time radius, at any radius
// 1..kMaxStatsRadius: the bitwise reference of pb_k7_stats' designs.
extern "C" int pb_k7_stats_one_thread(const void* planes, const void* uv,
                                      const void* valid, const void* desc,
                                      void* out, int n, int w, int c, int h,
                                      int wi, int radius, int cost_only,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = dispatch(radius, cost_only, [&](auto, auto m) {
    launch<pb::kRuntimeRadius, decltype(m)::value>(
        planes, uv, valid, desc, out, n, w, c, h, wi, radius, s);
  });
  return bad ? bad : static_cast<int>(cudaGetLastError());
}

// The design instance <radius, cost_only> runs: 0 samples on every pass, 1
// the register tile, 2 the runtime-radius instance, 3 the tiled design, 4
// staged; -1 where none runs.
extern "C" int pb_k7_design(int radius, int cost_only) {
  int design = -1;
  dispatch(radius, cost_only, [&](auto r, auto m) {
    constexpr int R = decltype(r)::value;
    constexpr int MODE = decltype(m)::value;
    design = R == pb::kRuntimeRadius ? 2
             : kTiled<R, MODE>       ? 3
             : kStaged<R, MODE>      ? 4
             : kTile<R, MODE>        ? 1
                                     : 0;
  });
  return design;
}

extern "C" const char* pb_k7_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
