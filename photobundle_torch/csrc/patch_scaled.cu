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
// stores 24 B: a few microseconds of HBM bandwidth; ~70 flops per patch
// pixel, well under a microsecond. One thread per observation, in blocks
// of 64, runs at 0.18 of that bound (mean), 0.12 (affine) and 0.021 at
// R = 9: its 4 float4 gathers per pixel are chains on few threads (~155 per
// SM), and the epilogue samples the patch again on every pass (two for mean
// and off, three for affine), so ptxas spills in the affine mode from
// R = 2.
//
// What the design does about it, by radius and mode (kTileRadii,
// kTiledRadii; each kept where one kernel_times.py call, parent and change
// interleaved, measured it at least 3 % faster cold than sampling on every
// pass: PERF.md's K3 and K5 rows):
//   - the register tile (mean R = 2, 4; affine R = 2-4): one thread per
//     observation samples its patch once, its 3P samples held in
//     registers, and the epilogue's passes read them: no second or third
//     gather (K3 0.88x at R = 2, K5 0.59-0.78x at R = 2-4); to R = 4 only,
//     where every patch loop unrolls (rolled rows cannot index registers);
//   - the tiled design (mean R = 5, 7-9; affine R = 7): each channel's
//     patch sampled once into a tile of samples in shared memory, 3P
//     floats per observation at an odd word stride, with the gathers
//     spread: a block of kObs observations (frame-major, so neighbouring
//     threads store neighbouring outputs) shares out (observation, patch
//     row) items over its kThreads threads, each row with its own tap and
//     phase, so the items are independent and each issues its row's
//     4 (2R+1) float4 loads together; then each observation's own thread
//     runs the epilogue on its tile (K3 0.57x at R = 9, where the one-
//     thread design's rolled rows run at 0.021 of the bound);
//   - one thread sampling on every pass elsewhere: the off mode (one pass:
//     nothing to share), mean R = 1, 3 and 6 (the register tile 1.007x at
//     R = 3, the tiled design 1.10x at R = 6), affine R = 1, 5, 6, 8, 9 (the
//     tiled design 1.15-1.81x: its epilogue's three passes run on few
//     observations per SM, the tile taking 2-4.5 KB of shared memory each).
// Windows vary in size with rho, so they are not staged whole. The sums
// stay one thread per observation, in the fixed k order, with no atomics,
// and every sample is the same in every design (the same taps, blends and
// rounding), so the sums are bitwise alike; pb_scaled_stats_one_thread
// runs the one-thread design with a run-time radius at any radius for
// that check. Patch radii 1..pb::kMaxSolveRadius, the reference's
// warped-grid limit.
//
// pb_scaled_stats takes B windows of the same shapes on a grid axis
// (blockIdx.y, csrc/patch_batch.cuh; the twin of the axis jax.vmap adds
// to the pallas_calls at photobundle_tpu/ops/patch_warp.py:964 (K3) and
// :722 (K5)): planes (B, W, C, H, Wi), uv, rho and valid (B, N, W), patch
// (B, N, C, P), out (B, 6, W, N); each block row offsets its pointers to
// its window's slices and runs the unchanged per-observation code, in
// every mode and design, so each window's sums are bitwise its own
// launch's. The batched window solve (core/batched.py) launches it once
// per evaluation for all its windows.

#include <cuda_runtime.h>

#include "patch_batch.cuh"
#include "patch_epilogue.cuh"

namespace {

constexpr int kOneThread = 64;        // threads (= observations) per block
constexpr int kThreads = 256;         // threads per block, tiled design
constexpr int kMaxSharedBytes = 232448;   // what a block may opt into

// The radii (bit R) at which each normalization (off, mean, affine) runs
// the register tile or the tiled design: where one kernel_times.py call
// measured it at least 3 % faster than sampling on every pass (see the
// note above); the one-thread design elsewhere.
constexpr unsigned kTileRadii[3] = {0u, (1u << 2) | (1u << 4),
                                    (1u << 2) | (1u << 3) | (1u << 4)};
constexpr unsigned kTiledRadii[3] = {
    0u, (1u << 5) | (1u << 7) | (1u << 8) | (1u << 9), 1u << 7};
template <int R, int NORM>
constexpr bool kRegisterTile = R >= 1 && ((kTileRadii[NORM] >> R) & 1u);
template <int R, int NORM>
constexpr bool kTiled = R >= 1 && ((kTiledRadii[NORM] >> R) & 1u);
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

// The samples (v, gx, gy) of one patch pixel from its four texels: rows
// first (the floor column F and the next column N), then the columns.
__device__ __forceinline__ float3 blend(const float4* t, int wi, float gy0,
                                        float gy1, float gx0, float gx1) {
  const float4 a = __ldg(t);
  const float4 b = __ldg(t + 1);
  const float4 cc = __ldg(t + wi);
  const float4 d = __ldg(t + wi + 1);
  const float fv = a.x * gy0 + cc.x * gy1;
  const float fgx = a.y * gy0 + cc.y * gy1;
  const float fgy = a.z * gy0 + cc.z * gy1;
  const float nv = b.x * gy0 + d.x * gy1;
  const float ngx = b.y * gy0 + d.y * gy1;
  const float ngy = b.z * gy0 + d.z * gy1;
  return make_float3(gx0 * fv + gx1 * nv, gx0 * fgx + gx1 * ngx,
                     gx0 * fgy + gx1 * ngy);
}

// ---------------------------------------------------------------------------
// The one-thread design: one thread per observation samples its patch on
// every pass of the epilogue, or once into a register tile
// (kRegisterTile). With R = pb::kRuntimeRadius the radius is a run-time
// argument, every loop rolls and each column's tap is taken where it is
// used (the same taps and blends in the same order).

template <int R, int NORM>
__global__ void __launch_bounds__(kOneThread)
scaled_stats_kernel(const float4* __restrict__ planes,
                    const float2* __restrict__ uv,
                    const float* __restrict__ rho,
                    const unsigned char* __restrict__ valid,
                    const float* __restrict__ patch,
                    float* __restrict__ out,
                    int n, int w, int c, int h, int wi, int radius) {
  constexpr int kPS = 2 * R + 1;
  const int rad = R == pb::kRuntimeRadius ? radius : R;
  const int ps = 2 * rad + 1;
  const int P = ps * ps;
  const long long total = static_cast<long long>(n) * w;
  const pb::WindowOffsets at = pb::window_offsets(n, w, c, h, wi, P);
  planes += at.planes;
  uv += at.obs;
  rho += at.obs;
  valid += at.obs;
  patch += at.patch;
  out += 6 * at.obs;
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
    int tx[kPS];
    float fx[kPS];
    if constexpr (R != pb::kRuntimeRadius) {
#pragma unroll
      for (int k = 0; k < kPS; ++k) tap(q.x, r, k - R, wi - 2, &tx[k],
                                        &fx[k]);
    }

    for (int ch = 0; ch < c; ++ch) {
      const float4* img =
          planes + (static_cast<long long>(f) * c + ch) * h * wi;
      auto sweep = [&](auto&& emit) {
        const float4* base = pb::opaque(img);
        auto patch_row = [&](int ky) {
          int ty;
          float gy1;
          tap(q.y, r, ky - rad, h - 2, &ty, &gy1);
          const float4* row = base + static_cast<long long>(ty) * wi;
          const float gy0 = 1.f - gy1;
          if constexpr (R == pb::kRuntimeRadius) {
#pragma unroll 1
            for (int kx = 0; kx < ps; ++kx) {
              int t;
              float gx1;
              tap(q.x, r, kx - rad, wi - 2, &t, &gx1);
              const float3 s = blend(row + t, wi, gy0, gy1, 1.f - gx1, gx1);
              emit(ky * ps + kx, s.x, s.y, s.z);
            }
          } else {
#pragma unroll
            for (int kx = 0; kx < kPS; ++kx) {
              const float gx1 = fx[kx];
              const float3 s = blend(row + tx[kx], wi, gy0, gy1, 1.f - gx1,
                                     gx1);
              emit(ky * kPS + kx, s.x, s.y, s.z);
            }
          }
        };
        if constexpr (R >= pb::kRolledRowRadius || R == pb::kRuntimeRadius) {
#pragma unroll 1
          for (int ky = 0; ky < ps; ++ky) patch_row(ky);
        } else {
#pragma unroll
          for (int ky = 0; ky < kPS; ++ky) patch_row(ky);
        }
      };
      const float* desc = patch + (static_cast<long long>(p) * c + ch) * P;
      if constexpr (kRegisterTile<R, NORM>) {
        // The register tile: the patch sampled once, its 3P samples held
        // in registers (every index a constant), the passes read them.
        constexpr int kP = kPS * kPS;
        float t[3 * kP];
        sweep([&](int k, float v, float gx, float gy) {
          t[k] = v;
          t[kP + k] = gx;
          t[2 * kP + k] = gy;
        });
        auto tile = [&](auto&& emit) {
#pragma unroll
          for (int k = 0; k < kP; ++k) {
            emit(k, t[k], t[kP + k], t[2 * kP + k]);
          }
        };
        pb::channel_stats<NORM>(tile, desc, P, acc);
      } else {
        pb::channel_stats<NORM>(sweep, desc, P, acc);
      }
    }
  }
  const long long o = static_cast<long long>(f) * n + p;
#pragma unroll
  for (int k = 0; k < 6; ++k) out[k * total + o] = acc[k];
}

// ---------------------------------------------------------------------------
// The tiled design (the radii of kTiledRadii).

// The plan of radius R: an observation's samples take kTileStride = 3P
// words (odd: P is odd), its column taps and phases 2 PS words, its row
// coordinate, scale and frame 3 words. kObs observations per block: 64
// where their tiles fit a block's shared memory, else 32.
template <int R>
struct Plan {
  static constexpr int kPS = 2 * R + 1;
  static constexpr int kP = kPS * kPS;
  static constexpr int kTileStride = 3 * kP;
  static constexpr int kObsBytes = (kTileStride + 2 * kPS + 3) * 4;
  static constexpr int kObs = 64 * kObsBytes <= kMaxSharedBytes ? 64 : 32;
  static_assert(R > pb::kMaxSolveRadius || kObs * kObsBytes <= kMaxSharedBytes,
                "a block's samples must fit its shared memory");
  static constexpr int kBytes = kObs * kObsBytes;
};

template <int R, int NORM>
__global__ void __launch_bounds__(kThreads)
tiled_scaled_stats_kernel(const float4* __restrict__ planes,
                          const float2* __restrict__ uv,
                          const float* __restrict__ rho,
                          const unsigned char* __restrict__ valid,
                          const float* __restrict__ patch,
                          float* __restrict__ out,
                          int n, int w, int c, int h, int wi) {
  using PL = Plan<R>;
  static_assert(kTiled<R, NORM>, "an instance without the tiled design");
  constexpr int PS = PL::kPS;
  constexpr int P = PL::kP;
  extern __shared__ float smem[];
  float* tile = smem;                                  // the samples
  int* tx = reinterpret_cast<int*>(tile + PL::kObs * PL::kTileStride);
  float* fx = reinterpret_cast<float*>(tx + PL::kObs * PS);
  float* qy = fx + PL::kObs * PS;     // row coordinate, scale, frame (< 0:
  float* rs = qy + PL::kObs;          // nothing to sample)
  int* fr = reinterpret_cast<int*>(rs + PL::kObs);
  const int o = threadIdx.x;                 // the observation it owns
  const long long total = static_cast<long long>(n) * w;
  const pb::WindowOffsets at = pb::window_offsets(n, w, c, h, wi, P);
  planes += at.planes;
  uv += at.obs;
  rho += at.obs;
  valid += at.obs;
  patch += at.patch;
  out += 6 * at.obs;
  const long long idx = static_cast<long long>(blockIdx.x) * PL::kObs + o;
  const bool owner = o < PL::kObs;
  const bool live = owner && idx < total;
  const int f = live ? static_cast<int>(idx / n) : 0;
  const int p = live ? static_cast<int>(idx - static_cast<long long>(f) * n)
                     : 0;
  const long long obs = static_cast<long long>(p) * w + f;
  const bool ok = live && valid[obs];
  const float* desc = patch + static_cast<long long>(p) * c * P;
  if (owner) {
    fr[o] = -1;
    if (ok) {
      const float2 q = uv[obs];
      const float r = fminf(fmaxf(rho[obs], kScaleMin), kScaleMax);
#pragma unroll
      for (int k = 0; k < PS; ++k) {
        tap(q.x, r, k - R, wi - 2, &tx[o * PS + k], &fx[o * PS + k]);
      }
      qy[o] = q.y;
      rs[o] = r;
      fr[o] = f;
      // The descriptor is read by the epilogue's passes: into L1 now.
      for (int k = 0; k < c * P; k += 32) {
        asm volatile("prefetch.global.L1 [%0];" ::"l"(desc + k));
      }
    }
  }
  __syncthreads();
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int ch = 0; ch < c; ++ch) {
    // Item (observation i / PS, patch row i % PS): the row's tap and phase,
    // then its PS samples into the tile.
    for (int i = threadIdx.x; i < PL::kObs * PS; i += kThreads) {
      const int io = i / PS;
      const int ky = i - io * PS;
      const int fi = fr[io];
      if (fi < 0) continue;
      int ty;
      float gy1;
      tap(qy[io], rs[io], ky - R, h - 2, &ty, &gy1);
      const float gy0 = 1.f - gy1;
      const float4* row = planes +
                          (static_cast<long long>(fi) * c + ch) * h * wi +
                          static_cast<long long>(ty) * wi;
      float* dst = tile + io * PL::kTileStride + ky * PS;
#pragma unroll
      for (int kx = 0; kx < PS; ++kx) {
        const float gx1 = fx[io * PS + kx];
        const float3 s = blend(row + tx[io * PS + kx], wi, gy0, gy1,
                               1.f - gx1, gx1);
        dst[kx] = s.x;
        dst[P + kx] = s.y;
        dst[2 * P + kx] = s.z;
      }
    }
    __syncthreads();   // the samples are in
    if (ok) {
      auto sweep = [&](auto&& emit) {
        // Each pass reads the tile anew, a row at a time: through an opaque
        // offset, or the compiler holds the samples in registers across
        // the passes; with the rows rolled, or it hoists a whole pass's
        // loads into registers (fewer blocks per SM).
        const float* s = tile + pb::opaque_int(o * PL::kTileStride);
#pragma unroll 1
        for (int ky = 0; ky < PS; ++ky) {
#pragma unroll
          for (int kx = 0; kx < PS; ++kx) {
            const int k = ky * PS + kx;
            emit(k, s[k], s[P + k], s[2 * P + k]);
          }
        }
      };
      pb::channel_stats<NORM>(sweep, desc + static_cast<long long>(ch) * P,
                              P, acc);
    }
    __syncthreads();   // the tile is free for the next channel
  }
  if (!live) return;
#pragma unroll
  for (int k = 0; k < 6; ++k) out[k * total + idx] = acc[k];
}

template <int R, int NORM>
void launch(const void* planes, const void* uv, const void* rho,
            const void* valid, const void* patch, void* out, int b, int n,
            int w, int c, int h, int wi, int radius, cudaStream_t stream) {
  using PL = Plan<R>;
  const long long total = static_cast<long long>(n) * w;
  const auto* pl = static_cast<const float4*>(planes);
  const auto* q = static_cast<const float2*>(uv);
  const auto* sc = static_cast<const float*>(rho);
  const auto* ok = static_cast<const unsigned char*>(valid);
  const auto* d = static_cast<const float*>(patch);
  auto* o = static_cast<float*>(out);
  if constexpr (kTiled<R, NORM>) {
    // Above 48 KB a kernel's dynamic shared memory must be opted into;
    // once per instance (the port drives one card per process). A failure
    // surfaces as the launch's error.
    static const cudaError_t opted = cudaFuncSetAttribute(
        tiled_scaled_stats_kernel<R, NORM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, PL::kBytes);
    (void)opted;
    const dim3 blocks(static_cast<unsigned>((total + PL::kObs - 1) / PL::kObs),
                      static_cast<unsigned>(b));
    tiled_scaled_stats_kernel<R, NORM>
        <<<blocks, kThreads, PL::kBytes, stream>>>(pl, q, sc, ok, d, o, n, w,
                                                   c, h, wi);
  } else {
    const dim3 blocks(
        static_cast<unsigned>((total + kOneThread - 1) / kOneThread),
        static_cast<unsigned>(b));
    scaled_stats_kernel<R, NORM><<<blocks, kOneThread, 0, stream>>>(
        pl, q, sc, ok, d, o, n, w, c, h, wi, radius);
  }
}

}  // namespace

// b: windows of the launch (the batch axis, grid y; 1 for one window).
extern "C" int pb_scaled_stats(const void* planes, const void* uv,
                               const void* rho, const void* valid,
                               const void* patch, void* out, int b, int n,
                               int w, int c, int h, int wi, int radius,
                               int norm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad =
      pb::dispatch<pb::kMaxSolveRadius>(radius, norm, [&](auto r, auto m) {
        launch<decltype(r)::value, decltype(m)::value>(
            planes, uv, rho, valid, patch, out, b, n, w, c, h, wi, radius,
            s);
      });
  return bad ? bad : static_cast<int>(cudaGetLastError());
}

// The one-thread design with a run-time radius, at any radius
// 1..pb::kMaxSolveRadius: the bitwise reference of pb_scaled_stats'
// designs.
extern "C" int pb_scaled_stats_one_thread(const void* planes, const void* uv,
                                          const void* rho, const void* valid,
                                          const void* patch, void* out, int n,
                                          int w, int c, int h, int wi,
                                          int radius, int norm,
                                          void* stream) {
  if (radius < 1 || radius > pb::kMaxSolveRadius) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = pb::launch_norm(
      norm,
      [&](auto r, auto m) {
        launch<decltype(r)::value, decltype(m)::value>(
            planes, uv, rho, valid, patch, out, 1, n, w, c, h, wi, radius,
            s);
      },
      std::integral_constant<int, pb::kRuntimeRadius>{});
  return bad ? bad : static_cast<int>(cudaGetLastError());
}

// The design instance <radius, norm> runs: 0 samples on every pass, 1 the
// register tile, 2 the runtime-radius instance, 3 the tiled design; -1
// where none runs.
extern "C" int pb_scaled_design(int radius, int norm) {
  int design = -1;
  pb::dispatch<pb::kMaxSolveRadius>(radius, norm, [&](auto r, auto m) {
    constexpr int R = decltype(r)::value;
    constexpr int NORM = decltype(m)::value;
    design = kTiled<R, NORM> ? 3 : kRegisterTile<R, NORM> ? 1 : 0;
  });
  return design;
}

extern "C" const char* pb_scaled_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
