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
// Inputs: planes (W, C, H, Wi) f32 values only, 16-byte aligned (the
// surface gradients come from the values, so no gradient planes are
// read); uv (N, W) float2; valid (N, W) bytes; patch (N, C, P) f32. The
// (2R+4)^2 window is clamped inside the image; the solve's border margins
// (R+1 <= u <= Wi-3-R) keep valid observations' windows unclamped.
//
// What bounds it on this card: at the solver's full-size window (4096
// points x 5 frames, ~20k observations) each observation needs an 8x8 f32
// window at R = 2 (256 B) and stores 24 B: ~1.5 us of HBM bandwidth. Its
// ~1.1k f32 operations per observation per channel (separable 4-tap
// passes for value and both derivatives, then the epilogue) take under a
// microsecond at the f32 rate. One thread per observation, in blocks of 64,
// runs at 0.16 of that bound (mean) and 0.085 (affine): ~155 threads per
// SM, each a chain of dependent gathers and filters, and an epilogue that
// sweeps the patch once per pass (two for mean and off, three for affine),
// each sweep filtering the window anew, the affine one with three IEEE
// divisions per pixel.
//
// What the design does about it: one thread per observation, R and the
// normalization mode template parameters (each mode's build carries only
// its own passes' registers) and every loop unrolled (the columns only
// from pb::kRolledRowRadius), so the window row loads of a pass are
// independent and in flight together. The separable passes run row by
// row: a window row is loaded, filtered along x (value and d/dx), and as
// soon as four filtered rows exist one output row is combined along y, so
// at most four filtered rows need to be live. In the affine mode to
// kMaxTileRadius the patch is sampled once, into a register tile of its 3P
// samples, which the three passes read (0.87x at R = 1, 0.90x at R = 2,
// 0.70x at R = 4); the tile stops there because from pb::kRolledRowRadius
// the rows are a loop, whose samples (3P >= 363) cannot be registers by
// name. Elsewhere every pass samples its window anew from L1.
//
// What was measured and not kept (PERF.md's K2 rows, kernel_times.py,
// parent and change interleaved, cold): a staged design, in which a block
// of 64 observations copied its windows into shared memory with 16-byte
// cp.async copies and its threads filtered each window once into a shared
// tile of samples, by (observation, patch column), before each thread's
// epilogue read its tile. Its copies were coalesced and nothing was
// filtered twice, yet it lost at every radius and mode: 1.22x at R = 2
// (mean), 1.6x at R = 4, 1.4-2.8x at R = 5-9 (the barriers serialize copy,
// filter and sums in a block, and the shared memory per observation, 0.8 KB
// at R = 2 and 6.8 KB at R = 9, leaves few observations per SM); the
// one-thread design's 4-byte texels mostly hit L1. The register tile
// ties in the mean mode (0.98-1.01x at R = 2-4), where the second sweep
// hides behind the first one's loads, so the mean and off modes keep
// sampling on every pass.
//
// With more than one channel (the IntensityAndGradient descriptor, C =
// 3; BitPlanes, C = 8) the first design ran an observation's channels one
// after another in its thread: its time grew with C (23.7-24.2 us at C =
// 3, R = 2, against 9.5 at C = 1), ~155 threads an SM each a chain C
// channels long. bicubic_split_stats_kernel gives each (observation,
// channel) pair its own thread running the unchanged per-channel code
// (channel_sums), the C partials added in channel order by one thread
// per observation: C times the threads, and sums bitwise the first
// design's (pb_bicubic_stats_one_thread keeps it). What bounds it then:
// at R = 2 the window loads, as at C = 1 (0.18 of its bound); at wide
// radii L1, where each thread's window rows must survive until its next
// sweep: from
// pb::kRolledRowRadius the grid holds kSplitBlocksWide blocks of
// kSplitWindows threads an SM (256 threads), each looping over groups.
// Measured at C = 3, 4096 x 5, cold (PERF.md, kernel_times.py, H100 at
// 700 W): R = 2 22.78 us against the first design's 24.04-24.06, R = 4
// 51.61 (58.36-58.43), R = 9 176.85 (215.67-217.41), R = 19 5203
// (6155-6189). Measured and not kept: blocks of 64, 128, 192 or 256
// threads with no cap (23.1-28.3 us at R = 2; 64 at R = 19: 8731, 1.4x
// the first design: resident windows evict each other's rows), and
// caps of 2, 4, 6, 8 blocks of 64 threads (R = 19: 9989, 5427, 8609,
// 8702), 4 of 32 (9609) or 2 of 128 (5382).
//
// Patch radii: compile-time instances 1..pb::kMaxSolveRadius, and above
// it, to kMaxBicubicRadius, one instance per normalization with the
// radius a run-time argument: every loop rolled, each sample filtering its
// four rows where it needs them (the same products in the same order).
// kMaxBicubicRadius = 61 is where the JAX package's value panel keeps a
// positive lane stride (photobundle_tpu/ops/patch_warp.py,
// value_lane_stride). The frame-major threads store neighbouring outputs;
// no atomics, so results are bitwise reproducible, and the sums are the
// same whatever the design: the same products of the same texels in the
// same order (-fmad=false). pb_bicubic_stats_one_thread runs the
// runtime-radius instance at any radius for that check. Taps combine in
// the JAX kernel's order (patch_warp.py:199-203): rows along x, then
// columns along y.
//
// pb_bicubic_stats takes B windows of the same shapes on a grid axis
// (blockIdx.y, csrc/patch_batch.cuh; the twin of the axis jax.vmap adds
// to the pallas_call at photobundle_tpu/ops/patch_warp.py:265): planes
// (B, W, C, H, Wi), uv and valid (B, N, W), patch (B, N, C, P), out
// (B, 6, W, N); each block row offsets its pointers to its window's slices
// and runs the unchanged per-observation code, in every design and
// radius instance, so each window's sums are bitwise its own launch's.
// The batched window solve (core/batched.py) launches it once per
// evaluation for all its windows.

#include <cuda_runtime.h>

#include "patch_batch.cuh"
#include "patch_epilogue.cuh"

namespace {

constexpr int kThreads = 64;           // threads (= observations) per block
constexpr int kMaxTileRadius = 4;      // the affine mode's register tile
constexpr int kMaxBicubicRadius = 61;  // ops/_common.BICUBIC_MAX
// K2's design at C > 1 (bicubic_split_stats_kernel; chosen by one
// kernel_times.py call, PERF.md): the threads, each an (observation,
// channel) pair, of a block. The channel count a launch takes is
// kMaxChannels.
constexpr int kSplitWindows = 32;
// Blocks an SM (0: one block a group) to pb::kRolledRowRadius, and from it
// (the rolled rows and the runtime radius).
constexpr int kSplitBlocks = 0;
constexpr int kSplitBlocksWide = 8;
template <int R>
constexpr int kSplitBlocksAt =
    R >= 1 && R < pb::kRolledRowRadius ? kSplitBlocks : kSplitBlocksWide;
constexpr int kMaxChannels = 32;       // ops/_common.MAX_CHANNELS
static_assert(kSplitWindows >= kMaxChannels, "a block holds every channel");

// Whether instance <R, NORM> samples each patch once into a register tile
// (measured faster there: see the note above).
template <int R, int NORM>
constexpr bool kRegisterTile =
    NORM == pb::kNormAffine && R >= 1 && R <= kMaxTileRadius;

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

// One observation's window origin (clamped inside the image) and its
// weights: wt[0..3] wx, [4..7] dwx, [8..11] wy, [12..15] dwy. Only for a
// valid observation (NaN never reaches floorf or an int cast).
__device__ __forceinline__ void window_at(float2 q, int radius, int h,
                                          int wi, int* x0, int* y0,
                                          float* wt) {
  const int win = 2 * radius + 4;
  const float flx = floorf(q.x);
  const float fly = floorf(q.y);
  catmull_rom(q.x - flx, wt, wt + 4);
  catmull_rom(q.y - fly, wt + 8, wt + 12);
  *x0 = min(max(static_cast<int>(flx) - radius - 1, 0), wi - win);
  *y0 = min(max(static_cast<int>(fly) - radius - 1, 0), h - win);
}

// One window row filtered along x: value (v) and d/dx (d) at the PS
// patch columns.
template <int PS>
__device__ __forceinline__ void filter_row(const float* __restrict__ row,
                                           const float* wx, const float* dwx,
                                           float (&v)[PS], float (&d)[PS]) {
  float a[PS + 3];
#pragma unroll
  for (int k = 0; k < PS + 3; ++k) a[k] = __ldg(row + k);
#pragma unroll
  for (int kx = 0; kx < PS; ++kx) {
    v[kx] = taps4(wx, a[kx], a[kx + 1], a[kx + 2], a[kx + 3]);
    d[kx] = taps4(dwx, a[kx], a[kx + 1], a[kx + 2], a[kx + 3]);
  }
}

// One sweep over a channel's patch: calls emit(k, v, gx, gy) for every
// patch pixel k in row-major order. `win` points at the window's top-left
// texel, `wi` is the image row stride. Up to R = 4 every loop unrolls and
// the filtered rows are registers by name; from pb::kRolledRowRadius the
// output rows are a loop over a ring of the last four filtered rows; with
// R = pb::kRuntimeRadius (radius `radius`) every loop is rolled and each
// sample filters its four rows at its own column (the same products in
// the same order).
template <int R, typename Emit>
__device__ __forceinline__ void sweep(const float* __restrict__ win, int wi,
                                      const float* wx, const float* dwx,
                                      const float* wy, const float* dwy,
                                      int radius, Emit&& emit) {
  if constexpr (R == pb::kRuntimeRadius) {
    const int ps = 2 * radius + 1;
#pragma unroll 1
    for (int ky = 0; ky < ps; ++ky) {
#pragma unroll 1
      for (int kx = 0; kx < ps; ++kx) {
        float rv[4], rd[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* a = win + (ky + r) * wi + kx;
          const float a0 = __ldg(a), a1 = __ldg(a + 1), a2 = __ldg(a + 2),
                      a3 = __ldg(a + 3);
          rv[r] = taps4(wx, a0, a1, a2, a3);
          rd[r] = taps4(dwx, a0, a1, a2, a3);
        }
        emit(ky * ps + kx, taps4(wy, rv[0], rv[1], rv[2], rv[3]),
             taps4(wy, rd[0], rd[1], rd[2], rd[3]),
             taps4(dwy, rv[0], rv[1], rv[2], rv[3]));
      }
    }
    return;
  } else {
    constexpr int PS = 2 * R + 1;
    constexpr int WIN = PS + 3;
    auto combine_row = [&](int ky, const float (&v0)[PS],
                           const float (&v1)[PS], const float (&v2)[PS],
                           const float (&v3)[PS], const float (&d0)[PS],
                           const float (&d1)[PS], const float (&d2)[PS],
                           const float (&d3)[PS]) {
#pragma unroll
      for (int kx = 0; kx < PS; ++kx) {
        const float v = taps4(wy, v0[kx], v1[kx], v2[kx], v3[kx]);
        const float gx = taps4(wy, d0[kx], d1[kx], d2[kx], d3[kx]);
        const float gy = taps4(dwy, v0[kx], v1[kx], v2[kx], v3[kx]);
        emit(ky * PS + kx, v, gx, gy);
      }
    };
    if constexpr (R >= pb::kRolledRowRadius) {
      float rv[4][PS];   // the ring: filtered rows ky .. ky + 3
      float rd[4][PS];
#pragma unroll
      for (int r = 0; r < 3; ++r) filter_row<PS>(win + r * wi, wx, dwx,
                                                 rv[r], rd[r]);
#pragma unroll 1
      for (int ky = 0; ky < PS; ++ky) {
        filter_row<PS>(win + (ky + 3) * wi, wx, dwx, rv[3], rd[3]);
        combine_row(ky, rv[0], rv[1], rv[2], rv[3], rd[0], rd[1], rd[2],
                    rd[3]);
#pragma unroll
        for (int r = 0; r < 3; ++r) {
#pragma unroll
          for (int kx = 0; kx < PS; ++kx) {
            rv[r][kx] = rv[r + 1][kx];
            rd[r][kx] = rd[r + 1][kx];
          }
        }
      }
    } else {
      float rv[WIN][PS];   // rows filtered along x: value
      float rd[WIN][PS];   // rows filtered along x: d/dx
#pragma unroll
      for (int r = 0; r < WIN; ++r) {
        filter_row<PS>(win + r * wi, wx, dwx, rv[r], rd[r]);
        if (r >= 3) {
          const int ky = r - 3;
          combine_row(ky, rv[ky], rv[ky + 1], rv[ky + 2], rv[ky + 3],
                      rd[ky], rd[ky + 1], rd[ky + 2], rd[ky + 3]);
        }
      }
    }
  }
}

// One channel's six sums of one observation, added to acc: its window
// `win` (rows `wi` apart), weights wt (window_at), descriptor desc.
template <int R, int NORM>
__device__ __forceinline__ void channel_sums(const float* win, int wi,
                                             const float* wt, int r,
                                             const float* __restrict__ desc,
                                             int P, float acc[6]) {
  auto sweep_channel = [&](auto&& emit) {
    sweep<R>(pb::opaque(win), wi, wt, wt + 4, wt + 8, wt + 12, r, emit);
  };
  if constexpr (kRegisterTile<R, NORM>) {
    // The register tile: the patch sampled once, its 3P samples held
    // in registers (every index a constant), the passes read them.
    constexpr int kP = (2 * R + 1) * (2 * R + 1);
    float t[3 * kP];
    sweep_channel([&](int k, float v, float gx, float gy) {
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
    pb::channel_stats<NORM>(sweep_channel, desc, P, acc);
  }
}

template <int R, int NORM>
__global__ void __launch_bounds__(kThreads)
bicubic_stats_kernel(const float* __restrict__ planes,
                     const float2* __restrict__ uv,
                     const unsigned char* __restrict__ valid,
                     const float* __restrict__ patch,
                     float* __restrict__ out,
                     int n, int w, int c, int h, int wi, int radius) {
  const int r = R == pb::kRuntimeRadius ? radius : R;
  const int P = (2 * r + 1) * (2 * r + 1);
  const long long total = static_cast<long long>(n) * w;
  const pb::WindowOffsets at = pb::window_offsets(n, w, c, h, wi, P);
  planes += at.planes;
  uv += at.obs;
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
    int x0, y0;
    float wt[16];
    window_at(uv[obs], r, h, wi, &x0, &y0, wt);
    for (int ch = 0; ch < c; ++ch) {
      const float* win = planes +
                         (static_cast<long long>(f) * c + ch) * h * wi +
                         static_cast<long long>(y0) * wi + x0;
      channel_sums<R, NORM>(
          win, wi, wt, r, patch + (static_cast<long long>(p) * c + ch) * P,
          P, acc);
    }
  }
  const long long o = static_cast<long long>(f) * n + p;
#pragma unroll
  for (int k = 0; k < 6; ++k) out[k * total + o] = acc[k];
}

// K2 at C > 1: each (observation, channel) pair its own thread. A block
// of kSplitWindows threads takes groups of obs = kSplitWindows / C
// consecutive observations (frame-major), thread t channel t / obs of
// observation t % obs (threads past obs * C idle). Each runs the
// unchanged per-channel code (channel_sums from zero, its design's
// register tile or sweeps) on its channel's window and leaves its six
// partial sums in shared memory; after the barrier thread o adds its
// observation's C partials into 0.f in channel order and stores. The
// grid holds kSplitBlocksAt<R> blocks an SM (0: one block a group), each
// looping over groups: at wide radii more resident windows than that
// evict each other's rows from L1 between their sweeps.
template <int R, int NORM>
__global__ void __launch_bounds__(kSplitWindows)
bicubic_split_stats_kernel(const float* __restrict__ planes,
                           const float2* __restrict__ uv,
                           const unsigned char* __restrict__ valid,
                           const float* __restrict__ patch,
                           float* __restrict__ out,
                           int n, int w, int c, int h, int wi, int radius) {
  __shared__ float part[6 * kSplitWindows];
  const int r = R == pb::kRuntimeRadius ? radius : R;
  const int P = (2 * r + 1) * (2 * r + 1);
  const long long total = static_cast<long long>(n) * w;
  const pb::WindowOffsets at = pb::window_offsets(n, w, c, h, wi, P);
  planes += at.planes;
  uv += at.obs;
  valid += at.obs;
  patch += at.patch;
  out += 6 * at.obs;
  const int obs_per_block = kSplitWindows / c;
  const long long groups = (total + obs_per_block - 1) / obs_per_block;
  const int t = threadIdx.x;
  const int ch = t / obs_per_block;
  const int o = t - ch * obs_per_block;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long idx = g * obs_per_block + o;
    const bool live = ch < c && idx < total;
    const int f = live ? static_cast<int>(idx / n) : 0;
    const int p =
        live ? static_cast<int>(idx - static_cast<long long>(f) * n) : 0;
    const long long obs = static_cast<long long>(p) * w + f;
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (live && valid[obs]) {
      int x0, y0;
      float wt[16];
      window_at(uv[obs], r, h, wi, &x0, &y0, wt);
      const float* win = planes +
                         (static_cast<long long>(f) * c + ch) * h * wi +
                         static_cast<long long>(y0) * wi + x0;
      channel_sums<R, NORM>(
          win, wi, wt, r, patch + (static_cast<long long>(p) * c + ch) * P,
          P, acc);
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) part[t * 6 + k] = acc[k];
    __syncthreads();
    if (t < obs_per_block && idx < total) {
      pb::store_channel_sums(part, 6, obs_per_block, t, c, out, total, idx);
    }
    __syncthreads();   // the next group refills the partials
  }
}

template <int R, int NORM>
void launch(const void* planes, const void* uv, const void* valid,
            const void* patch, void* out, int b, int n, int w, int c, int h,
            int wi, int radius, bool split, cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * w;
  if (split) {
    const int obs_per_block = kSplitWindows / c;
    const dim3 blocks(
        pb::resident_blocks((total + obs_per_block - 1) / obs_per_block,
                            kSplitBlocksAt<R>, b),
        static_cast<unsigned>(b));
    bicubic_split_stats_kernel<R, NORM><<<blocks, kSplitWindows, 0, stream>>>(
        static_cast<const float*>(planes), static_cast<const float2*>(uv),
        static_cast<const unsigned char*>(valid),
        static_cast<const float*>(patch), static_cast<float*>(out), n, w, c,
        h, wi, radius);
    return;
  }
  const dim3 blocks(static_cast<unsigned>((total + kThreads - 1) / kThreads),
                    static_cast<unsigned>(b));
  bicubic_stats_kernel<R, NORM><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(planes), static_cast<const float2*>(uv),
      static_cast<const unsigned char*>(valid),
      static_cast<const float*>(patch), static_cast<float*>(out), n, w, c, h,
      wi, radius);
}

}  // namespace

// b: windows of the launch (the batch axis, grid y; 1 for one window).
extern "C" int pb_bicubic_stats(const void* planes, const void* uv,
                                const void* valid, const void* patch,
                                void* out, int b, int n, int w, int c, int h,
                                int wi, int radius, int norm, void* stream) {
  if (c < 1 || c > kMaxChannels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = pb::dispatch<pb::kMaxSolveRadius, true>(
      radius, norm,
      [&](auto r, auto m) {
        launch<decltype(r)::value, decltype(m)::value>(
            planes, uv, valid, patch, out, b, n, w, c, h, wi, radius, c > 1,
            s);
      },
      kMaxBicubicRadius);
  return bad ? bad : static_cast<int>(cudaGetLastError());
}

// The one-thread design with a run-time radius, at any radius
// 1..kMaxBicubicRadius: the bitwise reference of pb_bicubic_stats' designs.
extern "C" int pb_bicubic_stats_one_thread(const void* planes,
                                           const void* uv, const void* valid,
                                           const void* patch, void* out,
                                           int n, int w, int c, int h, int wi,
                                           int radius, int norm,
                                           void* stream) {
  if (radius < 1 || radius > kMaxBicubicRadius) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = pb::launch_norm(
      norm,
      [&](auto r, auto m) {
        launch<decltype(r)::value, decltype(m)::value>(
            planes, uv, valid, patch, out, 1, n, w, c, h, wi, radius, false,
            s);
      },
      std::integral_constant<int, pb::kRuntimeRadius>{});
  return bad ? bad : static_cast<int>(cudaGetLastError());
}

// The design instance <radius, norm> runs: 0 samples on every pass, 1 the
// register tile, 2 the runtime-radius instance; -1 where none runs.
extern "C" int pb_bicubic_design(int radius, int norm) {
  int design = -1;
  pb::dispatch<pb::kMaxSolveRadius, true>(
      radius, norm,
      [&](auto r, auto m) {
        constexpr int R = decltype(r)::value;
        design = R == pb::kRuntimeRadius ? 2
                 : kRegisterTile<R, decltype(m)::value> ? 1 : 0;
      },
      kMaxBicubicRadius);
  return design;
}

extern "C" const char* pb_bicubic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
