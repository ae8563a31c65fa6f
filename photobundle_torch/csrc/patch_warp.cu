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
// points x 5 frames) there are ~20k observations, each needing a
// (2R+2)^2 window of float4 texels (576 B at R = 2) and storing 24 B: a
// few microseconds of HBM bandwidth. A first design let each thread gather
// its own window straight from global memory. Each warp-wide load then
// touched ~32 distinct 128-B lines, and with ~155 threads per SM (one per
// observation) too few loads were in flight to cover HBM latency: the
// window loads alone took 95-106 % of that design (an ablation of it;
// csrc/patch_ablate.cu now ablates the staged design below).
//
// What this design does about it, for R <= pb::kMaxStagedRadius: a block
// takes kThreads consecutive observations (frame-major, so neighbouring
// threads store neighbouring outputs) and stages their windows in shared
// memory, one channel at a time, with coalesced 16-byte cp.async.cg copies
// (csrc/patch_stage.cuh, shared with the ablation K8). It runs at C = 1
// (its channel double-buffering, channel c+1 in flight while channel c
// is summed, was the C > 1 path until the design below replaced it).
// After the barrier, each thread runs K1's unchanged per-observation
// epilogue (observation_stats) on its own window in the tile; its second
// and third sweeps read shared memory.
//
// Where staging pays, measured on the H100 (PERF.md's K1 rows, one
// kernel_times.py call): at 4096 x 5, R = 2, cold, 0.84x the one-thread
// design and 0.87x that design with the channel count fixed at one, so
// the gain is the coalesced copy, not the compile-time channel count. From
// R = 4 the windows of 64 observations take 103 KB or more per channel:
// two blocks or fewer fit an SM, and a block's copy and sums run one
// after the other, while the one-thread design (each thread gathers its
// own window through the read-only path, its later sweeps served by L1)
// overlaps loads with sums across all its warps. So R > kMaxStagedRadius
// keeps that design; the choice is compile-time.
// Where windows overlap (65 536 points) the staged K1 runs 1.04x the
// one-thread design: the copy bypasses L1, which that design's
// neighbouring threads share.
//
// With more than one channel (the IntensityAndGradient descriptor, C =
// 3; BitPlanes, C = 8) the first design walked an observation's channels
// one after another in one thread (the staged block: two channel
// buffers, 3 blocks of 2 warps an SM), so its time grew with C (R = 2:
// 13.4, 33.7, 71.5 us at C = 1, 3, 8; R = 19: 1358, 4040, 11 445).
// What bounds it then: to R = 4, the window rows' random DRAM reads (16-B
// texels, padding lane included, 32-B sectors; 0.2-0.3 of a bound that
// counts distinct 12-B texels at the peak rate), so more threads alone
// gain little; from R = 5, L1, where each thread's window rows must
// survive until its next sweep. What this design does about it
// (split_staged_stats_kernel, split_gathered_stats_kernel below): each
// (observation, channel) pair its own thread, so C times the threads;
// to kSplitStagedRadius every warp stages and sums its own 32 windows
// with no block barrier (the warps of an SM drift apart, copies of some
// in flight while others sum); above, the grid holds kSplitGatherBlocks
// blocks an SM looping over groups (256 resident windows: L1 holds
// their rows). Measured (PERF.md, kernel_times.py, 4096 x 5, cold, H100
// at 700 W, the first design in brackets): C = 3, R = 2 34.5 us [34.0],
// R = 3 57.4 [71.3], R = 4 80.9 [82.3], R = 9 662 [793], R = 19 3297
// [4038]; C = 8, R = 2 67.8 [71.9], R = 3 136.7 [191], R = 4 210.9 [201.4],
// R = 9 1733 [2147], R = 19 8950 [11 443]. Measured and not kept: one
// thread per window in blocks of 64, 128 or 192 barrier-synchronised
// windows (C = 3, R = 2: 34.2, 40.9, 42.0 us) or of 64 double-buffered
// windows looping over groups (34.2 at C = 3, 73.5 at C = 8); warps of 1
// or 4 a block (C = 3, R = 2: 35.9, 37.5); gathering to R = 4 (C = 3, R
// = 2: 39.0; R = 4: 93.9 and 223.7 at C = 3 and 8); no cap above (C = 8,
// R = 19: 32.6 ms, resident windows evict each other's rows), and caps
// of 2, 3, 6, 8 blocks (C = 8, R = 19: 14.9, 11.4, 8.9, 13.0 ms).
//
// The sums are bitwise those of the one-thread-per-observation design:
// the per-observation arithmetic and its order are unchanged (-fmad=false,
// centring before multiplying, channels summed in order, no atomics), only
// where the texels are read from differs.
//
// Both entries take B windows of the same shapes on a grid axis
// (blockIdx.y, csrc/patch_batch.cuh; the batched window solve,
// core/batched.py, runs one launch for all its windows): each block row
// offsets every pointer to its window's slices and runs the unchanged
// per-observation code.
//
// A second entry, pb_patch_stats_sorted, is K1's sort-reuse variant: the
// same sums with observations visited in a sorted point order, each block
// staging its union box or its own windows in shared memory (see below).
// Both entries take patch radii 1..kMaxFixedRadius in every
// normalization: compile-time instances to pb::kMaxSolveRadius, and above
// it one instance per normalization with the radius a run-time argument
// (the one-thread design with rolled loops, the same arithmetic in the
// same order), up to the JAX package's fixed-grid limit: its panel holds
// a (2R+2)-px window of three lanes per pixel with a positive stride to
// R = 19 (photobundle_tpu/ops/patch_warp.py, lane_stride).

#include <cuda_runtime.h>

#include <climits>

#include "patch_batch.cuh"
#include "patch_bilinear.cuh"
#include "patch_stage.cuh"

namespace {

using pb::cp_async_commit;
using pb::cp_async_wait;
using pb::LoadGlobal;
using pb::LoadPlain;
using pb::observation_stats;
using pb::Weights;
using pb::window_at;
using pb::window_offsets;
using pb::WindowOffsets;

constexpr int kThreads = 64;            // threads (observations) per block
constexpr int kMaxFixedRadius = 19;     // ops/_common.FIXED_RADII

// K1's staging plan (csrc/patch_stage.cuh): a block stages the windows of
// its kThreads observations, two channel buffers (one at C = 1).
template <int R, int OBS = kThreads>
using Plan = pb::Plan<R, OBS>;

// K1's design at C > 1 (split_staged_stats_kernel,
// split_gathered_stats_kernel; chosen by kernel_times.py calls, PERF.md):
// the radii whose windows are staged and the warps of such a block;
// above, the threads (each an (observation, channel) window) of a block
// and the blocks an SM. The channel count a launch takes is kMaxChannels.
constexpr int kSplitStagedRadius = 4;
constexpr int kSplitWarps = 2;
constexpr int kSplitWindows = 64;
constexpr int kSplitGatherBlocks = 4;
constexpr int kMaxChannels = 32;       // ops/_common.MAX_CHANNELS
static_assert(kSplitWindows >= kMaxChannels && 32 >= kMaxChannels,
              "a warp and a block hold every channel");
template <int R>
constexpr bool kSplitStaged = R >= 1 && R <= kSplitStagedRadius;

// K1 for R <= kMaxStagedRadius: the block's windows staged in shared
// memory one channel at a time, then each thread's sums from its tile
// window (thread o owns observation o of the block).
template <int R, int NORM>
__global__ void __launch_bounds__(kThreads)
staged_patch_stats_kernel(const float4* __restrict__ planes,
                          const float2* __restrict__ uv,
                          const unsigned char* __restrict__ valid,
                          const float* __restrict__ patch,
                          float* __restrict__ out,
                          int n, int w, int c, int h, int wi) {
  using PL = Plan<R>;
  static_assert(PL::kStaged && PL::kBuffers == 2,
                "radius above kMaxStagedRadius, or one channel buffer");
  constexpr int P = (2 * R + 1) * (2 * R + 1);
  extern __shared__ float4 tile[];
  __shared__ long long base[PL::kObs];
  const long long total = static_cast<long long>(n) * w;
  const WindowOffsets at = window_offsets(n, w, c, h, wi, P);
  planes += at.planes;
  uv += at.obs;
  valid += at.obs;
  patch += at.patch;
  out += 6 * at.obs;
  const long long idx =
      static_cast<long long>(blockIdx.x) * PL::kObs + threadIdx.x;
  const bool live = idx < total;
  const int f = live ? static_cast<int>(idx / n) : 0;
  const int p = live ? static_cast<int>(idx - static_cast<long long>(f) * n)
                     : 0;
  const long long obs = static_cast<long long>(p) * w + f;
  const bool ok = live && valid[obs];

  const long long chan = static_cast<long long>(h) * wi;
  Weights wt = {0.f, 0.f, 0.f, 0.f};
  base[threadIdx.x] = -1;
  if (ok) {
    int x0, y0;
    window_at<R>(uv[obs], h, wi, &x0, &y0, &wt);
    base[threadIdx.x] = static_cast<long long>(f) * c * chan +
                        static_cast<long long>(y0) * wi + x0;
  }
  __syncthreads();
  const float* desc = patch + static_cast<long long>(p) * c * P;
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  pb::stage_channel<R, kThreads, kThreads>(tile, planes, base, 0, wi);
  cp_async_commit();
  for (int ch = 0; ch < c; ++ch) {
    if (ch + 1 < c) {      // channel ch + 1 in flight while ch is summed
      pb::stage_channel<R, kThreads, kThreads>(
          tile + ((ch + 1) & 1) * PL::kObs * PL::kStride, planes, base,
          (ch + 1) * chan, wi);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (ok) {
      observation_stats<R, NORM>(
          tile + ((ch & 1) * PL::kObs + threadIdx.x) * PL::kStride, 0,
          PL::kWin, wt, desc + static_cast<long long>(ch) * P, 1,
          LoadPlain{}, acc);
    }
    __syncthreads();   // the buffer is refilled two channels on
  }
  if (!live) return;
#pragma unroll
  for (int k = 0; k < 6; ++k) out[k * total + idx] = acc[k];
}

// K1 for R > kMaxStagedRadius: one thread per observation gathers its own
// window through the read-only path (the first design, unchanged; R =
// pb::kRuntimeRadius takes the radius from `radius`).
template <int R, int NORM>
__global__ void __launch_bounds__(kThreads)
patch_stats_kernel(const float4* __restrict__ planes,
                   const float2* __restrict__ uv,
                   const unsigned char* __restrict__ valid,
                   const float* __restrict__ patch,
                   float* __restrict__ out,
                   int n, int w, int c, int h, int wi, int radius) {
  const int r = R == pb::kRuntimeRadius ? radius : R;
  const int P = (2 * r + 1) * (2 * r + 1);
  const long long total = static_cast<long long>(n) * w;
  const WindowOffsets at = window_offsets(n, w, c, h, wi, P);
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
    Weights wt;
    window_at(uv[obs], r, h, wi, &x0, &y0, &wt);
    const long long chan = static_cast<long long>(h) * wi;
    const float4* win = planes + static_cast<long long>(f) * c * chan +
                        static_cast<long long>(y0) * wi + x0;
    observation_stats<R, NORM>(win, chan, wi, wt,
                               patch + static_cast<long long>(p) * c * P, c,
                               LoadGlobal{}, acc, r);
  }
  const long long o = static_cast<long long>(f) * n + p;
#pragma unroll
  for (int k = 0; k < 6; ++k) out[k * total + o] = acc[k];
}

// K1 at C > 1, every radius: each (observation, channel) pair its own
// thread, running K1's unchanged per-channel arithmetic
// (observation_stats over its one channel, from zero) and leaving its six
// partial sums in shared memory; one thread per observation then adds its
// C partials into 0.f in channel order and stores.
//
// To kSplitStagedRadius: each warp takes obs = 32 / C consecutive
// observations (frame-major), lane l channel l / obs of observation
// l % obs (lanes past obs * C idle), and stages its 32 windows by its own
// lanes as the C = 1 design stages a block's (every channel's copy in
// flight at once); each lane sums its window and leaves its partials in
// its own window slot, which no other lane reads; lanes 0..obs-1 add
// and store. No block barrier: the warps of a block (kSplitWarps) run
// apart.
template <int R, int NORM>
__global__ void __launch_bounds__(kSplitWarps * 32)
split_staged_stats_kernel(const float4* __restrict__ planes,
                          const float2* __restrict__ uv,
                          const unsigned char* __restrict__ valid,
                          const float* __restrict__ patch,
                          float* __restrict__ out,
                          int n, int w, int c, int h, int wi) {
  using PL = Plan<R, 32>;
  static_assert(kSplitWarps * 32 * PL::kBuffer + pb::kStaticReserve <=
                    pb::kMaxSharedBytes,
                "a block's windows must fit its shared memory");
  constexpr int P = (2 * R + 1) * (2 * R + 1);
  extern __shared__ float4 tile[];
  __shared__ long long base[kSplitWarps * 32];
  const long long total = static_cast<long long>(n) * w;
  const WindowOffsets at = window_offsets(n, w, c, h, wi, P);
  planes += at.planes;
  uv += at.obs;
  valid += at.obs;
  patch += at.patch;
  out += 6 * at.obs;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int obs_per_warp = 32 / c;
  const int ch = lane / obs_per_warp;
  const int o = lane - ch * obs_per_warp;
  const long long idx =
      (static_cast<long long>(blockIdx.x) * kSplitWarps + warp) *
          obs_per_warp + o;
  const bool live = ch < c && idx < total;
  const int f = live ? static_cast<int>(idx / n) : 0;
  const int p = live ? static_cast<int>(idx - static_cast<long long>(f) * n)
                     : 0;
  const long long obs = static_cast<long long>(p) * w + f;
  const bool ok = live && valid[obs];
  const long long chan = static_cast<long long>(h) * wi;
  int x0 = 0, y0 = 0;
  Weights wt = {0.f, 0.f, 0.f, 0.f};
  if (ok) window_at<R>(uv[obs], h, wi, &x0, &y0, &wt);
  float4* const windows = tile + warp * 32 * PL::kStride;
  long long* const origins = base + warp * 32;
  origins[lane] = ok ? (static_cast<long long>(f) * c + ch) * chan +
                           static_cast<long long>(y0) * wi + x0
                     : -1;
  __syncwarp();
  pb::stage_windows<R, 32, 32>(windows, planes, origins, wi, lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (ok) {
    observation_stats<R, NORM>(
        windows + lane * PL::kStride, 0, PL::kWin, wt,
        patch + (static_cast<long long>(p) * c + ch) * P, 1, LoadPlain{},
        acc);
  }
  float* const slots = reinterpret_cast<float*>(windows);
  constexpr int kSlot = 4 * PL::kStride;          // floats per window slot
#pragma unroll
  for (int k = 0; k < 6; ++k) slots[lane * kSlot + k] = acc[k];
  __syncwarp();
  if (lane < obs_per_warp && idx < total) {
    pb::store_channel_sums(slots, kSlot, obs_per_warp, lane, c, out, total,
                           idx);
  }
}

// Above kSplitStagedRadius: a block of kSplitWindows threads takes groups
// of obs = kSplitWindows / C consecutive observations, thread t channel
// t / obs of observation t % obs (channel-major: a warp holds one channel
// of neighbouring observations; threads past obs * C idle). Each thread
// gathers its channel's window through the read-only path as the
// one-thread design does and leaves its partials in a shared array;
// after the barrier threads 0..obs-1 add and store. The grid holds
// kSplitGatherBlocks blocks an SM, each looping over groups: more
// resident windows than that evict each other's rows from L1 before
// their next sweep.
template <int R, int NORM>
__global__ void __launch_bounds__(kSplitWindows)
split_gathered_stats_kernel(const float4* __restrict__ planes,
                            const float2* __restrict__ uv,
                            const unsigned char* __restrict__ valid,
                            const float* __restrict__ patch,
                            float* __restrict__ out,
                            int n, int w, int c, int h, int wi,
                            int radius) {
  __shared__ float partials[6 * kSplitWindows];
  const int r = R == pb::kRuntimeRadius ? radius : R;
  const int P = (2 * r + 1) * (2 * r + 1);
  const long long total = static_cast<long long>(n) * w;
  const WindowOffsets at = window_offsets(n, w, c, h, wi, P);
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
  const long long chan = static_cast<long long>(h) * wi;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long idx = g * obs_per_block + o;
    const bool live = ch < c && idx < total;
    const int f = live ? static_cast<int>(idx / n) : 0;
    const int p =
        live ? static_cast<int>(idx - static_cast<long long>(f) * n) : 0;
    const long long obs = static_cast<long long>(p) * w + f;
    const bool ok = live && valid[obs];
    int x0 = 0, y0 = 0;
    Weights wt = {0.f, 0.f, 0.f, 0.f};
    if (ok) window_at(uv[obs], r, h, wi, &x0, &y0, &wt);
    const long long origin = (static_cast<long long>(f) * c + ch) * chan +
                             static_cast<long long>(y0) * wi + x0;
    const float* desc = patch + (static_cast<long long>(p) * c + ch) * P;
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (ok) {
      observation_stats<R, NORM>(planes + origin, chan, wi, wt, desc, 1,
                                 LoadGlobal{}, acc, r);
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) partials[t * 6 + k] = acc[k];
    __syncthreads();
    if (t < obs_per_block && idx < total) {
      pb::store_channel_sums(partials, 6, obs_per_block, t, c, out, total,
                             idx);
    }
    __syncthreads();   // the next group refills the partials
  }
}

template <int R, int NORM>
void launch(const void* planes, const void* uv, const void* valid,
            const void* patch, void* out, int b, int n, int w, int c, int h,
            int wi, int radius, cudaStream_t stream) {
  using PL = Plan<R>;
  const long long total = static_cast<long long>(n) * w;
  const dim3 blocks(static_cast<unsigned>((total + PL::kObs - 1) / PL::kObs),
                    static_cast<unsigned>(b));
  const auto* pl = static_cast<const float4*>(planes);
  const auto* q = static_cast<const float2*>(uv);
  const auto* ok = static_cast<const unsigned char*>(valid);
  const auto* d = static_cast<const float*>(patch);
  auto* o = static_cast<float*>(out);
  if (c > 1) {
    if constexpr (kSplitStaged<R>) {
      const int per_block = kSplitWarps * (32 / c);
      const dim3 split(
          static_cast<unsigned>((total + per_block - 1) / per_block),
          static_cast<unsigned>(b));
      const int bytes = kSplitWarps * 32 * Plan<R, 32>::kBuffer;
      // The dynamic shared memory opt-in, once per instance.
      static const cudaError_t opted = cudaFuncSetAttribute(
          split_staged_stats_kernel<R, NORM>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      (void)opted;
      split_staged_stats_kernel<R, NORM>
          <<<split, kSplitWarps * 32, bytes, stream>>>(pl, q, ok, d, o, n, w,
                                                       c, h, wi);
    } else {
      const int obs_per_block = kSplitWindows / c;
      const dim3 split(
          pb::resident_blocks((total + obs_per_block - 1) / obs_per_block,
                              kSplitGatherBlocks, b),
          static_cast<unsigned>(b));
      split_gathered_stats_kernel<R, NORM>
          <<<split, kSplitWindows, 0, stream>>>(pl, q, ok, d, o, n, w, c, h,
                                                wi, radius);
    }
    return;
  }
  if constexpr (PL::kStaged) {
    // Above 48 KB a kernel's dynamic shared memory must be opted into;
    // once per instance (the port drives one card per process). A failure
    // surfaces as the launch's error.
    static const cudaError_t opted = cudaFuncSetAttribute(
        staged_patch_stats_kernel<R, NORM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, PL::kMaxBytes);
    (void)opted;
    staged_patch_stats_kernel<R, NORM>
        <<<blocks, kThreads, PL::bytes(c), stream>>>(pl, q, ok, d, o, n, w,
                                                     c, h, wi);
  } else {
    patch_stats_kernel<R, NORM><<<blocks, kThreads, 0, stream>>>(
        pl, q, ok, d, o, n, w, c, h, wi, radius);
  }
}

// ---------------------------------------------------------------------------
// The sorted variant (K1 with sort_reuse=True): the same sums, observations
// visited in a sorted point order.
//
// Replaces photobundle_tpu/ops/patch_warp.py::_warp_kernel_packed with
// sort_reuse=True (patch_warp.py:393-411), which the JAX package feeds in
// (panel, image-row) order under PB_SORTED_DISPATCH=1 and which skips a
// group's window load when the previous group loaded the same rows. Here a
// block takes kThreads consecutive sorted ranks of one frame (feed[rank] is
// the point; its sums go to its own slot, so nothing is unscattered).
//
// What bounds it: where the windows are few and far apart (4096 points on
// a 370x1226 frame: a run of 64 sorted points spans thousands of texels),
// the window rows' scattered reads, as for K1, and one more dependent
// load (feed, then the observation) before them. Where they overlap
// (65 536 points: a 64-point run of a 16-row band spans ~21x33 texels at
// R = 2), the union box holds a third of the windows' texels.
//
// The design: one dynamic shared buffer a block, sized from the radius
// and the block's observation count: to pb::kMaxStagedRadius, K1's staged
// tile (64 windows, two channel buffers at C > 1). It holds either the
// block's union box or its observations' own windows, never both. The
// union box comes from a warp-shuffle min / max and one cross-warp step;
// then the block chooses by texels (`staged` receives its branch):
//   1 (the union box): its texels, C channels of it, fit the buffer and
//     are no more than the valid windows' texels summed (the windows
//     overlap): its rows (contiguous float4 runs of `planes`) copied once
//     with cp.async, every observation sampled from it;
//   2 (own windows): each observation's window staged as K1's staged
//     design stages it (csrc/patch_stage.cuh);
//   0 (gathered): above pb::kMaxStagedRadius every block, and below it a
//     block with no valid observation (nothing to sum): each thread
//     gathers its own window through the read-only path as K1's
//     one-thread design does, at that design's occupancy.
// Every branch feeds the same texel values to pb::observation_stats,
// channel by channel in order, so the sums are bitwise K1's.
//
// Measured on the H100 (PERF.md's sorted K1 row; kernel_times.py, cold,
// the first design in brackets, K1 after the semicolon): 4096 x 5, R = 2
// 15.3 us [16.3; 13.4], R = 10 490 [930; 415], R = 19 1640-1700 [3100;
// 1355]; 65 536 x 5, R = 2 77.5-79 [75.1; 77.7], R = 4 189-196 [203;
// 287], R = 10 3200-3460 [8890; 8760], R = 19 11 000-11 600 [30 400;
// 28 700]; B = 4, R = 2 42-44 [52; 38.6]. Measured and not kept: the
// first design (a static 1024-texel box tile, 16 KB, and global gathers
// elsewhere, the box found with shared atomics: its gathers took 2.2x
// K1's time at R = 10 and 19); a box buffer of 2048 texels above R = 3
// (65 536 points: R = 4 177 us, but R = 10 5080 and R = 19 30 900; 4096
// points 1.9x slower at R = 10 and 19: the buffer halves the gathers'
// occupancy); staging own windows where the box would do (65 536, R = 2:
// 106-114 us: the box copies a third of the texels); blocks taking one
// run of every frame in turn (65 536, R = 2: 85 us).

enum SortedBranch : unsigned char {
  kGathered = 0,
  kUnionBox = 1,
  kOwnWindows = 2,
};

template <int R, int NORM>
__global__ void __launch_bounds__(kThreads)
patch_stats_sorted_kernel(const float4* __restrict__ planes,
                          const float2* __restrict__ uv,
                          const unsigned char* __restrict__ valid,
                          const float* __restrict__ patch,
                          const long long* __restrict__ feed,
                          float* __restrict__ out,
                          unsigned char* __restrict__ staged,
                          int n, int w, int c, int h, int wi, int radius,
                          int buffer_texels) {
  using PL = Plan<R>;
  constexpr int kWarps = kThreads / 32;
  const int r = R == pb::kRuntimeRadius ? radius : R;
  const int win = 2 * r + 2;
  const int P = (2 * r + 1) * (2 * r + 1);
  extern __shared__ float4 tile[];
  __shared__ long long base[PL::kStaged ? kThreads : 1];
  __shared__ int part[kWarps][5];   // min x0, min y0, max x0, max y0, valid
  const WindowOffsets at = window_offsets(n, w, c, h, wi, P);
  planes += at.planes;
  uv += at.obs;
  valid += at.obs;
  patch += at.patch;
  out += 6 * at.obs;
  feed += static_cast<long long>(blockIdx.y) * n;   // each window's order
  if (staged != nullptr) {
    staged += static_cast<long long>(blockIdx.y) * gridDim.x;
  }
  const int runs = (n + kThreads - 1) / kThreads;
  const int f = blockIdx.x / runs;
  const int rank = (blockIdx.x - f * runs) * kThreads + threadIdx.x;
  const bool live = rank < n;
  const int p = live ? static_cast<int>(feed[rank]) : 0;
  const long long obs = static_cast<long long>(p) * w + f;
  const bool ok = live && valid[obs];

  int x0 = 0, y0 = 0;
  Weights wt = {0.f, 0.f, 0.f, 0.f};
  if (ok) window_at(uv[obs], r, h, wi, &x0, &y0, &wt);
  const long long chan = static_cast<long long>(h) * wi;
  const float4* frame = planes + static_cast<long long>(f) * c * chan;

  int branch = kGathered;
  int bx0 = 0, by0 = 0, bw = 0, area = 0;
  if constexpr (PL::kStaged) {
    // The union box: each warp's min / max by shuffles, then one step
    // across the block's warps.
    const unsigned all = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const int wp = threadIdx.x >> 5;
    const int lo_x = __reduce_min_sync(all, ok ? x0 : INT_MAX);
    const int lo_y = __reduce_min_sync(all, ok ? y0 : INT_MAX);
    const int hi_x = __reduce_max_sync(all, ok ? x0 : -1);
    const int hi_y = __reduce_max_sync(all, ok ? y0 : -1);
    const int count = __popc(__ballot_sync(all, ok));
    if (lane == 0) {
      part[wp][0] = lo_x;
      part[wp][1] = lo_y;
      part[wp][2] = hi_x;
      part[wp][3] = hi_y;
      part[wp][4] = count;
    }
    base[threadIdx.x] = ok ? static_cast<long long>(f) * c * chan +
                                 static_cast<long long>(y0) * wi + x0
                           : -1;
    __syncthreads();
    int bx1 = -1, by1 = -1, n_ok = 0;
    bx0 = by0 = INT_MAX;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      bx0 = min(bx0, part[k][0]);
      by0 = min(by0, part[k][1]);
      bx1 = max(bx1, part[k][2]);
      by1 = max(by1, part[k][3]);
      n_ok += part[k][4];
    }
    if (n_ok > 0) {
      bw = bx1 - bx0 + win;
      area = bw * (by1 - by0 + win);
      const long long box = static_cast<long long>(area) * c;
      const long long own = static_cast<long long>(n_ok) * win * win * c;
      branch = box <= buffer_texels && box <= own ? kUnionBox : kOwnWindows;
    }
  }
  if (staged != nullptr && threadIdx.x == 0) staged[blockIdx.x] = branch;

  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const float* desc = patch + static_cast<long long>(p) * c * P;
  if constexpr (!PL::kStaged) {
    if (ok) {
      observation_stats<R, NORM>(
          frame + static_cast<long long>(y0) * wi + x0, chan, wi, wt, desc,
          c, LoadGlobal{}, acc, r);
    }
  } else if (branch != kGathered) {
    if (branch == kUnionBox) {
      // Every channel of the box, row by row: consecutive threads copy
      // consecutive texels of a row.
      for (int i = threadIdx.x; i < area * c; i += kThreads) {
        const int ch = i / area;
        const int t = i - ch * area;
        const int row = t / bw;
        pb::cp_async16(tile + i,
                       frame + ch * chan +
                           static_cast<long long>(by0 + row) * wi + bx0 +
                           (t - row * bw));
      }
    } else {
      pb::stage_channel<R, kThreads, kThreads>(tile, planes, base, 0, wi);
    }
    cp_async_commit();
    for (int ch = 0; ch < c; ++ch) {
      int offset = ch * area + (y0 - by0) * bw + (x0 - bx0);
      int stride = bw;
      if (branch == kOwnWindows) {
        // K1's staged loop: channel ch + 1 in flight while ch is summed.
        if (ch + 1 < c) {
          pb::stage_channel<R, kThreads, kThreads>(
              tile + ((ch + 1) & 1) * PL::kObs * PL::kStride, planes, base,
              (ch + 1) * chan, wi);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        offset = ((ch & 1) * PL::kObs + threadIdx.x) * PL::kStride;
        stride = PL::kWin;
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (ok) {
        observation_stats<R, NORM>(tile + offset, 0, stride, wt,
                                   desc + static_cast<long long>(ch) * P, 1,
                                   LoadPlain{}, acc, r);
      }
      __syncthreads();   // an own-window buffer is refilled two channels on
    }
  }
  if (!live) return;
  const long long total = static_cast<long long>(n) * w;
  const long long o = static_cast<long long>(f) * n + p;
#pragma unroll
  for (int k = 0; k < 6; ++k) out[k * total + o] = acc[k];
}

template <int R, int NORM>
void launch_sorted(const void* planes, const void* uv, const void* valid,
                   const void* patch, const void* feed, void* out,
                   void* staged, int b, int n, int w, int c, int h, int wi,
                   int radius, cudaStream_t stream) {
  using PL = Plan<R>;
  const dim3 blocks(
      static_cast<unsigned>(w) * ((n + kThreads - 1) / kThreads),
      static_cast<unsigned>(b));
  if constexpr (PL::kStaged) {
    // The dynamic shared memory opt-in, once per instance.
    static const cudaError_t opted = cudaFuncSetAttribute(
        patch_stats_sorted_kernel<R, NORM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, PL::kMaxBytes);
    (void)opted;
  }
  const int bytes = PL::bytes(c);
  patch_stats_sorted_kernel<R, NORM><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const float4*>(planes), static_cast<const float2*>(uv),
      static_cast<const unsigned char*>(valid),
      static_cast<const float*>(patch), static_cast<const long long*>(feed),
      static_cast<float*>(out), static_cast<unsigned char*>(staged), n, w, c,
      h, wi, radius, bytes / 16);
}

}  // namespace

// b: windows of the launch (the batch axis, grid y; 1 for one window).
extern "C" int pb_patch_stats(const void* planes, const void* uv,
                              const void* valid, const void* patch, void* out,
                              int b, int n, int w, int c, int h, int wi,
                              int radius, int norm, void* stream) {
  if (c < 1 || c > kMaxChannels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = pb::dispatch<pb::kMaxSolveRadius, true>(
      radius, norm,
      [&](auto r, auto m) {
        launch<decltype(r)::value, decltype(m)::value>(
            planes, uv, valid, patch, out, b, n, w, c, h, wi, radius, s);
      },
      kMaxFixedRadius);
  return bad ? bad : static_cast<int>(cudaGetLastError());
}

// feed: (B, N) int64, each window's sorted rank -> point. staged: null,
// or (B, W * ceil(N / 64)) bytes, one per block (frame-major within a
// window), set to the block's branch: 1 where it sampled from its staged
// union box, 2 from its observations' staged own windows, 0 where it
// gathered from global memory.
extern "C" int pb_patch_stats_sorted(const void* planes, const void* uv,
                                     const void* valid, const void* patch,
                                     const void* feed, void* out,
                                     void* staged, int b, int n, int w,
                                     int c, int h, int wi, int radius,
                                     int norm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = pb::dispatch<pb::kMaxSolveRadius, true>(
      radius, norm,
      [&](auto r, auto m) {
        launch_sorted<decltype(r)::value, decltype(m)::value>(
            planes, uv, valid, patch, feed, out, staged, b, n, w, c, h,
            wi, radius, s);
      },
      kMaxFixedRadius);
  return bad ? bad : static_cast<int>(cudaGetLastError());
}

extern "C" const char* pb_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
