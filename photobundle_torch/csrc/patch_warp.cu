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
// (csrc/patch_stage.cuh, shared with the ablation K8). Channels
// are double-buffered: channel c+1 is in flight while channel c is summed,
// so the tile never holds more than two channels (C = 8 for bitplanes).
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
// same sums with observations visited in a sorted point order and each
// block's union box staged in shared memory where it fits (see below).
// Both entries take patch radii 1..kMaxFixedRadius in every
// normalization: compile-time instances to pb::kMaxSolveRadius, and above
// it one instance per normalization with the radius a run-time argument
// (the one-thread design with rolled loops, the same arithmetic in the
// same order), up to the JAX package's fixed-grid limit: its panel holds
// a (2R+2)-px window of three lanes per pixel with a positive stride to
// R = 19 (photobundle_tpu/ops/patch_warp.py, lane_stride).

#include <cuda_runtime.h>

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
constexpr int kStageTexels = 1024;      // the sorted entry's union box
constexpr int kMaxFixedRadius = 19;     // ops/_common.FIXED_RADII

// K1's staging plan (csrc/patch_stage.cuh): a block stages the windows of
// its kThreads observations, two channel buffers.
template <int R>
using Plan = pb::Plan<R, kThreads>;

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
// the point; its sums go to its own slot, so nothing is unscattered), finds
// the union box of its valid observations' windows, and, when that box
// fits kStageTexels, copies it into shared memory once with coalesced
// float4 loads; every thread then samples from the tile. A block whose box
// does not fit samples from global memory as K1's one-thread design does.
// Both branches run `sample` and the epilogue on the same texel values, so
// the sums are bitwise K1's.
//
// What bounds it: the same distinct texels as K1 (bytes); what it adds is
// one copy per staged block and a block reduction. Whether a block stages
// depends on the density of points: at 4096 points on a 370x1226 frame a
// run of 64 sorted points spans thousands of texels and no block fits;
// at 65 536 points a 64-point run of a 16-row band spans ~21x33 texels.
// `staged` (may be null) receives each block's choice. A block whose box
// does not fit does not stage its observations' own windows as the staged
// K1 does: reserving the shared memory for them (37 KB a block at R = 2)
// made the dense case, for which this entry exists, 1.14x slower (fewer
// blocks per SM; PERF.md's K1 rows).

template <int R, int NORM>
__global__ void __launch_bounds__(kThreads)
patch_stats_sorted_kernel(const float4* __restrict__ planes,
                          const float2* __restrict__ uv,
                          const unsigned char* __restrict__ valid,
                          const float* __restrict__ patch,
                          const long long* __restrict__ feed,
                          float* __restrict__ out,
                          unsigned char* __restrict__ staged,
                          int n, int w, int c, int h, int wi, int radius) {
  const int r = R == pb::kRuntimeRadius ? radius : R;
  const int win = 2 * r + 2;
  const int P = (2 * r + 1) * (2 * r + 1);
  __shared__ float4 tile[kStageTexels];
  __shared__ int box[4];     // min x0, min y0, max x0, max y0
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
  if (threadIdx.x == 0) {
    box[0] = box[1] = wi + h;
    box[2] = box[3] = -1;
  }
  __syncthreads();
  if (ok) {
    atomicMin(&box[0], x0);
    atomicMin(&box[1], y0);
    atomicMax(&box[2], x0);
    atomicMax(&box[3], y0);
  }
  __syncthreads();
  const int bx0 = box[0], by0 = box[1];
  const int bw = box[2] - bx0 + win;
  const int bh = box[3] - by0 + win;
  const long long chan = static_cast<long long>(h) * wi;
  const float4* frame = planes + static_cast<long long>(f) * c * chan;
  const bool stage = box[2] >= 0 &&
                     static_cast<long long>(bw) * bh * c <= kStageTexels;
  if (stage) {
    const int area = bw * bh;
    for (int i = threadIdx.x; i < area * c; i += kThreads) {
      const int ch = i / area;
      const int t = i - ch * area;
      const int row = t / bw;
      tile[i] = __ldg(frame + ch * chan +
                      static_cast<long long>(by0 + row) * wi + bx0 +
                      (t - row * bw));
    }
  }
  __syncthreads();
  if (staged != nullptr && threadIdx.x == 0) staged[blockIdx.x] = stage;

  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (ok) {
    const float* desc = patch + static_cast<long long>(p) * c * P;
    if (stage) {
      observation_stats<R, NORM>(tile + (y0 - by0) * bw + (x0 - bx0),
                                 static_cast<long long>(bw) * bh, bw, wt,
                                 desc, c, LoadPlain{}, acc, r);
    } else {
      observation_stats<R, NORM>(
          frame + static_cast<long long>(y0) * wi + x0, chan, wi, wt, desc,
          c, LoadGlobal{}, acc, r);
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
  const dim3 blocks(
      static_cast<unsigned>(w) * ((n + kThreads - 1) / kThreads),
      static_cast<unsigned>(b));
  patch_stats_sorted_kernel<R, NORM><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float4*>(planes), static_cast<const float2*>(uv),
      static_cast<const unsigned char*>(valid),
      static_cast<const float*>(patch), static_cast<const long long*>(feed),
      static_cast<float*>(out), static_cast<unsigned char*>(staged), n, w, c,
      h, wi, radius);
}

}  // namespace

// b: windows of the launch (the batch axis, grid y; 1 for one window).
extern "C" int pb_patch_stats(const void* planes, const void* uv,
                              const void* valid, const void* patch, void* out,
                              int b, int n, int w, int c, int h, int wi,
                              int radius, int norm, void* stream) {
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
// window), set to 1 where the block sampled from its staged union box.
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
