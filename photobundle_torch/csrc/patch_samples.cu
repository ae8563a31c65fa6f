// Bilinear patch samples stored per observation, for Hopper (sm_90a).
//
// Replaces photobundle_tpu/ops/patch_warp.py::_warp_kernel (K4's sample
// store, warp_patches(variant="rows")) and ::_warp_kernel_block (K6,
// variant="block" and "raw"). For every observation (point p, window frame
// f) it samples value, d/dx and d/dy on the integer (2R+1)^2 patch grid at
// uv[p, f] (the sampling of K1, csrc/patch_bilinear.cuh) and stores them in
// the TPU kernel's layout, the store layout a template parameter:
//
//   rows  (C, PS, N*W, 3PS): one patch row per store, lane 3*kx + plane
//         (the TPU kernel's ps row stores, patch_warp.py:120-121);
//   block (C, N*W, PS, 3PS): one (PS, 3PS) tile per observation
//         (patch_warp.py:1005-1006);
//   raw   (C, N*W, WIN, 3WIN): the integer WIN x WIN window of texels, no
//         bilinear combine (patch_warp.py:997); the wrapper combines it in
//         plain tensor ops.
//
// Observations are frame-major (index f * N + p), as the TPU grid walks
// them. Invalid observations store zeros: their coordinate (possibly NaN)
// is never read. The window is clamped inside the image, as K1 clamps it
// (the TPU kernel clamps into its zero-padded last panel; the two differ
// only for observations outside the margins, which are invalid).
//
// Inputs: planes (W, C, H, Wi) float4 = (value, d/dx, d/dy, 0), K1's;
// uv (N, W) float2; valid (N, W) bytes. Patch radii 1..kMaxFixedRadius,
// the JAX package's fixed-grid limit (its panel keeps a positive lane
// stride to R = 19, photobundle_tpu/ops/patch_warp.py `lane_stride`):
// compile-time instances to pb::kMaxSolveRadius and one runtime-radius
// instance per layout above it.
//
// What bounds it on this card: at the solver's window (4096 points x 5
// frames, R = 2, ~20k valid observations) it reads K1's distinct window
// texels and writes 75 floats per observation (rows, block: ~6 MB) or 108
// (raw: ~9 MB): a few microseconds of HBM bandwidth, most of it the store.
// A first design gave each thread one observation, its own window gather
// and its own tile's stores: a warp's stores were strided by the tile (60
// B for rows, 300 B for block, 432 B for raw), so each warp-wide 4-byte
// store touched ~32 sectors and filled 4 bytes of each.
//
// What this design does about it: a block of kObs consecutive
// observations (32, or 16 from R = 5) spreads its samples over its 256
// threads in the order of the stored tensor (a float3 item per sample, or
// per texel for raw), so a warp's 32 items are 384 contiguous bytes of the
// output ('block' and 'raw' store one run per channel, 'rows' one run per
// patch row, each a multiple of 32 items in a full block): each lane puts
// its float3 in a per-warp scratch and the warp writes it back as three
// coalesced 128-byte stores. Neighbouring items gather neighbouring texels
// of one window through the read-only path, so the window loads coalesce
// too, and L1 serves the taps that neighbouring samples share.
//
// Measured (PERF.md's store rows; kernel_times.py, cold, at 4096 x 5):
// 0.53x (rows), 0.31x (block) and 0.26x (raw) the first design's time at
// R = 2, 0.12-0.15x from R = 9. Not kept: 64 observations a block
// (1.10-1.17x at R = 2: fewer warps in flight); 16 below R = 5 (1.05-1.10x
// at R = 2-3, a tie at R = 4, 0.97x at R = 1 in rows and block); K1's
// staged window copy (csrc/patch_stage.cuh) before the samples (1.08x at
// R = 2 in rows and block, a tie in raw): here the gathers already
// coalesce, and the copy adds a barrier.
//
// A launch takes B windows of the same shapes on a grid axis (blockIdx.y,
// csrc/patch_batch.cuh; the twin of the axis jax.vmap adds to K4's
// pallas_call, photobundle_tpu/ops/patch_warp.py:1112): planes
// (B, W, C, H, Wi), uv and valid (B, N, W), out (B, <layout>); each block
// row offsets its pointers to its window's slices and runs the unchanged
// code, so each window's store is bitwise its own launch's. The batched
// window solve (core/batched.py) launches the row store once per
// evaluation for all its windows under PB_GROUPED_STATS=0.

#include <cuda_runtime.h>

#include "patch_batch.cuh"
#include "patch_bilinear.cuh"

namespace {

constexpr int kMaxFixedRadius = 19;     // ops/_common.FIXED_RADII

enum Layout : int { kRows = 0, kBlock = 1, kRaw = 2 };
// pb::dispatch hands the layout on as its three-valued mode code.
static_assert(kRows == pb::kNormOff && kBlock == pb::kNormMean &&
                  kRaw == pb::kNormAffine,
              "the layout codes must be pb::dispatch's mode codes");

constexpr int kThreads = 256;           // threads per block
constexpr int kWarps = kThreads / 32;

// Observations per block at radius R: 32 to R = 4, 16 from
// pb::kRolledRowRadius = 5 and at the runtime radius, where each
// observation has 121 items or more (measured, PERF.md's store rows).
template <int R>
constexpr int kObs = R >= 1 && R < pb::kRolledRowRadius ? 32 : 16;

template <int R, int LAYOUT>
__global__ void __launch_bounds__(kThreads)
warp_samples_kernel(const float4* __restrict__ planes,
                    const float2* __restrict__ uv,
                    const unsigned char* __restrict__ valid,
                    float* __restrict__ out, int n, int w, int c, int h,
                    int wi, int radius) {
  const int r = R == pb::kRuntimeRadius ? radius : R;
  const int ps = 2 * r + 1;
  const int rows = LAYOUT == kRaw ? ps + 1 : ps;   // tile rows and columns
  const int cells = rows * rows;                   // items per observation
  constexpr int OBS = kObs<R>;
  __shared__ long long base[OBS];         // window origin, -1: invalid
  __shared__ pb::Weights wts[OBS];
  __shared__ float scratch[kWarps][96];   // one warp's 32 float3 items
  const long long m = static_cast<long long>(n) * w;
  const pb::WindowOffsets at = pb::window_offsets(n, w, c, h, wi, 0);
  planes += at.planes;
  uv += at.obs;
  valid += at.obs;
  out += 3 * c * at.obs * cells;          // a window's stored tensor
  const long long o0 = static_cast<long long>(blockIdx.x) * OBS;
  const int nb = static_cast<int>(min(static_cast<long long>(OBS), m - o0));
  const long long chan = static_cast<long long>(h) * wi;
  if (threadIdx.x < OBS) {
    long long b = -1;
    pb::Weights wt = {0.f, 0.f, 0.f, 0.f};
    if (static_cast<int>(threadIdx.x) < nb) {
      const long long o = o0 + threadIdx.x;
      const int f = static_cast<int>(o / n);
      const int p = static_cast<int>(o - static_cast<long long>(f) * n);
      const long long obs = static_cast<long long>(p) * w + f;
      if (valid[obs]) {
        int x0, y0;
        pb::window_at(uv[obs], r, h, wi, &x0, &y0, &wt);
        b = static_cast<long long>(f) * c * chan +
            static_cast<long long>(y0) * wi + x0;
      }
    }
    base[threadIdx.x] = b;
    wts[threadIdx.x] = wt;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  float* sc = scratch[threadIdx.x >> 5];
  const int items = nb * cells;           // per channel
  const int run = nb * ps;                // 'rows': the items of a patch row
  for (int ch = 0; ch < c; ++ch) {
    // Warp-uniform chunks of 32 consecutive items.
    for (int t0 = (threadIdx.x >> 5) * 32; t0 < items; t0 += kThreads) {
      const int t = t0 + lane;
      float3 s = make_float3(0.f, 0.f, 0.f);
      long long j = -1;                   // the item's float3 index in out
      if (t < items) {
        int o, ky, kx;
        if constexpr (LAYOUT == kRows) {
          ky = t / run;
          const int q = t - ky * run;
          o = q / ps;
          kx = q - o * ps;
          j = ((static_cast<long long>(ch) * ps + ky) * m + o0 + o) * ps + kx;
        } else {
          o = t / cells;
          const int k = t - o * cells;
          ky = k / rows;
          kx = k - ky * rows;
          j = (static_cast<long long>(ch) * m + o0 + o) * cells + k;
        }
        const long long b = base[o];
        if (b >= 0) {
          const float4* win = planes + b + ch * chan;
          if constexpr (LAYOUT == kRaw) {
            const float4 v = __ldg(win + static_cast<long long>(ky) * wi + kx);
            s = make_float3(v.x, v.y, v.z);
          } else {
            s = pb::sample(win, wi, ky, kx, wts[o], pb::LoadGlobal{});
          }
        }
      }
      sc[3 * lane] = s.x;
      sc[3 * lane + 1] = s.y;
      sc[3 * lane + 2] = s.z;
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const int e = lane + 32 * q;      // float e % 3 of item e / 3
        const long long je = __shfl_sync(0xffffffffu, j, e / 3);
        if (je >= 0) out[3 * je + e % 3] = sc[e];
      }
      __syncwarp();
    }
  }
}

template <int R, int LAYOUT>
void launch(const void* planes, const void* uv, const void* valid, void* out,
            int b, int n, int w, int c, int h, int wi, int radius,
            cudaStream_t stream) {
  const long long m = static_cast<long long>(n) * w;
  const dim3 blocks(static_cast<unsigned>((m + kObs<R> - 1) / kObs<R>),
                    static_cast<unsigned>(b));
  warp_samples_kernel<R, LAYOUT><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float4*>(planes), static_cast<const float2*>(uv),
      static_cast<const unsigned char*>(valid), static_cast<float*>(out), n, w,
      c, h, wi, radius);
}

}  // namespace

// layout: 0 rows, 1 block, 2 raw; radius 1..kMaxFixedRadius; b: windows
// of the launch (the batch axis, grid y; 1 for one window). Returns 0 or
// a CUDA error code (cudaErrorInvalidValue, with nothing launched, for a
// radius or layout the kernel does not take).
extern "C" int pb_warp_samples(const void* planes, const void* uv,
                               const void* valid, void* out, int b, int n,
                               int w, int c, int h, int wi, int radius,
                               int layout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = pb::dispatch<pb::kMaxSolveRadius, true>(
      radius, layout,
      [&](auto r, auto l) {
        launch<decltype(r)::value, decltype(l)::value>(
            planes, uv, valid, out, b, n, w, c, h, wi, radius, s);
      },
      kMaxFixedRadius);
  return bad ? bad : static_cast<int>(cudaGetLastError());
}

extern "C" const char* pb_samples_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
