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
//
// A second entry, pb_patch_stats_sorted, is K1's sort-reuse variant: the
// same sums with observations visited in a sorted point order and each
// block's windows staged in shared memory where they fit (see below).

#include <cuda_runtime.h>

#include "patch_epilogue.cuh"

namespace {

constexpr int kThreads = 64;

struct Weights {
  float w00, w01, w10, w11;
};

// Texel loads: K1 reads its windows from global memory through the
// read-only cache; the sorted variant also reads a block's staged tile in
// shared memory (a generic pointer, plain loads).
struct LoadGlobal {
  __device__ __forceinline__ float4 operator()(const float4* p) const {
    return __ldg(p);
  }
};
struct LoadPlain {
  __device__ __forceinline__ float4 operator()(const float4* p) const {
    return *p;
  }
};

// Bilinear combine of value/gx/gy at window cell (ky, kx) of a window whose
// rows are `stride` texels apart, in the tap order of the TPU kernel:
// w00*a + w01*b + w10*c + w11*d.
template <typename Load>
__device__ __forceinline__ float3 sample(const float4* __restrict__ win,
                                         int stride, int ky, int kx,
                                         const Weights& q, Load load) {
  const float4* r0 = win + static_cast<long long>(ky) * stride + kx;
  const float4 a = load(r0);
  const float4 b = load(r0 + 1);
  const float4 c = load(r0 + stride);
  const float4 d = load(r0 + stride + 1);
  return make_float3(q.w00 * a.x + q.w01 * b.x + q.w10 * c.x + q.w11 * d.x,
                     q.w00 * a.y + q.w01 * b.y + q.w10 * c.y + q.w11 * d.y,
                     q.w00 * a.z + q.w01 * b.z + q.w10 * c.z + q.w11 * d.z);
}

// One observation's window origin and bilinear weights. The coordinate is
// read only for a valid observation (an invalid one may be NaN, which
// must never reach floorf or an int cast); the window is clamped inside
// the image.
template <int R>
__device__ __forceinline__ void window_at(float2 q, int h, int wi, int* x0,
                                          int* y0, Weights* wt) {
  constexpr int WIN = 2 * R + 2;
  const float flx = floorf(q.x);
  const float fly = floorf(q.y);
  const float fx = q.x - flx;
  const float fy = q.y - fly;
  *x0 = min(max(static_cast<int>(flx) - R, 0), wi - WIN);
  *y0 = min(max(static_cast<int>(fly) - R, 0), h - WIN);
  const float one_fy = 1.f - fy;
  *wt = Weights{(1.f - fx) * one_fy, fx * one_fy, (1.f - fx) * fy,
                fx * fy};
}

// The six sums of one observation over its C channels: `win` is channel
// 0's window origin, channels are `chan` texels apart, rows `stride`.
template <int R, int NORM, typename Load>
__device__ __forceinline__ void observation_stats(
    const float4* win, long long chan, int stride, const Weights& wt,
    const float* __restrict__ desc, int c, Load load, float acc[6]) {
  constexpr int PS = 2 * R + 1;
  constexpr int P = PS * PS;
  for (int ch = 0; ch < c; ++ch) {
    const float4* wc = win + ch * chan;
    auto sweep = [&](auto&& emit) {
      const float4* wv = pb::opaque(wc);
#pragma unroll
      for (int ky = 0; ky < PS; ++ky) {
#pragma unroll
        for (int kx = 0; kx < PS; ++kx) {
          const float3 s = sample(wv, stride, ky, kx, wt, load);
          emit(ky * PS + kx, s.x, s.y, s.z);
        }
      }
    };
    pb::channel_stats<P, NORM>(sweep, desc + static_cast<long long>(ch) * P,
                               acc);
  }
}

template <int R, int NORM>
__global__ void __launch_bounds__(kThreads)
patch_stats_kernel(const float4* __restrict__ planes,
                   const float2* __restrict__ uv,
                   const unsigned char* __restrict__ valid,
                   const float* __restrict__ patch,
                   float* __restrict__ out,
                   int n, int w, int c, int h, int wi) {
  constexpr int P = (2 * R + 1) * (2 * R + 1);
  const long long total = static_cast<long long>(n) * w;
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
    window_at<R>(uv[obs], h, wi, &x0, &y0, &wt);
    const long long chan = static_cast<long long>(h) * wi;
    const float4* win = planes + static_cast<long long>(f) * c * chan +
                        static_cast<long long>(y0) * wi + x0;
    observation_stats<R, NORM>(win, chan, wi, wt,
                               patch + static_cast<long long>(p) * c * P, c,
                               LoadGlobal{}, acc);
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
// does not fit samples from global memory as K1 does. Both branches run
// `sample` and the epilogue on the same texel values, so the sums are
// bitwise K1's.
//
// What bounds it: the same distinct texels as K1 (bytes); what it adds is
// one copy per staged block and a block reduction. Whether a block stages
// depends on the density of points: at 4096 points on a 370x1226 frame a
// run of 64 sorted points spans thousands of texels and no block fits;
// at 65 536 points a 64-point run of a 16-row band spans ~21x33 texels.
// `staged` (may be null) receives each block's choice.

constexpr int kStageTexels = 1024;   // 16 KB of float4 texels per block

template <int R, int NORM>
__global__ void __launch_bounds__(kThreads)
patch_stats_sorted_kernel(const float4* __restrict__ planes,
                          const float2* __restrict__ uv,
                          const unsigned char* __restrict__ valid,
                          const float* __restrict__ patch,
                          const long long* __restrict__ feed,
                          float* __restrict__ out,
                          unsigned char* __restrict__ staged,
                          int n, int w, int c, int h, int wi) {
  constexpr int WIN = 2 * R + 2;
  constexpr int P = (2 * R + 1) * (2 * R + 1);
  __shared__ float4 tile[kStageTexels];
  __shared__ int box[4];     // min x0, min y0, max x0, max y0
  const int runs = (n + kThreads - 1) / kThreads;
  const int f = blockIdx.x / runs;
  const int rank = (blockIdx.x - f * runs) * kThreads + threadIdx.x;
  const bool live = rank < n;
  const int p = live ? static_cast<int>(feed[rank]) : 0;
  const long long obs = static_cast<long long>(p) * w + f;
  const bool ok = live && valid[obs];

  int x0 = 0, y0 = 0;
  Weights wt = {0.f, 0.f, 0.f, 0.f};
  if (ok) window_at<R>(uv[obs], h, wi, &x0, &y0, &wt);
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
  const int bw = box[2] - bx0 + WIN;
  const int bh = box[3] - by0 + WIN;
  const long long chan = static_cast<long long>(h) * wi;
  const float4* frame = planes + static_cast<long long>(f) * c * chan;
  const bool stage = box[2] >= 0 &&
                     static_cast<long long>(bw) * bh * c <= kStageTexels;
  if (stage) {
    const int area = bw * bh;
    for (int i = threadIdx.x; i < area * c; i += kThreads) {
      const int ch = i / area;
      const int r = i - ch * area;
      const int row = r / bw;
      tile[i] = __ldg(frame + ch * chan +
                      static_cast<long long>(by0 + row) * wi + bx0 +
                      (r - row * bw));
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
                                 desc, c, LoadPlain{}, acc);
    } else {
      observation_stats<R, NORM>(
          frame + static_cast<long long>(y0) * wi + x0, chan, wi, wt, desc,
          c, LoadGlobal{}, acc);
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
                   void* staged, int n, int w, int c, int h, int wi,
                   cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>(w) * ((n + kThreads - 1) / kThreads);
  patch_stats_sorted_kernel<R, NORM><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float4*>(planes), static_cast<const float2*>(uv),
      static_cast<const unsigned char*>(valid),
      static_cast<const float*>(patch), static_cast<const long long*>(feed),
      static_cast<float*>(out), static_cast<unsigned char*>(staged), n, w, c,
      h, wi);
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

// feed: (N,) int64, sorted rank -> point. staged: null, or one byte per
// block (W * ceil(N / 64) blocks, frame-major) set to 1 where the block
// sampled from its staged tile.
extern "C" int pb_patch_stats_sorted(const void* planes, const void* uv,
                                     const void* valid, const void* patch,
                                     const void* feed, void* out,
                                     void* staged, int n, int w, int c, int h,
                                     int wi, int radius, int norm,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = pb::dispatch(radius, norm, [&](auto r, auto m) {
    launch_sorted<decltype(r)::value, decltype(m)::value>(
        planes, uv, valid, patch, feed, out, staged, n, w, c, h, wi, s);
  });
  return bad ? bad : static_cast<int>(cudaGetLastError());
}

extern "C" const char* pb_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
