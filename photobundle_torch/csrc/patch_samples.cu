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
// uv (N, W) float2; valid (N, W) bytes.
//
// What bounds it on this card: at the solver's window (4096 points x 5
// frames, R = 2, ~20k valid observations) it reads K1's distinct window
// texels (~8.5 MB, from HBM, or from L2 where a solve's planes stay there
// between evaluations) and writes 75 floats per observation (rows, block:
// ~6 MB) or 108 (raw: ~9 MB): a few microseconds of HBM bandwidth. One thread per observation with every patch loop unrolled
// keeps the loads of a patch in flight together; each thread's stores are
// its own contiguous tile, so a warp's stores are strided by the tile
// (75 or 108 floats). That is accepted here: a staged, coalesced store
// through shared memory is a later design.

#include <cuda_runtime.h>

#include "patch_bilinear.cuh"

namespace {

constexpr int kThreads = 128;

enum Layout : int { kRows = 0, kBlock = 1, kRaw = 2 };

template <int R, int LAYOUT>
__global__ void __launch_bounds__(kThreads)
warp_samples_kernel(const float4* __restrict__ planes,
                    const float2* __restrict__ uv,
                    const unsigned char* __restrict__ valid,
                    float* __restrict__ out, int n, int w, int c, int h,
                    int wi) {
  constexpr int PS = 2 * R + 1;
  constexpr int WIN = PS + 1;
  constexpr int ROWS = LAYOUT == kRaw ? WIN : PS;   // tile rows and columns
  constexpr int LANES = 3 * ROWS;                    // (column, plane)
  const long long m = static_cast<long long>(n) * w;
  const long long o =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= m) return;
  const int f = static_cast<int>(o / n);
  const int p = static_cast<int>(o - static_cast<long long>(f) * n);
  const long long obs = static_cast<long long>(p) * w + f;
  const bool ok = valid[obs];

  int x0 = 0, y0 = 0;
  pb::Weights wt = {0.f, 0.f, 0.f, 0.f};
  if (ok) pb::window_at<R>(uv[obs], h, wi, &x0, &y0, &wt);
  const long long chan = static_cast<long long>(h) * wi;
  for (int ch = 0; ch < c; ++ch) {
    const float4* win = planes + (static_cast<long long>(f) * c + ch) * chan +
                        static_cast<long long>(y0) * wi + x0;
#pragma unroll
    for (int ky = 0; ky < ROWS; ++ky) {
      float* dst;
      if constexpr (LAYOUT == kRows) {
        dst = out + ((static_cast<long long>(ch) * PS + ky) * m + o) * LANES;
      } else {
        dst = out + ((static_cast<long long>(ch) * m + o) * ROWS + ky) * LANES;
      }
#pragma unroll
      for (int kx = 0; kx < ROWS; ++kx) {
        float3 s = make_float3(0.f, 0.f, 0.f);
        if (ok) {
          if constexpr (LAYOUT == kRaw) {
            const float4 t = __ldg(win + static_cast<long long>(ky) * wi + kx);
            s = make_float3(t.x, t.y, t.z);
          } else {
            s = pb::sample(win, wi, ky, kx, wt, pb::LoadGlobal{});
          }
        }
        dst[3 * kx] = s.x;
        dst[3 * kx + 1] = s.y;
        dst[3 * kx + 2] = s.z;
      }
    }
  }
}

template <int R, int LAYOUT>
void launch(const void* planes, const void* uv, const void* valid, void* out,
            int n, int w, int c, int h, int wi, cudaStream_t stream) {
  const long long m = static_cast<long long>(n) * w;
  const unsigned blocks = static_cast<unsigned>((m + kThreads - 1) / kThreads);
  warp_samples_kernel<R, LAYOUT><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float4*>(planes), static_cast<const float2*>(uv),
      static_cast<const unsigned char*>(valid), static_cast<float*>(out), n, w,
      c, h, wi);
}

template <int R>
int launch_layout(int layout, const void* planes, const void* uv,
                  const void* valid, void* out, int n, int w, int c, int h,
                  int wi, cudaStream_t stream) {
  switch (layout) {
    case kRows:
      launch<R, kRows>(planes, uv, valid, out, n, w, c, h, wi, stream);
      return 0;
    case kBlock:
      launch<R, kBlock>(planes, uv, valid, out, n, w, c, h, wi, stream);
      return 0;
    case kRaw:
      launch<R, kRaw>(planes, uv, valid, out, n, w, c, h, wi, stream);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// layout: 0 rows, 1 block, 2 raw; radius 1..4. Returns 0 or a CUDA error
// code (cudaErrorInvalidValue, with nothing launched, for a radius or
// layout the kernel is not instantiated for).
extern "C" int pb_warp_samples(const void* planes, const void* uv,
                               const void* valid, void* out, int n, int w,
                               int c, int h, int wi, int radius, int layout,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int bad;
  switch (radius) {
    case 1:
      bad = launch_layout<1>(layout, planes, uv, valid, out, n, w, c, h, wi, s);
      break;
    case 2:
      bad = launch_layout<2>(layout, planes, uv, valid, out, n, w, c, h, wi, s);
      break;
    case 3:
      bad = launch_layout<3>(layout, planes, uv, valid, out, n, w, c, h, wi, s);
      break;
    case 4:
      bad = launch_layout<4>(layout, planes, uv, valid, out, n, w, c, h, wi, s);
      break;
    default:
      bad = static_cast<int>(cudaErrorInvalidValue);
  }
  return bad ? bad : static_cast<int>(cudaGetLastError());
}

extern "C" const char* pb_samples_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
