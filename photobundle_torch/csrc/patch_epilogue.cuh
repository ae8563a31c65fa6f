// Gauss-Newton statistics epilogue shared by the patch kernels
// (csrc/patch_warp.cu, csrc/patch_bicubic.cu, csrc/patch_scaled.cu).
//
// Each kernel samples (value v, d/dx gx, d/dy gy) at the P pixels of one
// observation's patch in its own way and hands this epilogue a `sweep`:
// a callable that, given `emit`, calls emit(k, v, gx, gy) for k = 0..P-1
// in the same order every time, either sampling its window anew (read
// through opaque(), in L1 after the first sweep) or reading a tile of
// samples taken once (K2's and K3's register tiles, K3's tiled design).
// The epilogue sweeps the patch as often as its normalization needs and
// adds one channel's six sums
//   [gx*gx, gx*gy, gy*gy, gx*r, gy*r, r*r]
// to acc. Normalization modes (photobundle_torch/ops/_common.py NORMS), a
// template parameter, so each mode's build carries only its own passes:
//   off:    r = v - d, gradients as sampled;
//   mean:   r = (v - d) - mean(v - d), g = g - mean(g)  (two sweeps);
//   affine: the ZNCC unit norm of photobundle_tpu/core/residuals.py:830-840
//           (the epilogue of the JAX package's K4 and K5 paths):
//             c = v - mean(v), G_c = g - mean(g), n = sqrt(sum c^2 + eps^2),
//             s = c / n, G = (G_c - s (s^T G_c)) / n, r = s - d
//           (three sweeps: means; then sum c^2, sum c*gx_c, sum c*gy_c;
//           then the products). It centres v, not v - d.
// Every sum is taken over centred terms: never the one-pass
// sum(a^2) - P*mean(a)^2 form, which cancels in f32. On smooth patches the
// affine mode amplifies the rounding of the samples (s and G_c are small
// differences of values of order 1), so the kernels are built without
// multiply-add contraction (ops/_build.py) and sample bitwise as their
// plain versions do.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace pb {

enum Norm : int { kNormOff = 0, kNormMean = 1, kNormAffine = 2 };

// AFFINE_NORM_EPS^2 of photobundle_torch/image/patches.py (eps = 1e-4).
constexpr float kAffineEps2 = 1e-8f;

// An opaque copy of p. Every pass reads the window and the descriptor
// through one: the loads are read-only, so without it the compiler proves
// that the passes load the same addresses and keeps a whole window, or
// the whole descriptor, live in registers across them; with it each pass
// re-loads from L1.
template <typename T>
__device__ __forceinline__ const T* opaque(const T* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// An opaque copy of an offset, for the same purpose where the pointer must
// keep its address space (a tile in shared memory plus this offset is
// still read with shared-memory loads).
__device__ __forceinline__ int opaque_int(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// P, the patch pixel count, is a constant in every compile-time-radius
// instance and a run-time value in the runtime-radius ones; 1 / P rounds
// alike either way.
template <int NORM, typename Sweep>
__device__ __forceinline__ void channel_stats(const Sweep& sweep,
                                              const float* __restrict__ d,
                                              int P, float acc[6]) {
  static_assert(NORM == kNormOff || NORM == kNormMean || NORM == kNormAffine,
                "unknown normalization");
  const float inv_p = 1.f / static_cast<float>(P);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f, s5 = 0.f;
  auto add = [&](float gx, float gy, float r) {
    s0 += gx * gx;
    s1 += gx * gy;
    s2 += gy * gy;
    s3 += gx * r;
    s4 += gy * r;
    s5 += r * r;
  };
  if constexpr (NORM == kNormAffine) {
    float ms = 0.f, mx = 0.f, my = 0.f;
    sweep([&](int, float v, float gx, float gy) {
      ms += v;
      mx += gx;
      my += gy;
    });
    ms *= inv_p;
    mx *= inv_p;
    my *= inv_p;
    float scc = 0.f, scx = 0.f, scy = 0.f;
    sweep([&](int, float v, float gx, float gy) {
      const float c = v - ms;
      scc += c * c;
      scx += c * (gx - mx);
      scy += c * (gy - my);
    });
    const float nrm = sqrtf(scc + kAffineEps2);
    const float px = scx / nrm;   // s^T G_c, x and y
    const float py = scy / nrm;
    const float* dp = opaque(d);
    sweep([&](int k, float v, float gx, float gy) {
      const float s = (v - ms) / nrm;
      add(((gx - mx) - s * px) / nrm, ((gy - my) - s * py) / nrm,
          s - __ldg(dp + k));
    });
  } else {
    float mv = 0.f, mx = 0.f, my = 0.f;
    if constexpr (NORM == kNormMean) {
      const float* dp = opaque(d);
      sweep([&](int k, float v, float gx, float gy) {
        mv += v - __ldg(dp + k);
        mx += gx;
        my += gy;
      });
      mv *= inv_p;
      mx *= inv_p;
      my *= inv_p;
    }
    const float* dp = opaque(d);
    sweep([&](int k, float v, float gx, float gy) {
      add(gx - mx, gy - my, (v - __ldg(dp + k)) - mv);
    });
  }
  acc[0] += s0;
  acc[1] += s1;
  acc[2] += s2;
  acc[3] += s3;
  acc[4] += s4;
  acc[5] += s5;
}

// K1's and K2's designs at C > 1 (csrc/patch_warp.cu, csrc/patch_bicubic.cu)
// give each (observation, channel) pair its own thread, which leaves its
// channel's six sums (channel_stats from zero) at
// part + (ch * obs + o) * stride. The thread of observation o adds its C
// partials into 0.f in channel order and stores them at out[k * total +
// idx]: the order of the one-thread designs, whose acc starts at 0.f and
// takes the channels in turn, so the sums are bitwise theirs.
__device__ __forceinline__ void store_channel_sums(const float* part,
                                                   int stride, int obs,
                                                   int o, int c,
                                                   float* __restrict__ out,
                                                   long long total,
                                                   long long idx) {
  float sum[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int ch = 0; ch < c; ++ch) {
    const float* q = part + (ch * obs + o) * stride;
#pragma unroll
    for (int k = 0; k < 6; ++k) sum[k] += q[k];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) out[k * total + idx] = sum[k];
}

// The patch radii with compile-time instances of the solve's kernels (K1
// with its sorted entry, K2, K3): 1..kMaxSolveRadius, the radii the JAX
// package runs its warped grid on (photobundle_torch/ops/_common.py
// WARPED_RADII). K1 and K2 take wider patches, up to the reference's
// fixed-grid limits (FIXED_RADII, BICUBIC_MAX there), through one instance
// per normalization with the radius a run-time argument (template radius
// kRuntimeRadius): rolled loops, the same per-observation arithmetic in
// the same order. The sample store takes K1's radii the same way (its
// layout code in the place of the normalization's); K7 stops at 4.
constexpr int kMaxSolveRadius = 9;
constexpr int kRuntimeRadius = 0;

// From this patch radius on, the patch loops unroll their columns only
// (the rows stay a loop): a full unroll of 19 x 19 samples in up to three
// sweeps inflates the build and the instruction footprint. Unrolling does
// not change the order of the operations, so the sums are the same.
constexpr int kRolledRowRadius = 5;

// Calls launch(r, NORM), each an std::integral_constant, for normalization
// code `norm` (Norm). Returns 0, or cudaErrorInvalidValue for an unknown
// code.
template <typename Radius, typename Launch>
inline int launch_norm(int norm, Launch&& launch, Radius r) {
  switch (norm) {
    case kNormOff:
      launch(r, std::integral_constant<int, kNormOff>{});
      return 0;
    case kNormMean:
      launch(r, std::integral_constant<int, kNormMean>{});
      return 0;
    case kNormAffine:
      launch(r, std::integral_constant<int, kNormAffine>{});
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Host side: calls launch(R, NORM), each an std::integral_constant, for a
// patch radius in 1..kMaxR and a normalization code (Norm). With
// kRuntimeAbove, a radius in kMaxR+1..max_radius launches
// R = kRuntimeRadius (the launch passes the radius on). Returns 0, or
// cudaErrorInvalidValue for a radius or code the kernels do not take
// (nothing is launched then).
template <int kMaxR = 4, bool kRuntimeAbove = false, int R = 1,
          typename Launch>
inline int dispatch(int radius, int norm, Launch&& launch,
                    int max_radius = kMaxR) {
  if constexpr (R > kMaxR) {
    if constexpr (kRuntimeAbove) {
      if (radius > kMaxR && radius <= max_radius) {
        return launch_norm(norm, launch,
                           std::integral_constant<int, kRuntimeRadius>{});
      }
    }
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (radius != R) {
      return dispatch<kMaxR, kRuntimeAbove, R + 1>(radius, norm, launch,
                                                   max_radius);
    }
    return launch_norm(norm, launch, std::integral_constant<int, R>{});
  }
}

}  // namespace pb
