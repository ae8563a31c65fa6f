// Gauss-Newton statistics epilogue shared by the patch kernels
// (csrc/patch_warp.cu, csrc/patch_bicubic.cu, csrc/patch_scaled.cu).
//
// Each kernel samples (value v, d/dx gx, d/dy gy) at the P pixels of one
// observation's patch in its own way and hands this epilogue a `sweep`:
// a callable that, given `emit`, reads its window through opaque() and
// calls emit(k, v, gx, gy) for k = 0..P-1 in the same order every time.
// The epilogue sweeps the patch as often as its normalization needs (the
// window is in L1 after the first sweep) and adds one channel's six sums
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

template <int P, int NORM, typename Sweep>
__device__ __forceinline__ void channel_stats(const Sweep& sweep,
                                              const float* __restrict__ d,
                                              float acc[6]) {
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

// Host side: calls launch(R, NORM), each an std::integral_constant, for a
// patch radius in 1..4 and a normalization code (Norm). Returns 0, or
// cudaErrorInvalidValue for a radius or code the kernels are not
// instantiated for (nothing is launched then).
template <typename Launch>
inline int dispatch(int radius, int norm, Launch&& launch) {
  auto with_norm = [&](auto r) {
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
  };
  switch (radius) {
    case 1:
      return with_norm(std::integral_constant<int, 1>{});
    case 2:
      return with_norm(std::integral_constant<int, 2>{});
    case 3:
      return with_norm(std::integral_constant<int, 3>{});
    case 4:
      return with_norm(std::integral_constant<int, 4>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace pb
