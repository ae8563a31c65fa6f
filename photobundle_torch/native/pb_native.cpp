// Native host runtime for photobundle-tpu: PNG ingestion, stereo block
// matching, and a prefetching frame pipeline.
//
// TPU-native counterpart of the reference's C++ dataset layer
// (pb:src/dataset.cc: cv::imread + cv::StereoBM inside Dataset::getFrame,
// SURVEY.md section 3.5). The reference decodes and block-matches on the
// main thread between solves; this loader runs a small worker pool that
// decodes + matches frames AHEAD of the solver (the pipeline-parallel
// analog of SURVEY.md section 2b: frame t+1 ingestion overlaps the window-t
// TPU solve), exposed to Python through a C API + ctypes.
//
// The block matcher reproduces photobundle_tpu/image/stereo.py
// (block_match) bit-for-bit in semantics: SAD costs with edge-padded box
// filtering, winner-take-all with sub-pixel parabola refinement,
// uniqueness ratio, texture gating, and edge-of-range rejection — tests
// assert C++ vs JAX agreement.

#include <png.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------
// PNG decoding (grayscale float in [0, 1])
// ---------------------------------------------------------------------

// Returns 0 on success. Queries dimensions only.
int pb_png_size(const char* path, int* width, int* height) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 2;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  *width = static_cast<int>(png_get_image_width(png, info));
  *height = static_cast<int>(png_get_image_height(png, info));
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 0;
}

// Decode to float32 grayscale in [0, 1]; `out` must hold width*height.
// Color images are converted with the ITU-R 601 luma (PIL convert("L")).
int pb_png_read_gray(const char* path, float* out, int width, int height) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 2;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  const int w = static_cast<int>(png_get_image_width(png, info));
  const int h = static_cast<int>(png_get_image_height(png, info));
  if (w != width || h != height) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 3;
  }
  const png_byte color = png_get_color_type(png, info);
  const png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);
  const int channels = png_get_channels(png, info);

  std::vector<png_byte> row(png_get_rowbytes(png, info));
  for (int y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* o = out + static_cast<size_t>(y) * w;
    if (channels == 1) {
      for (int x = 0; x < w; ++x) o[x] = row[x] * (1.0f / 255.0f);
    } else {  // RGB: ITU-R 601 luma, rounded like PIL convert("L")
      for (int x = 0; x < w; ++x) {
        const float r = row[x * channels + 0];
        const float g = row[x * channels + 1];
        const float b = row[x * channels + 2];
        const float l = 0.299f * r + 0.587f * g + 0.114f * b;
        o[x] = std::floor(l + 0.5f) * (1.0f / 255.0f);
      }
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 0;
}

// ---------------------------------------------------------------------
// Stereo block matching (semantics of image/stereo.py::block_match)
// ---------------------------------------------------------------------

namespace {

// Edge-padded box sum over (2r+1)^2 windows of src (h, w) into dst.
void box_filter(const float* src, float* dst, int h, int w, int r,
                std::vector<float>& tmp) {
  // Horizontal pass with edge padding.
  tmp.resize(static_cast<size_t>(h) * w);
  for (int y = 0; y < h; ++y) {
    const float* s = src + static_cast<size_t>(y) * w;
    float* t = tmp.data() + static_cast<size_t>(y) * w;
    double run = 0.0;
    for (int k = -r; k <= r; ++k) run += s[std::clamp(k, 0, w - 1)];
    t[0] = static_cast<float>(run);
    for (int x = 1; x < w; ++x) {
      run += s[std::clamp(x + r, 0, w - 1)] - s[std::clamp(x - r - 1, 0, w - 1)];
      t[x] = static_cast<float>(run);
    }
  }
  // Vertical pass with edge padding.
  for (int x = 0; x < w; ++x) {
    double run = 0.0;
    for (int k = -r; k <= r; ++k)
      run += tmp[static_cast<size_t>(std::clamp(k, 0, h - 1)) * w + x];
    dst[x] = static_cast<float>(run);
    for (int y = 1; y < h; ++y) {
      run += tmp[static_cast<size_t>(std::clamp(y + r, 0, h - 1)) * w + x] -
             tmp[static_cast<size_t>(std::clamp(y - r - 1, 0, h - 1)) * w + x];
      dst[static_cast<size_t>(y) * w + x] = static_cast<float>(run);
    }
  }
}

}  // namespace

namespace {

// Left-right consistency (stereo.py::_lr_consistency): the right image's
// best disparity index from the same cost volume. Plane d at left column
// xl scores the pair (xl, xl - d - min_disp), so costR[d][xR] =
// costL[d][xR + d + min_disp] (out-of-range -> inf). stride_d = distance
// between consecutive disparity planes for a fixed pixel.
void right_best(const float* cost, int y, int w, int D, int min_disp,
                size_t plane, size_t stride_d, bool pixel_major,
                std::vector<int>& out) {
  const float inf = std::numeric_limits<float>::infinity();
  out.resize(w);
  for (int xr = 0; xr < w; ++xr) {
    int best = 0;
    float cmin = inf;
    for (int d = 0; d < D; ++d) {
      const int xl = xr + d + min_disp;
      if (xl >= w) break;
      const size_t px = static_cast<size_t>(y) * w + xl;
      const float c = pixel_major ? cost[px * stride_d + d]
                                  : cost[static_cast<size_t>(d) * plane + px];
      if (c < cmin) {
        cmin = c;
        best = d;
      }
    }
    out[xr] = best;
  }
}

}  // namespace

// cv::StereoBM PREFILTER_XSOBEL analog — matches
// image/stereo.py::prefilter_xsobel (same 3x3 kernel, edge-clamped
// padding, clamp to [-cap, cap]).
int pb_prefilter_xsobel(const float* src, float* dst, int h, int w,
                        float cap) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int y = 0; y < h; ++y) {
    const int ym = std::max(y - 1, 0), yp = std::min(y + 1, h - 1);
    const float* r0 = src + static_cast<size_t>(ym) * w;
    const float* r1 = src + static_cast<size_t>(y) * w;
    const float* r2 = src + static_cast<size_t>(yp) * w;
    float* d = dst + static_cast<size_t>(y) * w;
    for (int x = 0; x < w; ++x) {
      const int xm = std::max(x - 1, 0), xp = std::min(x + 1, w - 1);
      const float gx = (r0[xp] + 2.0f * r1[xp] + r2[xp]) -
                       (r0[xm] + 2.0f * r1[xm] + r2[xm]);
      d[x] = std::clamp(gx, -cap, cap);
    }
  }
  return 0;
}

// disparity/valid: (h, w) outputs. Matches stereo.py block_match.
int pb_block_match(const float* left, const float* right, int h, int w,
                   int num_disparities, int min_disparity, int sad_radius,
                   float uniqueness_ratio, float texture_threshold,
                   float* disparity, uint8_t* valid) {
  const int D = num_disparities;
  const size_t plane = static_cast<size_t>(h) * w;
  const float inf = std::numeric_limits<float>::infinity();
  std::vector<float> cost(static_cast<size_t>(D) * plane);

  // Cost volume, parallel over disparity planes.
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    std::vector<float> ad(plane), tmp;
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
    for (int di = 0; di < D; ++di) {
      const int d = min_disparity + di;
      for (int y = 0; y < h; ++y) {
        const float* L = left + static_cast<size_t>(y) * w;
        const float* R = right + static_cast<size_t>(y) * w;
        float* a = ad.data() + static_cast<size_t>(y) * w;
        for (int x = 0; x < w; ++x) {
          // roll(right, d) wraps; wrapped columns are masked below and
          // never reach an unmasked box sum (see stereo.py).
          const int xr = x - d >= 0 ? x - d : x - d + w;
          a[x] = std::fabs(L[x] - R[xr]);
        }
      }
      float* c = cost.data() + static_cast<size_t>(di) * plane;
      box_filter(ad.data(), c, h, w, sad_radius, tmp);
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < d + sad_radius && x < w; ++x)
          c[static_cast<size_t>(y) * w + x] = inf;
    }
  }

  // Texture gate from the left image statistics.
  std::vector<float> lsum(plane), l2sum(plane);
  {
    std::vector<float> sq(plane), tmp;
    for (size_t i = 0; i < plane; ++i) sq[i] = left[i] * left[i];
    box_filter(left, lsum.data(), h, w, sad_radius, tmp);
    box_filter(sq.data(), l2sum.data(), h, w, sad_radius, tmp);
  }
  const float n_px = static_cast<float>((2 * sad_radius + 1) * (2 * sad_radius + 1));

  // Winner-take-all + sub-pixel + gates, parallel over rows.
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    std::vector<int> rbest;
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
  for (int y = 0; y < h; ++y) {
    right_best(cost.data(), y, w, D, min_disparity, plane, 0, false, rbest);
    for (int x = 0; x < w; ++x) {
      const size_t px = static_cast<size_t>(y) * w + x;
      int best = 0;
      float cmin = cost[px];
      for (int di = 1; di < D; ++di) {
        const float c = cost[static_cast<size_t>(di) * plane + px];
        if (c < cmin) {
          cmin = c;
          best = di;
        }
      }
      // Runner-up excluding |d - best| <= 1.
      float second = inf;
      for (int di = 0; di < D; ++di) {
        if (std::abs(di - best) <= 1) continue;
        second = std::min(second, cost[static_cast<size_t>(di) * plane + px]);
      }
      const int d0 = std::clamp(best, 1, D - 2);
      const float cm = cost[static_cast<size_t>(d0 - 1) * plane + px];
      const float c0 = cost[static_cast<size_t>(d0) * plane + px];
      const float cp = cost[static_cast<size_t>(d0 + 1) * plane + px];
      float delta = 0.0f;
      if (std::isfinite(cm) && std::isfinite(c0) && std::isfinite(cp)) {
        const float denom = cm - 2.0f * c0 + cp;
        if (std::fabs(denom) > 1e-9f)
          delta = std::clamp(0.5f * (cm - cp) / denom, -0.5f, 0.5f);
      }
      float disp = static_cast<float>(best + min_disparity);
      if (best == d0) disp += delta;

      const bool unique = cmin <= uniqueness_ratio * second;
      const float mean = lsum[px] / n_px;
      const float var = l2sum[px] / n_px - mean * mean;
      const bool textured = std::sqrt(std::max(var, 0.0f)) > texture_threshold;
      const bool at_edge = best == 0 || best == D - 1;
      const int xr = std::clamp(x - (best + min_disparity), 0, w - 1);
      const bool consistent = std::abs(rbest[xr] - best) <= 1;
      const bool ok = std::isfinite(cmin) && unique && textured && !at_edge
                      && consistent;
      disparity[px] = ok ? disp : 0.0f;
      valid[px] = ok ? 1 : 0;
    }
  }
  }
  return 0;
}

// Semi-global matching — mirrors image/stereo.py::semi_global_match
// (4 scanline paths, Hirschmueller P1/P2, finite cost sentinel).
int pb_sgbm(const float* left, const float* right, int h, int w,
            int num_disparities, int min_disparity, int sad_radius,
            float p1, float p2, float uniqueness_ratio,
            float texture_threshold, float* disparity, uint8_t* valid) {
  const int D = num_disparities;
  const size_t plane = static_cast<size_t>(h) * w;
  const float big = 1e4f;
  // Pixel-major cost layout (plane, D): the aggregation inner loop runs
  // over D, so contiguity along D is what matters.
  std::vector<float> cost(plane * D);

#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    std::vector<float> ad(plane), boxed(plane), tmp;
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
    for (int di = 0; di < D; ++di) {
      const int d = min_disparity + di;
      for (int y = 0; y < h; ++y) {
        const float* L = left + static_cast<size_t>(y) * w;
        const float* R = right + static_cast<size_t>(y) * w;
        float* a = ad.data() + static_cast<size_t>(y) * w;
        for (int x = 0; x < w; ++x) {
          const int xr = x - d >= 0 ? x - d : x - d + w;
          a[x] = std::fabs(L[x] - R[xr]);
        }
      }
      box_filter(ad.data(), boxed.data(), h, w, sad_radius, tmp);
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          const size_t px = static_cast<size_t>(y) * w + x;
          cost[px * D + di] = x >= d + sad_radius ? boxed[px] : big;
        }
    }
  }

  std::vector<float> agg(plane * D, 0.0f);
  // One path: walk pixels px0, px0+step, ... (npix steps) accumulating DP.
  auto run_path = [&](size_t px0, long step, int npix) {
    std::vector<float> prev(D), cur(D);
    size_t px = px0;
    for (int k = 0; k < npix; ++k, px += step) {
      const float* c = cost.data() + px * D;
      float* s = agg.data() + px * D;
      if (k == 0) {
        for (int d = 0; d < D; ++d) {
          cur[d] = c[d];
          s[d] += cur[d];
        }
      } else {
        float pmin = prev[0];
        for (int d = 1; d < D; ++d) pmin = std::min(pmin, prev[d]);
        for (int d = 0; d < D; ++d) {
          float best = std::min(prev[d], pmin + p2);
          if (d > 0) best = std::min(best, prev[d - 1] + p1);
          if (d + 1 < D) best = std::min(best, prev[d + 1] + p1);
          cur[d] = c[d] + best - pmin;
          s[d] += cur[d];
        }
      }
      std::swap(prev, cur);
    }
  };

#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int y = 0; y < h; ++y) {
    run_path(static_cast<size_t>(y) * w, 1, w);                    // ->
    run_path(static_cast<size_t>(y) * w + (w - 1), -1, w);         // <-
  }
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int x = 0; x < w; ++x) {
    run_path(static_cast<size_t>(x), w, h);                        // v
    run_path(static_cast<size_t>(h - 1) * w + x, -static_cast<long>(w), h);
  }

  // Texture gate (same statistics as BM).
  std::vector<float> lsum(plane), l2sum(plane);
  {
    std::vector<float> sq(plane), tmp;
    for (size_t i = 0; i < plane; ++i) sq[i] = left[i] * left[i];
    box_filter(left, lsum.data(), h, w, sad_radius, tmp);
    box_filter(sq.data(), l2sum.data(), h, w, sad_radius, tmp);
  }
  const float n_px =
      static_cast<float>((2 * sad_radius + 1) * (2 * sad_radius + 1));
  const float inf = std::numeric_limits<float>::infinity();

#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    std::vector<int> rbest;
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
  for (int y = 0; y < h; ++y) {
    right_best(agg.data(), y, w, D, min_disparity, plane, D, true, rbest);
    for (int x = 0; x < w; ++x) {
      const size_t px = static_cast<size_t>(y) * w + x;
      const float* s = agg.data() + px * D;
      int best = 0;
      float cmin = s[0];
      for (int d = 1; d < D; ++d)
        if (s[d] < cmin) {
          cmin = s[d];
          best = d;
        }
      float second = inf;
      for (int d = 0; d < D; ++d) {
        if (std::abs(d - best) <= 1) continue;
        second = std::min(second, s[d]);
      }
      const int d0 = std::clamp(best, 1, D - 2);
      const float cm = s[d0 - 1];
      const float c0 = s[d0];
      const float cp = s[d0 + 1];
      float delta = 0.0f;
      const float denom = cm - 2.0f * c0 + cp;
      if (std::fabs(denom) > 1e-9f)
        delta = std::clamp(0.5f * (cm - cp) / denom, -0.5f, 0.5f);
      float disp = static_cast<float>(best + min_disparity);
      if (best == d0) disp += delta;

      const bool unique = cmin <= uniqueness_ratio * second;
      const float mean = lsum[px] / n_px;
      const float var = l2sum[px] / n_px - mean * mean;
      const bool textured = std::sqrt(std::max(var, 0.0f)) > texture_threshold;
      const bool at_edge = best == 0 || best == D - 1;
      const bool has_match = cost[px * D + best] < 1e3f;
      const int xr = std::clamp(x - (best + min_disparity), 0, w - 1);
      const bool consistent = std::abs(rbest[xr] - best) <= 1;
      const bool ok = has_match && unique && textured && !at_edge
                      && consistent;
      disparity[px] = ok ? disp : 0.0f;
      valid[px] = ok ? 1 : 0;
    }
  }
  }
  return 0;
}

// Speckle filter (cv::filterSpeckles semantics): 4-connected components
// of similar disparity smaller than min_region pixels are invalidated.
// Small isolated patches are the signature of matching outliers (e.g.
// cost-volume aliasing) that survive per-pixel gates.
int pb_speckle_filter(float* disp, uint8_t* valid, int h, int w,
                      float max_diff, int min_region) {
  const size_t plane = static_cast<size_t>(h) * w;
  std::vector<int32_t> label(plane, -1);
  std::vector<size_t> stack;
  std::vector<size_t> members;
  int32_t cur = 0;
  for (size_t seed = 0; seed < plane; ++seed) {
    if (!valid[seed] || label[seed] >= 0) continue;
    stack.clear();
    members.clear();
    stack.push_back(seed);
    label[seed] = cur;
    while (!stack.empty()) {
      const size_t p = stack.back();
      stack.pop_back();
      members.push_back(p);
      const int y = static_cast<int>(p / w);
      const int x = static_cast<int>(p % w);
      const float dp = disp[p];
      const int ny[4] = {y - 1, y + 1, y, y};
      const int nx[4] = {x, x, x - 1, x + 1};
      for (int k = 0; k < 4; ++k) {
        if (ny[k] < 0 || ny[k] >= h || nx[k] < 0 || nx[k] >= w) continue;
        const size_t q = static_cast<size_t>(ny[k]) * w + nx[k];
        if (!valid[q] || label[q] >= 0) continue;
        if (std::fabs(disp[q] - dp) > max_diff) continue;
        label[q] = cur;
        stack.push_back(q);
      }
    }
    if (static_cast<int>(members.size()) < min_region) {
      for (size_t p : members) {
        valid[p] = 0;
        disp[p] = 0.0f;
      }
    }
    ++cur;
  }
  return 0;
}

// ---------------------------------------------------------------------
// Prefetching frame loader
// ---------------------------------------------------------------------

namespace {

struct Frame {
  std::vector<float> image;
  std::vector<float> depth;
  std::vector<uint8_t> depth_ok;
  int status = 0;
};

struct Loader {
  std::vector<std::string> left, right;
  int h = 0, w = 0;
  int num_disp, min_disp, sad_radius;
  int algorithm = 0;  // 0 = BM, 1 = SGBM
  float uniq, texture;
  int speckle_size = 0;
  float speckle_range = 1.0f;
  float prefilter_cap = 0.0f;
  float fx, baseline, min_depth, max_depth;
  int ahead;

  std::mutex mu;
  std::condition_variable cv;
  std::map<int, Frame> ready;
  std::atomic<int> next_to_produce{0};
  int consumer_at = 0;
  bool stop = false;
  std::vector<std::thread> workers;

  void work() {
    for (;;) {
      int idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] {
          return stop || (next_to_produce.load() <
                              static_cast<int>(left.size()) &&
                          next_to_produce.load() < consumer_at + ahead);
        });
        if (stop) return;
        idx = next_to_produce.fetch_add(1);
        if (idx >= static_cast<int>(left.size())) return;
      }
      Frame f = produce(idx);
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.emplace(idx, std::move(f));
      }
      cv.notify_all();
    }
  }

  Frame produce(int idx) {
    Frame f;
    const size_t plane = static_cast<size_t>(h) * w;
    f.image.resize(plane);
    f.status = pb_png_read_gray(left[idx].c_str(), f.image.data(), w, h);
    if (f.status) return f;
    std::vector<float> rimg(plane);
    f.status = pb_png_read_gray(right[idx].c_str(), rimg.data(), w, h);
    if (f.status) return f;
    std::vector<float> disp(plane);
    std::vector<uint8_t> dvalid(plane);
    // The matcher sees the (optionally prefiltered) pair; the engine
    // always gets the raw image in f.image.
    const float* ml = f.image.data();
    const float* mr = rimg.data();
    std::vector<float> lfil, rfil;
    if (prefilter_cap > 0.0f) {
      lfil.resize(plane);
      rfil.resize(plane);
      pb_prefilter_xsobel(f.image.data(), lfil.data(), h, w, prefilter_cap);
      pb_prefilter_xsobel(rimg.data(), rfil.data(), h, w, prefilter_cap);
      ml = lfil.data();
      mr = rfil.data();
    }
    if (algorithm == 1) {
      pb_sgbm(ml, mr, h, w, num_disp, min_disp,
              sad_radius, 0.03f, 0.4f, uniq, texture, disp.data(),
              dvalid.data());
    } else {
      pb_block_match(ml, mr, h, w, num_disp, min_disp,
                     sad_radius, uniq, texture, disp.data(), dvalid.data());
    }
    if (speckle_size > 0)
      pb_speckle_filter(disp.data(), dvalid.data(), h, w, speckle_range,
                        speckle_size);
    f.depth.resize(plane);
    f.depth_ok.resize(plane);
    const float fb = fx * baseline;
    for (size_t i = 0; i < plane; ++i) {
      const float z = dvalid[i] && disp[i] > 0.0f
                          ? fb / std::max(disp[i], 1e-6f)
                          : 0.0f;
      const bool ok = dvalid[i] && z > min_depth && z < max_depth;
      f.depth[i] = z;
      f.depth_ok[i] = ok ? 1 : 0;
    }
    return f;
  }
};

}  // namespace

void* pb_loader_create(const char** left_paths, const char** right_paths,
                       int n_frames, int h, int w, int num_disp, int min_disp,
                       int sad_radius, int algorithm, float uniqueness_ratio,
                       float texture_threshold, int speckle_size,
                       float speckle_range, float prefilter_cap, float fx,
                       float baseline, float min_depth, float max_depth,
                       int n_threads, int prefetch_ahead) {
  auto* L = new Loader();
  L->left.assign(left_paths, left_paths + n_frames);
  L->right.assign(right_paths, right_paths + n_frames);
  L->h = h;
  L->w = w;
  L->num_disp = num_disp;
  L->min_disp = min_disp;
  L->sad_radius = sad_radius;
  L->algorithm = algorithm;
  L->uniq = uniqueness_ratio;
  L->speckle_size = speckle_size;
  L->speckle_range = speckle_range;
  L->prefilter_cap = prefilter_cap;
  L->texture = texture_threshold;
  L->fx = fx;
  L->baseline = baseline;
  L->min_depth = min_depth;
  L->max_depth = max_depth;
  L->ahead = std::max(prefetch_ahead, 1);
  for (int t = 0; t < std::max(n_threads, 1); ++t)
    L->workers.emplace_back([L] { L->work(); });
  return L;
}

// Jump the pipeline to frame i (resume mid-sequence): frames before i are
// neither produced nor retained. Racing workers may still finish a few
// in-flight earlier frames; pb_loader_get drops them.
void pb_loader_seek(void* handle, int i) {
  auto* L = static_cast<Loader*>(handle);
  std::lock_guard<std::mutex> lk(L->mu);
  int cur = L->next_to_produce.load();
  while (cur < i && !L->next_to_produce.compare_exchange_weak(cur, i)) {
  }
  L->consumer_at = std::max(L->consumer_at, i);
  L->cv.notify_all();
}

// Blocks until frame i is ready; copies into caller buffers. Returns the
// frame's status (0 = ok).
int pb_loader_get(void* handle, int i, float* image, float* depth,
                  uint8_t* depth_ok) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  L->consumer_at = std::max(L->consumer_at, i);
  // Consumption is monotone: frames before i will never be fetched — drop
  // any that finished out of order so a resumed run cannot accumulate them.
  L->ready.erase(L->ready.begin(), L->ready.lower_bound(i));
  L->cv.notify_all();
  L->cv.wait(lk, [&] { return L->ready.count(i) > 0; });
  Frame& f = L->ready[i];
  const int status = f.status;
  if (status == 0) {
    std::memcpy(image, f.image.data(), f.image.size() * sizeof(float));
    std::memcpy(depth, f.depth.data(), f.depth.size() * sizeof(float));
    std::memcpy(depth_ok, f.depth_ok.data(), f.depth_ok.size());
  }
  L->ready.erase(i);
  return status;
}

void pb_loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

int pb_omp_max_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
