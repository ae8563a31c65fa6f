// Staging a block's patch windows in shared memory, shared by the kernels
// that sample a (2R+2)^2 window of float4 texels per observation from a
// block's tile: K1 (csrc/patch_warp.cu) and its ablation K8
// (csrc/patch_ablate.cu), which must copy exactly as K1 does.
//
// A block of OBS observations copies its windows, one channel at a time,
// with 16-byte cp.async.cg copies (L2 only: the reuse lives in shared
// memory). A linear index runs over (observation, window row, column),
// column fastest, so consecutive threads copy consecutive texels of one
// window row (96 contiguous bytes at R = 2) and a warp-wide copy touches a
// handful of lines. Each window's stride in the tile is odd in float4 (37
// at R = 2), so the eight threads of a 128-bit shared-load phase that read
// the same cell of eight windows hit distinct banks. A kernel may keep two
// channel buffers (channel c+1 in flight while channel c is read) where
// they fit a block's shared memory.
#pragma once

#include <cuda_runtime.h>

namespace pb {

// Radii whose windows are staged (K1's measured crossover, PERF.md): from
// R = 4 the windows of 64 observations take 103 KB or more per channel,
// and each thread gathering its own window through the read-only path
// overlaps loads with sums across more warps.
constexpr int kMaxStagedRadius = 3;
constexpr int kMaxSharedBytes = 232448;  // what a block may opt into (227 KB)
constexpr int kStaticReserve = 1024;     // static shared memory of a block

// The staging plan of radius R for a block of OBS observations: each
// window is kTex float4 texels (kWin x kWin) at an odd stride kStride in
// the tile; kBuffers channel buffers (two where they fit), kMaxBytes at
// most. Radii above kMaxStagedRadius stage nothing.
template <int R, int OBS>
struct Plan {
  static constexpr bool kStaged = R >= 1 && R <= kMaxStagedRadius;
  static constexpr int kWin = 2 * R + 2;
  static constexpr int kTex = kWin * kWin;
  static constexpr int kStride = kTex | 1;
  static constexpr int kBuffer = kStride * 16;   // bytes per observation
  static constexpr int kObs = OBS;
  static constexpr int kBuffers =
      2 * OBS * kBuffer + kStaticReserve <= kMaxSharedBytes ? 2 : 1;
  static constexpr int kMaxBytes = kStaged ? kBuffers * OBS * kBuffer : 0;
  static_assert(!kStaged || kMaxBytes + kStaticReserve <= kMaxSharedBytes,
                "a channel buffer must fit a block's shared memory");
  // Dynamic shared bytes for C channels (one buffer for C = 1).
  static int bytes(int c) {
    return kStaged ? (c > 1 ? kBuffers : 1) * OBS * kBuffer : 0;
  }
};

__device__ __forceinline__ void cp_async16(float4* smem,
                                           const float4* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copies of one channel of the block's windows into `buf`, the
// THREADS threads of the block together: observation o's window (origin
// base[o] + chan_off texels, rows `wi` apart) to buf[o * kStride ...];
// base[o] < 0 marks an observation with nothing to copy.
template <int R, int OBS, int THREADS>
__device__ __forceinline__ void stage_channel(
    float4* buf, const float4* __restrict__ planes, const long long* base,
    long long chan_off, int wi) {
  using PL = Plan<R, OBS>;
  for (int i = threadIdx.x; i < PL::kObs * PL::kTex; i += THREADS) {
    const int o = i / PL::kTex;
    const int t = i - o * PL::kTex;
    const int row = t / PL::kWin;
    const long long b = base[o];
    if (b >= 0) {
      cp_async16(buf + o * PL::kStride + t,
                 planes + b + chan_off + static_cast<long long>(row) * wi +
                     (t - row * PL::kWin));
    }
  }
}

// stage_channel for a group of THREADS threads of a block, this one of
// rank `rank` in it (0..THREADS-1; K1 at C > 1 stages each warp's
// windows by its own lanes): observation o's window (origin base[o]) to
// buf[o * kStride ...], base[o] < 0 copying nothing.
template <int R, int OBS, int THREADS>
__device__ __forceinline__ void stage_windows(
    float4* buf, const float4* __restrict__ planes, const long long* base,
    int wi, int rank) {
  using PL = Plan<R, OBS>;
  for (int i = rank; i < PL::kObs * PL::kTex; i += THREADS) {
    const int o = i / PL::kTex;
    const int t = i - o * PL::kTex;
    const int row = t / PL::kWin;
    const long long b = base[o];
    if (b >= 0) {
      cp_async16(buf + o * PL::kStride + t,
                 planes + b + static_cast<long long>(row) * wi +
                     (t - row * PL::kWin));
    }
  }
}

}  // namespace pb
