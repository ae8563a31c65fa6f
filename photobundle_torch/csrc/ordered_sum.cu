// Sums and dot products along the last axis in an order fixed by their
// length alone: the reductions of the LM body (core/schur.py,
// core/residuals.py, core/lm.py), ops/ordered_sum.py.
//
//   out[g, h, p, q] = sum_k a[g, h, p, k] * c[g, h, q, k]   (c given)
//   out[g, h, p]    = sum_k a[g, h, p, k]                   (c null)
//
// Replaces no TPU kernel: the JAX package leaves these sums to XLA
// (photobundle_tpu/core/schur.py:134 and :246, the einsums and sums of
// the normal equations and the Schur terms), which vmap batches. It was
// added so that a batched window solve rounds each window as its own solve
// does: torch's own reductions choose their thread and block split, and
// cuBLAS its kernel, by the number of outputs, i.e. by the batch, so window
// b of a batch of 4 can come out an ulp from the same window alone. Here
// the order of every output's sum depends on k alone:
//
//   k <= kThreadRow: k = 0, 1, ... in turn (one thread per output);
//   k >  kThreadRow: the terms cut into chunks of kChunk (the last one
//     shorter). Within a chunk, lane s of 32 sums the terms s, s + 32,
//     s + 64, ... in turn, from 0; the 32 lane sums are added as a tree
//     (lane l with lane l + 16 first, then 8, 4, 2, 1 apart: a warp's xor
//     butterfly). The chunk sums are then added in chunk order,
//     ((p0 + p1) + p2) + ...
//
// What bounds it on this card: the bytes of its operands where outputs
// are few (a cost, a norm: one output of 3N to W N terms), the f32
// multiplies and adds where they are many (s_off, sum_n Hpc W_p Hpc^T:
// (6W)^2 outputs of 3N terms; 3.6e9 products at 32 768 points x 32 poses,
// built with -fmad=false, so a multiply and an add each). The first design
// ran one block per output and read both of an output's rows whole, so
// s_off read its operands (6W) times over (29 GB at 32 768 x 32), and an
// output of 10^5 terms ran on one SM. This design:
//
//   - A block computes a tile of outputs: warps of 8 x 8 outputs (8 x 1
//     for one column of c; 2 x 4 where a (g, h) is at most 8 x 8, one
//     output each where it has at most kSmallTile in a row or a column),
//     up to 8 warps; every lane holds its warp's outputs' lane sums in
//     registers, so the terms of an output come in the lane order above.
//   - The block stages its rows of a and c in shared memory through
//     cp.async (16-byte copies where the rows are contiguous and aligned,
//     element copies through the strides otherwise; zeros past k and past
//     the rows), kStages deep, each stage ~kStageBytes (64 to kChunk
//     terms: a whole chunk of one row): each operand is read once per
//     tile, not once per output. Every block has 8 warps, those past the
//     tile's only staging: a warp keeps only ~8 KB of copies in flight a
//     microsecond, so a one-warp tile staged by its own warp waited ~4 us
//     for its first chunk.
//   - At each chunk's end the warp adds its lanes as the tree above and
//     scatters the sums over its lanes (after the step 16 apart a lane
//     keeps half of its outputs, ...): 62 shuffles for 64 outputs in
//     place of 320, the same additions as the butterfly.
//   - Where tiles are few, the chunks of a tile are split over blocks
//     (kTargetBlocks blocks in all): each writes its chunk sums to the
//     wrapper's scratch, and the last block of the tile to arrive (an
//     integer counter per tile, set back to 0 by that block) adds them in
//     chunk order (loaded by all its threads into shared memory first,
//     where they fit). Where a block holds every chunk of its tile, it adds
//     them in registers, the same additions. No float atomics: the result
//     does not depend on which block ends last.
//
// No tensor cores: f32 operands would run as TF32. Sums are taken in the
// operands' type (f32 or f64), as the JAX package's XLA reductions take
// them; each product and each sum rounds once. Operands are read through
// their strides (elements, two leading axes: the batch and one more), so a
// transposed or broadcast view needs no copy.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreadRow = 64;   // longest row summed by one thread
constexpr int kRowsPerBlock = 256;
constexpr int kChunk = 1024;     // terms of a chunk (the order's unit)
constexpr int kMinStage = 64;    // terms staged at a time: 64 ..
constexpr int kStageBytes = 24 << 10;  // .. kChunk, ~this many bytes
constexpr int kStages = 3;       // depth of the cp.async ring
constexpr int kMaxWarps = 8;
constexpr int kTargetBlocks = 1024;
constexpr int kMaxTiles = 1024;  // tiles whose chunks may be split
constexpr int kSmallTile = 64;   // outputs of a (g, h) given a warp each
static_assert(kChunk % kMinStage == 0 && kMinStage % 32 == 0,
              "chunk layout");

// Arrivals per split tile; each count is set back to 0 by the block that
// completes it, so a launch finds them all 0 (launches on one stream).
__device__ unsigned int g_arrivals[kMaxTiles] = {};

template <typename T>
struct Operand {
  const T* ptr;
  long long sg, sh, sp, sk;      // strides in elements
};

// The row offsets of output o = ((g * h + hi) * p + pi) * q + qi.
struct Rows {
  long long a, c;
};

template <typename T>
__device__ __forceinline__ Rows rows(const Operand<T>& a, const Operand<T>& c,
                                     long long o, int h, int p, int q) {
  const int qi = static_cast<int>(o % q);
  const long long r = o / q;
  const int pi = static_cast<int>(r % p);
  const long long gh = r / p;
  const long long gi = gh / h, hi = gh % h;
  return {gi * a.sg + hi * a.sh + pi * a.sp,
          c.ptr ? gi * c.sg + hi * c.sh + qi * c.sp : 0};
}

template <typename T>
__device__ __forceinline__ T term(const Operand<T>& a, const Operand<T>& c,
                                  long long ga, long long gc, int k) {
  const T x = a.ptr[ga + k * a.sk];
  return c.ptr ? x * c.ptr[gc + k * c.sk] : x;
}

// One thread per output, its row in order (k <= kThreadRow).
template <typename T>
__global__ void row_dot_thread(Operand<T> a, Operand<T> c, T* out,
                               long long n, int h, int p, int q, int k) {
  for (long long o = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       o < n; o += static_cast<long long>(gridDim.x) * blockDim.x) {
    const Rows at = rows(a, c, o, h, p, q);
    T s = T(0);
    for (int kk = 0; kk < k; ++kk) s += term(a, c, at.a, at.c, kk);
    out[o] = s;
  }
}

// The launch of the tiled kernel: its tile grid, its warps and its split.
struct Plan {
  int g, h, p, q, k;
  int wm, wn;            // warps of the block along p and q
  int tiles_p, tiles_q;  // tiles along p and q of one (g, h)
  int tiles;             // g * h * tiles_p * tiles_q
  int chunks;            // ceil(k / kChunk)
  int per_block;         // chunks of one block
  int splits;            // blocks of one tile
  int lg_stage;          // log2 of a stage's terms (kMinStage .. kChunk)
  bool vec_a, vec_c;     // 16-byte copies of a's / c's rows
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies `bytes` of `src` (0 to SIZE) to shared memory, zeros after them.
template <int SIZE>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  if constexpr (SIZE == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(SIZE), "r"(bytes));
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + rows) of one (g, h) of an operand, terms [k0, k0 +
// stage), stage = 2^lg, into dst[row][term]; zeros past k and past
// `valid` rows. The copies are independent: their addresses come from
// shifts, not divisions, so that a thread's copies issue back to back.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const Operand<T>& x,
                                           long long base, int r0, int rows,
                                           int valid, int k0, int k,
                                           int lg, bool vec) {
  const int tid = threadIdx.x, nt = blockDim.x, stage = 1 << lg;
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    constexpr int kLgPer = sizeof(T) == 4 ? 2 : 1;
    const int lgv = lg - kLgPer;                  // vectors of a row: 2^lgv
#pragma unroll 4
    for (int e = tid; e < rows << lgv; e += nt) {
      const int r = e >> lgv, kk = (e & ((1 << lgv) - 1)) * kPer;
      const int left = k - (k0 + kk);
      const bool in = r0 + r < valid && left > 0;
      const T* src = in ? x.ptr + base + (r0 + r) * x.sp + k0 + kk : x.ptr;
      cp_async<16>(dst + r * stage + kk, src,
                   in ? (left < kPer ? left : kPer) * int(sizeof(T)) : 0);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < rows << lg; e += nt) {
      const int r = e >> lg, kk = e & (stage - 1);
      const bool in = r0 + r < valid && k0 + kk < k;
      const T* src =
          in ? x.ptr + base + (r0 + r) * x.sp + (k0 + kk) * x.sk : x.ptr;
      cp_async<sizeof(T)>(dst + r * stage + kk, src,
                          in ? int(sizeof(T)) : 0);
    }
  }
}

// The warp's xor-butterfly sum of L entries per lane, scattered: after the
// step `o` apart a lane keeps the half of its entries that its bit o
// selects (the upper half if set), added to its partner's same entries.
// Each kept sum is the butterfly's; the lane ends with max(L / 32, 1)
// sums, of entries lane * (L / 32) + j (L >= 32) or lane >> (5 - log2 L).
template <int L, int O, typename T, int M>
__device__ __forceinline__ void scatter_sum(T (&v)[M], int lane) {
  if constexpr (O > 0) {
    if constexpr (L > 1) {
      constexpr int kHalf = L / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        const T send = up ? v[j] : v[j + kHalf];
        const T keep = up ? v[j + kHalf] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      scatter_sum<kHalf, O / 2>(v, lane);
    } else {
      v[0] = v[0] + __shfl_xor_sync(0xffffffffu, v[0], O);
      scatter_sum<1, O / 2>(v, lane);
    }
  }
}

// Tiles of outputs, each warp RM x RN of them (RN = 1 without c), their
// terms in the chunked lane order.
template <typename T, int RM, int RN, bool kDot>
__global__ void __launch_bounds__(kMaxWarps * 32)
    row_dot_tile(Operand<T> a, Operand<T> c, T* out, T* partial, Plan pl) {
  constexpr int M = RM * RN;                 // outputs of a warp
  constexpr int kHeld = M >= 32 ? M / 32 : 1;
  constexpr int kSpread = M >= 32 ? 1 : 32 / M;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ bool last;
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tp = pl.wm * RM, tq = kDot ? pl.wn * RN : 0;
  const int stage = 1 << pl.lg_stage;
  const int stage_elems = (tp + tq) * stage;

  const int tile = blockIdx.x % pl.tiles, split = blockIdx.x / pl.tiles;
  const int per_gh = pl.tiles_p * pl.tiles_q;
  const int gh = tile / per_gh, tpi = (tile % per_gh) / pl.tiles_q,
            tqi = tile % pl.tiles_q;
  const long long gi = gh / pl.h, hi = gh % pl.h;
  const long long base_a = gi * a.sg + hi * a.sh;
  const long long base_c = kDot ? gi * c.sg + hi * c.sh : 0;
  const int p0 = tpi * tp, q0 = tqi * tq;
  // Warps past wm x wn only stage: every block has kMaxWarps, so that a
  // tile of one warp's outputs still has eight warps' copies in flight (a
  // warp keeps ~8 KB of copies in flight per microsecond).
  const bool computes = warp < pl.wm * pl.wn;
  const int wm_i = warp % pl.wm, wn_i = warp / pl.wm;
  const int rp = wm_i * RM, rq = wn_i * RN;   // the warp's rows in the tile

  const int c_begin = split * pl.per_block;
  const int c_end = min(pl.chunks, c_begin + pl.per_block);
  const bool whole = pl.splits == 1;
  const int k_begin = c_begin * kChunk;
  const int k_end = min(pl.k, c_end * kChunk);
  const int stages = (k_end - k_begin + stage - 1) / stage;

  auto load = [&](int s) {
    T* dst = smem + (s % kStages) * stage_elems;
    const int k0 = k_begin + s * stage;
    stage_rows(dst, a, base_a, p0, tp, pl.p, k0, pl.k, pl.lg_stage,
               pl.vec_a);
    if constexpr (kDot)
      stage_rows(dst + tp * stage, c, base_c, q0, tq, pl.q, k0, pl.k,
                 pl.lg_stage, pl.vec_c);
  };

  T acc[M], run[kHeld];
#pragma unroll
  for (int e = 0; e < M; ++e) acc[e] = T(0);
#pragma unroll
  for (int j = 0; j < kHeld; ++j) run[j] = T(0);

  // The warp's outputs held by this lane after the scatter: entry e of the
  // warp's RM x RN is output (p0 + rp + e / RN, q0 + rq + e % RN).
  auto entry = [&](int j) {
    return M >= 32 ? lane * kHeld + j : lane / kSpread;
  };
  auto output = [&](int e, long long& o) {
    const int pi = p0 + rp + e / RN, qi = q0 + rq + e % RN;
    o = ((gh * static_cast<long long>(pl.p) + pi) * (kDot ? pl.q : 1)) +
        (kDot ? qi : 0);
    return pi < pl.p && (!kDot || qi < pl.q) &&
           (M >= 32 || lane % kSpread == 0);
  };
  const long long n_out =
      static_cast<long long>(pl.g) * pl.h * pl.p * (kDot ? pl.q : 1);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages) load(s);
    cp_commit();
  }
  for (int s = 0; s < stages; ++s) {
    cp_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < stages) load(s + kStages - 1);
    cp_commit();
    if (!computes) continue;
    const T* sa = smem + (s % kStages) * stage_elems + rp * stage;
    const T* sc = smem + (s % kStages) * stage_elems + (tp + rq) * stage;
#pragma unroll 2
    for (int kk = lane; kk < stage; kk += 32) {
      T av[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = sa[i * stage + kk];
      if constexpr (kDot) {
        T cv[RN];
#pragma unroll
        for (int j = 0; j < RN; ++j) cv[j] = sc[j * stage + kk];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j)
            acc[i * RN + j] = acc[i * RN + j] + av[i] * cv[j];
      } else {
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i] = acc[i] + av[i];
      }
    }
    const int k_next = k_begin + (s + 1) * stage;
    if (k_next % kChunk == 0 || s == stages - 1) {   // a chunk ends
      const int chunk = (k_next - 1) / kChunk;
      scatter_sum<M, 16>(acc, lane);
#pragma unroll
      for (int j = 0; j < kHeld; ++j) {
        long long o;
        const bool mine = output(entry(j), o);
        if (whole) {
          run[j] = chunk == 0 ? acc[j] : run[j] + acc[j];
        } else if (mine && computes) {
          partial[chunk * n_out + o] = acc[j];
        }
      }
#pragma unroll
      for (int e = 0; e < M; ++e) acc[e] = T(0);
    }
  }
  cp_wait<0>();

  if (whole) {
#pragma unroll
    for (int j = 0; j < kHeld; ++j) {
      long long o;
      if (computes && output(entry(j), o)) out[o] = run[j];
    }
    return;
  }
  // Split tile: the last of its blocks to arrive adds the chunk sums.
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(&g_arrivals[tile], 1u) == unsigned(pl.splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int tqn = kDot ? tq : 1, n_tile = tp * tqn, nt = blockDim.x;
  auto tile_output = [&](int e, long long& o) {
    const int pi = p0 + e / tqn, qi = q0 + e % tqn;
    o = (gh * static_cast<long long>(pl.p) + pi) * (kDot ? pl.q : 1) +
        (kDot ? qi : 0);
    return pi < pl.p && (!kDot || qi < pl.q);
  };
  if (pl.chunks * n_tile <= kStages * stage_elems && n_tile <= nt) {
    // The tile's chunk sums, loaded at once into the ring by all threads
    // (thread t: output t % n_tile, chunks t / n_tile + i nt / n_tile),
    // then added in chunk order from there.
    const int e = tid % n_tile, step = nt / n_tile;
    long long o;
    const bool mine = tid < step * n_tile && tile_output(e, o);
#pragma unroll 4
    for (int ch = tid / n_tile; ch < pl.chunks; ch += step)
      if (mine) smem[ch * n_tile + e] = __ldcg(partial + ch * n_out + o);
    __syncthreads();
    if (tid < n_tile && tile_output(tid, o)) {
      T sum = smem[tid];
      for (int ch = 1; ch < pl.chunks; ++ch)
        sum = sum + smem[ch * n_tile + tid];
      out[o] = sum;
    }
  } else {
    for (int e = tid; e < n_tile; e += blockDim.x) {
      long long o;
      if (!tile_output(e, o)) continue;
      T sum = __ldcg(partial + o);
#pragma unroll 8
      for (int ch = 1; ch < pl.chunks; ++ch)
        sum = sum + __ldcg(partial + ch * n_out + o);
      out[o] = sum;
    }
  }
  if (tid == 0) g_arrivals[tile] = 0u;
}

template <typename T>
bool rows_aligned(const Operand<T>& x) {
  constexpr long long kPer = 16 / sizeof(T);
  return x.sk == 1 && reinterpret_cast<uintptr_t>(x.ptr) % 16 == 0 &&
         x.sg % kPer == 0 && x.sh % kPer == 0 && x.sp % kPer == 0;
}

template <typename T, int RM, int RN, bool kDot>
int launch_tile(const Operand<T>& a, const Operand<T>& c, T* out,
                T* partial, Plan pl, cudaStream_t s) {
  // Warps along q first (up to 2 for 8 x 8 warps), then along p.
  const int need_p = (pl.p + RM - 1) / RM;
  const int need_q = kDot ? (pl.q + RN - 1) / RN : 1;
  pl.wn = kDot ? std::min(need_q, RM == 1 ? kMaxWarps : 2) : 1;
  pl.wm = std::min(need_p, kMaxWarps / pl.wn);
  pl.tiles_p = (pl.p + pl.wm * RM - 1) / (pl.wm * RM);
  pl.tiles_q = kDot ? (pl.q + pl.wn * RN - 1) / (pl.wn * RN) : 1;
  const long long tiles =
      static_cast<long long>(pl.g) * pl.h * pl.tiles_p * pl.tiles_q;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  pl.tiles = static_cast<int>(tiles);
  pl.chunks = (pl.k + kChunk - 1) / kChunk;
  int splits = 1;
  if (pl.chunks > 1 && pl.tiles <= kMaxTiles && partial != nullptr)
    splits = std::min(pl.chunks, std::max(1, kTargetBlocks / pl.tiles));
  pl.per_block = (pl.chunks + splits - 1) / splits;
  pl.splits = (pl.chunks + pl.per_block - 1) / pl.per_block;
  const long long blocks = static_cast<long long>(pl.tiles) * pl.splits;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  pl.vec_a = rows_aligned(a);
  pl.vec_c = kDot && rows_aligned(c);
  const int rows = pl.wm * RM + (kDot ? pl.wn * RN : 0);
  int stage = kMinStage;
  pl.lg_stage = 6;
  static_assert(kMinStage == 1 << 6, "lg_stage starts at kMinStage");
  while (stage < kChunk &&
         2 * stage * rows * static_cast<int>(sizeof(T)) <= kStageBytes) {
    stage *= 2;
    ++pl.lg_stage;
  }
  const size_t bytes = static_cast<size_t>(kStages) * rows * stage *
                       sizeof(T);
  // The most any launch of this instance stages: kStageBytes, or kMinStage
  // terms of its most rows (8 warps of RM + RN).
  constexpr size_t most_rows = RM == 1 ? 1 + kMaxWarps * RN
                                       : kMaxWarps * RM + (kDot ? RN : 0);
  constexpr size_t most =
      kStages * std::max<size_t>(kStageBytes,
                                 kMinStage * most_rows * sizeof(T));
  static unsigned long long opted = 0;     // a bit per device
  if (most > (48 << 10)) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!(opted >> (dev & 63) & 1ull)) {
      e = cudaFuncSetAttribute(row_dot_tile<T, RM, RN, kDot>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(most));
      if (e != cudaSuccess) return static_cast<int>(e);
      opted |= 1ull << (dev & 63);
    }
  }
  row_dot_tile<T, RM, RN, kDot>
      <<<static_cast<unsigned>(blocks), kMaxWarps * 32, bytes, s>>>(
          a, c, out, partial, pl);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* a, const void* c, void* out, void* partial,
           const int* dims, const long long* sa, const long long* sc,
           cudaStream_t s) {
  const int g = dims[0], h = dims[1], p = dims[2], q = dims[3], k = dims[4];
  Operand<T> oa{static_cast<const T*>(a), sa[0], sa[1], sa[2], sa[3]};
  const Operand<T> oc{static_cast<const T*>(c), sc[0], sc[1], sc[2], sc[3]};
  T* o = static_cast<T*>(out);
  T* part = static_cast<T*>(partial);
  const long long n = static_cast<long long>(g) * h * p * q;
  if (n == 0) return 0;
  if (k <= kThreadRow) {
    long long blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
    if (blocks > (1 << 30)) blocks = 1 << 30;
    row_dot_thread<T><<<static_cast<unsigned>(blocks), kRowsPerBlock, 0,
                        s>>>(oa, oc, o, n, h, p, q, k);
    return static_cast<int>(cudaGetLastError());
  }
  Plan pl{};
  pl.g = g, pl.h = h, pl.p = p, pl.q = q, pl.k = k;
  if (c == nullptr && p == 1) {
    // One sum a (g, h): the h axis as rows (the same outputs, in the same
    // places), so that a tile holds many of them.
    pl.p = h;
    pl.h = 1;
    oa.sp = oa.sh;
  }
  // Few outputs of a (g, h): smaller warp tiles (a warp of 8 x 8 would run
  // all of a tile's products alone), a (g, h) still one tile where it is
  // 8 x 8 at most (hcc's 6 x 6: each row staged once).
  if (c == nullptr)
    return pl.p > kSmallTile
               ? launch_tile<T, 8, 1, false>(oa, oc, o, part, pl, s)
               : launch_tile<T, 1, 1, false>(oa, oc, o, part, pl, s);
  if (p > 1 && q > 1 && p <= 8 && q <= 8)
    return launch_tile<T, 2, 4, true>(oa, oc, o, part, pl, s);
  if (static_cast<long long>(p) * q <= kSmallTile)
    return launch_tile<T, 1, 1, true>(oa, oc, o, part, pl, s);
  return q > 1 ? launch_tile<T, 8, 8, true>(oa, oc, o, part, pl, s)
               : launch_tile<T, 8, 1, true>(oa, oc, o, part, pl, s);
}

}  // namespace

// dims = {g, h, p, q, k}; a: (g, h, p, k) through its strides sa[4]; c:
// (g, h, q, k) through sc[4], or null (then q must be 1); out: (g, h, p,
// q) contiguous; partial: scratch of ceil(k / kChunk) * g * h * p * q
// elements where k > kThreadRow and k spans more than one chunk
// (ops/ordered_sum.scratch_elements), else may be null; dtype 0 for f32
// operands and output, 1 for f64.
extern "C" int pb_row_dot(const void* a, const void* c, void* out,
                          void* partial, const int* dims, const long long* sa,
                          const long long* sc, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, c, out, partial, dims, sa, sc, s);
  if (dtype == 1) return launch<double>(a, c, out, partial, dims, sa, sc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* pb_row_dot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
