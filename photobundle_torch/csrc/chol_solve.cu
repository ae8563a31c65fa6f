// Batched Cholesky factor-and-solve of the reduced camera systems:
// ops/chol_solve.py, core/schur.py `solve_reduced`.
//
//   x[g] = S[g]^{-1} b[g],   S[g] = L L^T   (n x n, one right-hand side)
//
// Replaces no TPU kernel: the JAX package solves the reduced system with
// XLA's cho_factor / cho_solve (photobundle_tpu/core/schur.py:282-283),
// which vmap batches. It was added because torch's batched
// cholesky_solve goes through MAGMA, which allocates and so cannot be
// captured in a CUDA graph, and because cuSOLVER's batched and
// single-matrix routines are different code, so window b of a batch need
// not come out as its own solve. Here every element of a system sees the
// same operations in the same order, whatever the batch and whichever
// path below runs (right-looking: column j's update of A[i][k] is
// subtracted in turn, j = 0, 1, ...; the forward substitution's y_i -=
// L_ij z_j likewise, in the factor's sweep; the back substitution's y_i -=
// L_ji x_j for j = n - 1, n - 2, ...), so each system's x depends on it
// alone. A system whose factor fails (a pivot not > 0, NaN included) gets
// NaN in all of x, as the plain version's `info != 0` does, and touches no
// other system. Built with -fmad=false: each product and each difference
// rounds once, in the matrix's own type.
//
// What bounds it on this card: latency. A system of the main path (W = 5,
// n = 30) is ~10^4 operations on ~2 KB, a dependent chain of n pivots,
// square roots and divisions; the first design took two block barriers a
// column and one a row (90 at n = 30), every step through shared memory,
// and at n = 192 walked 192 columns on one SM with 384 barriers. This
// design:
//
//   n <= 32: one warp per system, kWarpSystems systems a block, no block
//     barrier (warp_factor, warp_back). Lane i holds row i of the lower
//     triangle in registers (a fixed-size array, indexed at compile time
//     only); the pivot and z_j go to the lanes by shuffles, L's column j
//     through a column tile of the warp's own in shared memory, which the
//     back substitution reads too (L_ji for lane i, a row of the tile).
//     A lone warp runs a chain of ~10^2 dependent instructions a column
//     (~900 cycles at first): the loop is kept branch-free, with loads
//     ahead of their uses and the next column's pivot ahead of the rest.
//   n > 32: one block per system, panels of 32 columns. One warp factors
//     the panel's diagonal block as above; each thread then takes one row
//     below it (its 32 entries in registers: the subtractions of the
//     panel's earlier columns, then the division, column by column, and
//     its y_i); then the block updates the trailing matrix in 4 x 4
//     register tiles, each element's 32 subtractions in column order, from
//     a copy of the panel's columns. Three barriers a panel (18 at n =
//     192) and two a panel in the back substitution. The matrix is kept as
//     its packed lower triangle.
//
// The packed triangle, the right-hand side and the panel copy live in
// shared memory where they fit kMaxShared (f32: n <= 240, 6W for a window
// of up to 40 poses; f64: n <= 168), else in the global scratch the wrapper
// allocates (the packed triangle and the panel copy in one system's n x n,
// the right-hand side in x); the code and order are the same.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpN = 32;        // largest n solved by one warp
// Systems of a block on the warp path (its column tiles within the 48 KB
// of static shared memory).
template <typename T>
constexpr int kWarpSystems = sizeof(T) == 4 ? 4 : 2;
constexpr int kPanelThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
// The first design's shared-memory limit (its n x n matrix and two
// n-vectors in 227 KB), kept.
template <typename T>
constexpr int kMaxShared = sizeof(T) == 4 ? 240 : 168;

template <typename T>
__device__ __forceinline__ T quiet_nan() {
  return T(__int_as_float(0x7fc00000));
}

__device__ __forceinline__ long long packed(long long i) {
  return i * (i + 1) / 2;        // row i of the packed lower triangle
}

// A diagonal block's L by columns: lt[j * kLt + k] = L_kj. Its columns
// are padded past 2 x 32 rows, so that column j's entries k = j + 1 ..
// j + 31 sit at fixed offsets from one address (no clamping), and its
// stride is odd, so that lane i reading row i of it hits bank i.
constexpr int kLt = 2 * kWarpN + 1;

// Factors a diagonal block of nb <= 32 columns held a row per lane, and
// runs the forward substitution on y (lane i's entry, z on return). The
// row is held rotated: at column j, a[r] is row lane's column j + r
// (zeros past the row's diagonal and for lanes >= nb), so that the code
// of a column indexes registers at compile time only and the loop over
// columns stays rolled (one warp runs it once: unrolled, its ~10^4
// instructions would be fetched cold). L_kj goes to the warp's column
// tile lt as it is made, and the lanes read column j back from there: all
// of its entries first, then every update selected (no branch; 31 loads
// from one address overlap, where 31 shuffles cost ~31 latencies). The
// column's critical chain (L_(j+1)j, the next pivot, its square root, the
// next L_(j+2)(j+1)) and the substitution's (z_j, y_(j+1), z_(j+1)) are
// taken ahead of the rest of the row's update, so that their latencies
// overlap its work. False (for every lane) if a pivot is not > 0. The
// operations on each element are the first design's, in its order.
template <typename T>
__device__ __forceinline__ bool warp_factor(T (&a)[kWarpN], T& y, int nb,
                                            int lane, T* lt) {
  T d = __shfl_sync(kFull, a[0], 0);
  if (!(d > T(0))) return false;                  // uniform: every lane has d
  T ljj = sqrt(d);
  T v = a[0] / ljj;                               // lane i > j: L_ij
  T zj = __shfl_sync(kFull, y, 0) / ljj;
#pragma unroll 1
  for (int j = 0; j < nb; ++j) {
    T* col = lt + j * kLt;
    const int below = lane - j;                   // row lane is column j + r
                                                  // 's for r <= below
    // Branch-free: a branch would split the column's two chains (the
    // pivots', the substitution's) into blocks ptxas schedules apart.
    if (below >= 0 && lane < nb) col[lane] = below == 0 ? ljj : v;
    y = below == 0 ? zj : below > 0 ? y - v * zj : y;
    // Column j + 1 first: its pivot from lane j + 1's own L_(j+1)j (no
    // round trip through the tile), its z from lane j + 1's y.
    const T pivot = a[1] - v * v;
    const T d1 = __shfl_sync(kFull, pivot, (j + 1) & (kWarpN - 1));
    const T y1 = __shfl_sync(kFull, y, (j + 1) & (kWarpN - 1));
    const T ljj1 = sqrt(d1);
    const T zj1 = y1 / ljj1;
    __syncwarp();
    // The trailing update A[i][k] -= L_ij L_kj, j < k <= i, shifted down
    // by one column.
    T lk[kWarpN];
#pragma unroll
    for (int r = 1; r < kWarpN; ++r) lk[r] = col[j + r];
    const T next = below >= 1 ? a[1] - v * lk[1] : a[1];
    const T v1 = next / ljj1;
    a[0] = next;
#pragma unroll
    for (int r = 2; r < kWarpN; ++r) {
      const T upd = a[r] - v * lk[r];
      a[r - 1] = below >= r ? upd : a[r];
    }
    a[kWarpN - 1] = T(0);
    if (j + 1 < nb && !(d1 > T(0))) return false;   // uniform
    ljj = ljj1;
    v = v1;
    zj = zj1;
  }
  return true;
}

// The back substitution L^T x = z over a block of nb <= 32 rows whose later
// rows' terms y has already had subtracted: x_j = y_j / L_jj, then y_i -=
// L_ji x_j (i < j), j = nb - 1, ..., 0; L from the column tile lt.
template <typename T>
__device__ __forceinline__ void warp_back(T& y, int nb, int lane,
                                          const T* lt) {
  const T* mine = lt + lane * kLt;                // column lane: L_j,lane
#pragma unroll 1
  for (int j = nb - 1; j >= 0; --j) {
    const T xj = __shfl_sync(kFull, y, j) / lt[j * kLt + j];
    const T lji = mine[j];
    if (lane == j) {
      y = xj;
    } else if (lane < j) {
      y = y - lji * xj;
    }
  }
}

// n <= 32: a warp per system, with a column tile of its own.
template <typename T>
__global__ void __launch_bounds__(kWarpSystems<T> * 32)
    chol_solve_warp(const T* __restrict__ s, const T* __restrict__ b,
                    T* __restrict__ x, long long g, int n) {
  __shared__ T tiles[kWarpSystems<T>][kWarpN * kLt];
  const int lane = threadIdx.x & 31;
  const long long sys = blockIdx.x * static_cast<long long>(kWarpSystems<T>) +
                        (threadIdx.x >> 5);
  if (sys >= g) return;                           // the whole warp
  T* lt = tiles[threadIdx.x >> 5];
  const T* sg = s + sys * n * n;
  T a[kWarpN];
#pragma unroll
  for (int k = 0; k < kWarpN; ++k)
    a[k] = lane < n && k <= lane ? sg[lane * n + k] : T(0);
  T y = lane < n ? b[sys * n + lane] : T(0);
  const bool ok = warp_factor(a, y, n, lane, lt);
  __syncwarp();
  if (ok) warp_back(y, n, lane, lt);
  if (lane < n) x[sys * n + lane] = ok ? y : quiet_nan<T>();
}

// n > 32: a block per system, panels of 32 columns.
template <typename T>
__global__ void __launch_bounds__(kPanelThreads)
    chol_solve_panel(const T* __restrict__ s, const T* __restrict__ b,
                     T* __restrict__ x, T* __restrict__ scratch, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int failed;
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = nt >> 5;
  const long long g = blockIdx.x;
  const long long nn = static_cast<long long>(n) * n, tri = packed(n);
  T* lt = smem;                                   // the panel's column tile
  T* A = scratch ? scratch + g * nn : lt + kWarpN * kLt;   // packed
  T* lp = scratch ? scratch + g * nn + tri : A + tri;      // 32 x n
  T* Y = scratch ? x + g * n : lp + kWarpN * n;            // b, z, then x
  const T* sg = s + g * nn;
  for (int i = warp; i < n; i += warps)
    for (int k = lane; k <= i; k += 32) A[packed(i) + k] = sg[i * n + k];
  for (int i = tid; i < n; i += nt) Y[i] = b[g * n + i];
  if (tid == 0) failed = 0;
  __syncthreads();

  T a[kWarpN];
  for (int c0 = 0; c0 < n; c0 += kWarpN) {
    const int nb = min(kWarpN, n - c0), c1 = c0 + nb;
    // Row c0 + i of the panel, from column c0: l0 + i c0 + i (i + 1) / 2.
    T* l0 = A + packed(c0) + c0;
    // The diagonal block, by warp 0 in registers; its L to A and to lt.
    if (warp == 0) {
      T* row = l0 + lane * c0 + lane * (lane + 1) / 2;
#pragma unroll
      for (int k = 0; k < kWarpN; ++k)
        a[k] = lane < nb && k <= lane ? row[k] : T(0);
      T y = lane < nb ? Y[c0 + lane] : T(0);
      if (warp_factor(a, y, nb, lane, lt)) {
        __syncwarp();
        if (lane < nb) {
          Y[c0 + lane] = y;
          for (int k = 0; k <= lane; ++k) row[k] = lt[k * kLt + lane];
        }
      } else if (lane == 0) {
        failed = 1;
      }
    }
    __syncthreads();
    if (failed) break;                            // uniform
    // The rows below it, a thread each, held rotated as in warp_factor:
    // L_ij for the panel's columns j in turn (its subtractions, then the
    // division), then y_i's term; stored, and copied to lp[j][i - c1].
    for (int i = c1 + tid; i < n; i += nt) {
      T* row = A + packed(i) + c0;
#pragma unroll
      for (int k = 0; k < kWarpN; ++k) a[k] = k < nb ? row[k] : T(0);
      T yi = Y[i];
      // The next column's entry and division first, as in warp_factor.
      T rj = a[0] / lt[0];
#pragma unroll 1
      for (int j = 0; j < nb; ++j) {
        const T* col = lt + j * kLt;              // L_kj at col[k]
        row[j] = rj;
        lp[j * n + (i - c1)] = rj;
        yi = yi - rj * Y[c0 + j];
        T lk[kWarpN];
#pragma unroll
        for (int r = 1; r < kWarpN; ++r) lk[r] = col[j + r];
        const int left = nb - j;                  // columns j + r, r < left
        const T next = left > 1 ? a[1] - rj * lk[1] : a[1];
        const int j1 = min(j + 1, nb - 1);        // in the tile past it
        const T rj1 = next / lt[j1 * kLt + j1];   // L_(j+1)(j+1)
        a[0] = next;
#pragma unroll
        for (int r = 2; r < kWarpN; ++r) {
          const T upd = a[r] - rj * lk[r];
          a[r - 1] = left > r ? upd : a[r];
        }
        a[kWarpN - 1] = T(0);
        rj = rj1;
      }
      Y[i] = yi;
    }
    __syncthreads();
    // The trailing matrix, 4 x 4 tiles of its lower triangle:
    // A[i][k] -= L_ij L_kj for the panel's columns j in turn.
    const int m = n - c1, t4 = (m + 3) / 4;
    const int tiles = t4 * (t4 + 1) / 2;
    for (int t = tid; t < tiles; t += nt) {
      int ti = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
      while (ti * (ti + 1) / 2 > t) --ti;
      while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
      const int tk = t - ti * (ti + 1) / 2;
      const int i0 = 4 * ti, k0 = 4 * tk;       // relative to c1
      T acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + r, k = k0 + q;
          acc[r][q] = i < m && k <= i ? A[packed(c1 + i) + c1 + k] : T(0);
        }
      for (int j = 0; j < nb; ++j) {
        const T* lj = lp + j * n;
        T li[4], lk[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          li[r] = i0 + r < m ? lj[i0 + r] : T(0);
          lk[r] = k0 + r < m ? lj[k0 + r] : T(0);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = acc[r][q] - li[r] * lk[q];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + r, k = k0 + q;
          if (i < m && k <= i) A[packed(c1 + i) + c1 + k] = acc[r][q];
        }
    }
    __syncthreads();
  }
  if (failed) {
    for (int i = tid; i < n; i += nt) x[g * n + i] = quiet_nan<T>();
    return;
  }
  // Back substitution L^T x = z, panels from the last.
  for (int c0 = (n - 1) / kWarpN * kWarpN; c0 >= 0; c0 -= kWarpN) {
    const int nb = min(kWarpN, n - c0);
    if (warp == 0) {
      // The block's L to the column tile, then the warp's substitution.
      const T* row = A + packed(c0 + lane) + c0;
      if (lane < nb)
        for (int k = 0; k <= lane; ++k) lt[k * kLt + lane] = row[k];
      __syncwarp();
      T y = lane < nb ? Y[c0 + lane] : T(0);
      warp_back(y, nb, lane, lt);
      if (lane < nb) Y[c0 + lane] = y;
    }
    __syncthreads();
    for (int i = tid; i < c0; i += nt) {
      T yi = Y[i];
      for (int j = nb - 1; j >= 0; --j)
        yi = yi - A[packed(c0 + j) + i] * Y[c0 + j];
      Y[i] = yi;
    }
    __syncthreads();
  }
  if (!scratch)
    for (int i = tid; i < n; i += nt) x[g * n + i] = Y[i];
}

template <typename T>
int launch(const void* s, const void* b, void* x, void* scratch, int g, int n,
           cudaStream_t st) {
  if (g == 0 || n == 0) return 0;
  const T* sp = static_cast<const T*>(s);
  const T* bp = static_cast<const T*>(b);
  T* xp = static_cast<T*>(x);
  if (n <= kWarpN) {
    const long long blocks = (g + kWarpSystems<T> - 1) / kWarpSystems<T>;
    chol_solve_warp<T><<<static_cast<unsigned>(blocks), kWarpSystems<T> * 32,
                         0, st>>>(sp, bp, xp, g, n);
    return static_cast<int>(cudaGetLastError());
  }
  const bool shared = n <= kMaxShared<T>;
  if (!shared && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // Shared: the column tile, the packed triangle, the panel copy and the
  // right-hand side; global: the column tile.
  auto footprint = [](long long m) {
    return static_cast<size_t>(kWarpN * kLt + m * (m + 1) / 2 + 33 * m) *
           sizeof(T);
  };
  const size_t bytes = shared ? footprint(n) : footprint(0);
  const size_t most = footprint(kMaxShared<T>);
  static unsigned long long opted = 0;     // a bit per device
  if (bytes > (48 << 10)) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!(opted >> (dev & 63) & 1ull)) {
      e = cudaFuncSetAttribute(chol_solve_panel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(most));
      if (e != cudaSuccess) return static_cast<int>(e);
      opted |= 1ull << (dev & 63);
    }
  }
  chol_solve_panel<T><<<g, kPanelThreads, bytes, st>>>(
      sp, bp, xp, shared ? nullptr : static_cast<T*>(scratch), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// s: (g, n, n) contiguous, SPD with its jitter already added; b: (g, n);
// x: (g, n) output; scratch: (g, n, n) when n > pb_chol_max_shared(dtype),
// else null; dtype 0 for f32, 1 for f64.
extern "C" int pb_chol_solve(const void* s, const void* b, void* x,
                             void* scratch, int g, int n, int dtype,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(s, b, x, scratch, g, n, st);
  if (dtype == 1) return launch<double>(s, b, x, scratch, g, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int pb_chol_max_shared(int dtype) {
  return dtype == 0 ? kMaxShared<float> : kMaxShared<double>;
}

extern "C" const char* pb_chol_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
