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
// not come out as its own solve. Here one block factors and solves one
// system, every element's sum in a fixed order (right-looking: column j's
// update of A[i][k] is subtracted in turn, j = 0, 1, ...; the forward and
// back substitutions likewise), so each system's result depends on it
// alone, whatever the batch.
//
// The matrix and the right-hand side live in shared memory where they fit
// a block (f32: n <= 240, 6W for a window of up to 40 poses; f64: n <=
// 168), else in a global scratch copy the wrapper allocates; the code and
// order are the same. A system whose factor fails (a pivot not > 0, NaN
// included) gets NaN in all of x, as the plain version's `info != 0`
// does, and touches no other system. Built with -fmad=false: each product
// and each difference rounds once, in the matrix's own type.
//
// Work per column j: the pivot and column j scaled (a copy of the column
// kept in `col`, so the trailing update reads it without bank conflicts),
// then the trailing update, one warp per row and a lane per column, and
// the forward substitution's update of b by z_j in the same pass (the
// same terms in the same order as a separate sweep after the factor).
// Two barriers a column; the back substitution one a row.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
// Largest n whose n x n matrix and two n-vectors fit a block's 227 KB.
template <typename T>
constexpr int kMaxShared = sizeof(T) == 4 ? 240 : 168;

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    chol_solve(const T* __restrict__ s, const T* __restrict__ b,
               T* __restrict__ x, T* __restrict__ scratch, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int failed;
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = nt >> 5;
  const long long g = blockIdx.x;
  const long long nn = static_cast<long long>(n) * n;
  T* a = scratch ? scratch + g * nn : smem;
  T* y = scratch ? x + g * n : smem + nn;  // right-hand side, then solution
  T* col = scratch ? smem : smem + nn + n;   // L's column j
  const T* sg = s + g * nn;
  for (long long e = tid; e < nn; e += nt) a[e] = sg[e];
  for (int i = tid; i < n; i += nt) y[i] = b[g * n + i];
  if (tid == 0) failed = 0;
  __syncthreads();

  // Right-looking factorization of the lower triangle, in place, with the
  // forward substitution L z = b: z_j = y_j / L_jj, then y_i -= L_ij z_j.
  T zj = T(0);
  for (int j = 0; j < n; ++j) {
    // Every thread has read y[j - 1] (the last barrier): it becomes z.
    if (tid == 0 && j > 0) y[j - 1] = zj;
    const T d = a[j * n + j];
    if (!(d > T(0))) {                    // not positive definite, or NaN
      if (tid == 0) failed = 1;
      break;                              // uniform: every thread reads d
    }
    const T ljj = sqrt(d);
    for (int i = j + 1 + tid; i < n; i += nt) {
      const T v = a[i * n + j] / ljj;
      a[i * n + j] = v;
      col[i] = v;
    }
    __syncthreads();
    zj = y[j] / ljj;
    if (tid == 0) a[j * n + j] = ljj;     // no thread reads it before the
                                          // next barrier
    for (int i = j + 1 + tid; i < n; i += nt) y[i] = y[i] - col[i] * zj;
    // Trailing update A[i][k] -= L[i][j] L[k][j], j < k <= i.
    for (int i = j + 1 + warp; i < n; i += warps) {
      const T lij = col[i];
      for (int k = j + 1 + lane; k <= i; k += 32)
        a[i * n + k] = a[i * n + k] - lij * col[k];
    }
    __syncthreads();
  }
  if (tid == 0 && !failed) y[n - 1] = zj;
  __syncthreads();
  if (failed) {
    for (int i = tid; i < n; i += nt)
      x[g * n + i] = T(__int_as_float(0x7fc00000));   // quiet NaN
    return;
  }
  // Back substitution L^T x = z: x_j = y_j / L_jj, then y_i -= L_ji x_j.
  T xj = T(0);
  for (int j = n - 1; j >= 0; --j) {
    // Every thread has read y[j + 1] (the last barrier): it becomes x.
    if (tid == 0 && j < n - 1) y[j + 1] = xj;
    xj = y[j] / a[j * n + j];
    for (int i = tid; i < j; i += nt) y[i] = y[i] - a[j * n + i] * xj;
    __syncthreads();
  }
  if (tid == 0) y[0] = xj;
  __syncthreads();
  if (!scratch)
    for (int i = tid; i < n; i += nt) x[g * n + i] = y[i];
}

template <typename T>
int launch(const void* s, const void* b, void* x, void* scratch, int g, int n,
           cudaStream_t st) {
  if (g == 0 || n == 0) return 0;
  const bool shared = n <= kMaxShared<T>;
  if (!shared && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // Shared: the matrix, the right-hand side and the column; global: the
  // column alone.
  const size_t bytes =
      (shared ? static_cast<size_t>(n) * n + 2 * n : n) * sizeof(T);
  const size_t most =
      (static_cast<size_t>(kMaxShared<T>) * kMaxShared<T> +
       2 * kMaxShared<T>) * sizeof(T);
  if (bytes > most) return static_cast<int>(cudaErrorInvalidValue);
  static size_t opted = 48 << 10;         // the default dynamic limit
  if (bytes > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        chol_solve<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(most));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = most;
  }
  // A warp per trailing row: more warps for the larger systems.
  const int threads = n <= 64 ? 256 : kMaxThreads;
  chol_solve<T><<<g, threads, bytes, st>>>(
      static_cast<const T*>(s), static_cast<const T*>(b), static_cast<T*>(x),
      shared ? nullptr : static_cast<T*>(scratch), n);
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
