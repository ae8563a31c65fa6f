// Sums and dot products along the last axis in an order fixed by their
// length alone: the reductions of the LM body (core/schur.py,
// core/residuals.py, core/lm.py), ops/ordered_sum.py.
//
//   out[g, h, p, q] = sum_k a[g, h, p, k] * c[g, h, q, k]   (c given)
//   out[g, h, p]    = sum_k a[g, h, p, k]                   (c null)
//
// Replaces no TPU kernel: the JAX package leaves these sums to XLA
// (photobundle_tpu/core/schur.py:94-106 and :223-241, the einsums and sums
// of the normal equations and the Schur terms), which vmap batches. It was
// added so that a batched window solve rounds each window as its own solve
// does: torch's own reductions choose their thread and block split, and
// cuBLAS its kernel, by the number of outputs, i.e. by the batch, so window
// b of a batch of 4 can come out an ulp from the same window alone. Here
// the order of every output's sum depends on k alone:
//
//   k <= kThreadRow: one thread per output, k = 0, 1, ... in turn;
//   k >  kThreadRow: one block of kBlock threads per output, thread t
//                    summing k = t, t + kBlock, ... in turn, then a fixed
//                    tree over the block's partial sums in shared memory.
//
// Sums are taken in the operands' type (f32 or f64), as the JAX package's
// XLA reductions take them; built with -fmad=false, each product and each
// sum rounds once.
// Operands are read through their strides (elements, two leading axes:
// the batch and one more), so a transposed or broadcast view needs no
// copy. Bounded by the bytes it reads (each operand
// once at the HBM rate) at the body's shapes, which are small: the launch
// is most of its time.
#include <cuda_runtime.h>

namespace {

constexpr int kThreadRow = 64;   // longest row summed by one thread
constexpr int kBlock = 256;      // threads of a block per output
constexpr int kRowsPerBlock = 256;

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

// One thread per output, its row in order.
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

// One block per output: strided partial sums, then a fixed tree.
template <typename T>
__global__ void __launch_bounds__(kBlock)
    row_dot_block(Operand<T> a, Operand<T> c, T* out, int h, int p, int q,
                  int k) {
  __shared__ T part[kBlock];
  const long long o = blockIdx.x;
  const Rows at = rows(a, c, o, h, p, q);
  T s = T(0);
  for (int kk = threadIdx.x; kk < k; kk += kBlock)
    s += term(a, c, at.a, at.c, kk);
  part[threadIdx.x] = s;
  __syncthreads();
  for (int half = kBlock / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) part[threadIdx.x] += part[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[o] = part[0];
}

template <typename T>
int launch(const void* a, const void* c, void* out, const int* dims,
           const long long* sa, const long long* sc, cudaStream_t s) {
  const int g = dims[0], h = dims[1], p = dims[2], q = dims[3], k = dims[4];
  const Operand<T> oa{static_cast<const T*>(a), sa[0], sa[1], sa[2], sa[3]};
  const Operand<T> oc{static_cast<const T*>(c), sc[0], sc[1], sc[2], sc[3]};
  T* o = static_cast<T*>(out);
  const long long n = static_cast<long long>(g) * h * p * q;
  if (n == 0) return 0;
  if (k <= kThreadRow) {
    long long blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
    if (blocks > (1 << 30)) blocks = 1 << 30;
    row_dot_thread<T><<<static_cast<unsigned>(blocks), kRowsPerBlock, 0,
                        s>>>(oa, oc, o, n, h, p, q, k);
  } else {
    if (n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    row_dot_block<T><<<static_cast<unsigned>(n), kBlock, 0, s>>>(
        oa, oc, o, h, p, q, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dims = {g, h, p, q, k}; a: (g, h, p, k) through its strides sa[4]; c:
// (g, h, q, k) through sc[4], or null (then q must be 1); out: (g, h, p,
// q) contiguous; dtype 0 for f32 operands and output, 1 for f64.
extern "C" int pb_row_dot(const void* a, const void* c, void* out,
                          const int* dims, const long long* sa,
                          const long long* sc, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, c, out, dims, sa, sc, s);
  if (dtype == 1) return launch<double>(a, c, out, dims, sa, sc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* pb_row_dot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
