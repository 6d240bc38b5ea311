// The compact direction's second pass over the history in one stream:
//   r = gamma g + sum_k v_k s_k - gamma sum_k u_k y_k.
//
// Replaces the Pallas kernel tpu_lbfgs/kernels/pallas_ops.py _combine_kernel
// (run by _combine_pallas), the public entry
// combine_direction(use_pallas=True).
//
// Bound by device-memory bytes: (2m + 1) values are read and one written
// per element for 4m + 1 operations.  So every row of S and Y is read
// exactly once: a thread owns one element of r and walks the m rows at
// that column, which makes each warp's loads of a row contiguous, and its
// 2m loads are independent, so many are in flight at once.  There is no
// reduction across threads and nothing is kept between blocks.  m is a
// run-time argument; v, u and gamma are read from device memory (they come
// out of the small-matrix head), one broadcast load per row.  The edge is
// masked by index, so any n works.
//
// The accumulation follows the TPU kernel's and the plain PyTorch
// version's order (tpu_lbfgs_torch/kernels/fused_ops.py::
// combine_direction_plain), acc = gamma g, then for k = 0 .. m-1
// acc = (acc + v_k s_k) - (gamma u_k) y_k in the working type, and the
// library is built with -fmad=false, so r matches the plain version bit
// for bit.  The kernel is a template on the scalar type, float or double,
// and on the ring's type: the scalar type, or bfloat16 under float (the TPU
// kernel's hist_ok), each ring value widened to float as it is read, which
// halves the bytes of the two streams that bound the kernel.
//
// The batched form (kBatched, tl_combine_direction_batched_*; the
// reference's jax.vmap over _combine_pallas) takes B lanes: g and r (B, n),
// the ring (B, m, n), v and u (B, m) and gamma (B,).  A thread owns one
// element of the flattened (B, n) r, finds its lane by division, and walks
// that lane's m rows at its column with that lane's coefficients, in the
// same order, so r equals the batched plain version bit for bit.  The grid
// is one-dimensional over B * n elements, so any B fits.  One instance is
// the kBatched = false copy and not a batch of one lane: the lane
// arithmetic, even behind a branch taken only for a batch, made the
// one-instance kernel 1-2% slower on a float32 or float64 ring and 10% on a
// bfloat16 one (bench/kernel_ab.py against the copy without it, NVIDIA
// H100 80GB HBM3, 700 W).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T widen(T v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// total: the elements of r, n for one instance, lanes * n batched.
template <typename T, typename H, bool kBatched>
__global__ void __launch_bounds__(kThreads)
    combine_direction_kernel(const T* __restrict__ g,
                             const H* __restrict__ s_hist,
                             const H* __restrict__ y_hist,
                             const T* __restrict__ v, const T* __restrict__ u,
                             const T* __restrict__ gamma, T* __restrict__ r,
                             int m, int64_t n, int64_t total) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int64_t lane = 0, col = i;
  if constexpr (kBatched) {
    lane = i / n;
    col = i - lane * n;
    s_hist += lane * m * n;
    y_hist += lane * m * n;
    v += lane * m;
    u += lane * m;
  }
  const T gam = gamma[lane];
  T acc = gam * g[i];
#pragma unroll 5
  for (int k = 0; k < m; ++k) {
    const int64_t at = static_cast<int64_t>(k) * n + col;
    acc = (acc + v[k] * widen(s_hist[at])) - (gam * u[k]) * widen(y_hist[at]);
  }
  r[i] = acc;
}

template <typename T, typename H, bool kBatched>
int launch(const T* g, const H* s_hist, const H* y_hist, const T* v,
           const T* u, const T* gamma, T* r, int m, long long lanes,
           long long n, void* stream) {
  if (n < 1 || m < 1 || lanes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = lanes * n;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  combine_direction_kernel<T, H, kBatched>
      <<<static_cast<unsigned>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(g, s_hist, y_hist, v, u, gamma,
                                              r, m, n, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g, r: n values; s_hist, y_hist: m * n values, row-major (m, n); v, u: m
// values; gamma: one value; all on the device, float (_f32) or double
// (_f64); for _f32_bf16 the ring is bfloat16 and the rest float.  Returns
// the cudaError_t of the launch.
#define TL_COMBINE_ENTRY(NAME, T, H)                                         \
  extern "C" int NAME(const T* g, const void* s_hist, const void* y_hist,    \
                      const T* v, const T* u, const T* gamma, T* r, int m,   \
                      long long n, void* stream) {                           \
    return launch<T, H, false>(g, static_cast<const H*>(s_hist),             \
                               static_cast<const H*>(y_hist), v, u, gamma, r, \
                               m, 1, n, stream);                              \
  }

TL_COMBINE_ENTRY(tl_combine_direction_f32, float, float)
TL_COMBINE_ENTRY(tl_combine_direction_f64, double, double)
TL_COMBINE_ENTRY(tl_combine_direction_f32_bf16, float, __nv_bfloat16)

// The batched form: g, r: lanes * n values, row-major (lanes, n); s_hist,
// y_hist: (lanes, m, n); v, u: (lanes, m); gamma: lanes values.  Returns
// the cudaError_t of the launch.
#define TL_COMBINE_BATCHED_ENTRY(NAME, T, H)                                 \
  extern "C" int NAME(const T* g, const void* s_hist, const void* y_hist,    \
                      const T* v, const T* u, const T* gamma, T* r, int m,   \
                      long long lanes, long long n, void* stream) {          \
    return launch<T, H, true>(g, static_cast<const H*>(s_hist),              \
                              static_cast<const H*>(y_hist), v, u, gamma, r,  \
                              m, lanes, n, stream);                           \
  }

TL_COMBINE_BATCHED_ENTRY(tl_combine_direction_batched_f32, float, float)
TL_COMBINE_BATCHED_ENTRY(tl_combine_direction_batched_f64, double, double)
TL_COMBINE_BATCHED_ENTRY(tl_combine_direction_batched_f32_bf16, float,
                         __nv_bfloat16)
