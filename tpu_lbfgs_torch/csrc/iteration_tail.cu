// The solver's post-gradient tail for any objective, in one pass.
//
// Replaces the Pallas kernel tpu_lbfgs/kernels/pallas_ops.py
// _make_iteration_tail_kernel (run by _iteration_tail_pallas), plain and
// compensated.
//
// From x, d, g, the gradient g_new at the trial point and the accepted step
// alpha it computes
//   x_new = x + alpha d,   s = alpha d,   y = g_new - g,
// and five sums: s.y, y.y, g_new.g_new, d.g_new, g.g_new.
//
// Bound by device-memory bytes: per element four values are read and three
// written for 13 operations.  So each element is touched once: the three
// vectors and the five products come out of the same read, and the products
// go to float64 running sums per thread, which a fixed tree folds to one
// partial per block and sum (reduce.cuh).  alpha is read from device memory:
// the line search leaves it there and the host never waits for it.  The
// edge is masked by index, so any n works.
//
// In stage 2 one block per sum adds that sum's block partials.  The plain
// form adds them by a fixed tree.  The compensated form (the TPU kernel's
// `compensated` flag, which guards its sequential cross-block accumulation
// with _neumaier_add) runs the same Neumaier recurrence over the block
// partials, in block order: a running sum and, beside it, the sum of the
// low-order bits each addition dropped (reduce.cuh).
//
// The kernel is a template on the scalar type, float or double.  The
// per-element arithmetic follows the plain PyTorch version
// (tpu_lbfgs_torch/kernels/fused_ops.py::iteration_tail_plain) op for op,
// and the library is built with -fmad=false, so the three vectors match it
// bit for bit; only the sums differ, by their order.
#include "reduce.cuh"

namespace {

constexpr int kSums = 5;

template <typename T>
__global__ void __launch_bounds__(tl::kThreads)
    iteration_tail_kernel(const T* __restrict__ x, const T* __restrict__ d,
                          const T* __restrict__ g,
                          const T* __restrict__ g_new,
                          const T* __restrict__ alpha, T* __restrict__ x_new,
                          T* __restrict__ s_row, T* __restrict__ y_row,
                          double* __restrict__ partials, int64_t n) {
  const T a = *alpha;
  double acc[kSums] = {0.0, 0.0, 0.0, 0.0, 0.0};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const T di = d[i];
    const T gi = g[i];
    const T gn = g_new[i];
    const T s = a * di;
    const T y = gn - gi;
    x_new[i] = x[i] + s;
    s_row[i] = s;
    y_row[i] = y;
    acc[0] += static_cast<double>(s) * y;
    acc[1] += static_cast<double>(y) * y;
    acc[2] += static_cast<double>(gn) * gn;
    acc[3] += static_cast<double>(di) * gn;
    acc[4] += static_cast<double>(gi) * gn;
  }
  tl::block_sum_to<kSums>(acc, partials);
}

template <typename T>
int launch(const T* x, const T* d, const T* g, const T* g_new, const T* alpha,
           T* x_new, T* s_row, T* y_row, double* partials, T* sums,
           long long n, int compensated, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = tl::blocks_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  iteration_tail_kernel<T><<<blocks, tl::kThreads, 0, s>>>(
      x, d, g, g_new, alpha, x_new, s_row, y_row, partials, n);
  if (compensated) {
    tl::finish_sums_neumaier<T><<<kSums, tl::kThreads, 0, s>>>(partials, blocks,
                                                           sums);
  } else {
    tl::finish_sums<T><<<kSums, tl::kThreads, 0, s>>>(partials, blocks, sums);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, d, g, g_new, x_new, s_row, y_row: n values on the device, float (_f32)
// or double (_f64).  alpha: one value on the device.  partials: 5 *
// tl_max_blocks() doubles of scratch.  sums: 5 values, in the order s.y, y.y,
// g_new.g_new, d.g_new, g.g_new.  compensated: nonzero for the Neumaier
// stage 2.  Returns the cudaError_t of the launches.
#define TL_ITERATION_TAIL_ENTRY(NAME, T)                                     \
  extern "C" int NAME(const T* x, const T* d, const T* g, const T* g_new,    \
                      const T* alpha, T* x_new, T* s_row, T* y_row,          \
                      double* partials, T* sums, long long n,                \
                      int compensated, void* stream) {                       \
    return launch<T>(x, d, g, g_new, alpha, x_new, s_row, y_row, partials,   \
                     sums, n, compensated, stream);                          \
  }

TL_ITERATION_TAIL_ENTRY(tl_iteration_tail_f32, float)
TL_ITERATION_TAIL_ENTRY(tl_iteration_tail_f64, double)
