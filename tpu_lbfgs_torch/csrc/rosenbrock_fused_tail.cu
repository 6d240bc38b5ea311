// The solver's post-line-search tail for chained Rosenbrock in one pass.
//
// Replaces the Pallas kernel tpu_lbfgs/kernels/pallas_ops.py
// _make_tail_kernel with the body _body_rosenbrock (run by
// _fused_tail_pallas, with_matvec=False, compensated=False).
//
// From x, d, g and the accepted step alpha it computes
//   x_new = x + alpha d,   f and g_new at x_new,
//   s = alpha d,   y = g_new - g,
// and seven sums: f, s.y, y.y, g_new.g_new, d.g_new, g.g_new, y.g_new.
//
// Bound by device-memory bytes: 28 bytes move per element (x, d, g in;
// x_new, g_new, s, y out) for about 40 flops.  So everything the
// iteration needs after the line search comes out of this one read of
// x, d and g, with the sums reduced in the same pass (reduce.cuh).
// alpha is read from device memory: the line search leaves it there and
// the host never waits for it.
//
// The Rosenbrock terms need the trial point's neighbours x_new[i+-1].  A
// thread rebuilds them from x and d (the loads hit lines its warp already
// holds), with the same correctly rounded expression as the thread that
// owns that element (trial_point.cuh), so a neighbour equals its owner's
// x_new bit for bit.  The TPU kernel shifted the formed x_new through an
// SMEM carry and an 8-row halo DMA instead.  The edge is masked by index,
// so any n works.
//
// The per-element arithmetic follows the plain PyTorch version
// (tpu_lbfgs_torch/kernels/fused_ops.py::fused_tail_plain) op for op, and
// the library is built with -fmad=false, so every output vector matches it
// bit for bit; only the sums differ, by their order.
#include "reduce.cuh"
#include "trial_point.cuh"

namespace {

__global__ void __launch_bounds__(tl::kThreads)
    rosenbrock_tail_kernel(const float* __restrict__ x,
                           const float* __restrict__ d,
                           const float* __restrict__ g,
                           const float* __restrict__ alpha,
                           float* __restrict__ x_new, float* __restrict__ g_new,
                           float* __restrict__ s_row, float* __restrict__ y_row,
                           double* __restrict__ partials, int64_t n) {
  const float a = *alpha;
  double acc[7] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float di = d[i];
    const float s = __fmul_rn(a, di);
    const float xn = __fadd_rn(x[i], s);  // = trial_point(x[i], di, a)
    float gn = 0.0f;
    if (i < n - 1) {
      const float xf = tl::trial_point(x[i + 1], d[i + 1], a);
      const float t = xf - xn * xn;
      const float e = 1.0f - xn;
      acc[0] += static_cast<double>(100.0f * t * t + e * e);
      gn = 2.0f * (xn - 1.0f) - 400.0f * xn * t;
    }
    if (i >= 1) {
      const float xp = tl::trial_point(x[i - 1], d[i - 1], a);
      gn += 200.0f * (xn - xp * xp);
    }
    const float gi = g[i];
    const float y = gn - gi;
    x_new[i] = xn;
    g_new[i] = gn;
    s_row[i] = s;
    y_row[i] = y;
    acc[1] += static_cast<double>(s) * y;
    acc[2] += static_cast<double>(y) * y;
    acc[3] += static_cast<double>(gn) * gn;
    acc[4] += static_cast<double>(di) * gn;
    acc[5] += static_cast<double>(gi) * gn;
    acc[6] += static_cast<double>(y) * gn;
  }
  tl::block_sum_to<7>(acc, partials);
}

}  // namespace

// x, d, g, x_new, g_new, s_row, y_row: n floats on the device.  alpha: one
// float on the device.  partials: 7 * tl_max_blocks() doubles of scratch.
// sums: 7 floats, in the order f, s.y, y.y, g_new.g_new, d.g_new, g.g_new,
// y.g_new.  Returns the cudaError_t of the launches.
extern "C" int tl_rosenbrock_fused_tail_f32(
    const float* x, const float* d, const float* g, const float* alpha,
    float* x_new, float* g_new, float* s_row, float* y_row, double* partials,
    float* sums, long long n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = tl::blocks_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rosenbrock_tail_kernel<<<blocks, tl::kThreads, 0, s>>>(
      x, d, g, alpha, x_new, g_new, s_row, y_row, partials, n);
  tl::finish_sums<<<7, tl::kThreads, 0, s>>>(partials, blocks, sums);
  return static_cast<int>(cudaGetLastError());
}
