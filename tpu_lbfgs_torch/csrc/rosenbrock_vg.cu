// Chained Rosenbrock: f(x) and its analytic gradient in one read of x.
//
// Replaces the Pallas kernel tpu_lbfgs/kernels/pallas_ops.py
// _vg_rosenbrock_kernel (run by _run_vg through fused_vg_rosenbrock).
//
//   f   = sum_{i<n-1} 100 t_i^2 + (1 - x_i)^2,   t_i = x_{i+1} - x_i^2
//   g_i = [i<n-1] (2 (x_i - 1) - 400 x_i t_i) + [i>=1] 200 (x_i - x_{i-1}^2)
//
// Bound by device-memory bytes: 8 bytes move per element (x in, g out) for
// about 15 flops.  So the design reads x once and writes g once: each
// thread loads x[i-1] and x[i+1] beside x[i], and those neighbour loads hit
// the lines its warp already brought into L1, where the TPU kernel needed an
// SMEM carry and an 8-row halo DMA.  f is reduced in the same pass (see
// reduce.cuh).  The edge is masked by index, so any n works; there is no
// (R, 128) padding.
//
// The per-element arithmetic is written in the order of the plain PyTorch
// version (tpu_lbfgs_torch/kernels/fused_ops.py::rosenbrock_vg_plain), and
// the library is built with -fmad=false, so g matches it bit for bit.
#include "reduce.cuh"

namespace {

__global__ void __launch_bounds__(tl::kThreads)
    rosenbrock_vg_kernel(const float* __restrict__ x, float* __restrict__ g,
                         double* __restrict__ partials, int64_t n) {
  double acc[1] = {0.0};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float xi = x[i];
    float gi = 0.0f;
    if (i < n - 1) {
      const float t = x[i + 1] - xi * xi;
      const float e = 1.0f - xi;
      acc[0] += static_cast<double>(100.0f * t * t + e * e);
      gi = 2.0f * (xi - 1.0f) - 400.0f * xi * t;
    }
    if (i >= 1) {
      const float xp = x[i - 1];
      gi += 200.0f * (xi - xp * xp);
    }
    g[i] = gi;
  }
  tl::block_sum_to<1>(acc, partials);
}

}  // namespace

// x, g: n floats on the device.  partials: tl_max_blocks() doubles of
// scratch.  f: 1 float.  Returns the cudaError_t of the launches.
extern "C" int tl_rosenbrock_vg_f32(const float* x, float* g, double* partials,
                                    float* f, long long n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = tl::blocks_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rosenbrock_vg_kernel<<<blocks, tl::kThreads, 0, s>>>(x, g, partials, n);
  tl::finish_sums<1><<<1, tl::kThreads, 0, s>>>(partials, blocks, f);
  return static_cast<int>(cudaGetLastError());
}
