// A suite problem's f(x) and analytic gradient in one read of x.
//
// Replaces the Pallas kernels tpu_lbfgs/kernels/pallas_ops.py
// _vg_quadratic_kernel, _vg_rosenbrock_kernel and _vg_coupled_kernel (run by
// _run_vg through fused_vg_quadratic, fused_vg_rosenbrock and
// fused_vg_coupled_quadratic).  One kernel, a template on the problem's body
// (bodies.cuh).
//
// Bound by device-memory bytes: 8 bytes move per element (x in, g out) for
// 3 to 15 flops.  So the design reads x once and writes g once: for a
// chain-structured body each thread loads x[i-1] and x[i+1] beside x[i], and
// those neighbour loads hit the lines its warp already brought into L1,
// where the TPU kernels needed an SMEM carry and an 8-row halo DMA.  f is
// reduced in the same pass (see reduce.cuh).  The edge is masked by index,
// so any n works; there is no (R, 128) padding.
//
// The per-element arithmetic is written in the order of the plain PyTorch
// versions (tpu_lbfgs_torch/kernels/fused_ops.py::VG_PLAIN), and the library
// is built with -fmad=false, so g matches them bit for bit.
//
// The shard-local form (kShard; replaces tpu_lbfgs/dist/pallas_sharded.py
// shardmap_fused_vg's per-shard call of local_fused_vg) runs the same
// kernel on one shard's block of x: element i has the global index
// start + i, a term exists where that index says so against the global
// unpadded length n_global (a zero-padded tail contributes nothing and gets
// zero gradient), and the first and last threads take their outer
// neighbours from edges = [previous shard's last x, next shard's first x]
// in device memory.  Its f is the float64 sum, unrounded: the caller adds
// the shards' partials in one float64 all-reduce and rounds once.  The
// whole-vector form is the instantiation without kShard.
#include "bodies.cuh"
#include "reduce.cuh"

namespace {

template <typename Body, bool kShard>
__global__ void __launch_bounds__(tl::kThreads)
    vg_kernel(const float* __restrict__ x, float* __restrict__ g,
              double* __restrict__ partials, int64_t n, tl::Shard shard) {
  double acc[1] = {0.0};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float xi = x[i];
    float xp = 0.0f, xf = 0.0f;
    if constexpr (kShard) {
      if constexpr (Body::kNeighbours) {
        xf = i < n - 1 ? x[i + 1] : shard.edges[1];
        xp = i >= 1 ? x[i - 1] : shard.edges[0];
      }
      const int64_t gi = shard.start + i;
      g[i] = gi < shard.n_global
                 ? Body::fg(xi, xp, xf, gi, shard.n_global, acc[0])
                 : 0.0f;
    } else {
      if constexpr (Body::kNeighbours) {
        if (i < n - 1) xf = x[i + 1];
        if (i >= 1) xp = x[i - 1];
      }
      g[i] = Body::fg(xi, xp, xf, i, n, acc[0]);
    }
  }
  tl::block_sum_to<1>(acc, partials);
}

}  // namespace

// body: 0 quadratic, 1 rosenbrock, 2 coupled quadratic.  x, g: n floats on
// the device.  partials: tl_max_blocks() doubles of scratch.  f: 1 float.
// Returns the cudaError_t of the launches.
extern "C" int tl_fused_vg_f32(int body, const float* x, float* g,
                               double* partials, float* f, long long n,
                               void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = tl::blocks_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool known = TL_DISPATCH_BODY(
      body, vg_kernel<Body, false><<<blocks, tl::kThreads, 0, s>>>(
                x, g, partials, n, tl::Shard{}));
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  tl::finish_sums<<<1, tl::kThreads, 0, s>>>(partials, blocks, f);
  return static_cast<int>(cudaGetLastError());
}

// The shard-local form.  x, g: n floats, one shard's block.  n_global: the
// global unpadded length; start: the block's global offset; edges: 2 floats
// on the device, [previous shard's last x, next shard's first x] (read only
// by a chain-structured body).  f: 1 double, this shard's partial.
extern "C" int tl_fused_vg_local_f32(int body, const float* x, float* g,
                                     double* partials, double* f, long long n,
                                     long long n_global, long long start,
                                     const float* edges, void* stream) {
  if (n < 1 || start < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = tl::blocks_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const tl::Shard shard{n_global, start, edges};
  const bool known = TL_DISPATCH_BODY(
      body, vg_kernel<Body, true><<<blocks, tl::kThreads, 0, s>>>(
                x, g, partials, n, shard));
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  tl::finish_sums<<<1, tl::kThreads, 0, s>>>(partials, blocks, f);
  return static_cast<int>(cudaGetLastError());
}
