// A suite problem's objective at K line-search trial points in one pass over
// (x, d):
//
//   phi_k = f(x + alpha_k d),   k < K.
//
// Replaces the Pallas kernel tpu_lbfgs/kernels/pallas_ops.py
// _make_multi_phi_kernel with the bodies _f_quadratic, _f_rosenbrock and
// _f_coupled (run by _multi_phi_pallas through make_multi_phi), the
// evaluator of the speculative Armijo search (backtracking_speculative).
// One kernel, a template on the problem's body (bodies.cuh).
//
// 8 bytes per element (x and d in) feed all K trials, 4 to 12 float32
// operations each, and only K floats come out.  Each thread loads x[i],
// d[i] and, for a chain-structured body, the forward neighbour x[i+1],
// d[i+1] (from the lines its warp already holds; the TPU kernel needed an
// SMEM carry and a halo DMA) and forms the trial points in registers with
// the correctly rounded trial_point, so the neighbour's value equals its
// owner's.  The alphas are read from device memory: the search builds its
// ladder there and the host never reads it.  On an H100 the Rosenbrock body
// reads at 0.57 TB/s at K = 8 (14.8 us at n = 2^20), so the bytes do not
// bound it: each term's conversion to float64 and its float64 add, kept so
// that the sums equal the plain version's, are the likely bound.
//
// K is a runtime count.  Each row of blocks (blockIdx.y) takes
// kTrialsPerRow trials, so a thread holds that many float64 sums and no
// more; at larger K the rows re-read x and d, mostly from L2 (8 MB at
// n = 2^20).  The sums reduce per block in float64 and then per trial in
// a fixed order (reduce.cuh), with no float atomics.  The edge is masked
// by index, so any n works.
//
// The shard-local form (kShard; replaces tpu_lbfgs/dist/pallas_sharded.py
// shardmap_multi_phi's per-shard call of _multi_phi_pallas with n, start
// and edges) runs the same kernel on one shard's blocks of x and d: a term
// exists where the global index start + i says so against the global
// unpadded length (bodies.cuh::Shard), the last thread takes its forward
// neighbour from edges = [next shard's first x, its first d] in device
// memory, and the K sums come back as float64, unrounded, for the caller's
// one float64 all-reduce.  The whole-vector form is the instantiation
// without kShard.
//
// The terms are those of the plain PyTorch version
// (tpu_lbfgs_torch/kernels/line_search_ops.py::multi_phi_plain with
// fused_ops.F_PLAIN), op for op, and the library is built with
// -fmad=false, so the two differ only by the order of float64 additions.
#include "bodies.cuh"
#include "reduce.cuh"
#include "trial_point.cuh"

namespace {

constexpr int kTrialsPerRow = 8;
constexpr int kMaxRows = 65535;  // gridDim.y

template <typename Body, bool kShard>
__global__ void __launch_bounds__(tl::kThreads)
    multi_phi_kernel(const float* __restrict__ x, const float* __restrict__ d,
                     const float* __restrict__ alphas, int num_trials,
                     double* __restrict__ partials, int64_t n,
                     tl::Shard shard) {
  const int k0 = blockIdx.y * kTrialsPerRow;
  const int count = min(kTrialsPerRow, num_trials - k0);
  float a[kTrialsPerRow];
  double acc[kTrialsPerRow];
#pragma unroll
  for (int j = 0; j < kTrialsPerRow; ++j) {
    a[j] = j < count ? alphas[k0 + j] : 0.0f;
    acc[j] = 0.0;
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // Element i owns term i; where a term needs element i + 1 and the last
  // element owns none (Rosenbrock), the loop ends before it.
  // A shard's block ends where its terms do: the global count of terms,
  // seen from this block's offset.
  const int64_t terms =
      kShard ? min(n, Body::terms(shard.n_global) - shard.start)
             : Body::terms(n);
  const int64_t n_total = kShard ? shard.n_global : n;
  const int64_t offset = kShard ? shard.start : 0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < terms; i += stride) {
    const float xi = x[i], di = d[i];
    float xf = 0.0f, df = 0.0f;
    if constexpr (Body::kNeighbours) {
      if constexpr (kShard) {
        xf = i < n - 1 ? x[i + 1] : shard.edges[0];
        df = i < n - 1 ? d[i + 1] : shard.edges[1];
      } else if (terms < n || i < n - 1) {
        xf = x[i + 1];
        df = d[i + 1];
      }
    }
#pragma unroll
    for (int j = 0; j < kTrialsPerRow; ++j) {
      const float u = tl::trial_point(xi, di, a[j]);
      const float uf =
          Body::kNeighbours ? tl::trial_point(xf, df, a[j]) : 0.0f;
      acc[j] += static_cast<double>(Body::f(u, uf, offset + i, n_total));
    }
  }
  tl::block_sum_to<kTrialsPerRow>(
      acc, partials + static_cast<int64_t>(k0) * gridDim.x, count);
}

}  // namespace

// body: 0 quadratic, 1 rosenbrock, 2 coupled quadratic.  x, d: n floats on
// the device.  alphas: num_trials floats on the device.  partials:
// num_trials * tl_max_blocks() doubles of scratch.  out: num_trials floats,
// phi at each alpha.  Returns the cudaError_t of the launches
// (cudaErrorInvalidValue for n < 1, an unknown body or a num_trials outside
// [1, kTrialsPerRow * 65535]).
extern "C" int tl_multi_phi_f32(int body, const float* x, const float* d,
                                const float* alphas, int num_trials,
                                double* partials, float* out, long long n,
                                void* stream) {
  const int rows = (num_trials + kTrialsPerRow - 1) / kTrialsPerRow;
  if (n < 1 || num_trials < 1 || rows > kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = tl::blocks_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool known = TL_DISPATCH_BODY(
      body,
      multi_phi_kernel<Body, false>
      <<<dim3(blocks, rows), tl::kThreads, 0, s>>>(x, d, alphas, num_trials,
                                                   partials, n, tl::Shard{}));
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  tl::finish_sums<<<num_trials, tl::kThreads, 0, s>>>(partials, blocks, out);
  return static_cast<int>(cudaGetLastError());
}

// The shard-local form: x, d are one shard's n elements; n_global is the
// global unpadded length, start the block's global offset, edges 2 floats
// on the device, [next shard's first x, its first d] (read only by a
// chain-structured body).  out: num_trials doubles, this shard's partials.
extern "C" int tl_multi_phi_local_f32(int body, const float* x, const float* d,
                                      const float* alphas, int num_trials,
                                      double* partials, double* out,
                                      long long n, long long n_global,
                                      long long start, const float* edges,
                                      void* stream) {
  const int rows = (num_trials + kTrialsPerRow - 1) / kTrialsPerRow;
  if (n < 1 || start < 0 || num_trials < 1 || rows > kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = tl::blocks_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const tl::Shard shard{n_global, start, edges};
  const bool known = TL_DISPATCH_BODY(
      body,
      multi_phi_kernel<Body, true>
      <<<dim3(blocks, rows), tl::kThreads, 0, s>>>(x, d, alphas, num_trials,
                                                   partials, n, shard));
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  tl::finish_sums<<<num_trials, tl::kThreads, 0, s>>>(partials, blocks, out);
  return static_cast<int>(cudaGetLastError());
}
