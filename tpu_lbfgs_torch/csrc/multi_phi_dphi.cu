// A suite problem's value and directional derivative at K line-search trial
// points in one pass over (x, d):
//
//   phi_k = f(u),  dphi_k = grad f(u) . d,   u = x + alpha_k d,   k < K.
//
// Replaces the Pallas kernel tpu_lbfgs/kernels/pallas_ops.py
// _make_multi_phi_dphi_kernel with the bodies _body_quadratic,
// _body_rosenbrock and _body_coupled (run by _multi_phi_dphi_pallas through
// make_multi_phi_dphi), the evaluator of the speculative Wolfe searches
// (wolfe_interpolation_speculative and backtracking_wolfe_speculative,
// whose tree is 36 trials at the default spec_width).  One kernel, a
// template on the problem's body (bodies.cuh).
//
// Bound by operations: 8 bytes per element (x and d in) feed every trial,
// for the Rosenbrock body about 25 float32 and 5 float64 operations each
// (no fused multiply-add), and 2K floats come out; at K = 36 some 900
// float32 operations per element (103 us at n = 2^20 on an H100, 28 us at
// K = 8).  Each thread loads x[i], d[i] and, for a chain-structured body,
// both neighbours x[i-1], d[i-1], x[i+1], d[i+1] (from lines its warp
// already holds; the TPU kernel carried them through SMEM and a halo DMA)
// and rebuilds each trial's neighbours with the correctly rounded
// trial_point, so they equal their owners' values.  The alphas are read
// from device memory: the search builds its ladder there and the host never
// reads it.
//
// K is a runtime count.  Each row of blocks (blockIdx.y) takes
// kTrialsPerRow trials, so a thread holds 2 kTrialsPerRow float64 sums and
// no more; the rows re-read x and d, mostly from L2.  Sums reduce per block
// in float64 and then per output in a fixed order (reduce.cuh), with no
// float atomics.  The edge is masked by index, so any n works.
//
// The shard-local form (kShard; replaces tpu_lbfgs/dist/pallas_sharded.py
// shardmap_multi_phi_dphi's per-shard call of _multi_phi_dphi_pallas with
// n, start and edges) runs the same kernel on one shard's blocks of x and
// d: term ownership and the zero-padded tail go by the global index
// (bodies.cuh::Shard), the first and last threads take their outer
// neighbours from edges = [previous shard's last x and d, next shard's
// first x and d] in device memory, and the 2 K sums come back as float64,
// unrounded, for the caller's one float64 all-reduce.  The whole-vector
// form is the instantiation without kShard.
//
// The gradient terms are those of the plain PyTorch version
// (tpu_lbfgs_torch/kernels/line_search_ops.py::multi_phi_dphi_plain with
// fused_ops.VG_PLAIN), op for op, and the library is built with
// -fmad=false; g . d adds the exact float64 products g_i d_i, as the plain
// version's float64 dot does.
#include "bodies.cuh"
#include "reduce.cuh"
#include "trial_point.cuh"

namespace {

constexpr int kTrialsPerRow = 8;
constexpr int kMaxRows = 65535;  // gridDim.y

// Four blocks to an SM (64 registers a thread): the kernel waits on its
// float-to-double conversions, so the fourth block is worth more than the
// few registers it spills (Rosenbrock, K = 36, d = 2^20 on an H100: 100.5 us
// against 115.3 us at the 72 registers the compiler takes unasked).
template <typename Body, bool kShard>
__global__ void __launch_bounds__(tl::kThreads, 4)
    multi_phi_dphi_kernel(const float* __restrict__ x,
                          const float* __restrict__ d,
                          const float* __restrict__ alphas, int num_trials,
                          double* __restrict__ partials, int64_t n,
                          tl::Shard shard) {
  const int k0 = blockIdx.y * kTrialsPerRow;
  const int count = min(kTrialsPerRow, num_trials - k0);
  float a[kTrialsPerRow];
  double f_acc[kTrialsPerRow], g_acc[kTrialsPerRow];
#pragma unroll
  for (int j = 0; j < kTrialsPerRow; ++j) {
    a[j] = j < count ? alphas[k0 + j] : 0.0f;
    f_acc[j] = 0.0;
    g_acc[j] = 0.0;
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float xi = x[i], di = d[i];
    float xf = 0.0f, df = 0.0f, xp = 0.0f, dp = 0.0f;
    if constexpr (Body::kNeighbours) {
      if constexpr (kShard) {
        xf = i < n - 1 ? x[i + 1] : shard.edges[2];
        df = i < n - 1 ? d[i + 1] : shard.edges[3];
        xp = i >= 1 ? x[i - 1] : shard.edges[0];
        dp = i >= 1 ? d[i - 1] : shard.edges[1];
      } else {
        if (i < n - 1) {
          xf = x[i + 1];
          df = d[i + 1];
        }
        if (i >= 1) {
          xp = x[i - 1];
          dp = d[i - 1];
        }
      }
    }
    // An element of the zero-padded tail owns no term and has no gradient.
    if constexpr (kShard) {
      if (shard.start + i >= shard.n_global) continue;
    }
    const int64_t at = kShard ? shard.start + i : i;
    const int64_t n_total = kShard ? shard.n_global : n;
#pragma unroll
    for (int j = 0; j < kTrialsPerRow; ++j) {
      const float u = tl::trial_point(xi, di, a[j]);
      float uf = 0.0f, up = 0.0f;
      if constexpr (Body::kNeighbours) {
        uf = tl::trial_point(xf, df, a[j]);
        up = tl::trial_point(xp, dp, a[j]);
      }
      const float gi = Body::fg(u, up, uf, at, n_total, f_acc[j]);
      g_acc[j] += static_cast<double>(gi) * di;
    }
  }
  const int64_t nb = gridDim.x;
  tl::block_sum_to<kTrialsPerRow>(f_acc, partials + k0 * nb, count);
  tl::block_sum_to<kTrialsPerRow>(
      g_acc, partials + (static_cast<int64_t>(num_trials) + k0) * nb, count);
}

}  // namespace

// body: 0 quadratic, 1 rosenbrock, 2 coupled quadratic.  x, d: n floats on
// the device.  alphas: num_trials floats on the device.  partials:
// 2 * num_trials * tl_max_blocks() doubles of scratch.  out: 2 * num_trials
// floats, phi at each alpha and then dphi at each alpha.  Returns the
// cudaError_t of the launches (cudaErrorInvalidValue for n < 1, an unknown
// body or a num_trials outside [1, kTrialsPerRow * 65535]).
extern "C" int tl_multi_phi_dphi_f32(int body, const float* x, const float* d,
                                     const float* alphas, int num_trials,
                                     double* partials, float* out,
                                     long long n, void* stream) {
  const int rows = (num_trials + kTrialsPerRow - 1) / kTrialsPerRow;
  if (n < 1 || num_trials < 1 || rows > kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = tl::blocks_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool known = TL_DISPATCH_BODY(
      body,
      multi_phi_dphi_kernel<Body, false>
      <<<dim3(blocks, rows), tl::kThreads, 0, s>>>(x, d, alphas, num_trials,
                                                   partials, n, tl::Shard{}));
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  tl::finish_sums<<<2 * num_trials, tl::kThreads, 0, s>>>(partials, blocks,
                                                          out);
  return static_cast<int>(cudaGetLastError());
}

// The shard-local form: x, d are one shard's n elements; n_global is the
// global unpadded length, start the block's global offset, edges 4 floats
// on the device, [previous shard's last x, its last d, next shard's first
// x, its first d] (read only by a chain-structured body).  out: 2 *
// num_trials doubles, this shard's partials of phi and then of dphi.
extern "C" int tl_multi_phi_dphi_local_f32(
    int body, const float* x, const float* d, const float* alphas,
    int num_trials, double* partials, double* out, long long n,
    long long n_global, long long start, const float* edges, void* stream) {
  const int rows = (num_trials + kTrialsPerRow - 1) / kTrialsPerRow;
  if (n < 1 || start < 0 || num_trials < 1 || rows > kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = tl::blocks_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const tl::Shard shard{n_global, start, edges};
  const bool known = TL_DISPATCH_BODY(
      body,
      multi_phi_dphi_kernel<Body, true>
      <<<dim3(blocks, rows), tl::kThreads, 0, s>>>(x, d, alphas, num_trials,
                                                   partials, n, shard));
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  tl::finish_sums<<<2 * num_trials, tl::kThreads, 0, s>>>(partials, blocks,
                                                          out);
  return static_cast<int>(cudaGetLastError());
}
