// The solver's post-line-search tail for a suite problem in one pass.
//
// Replaces the Pallas kernel tpu_lbfgs/kernels/pallas_ops.py
// _make_tail_kernel (run by _fused_tail_pallas) with each body of
// TAIL_BODIES, with and without with_matvec, plain and compensated, with
// the ring rows in float32 or bfloat16.  One kernel, a template on the
// problem's body (bodies.cuh), the history's type and the history depth.
//
// From x, d, g and the accepted step alpha it computes
//   x_new = x + alpha d,   f and g_new at x_new,
//   s = alpha d,   y = g_new - g   (the two ring rows, in the history's type),
// seven sums: f, s.y, y.y, g_new.g_new, d.g_new, g.g_new, y.g_new, and, with
// the matvec, t1 = S y and t2 = Y y over the m rows of the ring as it stands
// before this pair is stored, against the raw float32 y.
//
// Bound by device-memory bytes: 28 bytes move per element (x, d, g in;
// x_new, g_new, s, y out; 24 with bfloat16 rows) for about 40 flops, plus
// the ring's 2 m values per element with the matvec.  So everything the
// iteration needs after the line search comes out of this one read of
// x, d and g, with the sums reduced in the same pass (reduce.cuh).
// alpha is read from device memory: the line search leaves it there and
// the host never waits for it.
//
// A chain-structured body needs the trial point's neighbours x_new[i+-1].
// A thread rebuilds them from x and d (the loads hit lines its warp already
// holds), with the same correctly rounded expression as the thread that
// owns that element (trial_point.cuh), so a neighbour equals its owner's
// x_new bit for bit.  The TPU kernel shifted the formed x_new through an
// SMEM carry and an 8-row halo DMA instead.  The edge is masked by index,
// so any n works.
//
// The matvec.  y exists only in the thread that made g_new, so that thread
// reads S[k][i] and Y[k][i] for every row k (each warp's loads of a row are
// contiguous, and a thread's 2 m loads are independent) and keeps 2 m more
// float64 running sums beside the seven.  m is a template parameter (5, 10
// or 20; 0 for no matvec) so that they stay in registers; their block tree
// runs five sums at a time (reduce.cuh::block_sum_chunks) to keep its shared
// memory small.  The ring is only read: the kernel writes the new rows to
// their own buffers, and the solver stores them after its curvature test
// and patches the slot's own entries of t1 and t2 from the exact sums.
//
// The compensated form (the TPU kernel's `compensated` flag) adds the block
// partials of the seven sums by the Neumaier recurrence in block order
// (reduce.cuh::finish_sums_neumaier); t1 and t2 stay plain, as the TPU
// kernel's do.
//
// The shard-local form (kShard; replaces tpu_lbfgs/dist/pallas_sharded.py
// shardmap_fused_tail's per-shard call of _fused_tail_pallas with n, start
// and edges) runs the same kernel on one shard's blocks of x, d, g and the
// ring: term ownership and the zero-padded tail go by the global index
// (bodies.cuh::Shard), the first and last threads rebuild their outer
// trial-point neighbours from edges = [previous shard's last x and d, next
// shard's first x and d] in device memory with the same trial_point, and
// all 7 + 2 m sums come back as float64, unrounded (compensated: the
// Neumaier sum and its correction added in float64), for the caller's one
// packed float64 all-reduce.  The whole-vector form is the instantiation
// without kShard.
//
// A bfloat16 row is rounded to nearest even, as Tensor.to(torch.bfloat16)
// rounds.  The per-element arithmetic follows the plain PyTorch version
// (tpu_lbfgs_torch/kernels/fused_ops.py::fused_tail_plain) op for op, and
// the library is built with -fmad=false, so every output vector matches it
// bit for bit; only the sums differ, by their order.
#include <cuda_bf16.h>

#include "bodies.cuh"
#include "reduce.cuh"
#include "trial_point.cuh"

namespace {

constexpr int kSums = 7;
constexpr int kMatvecChunk = 5;

__device__ __forceinline__ void store_row(float* row, int64_t i, float v) {
  row[i] = v;
}
__device__ __forceinline__ void store_row(__nv_bfloat16* row, int64_t i,
                                          float v) {
  row[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ double load_row(const float* row, int64_t i) {
  return static_cast<double>(row[i]);
}
__device__ __forceinline__ double load_row(const __nv_bfloat16* row,
                                           int64_t i) {
  return static_cast<double>(__bfloat162float(row[i]));
}

template <typename Body, typename H, int M, bool kShard>
__global__ void __launch_bounds__(tl::kThreads)
    tail_kernel(const float* __restrict__ x, const float* __restrict__ d,
                const float* __restrict__ g, const float* __restrict__ alpha,
                const H* __restrict__ s_hist, const H* __restrict__ y_hist,
                float* __restrict__ x_new, float* __restrict__ g_new,
                H* __restrict__ s_row, H* __restrict__ y_row,
                double* __restrict__ partials, int64_t n, tl::Shard shard) {
  const float a = *alpha;
  double acc[kSums] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  double t[M > 0 ? 2 * M : 1];
#pragma unroll
  for (int k = 0; k < 2 * M; ++k) t[k] = 0.0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float di = d[i];
    const float s = __fmul_rn(a, di);
    const float xn = __fadd_rn(x[i], s);  // = trial_point(x[i], di, a)
    float xp = 0.0f, xf = 0.0f;
    float gn;
    if constexpr (kShard) {
      if constexpr (Body::kNeighbours) {
        xf = i < n - 1 ? tl::trial_point(x[i + 1], d[i + 1], a)
                       : tl::trial_point(shard.edges[2], shard.edges[3], a);
        xp = i >= 1 ? tl::trial_point(x[i - 1], d[i - 1], a)
                    : tl::trial_point(shard.edges[0], shard.edges[1], a);
      }
      const int64_t gi = shard.start + i;
      gn = gi < shard.n_global
               ? Body::fg(xn, xp, xf, gi, shard.n_global, acc[0])
               : 0.0f;
    } else {
      if constexpr (Body::kNeighbours) {
        if (i < n - 1) xf = tl::trial_point(x[i + 1], d[i + 1], a);
        if (i >= 1) xp = tl::trial_point(x[i - 1], d[i - 1], a);
      }
      gn = Body::fg(xn, xp, xf, i, n, acc[0]);
    }
    const float gi = g[i];
    const float y = gn - gi;
    x_new[i] = xn;
    g_new[i] = gn;
    store_row(s_row, i, s);
    store_row(y_row, i, y);
    acc[1] += static_cast<double>(s) * y;
    acc[2] += static_cast<double>(y) * y;
    acc[3] += static_cast<double>(gn) * gn;
    acc[4] += static_cast<double>(di) * gn;
    acc[5] += static_cast<double>(gi) * gn;
    acc[6] += static_cast<double>(y) * gn;
    if constexpr (M > 0) {
      const double yd = static_cast<double>(y);
#pragma unroll
      for (int k = 0; k < M; ++k) {
        const int64_t at = static_cast<int64_t>(k) * n + i;
        t[k] += load_row(s_hist, at) * yd;
        t[M + k] += load_row(y_hist, at) * yd;
      }
    }
  }
  tl::block_sum_to<kSums>(acc, partials);
  if constexpr (M > 0) {
    tl::block_sum_chunks<2 * M, kMatvecChunk>(
        t, partials + static_cast<int64_t>(kSums) * gridDim.x);
  }
}

struct Args {
  const float *x, *d, *g, *alpha;
  const void *s_hist, *y_hist;
  float *x_new, *g_new;
  void *s_row, *y_row;
  double* partials;
  void* sums;  // float for the whole vector, double for a shard
  int64_t n;
  bool compensated;
  cudaStream_t stream;
  tl::Shard shard;
};

// T: the type of the sums, float (rounded once) or double (a shard's
// partials, unrounded).
template <typename T>
void finish(const Args& p, int blocks, int m) {
  T* sums = static_cast<T*>(p.sums);
  if (p.compensated) {
    tl::finish_sums_neumaier<<<kSums, tl::kThreads, 0, p.stream>>>(
        p.partials, blocks, sums);
    if (m > 0) {
      tl::finish_sums<<<2 * m, tl::kThreads, 0, p.stream>>>(
          p.partials + static_cast<int64_t>(kSums) * blocks, blocks,
          sums + kSums);
    }
  } else {
    tl::finish_sums<<<kSums + 2 * m, tl::kThreads, 0, p.stream>>>(
        p.partials, blocks, sums);
  }
}

template <typename Body, typename H, int M, bool kShard>
void launch(const Args& p) {
  const int blocks = tl::blocks_for(p.n);
  tail_kernel<Body, H, M, kShard><<<blocks, tl::kThreads, 0, p.stream>>>(
      p.x, p.d, p.g, p.alpha, static_cast<const H*>(p.s_hist),
      static_cast<const H*>(p.y_hist), p.x_new, p.g_new,
      static_cast<H*>(p.s_row), static_cast<H*>(p.y_row), p.partials, p.n,
      p.shard);
  if (kShard) {
    finish<double>(p, blocks, M);
  } else {
    finish<float>(p, blocks, M);
  }
}

template <typename Body, typename H, bool kShard>
bool launch_m(int m, const Args& p) {
  switch (m) {
    case 0: launch<Body, H, 0, kShard>(p); return true;
    case 5: launch<Body, H, 5, kShard>(p); return true;
    case 10: launch<Body, H, 10, kShard>(p); return true;
    case 20: launch<Body, H, 20, kShard>(p); return true;
    default: return false;
  }
}

template <bool kShard>
int run(int body, int hist_bf16, int m, const Args& p) {
  if (p.n < 1) return static_cast<int>(cudaErrorInvalidValue);
  bool known_m = false;
  const bool known = TL_DISPATCH_BODY(
      body,
      known_m = hist_bf16 ? launch_m<Body, __nv_bfloat16, kShard>(m, p)
                          : launch_m<Body, float, kShard>(m, p));
  if (!known || !known_m) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// body: 0 quadratic, 1 rosenbrock, 2 coupled quadratic.  hist_bf16: nonzero
// when the ring and the two rows are bfloat16, else they are float.  m: 0
// for no matvec (s_hist and y_hist are then not read), else the ring's depth,
// 5, 10 or 20.  compensated: nonzero for the Neumaier stage 2 of the seven
// sums.  x, d, g, x_new, g_new: n floats on the device; s_row, y_row: n ring
// values; s_hist, y_hist: m * n ring values, row-major (m, n); alpha: one
// float on the device.  partials: (7 + 2 m) * tl_max_blocks() doubles of
// scratch.  sums: 7 + 2 m floats, in the order f, s.y, y.y, g_new.g_new,
// d.g_new, g.g_new, y.g_new, t1[0..m), t2[0..m).  Returns the cudaError_t of
// the launches (cudaErrorInvalidValue for n < 1, an unknown body or an m the
// kernel is not built for).
extern "C" int tl_fused_tail_f32(int body, int hist_bf16, int m,
                                 int compensated, const float* x,
                                 const float* d, const float* g,
                                 const float* alpha, const void* s_hist,
                                 const void* y_hist, float* x_new,
                                 float* g_new, void* s_row, void* y_row,
                                 double* partials, float* sums, long long n,
                                 void* stream) {
  const Args p{x, d, g, alpha, s_hist, y_hist, x_new, g_new, s_row, y_row,
               partials, sums, n, compensated != 0,
               static_cast<cudaStream_t>(stream), tl::Shard{}};
  return run<false>(body, hist_bf16, m, p);
}

// The shard-local form: the same arguments over one shard's blocks (n
// elements; s_hist, y_hist (m, n) rows of the shard's ring), then n_global,
// the global unpadded length, start, the block's global offset, and edges,
// 4 floats on the device: [previous shard's last x, its last d, next
// shard's first x, its first d] (read only by a chain-structured body).
// sums: 7 + 2 m doubles, this shard's partials in the order above.
extern "C" int tl_fused_tail_local_f32(
    int body, int hist_bf16, int m, int compensated, const float* x,
    const float* d, const float* g, const float* alpha, const void* s_hist,
    const void* y_hist, float* x_new, float* g_new, void* s_row, void* y_row,
    double* partials, double* sums, long long n, long long n_global,
    long long start, const float* edges, void* stream) {
  if (start < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args p{x, d, g, alpha, s_hist, y_hist, x_new, g_new, s_row, y_row,
               partials, sums, n, compensated != 0,
               static_cast<cudaStream_t>(stream),
               tl::Shard{n_global, start, edges}};
  return run<true>(body, hist_bf16, m, p);
}
