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
// 8 bytes per element (x and d in) feed all K trials, 4 to 13 float32
// operations each and a float64 add, and only K floats come out: 2.50 us
// of bytes at n = 2^20, and at K = 36 7.3 us of operations (14.6 without
// contraction; the library is built with -fmad=false).
//
// The first design, one element per thread per step, 8 trials to a row of
// blocks and 1024 blocks to a row, each thread loading its forward
// neighbour and rebuilding two trial points per element and trial, took
// 14.52 us at K = 8 and 43.72 at K = 36 (NVIDIA H100 80GB HBM3, 700 W).
// Its header named the float64 conversions as the likely bound; ablations
// of it said otherwise: skipping its block trees (eight 8-level
// shared-memory trees per block) took 22-28% off, one wave of blocks in
// place of 1024 a row 7-30%, float32 sums 7-12% (none for the quadratic),
// 16-byte loads alone nothing (+12% at K = 36), and folding the second
// stage into the first by a last-block ticket cost 2-11%.
//
// This design carries over multi_phi_dphi.cu's:
// - each thread owns a run of kRun consecutive elements of a tile, loaded
//   16 bytes at a time, with the element just after it from the next lane
//   by shuffle (one load at a warp's edge), so a trial forms kRun + 1
//   trial points a run, about one per element, with the correctly rounded
//   trial_point, equal to their owners' values; the TPU kernel carried the
//   neighbour through SMEM and a halo DMA;
// - a run whose elements all have a term and their forward neighbour takes
//   the bodies' f<true>, with no index test and no branch per element and
//   trial;
// - kTrials trials to a row of blocks (8 for K <= 8, kWide above), their
//   float64 sums in registers, and the rows' blocks together one wave (at
//   K = 8 the 8-wide row, four blocks an SM, is 0-6% faster than an
//   18-wide one at two; at K = 36 18 a row beat 12 and 36);
// - the block sums by warp shuffles, once per block
//   (reduce.cuh::block_sum_warps), then one block per trial sums the
//   partials in a fixed order (reduce.cuh::finish_sums).
// K is a runtime count; at larger K the rows re-read x and d, mostly from
// L2.  No float atomics.  The edge is masked by index, so any n works.
//
// The shard-local form (kShard; replaces tpu_lbfgs/dist/pallas_sharded.py
// shardmap_multi_phi's per-shard call of _multi_phi_pallas with n, start
// and edges) runs the same kernel on one shard's blocks of x and d: a term
// exists where the global index start + i says so against the global
// unpadded length (bodies.cuh::Shard), element n (one past the block) is
// edges = [next shard's first x, its first d] in device memory, and the K
// sums come back as float64, unrounded, for the caller's one float64
// all-reduce.  The whole-vector form is the instantiation without kShard.
//
// The batched shard-local form (kShard and kBatched,
// tl_multi_phi_local_batched_f32; the reference's jax.vmap over
// shardmap_multi_phi, as sharded_vmap_minimize runs it) takes B lanes of
// one shard's blocks, (B, n) rows of x and d, each lane with its own K
// alphas, (B, K), and its own edges row of (B, 2); the lanes share start
// and n_global.  Each row of blocks takes its trials of every lane on the
// batched walk (reduce.cuh: block b on lane b / parts), so a lane's terms
// and its next edge stay its own, and stage 2 is one thread per (trial,
// lane) (reduce.cuh::finish_rows): (K, B) float64 partials, unrounded.
//
// The terms are those of the plain PyTorch version
// (tpu_lbfgs_torch/kernels/line_search_ops.py::multi_phi_plain with
// fused_ops.F_PLAIN), op for op, and the library is built with
// -fmad=false, so the two differ only by the order of float64 additions.
#include "bodies.cuh"
#include "reduce.cuh"
#include "trial_point.cuh"

namespace {

constexpr int kWide = 18;        // trials a row above K = 8
constexpr int kMaxRows = 65535;  // gridDim.y
constexpr int kRun = 4;          // consecutive elements per thread and tile
constexpr int kTile = tl::kThreads * kRun;
constexpr int kSMs = 132;        // an H100's
constexpr unsigned kFull = 0xffffffffu;

// Blocks of one SM, and so of all rows together one wave, by what the
// kernel's registers allow at each row width (-Xptxas -v).
template <int kTrials>
constexpr int kBlocksPerSM = kTrials <= 8 ? 4 : 2;

template <int kTrials>
int row_blocks(int64_t n, int rows) {
  constexpr int budget = kBlocksPerSM<kTrials> * kSMs;
  static_assert(budget <= tl::kMaxBlocks, "partials hold kMaxBlocks");
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t cap = budget / rows > 1 ? budget / rows : 1;
  return static_cast<int>(tiles < cap ? tiles : cap);
}

// xs[0..kRun), ds[0..kRun) hold this thread's run and xs[kRun], ds[kRun]
// the element just after it, from the next lane by shuffle (one load at a
// warp's edge).  Elements at and beyond n hold 0 (a body reads its forward
// neighbour behind its index test only), but a shard's element n is the
// edge.
template <typename Body, bool kShard>
__device__ __forceinline__ void load_run(const float* __restrict__ x,
                                         const float* __restrict__ d,
                                         int64_t i0, int64_t n, bool vec,
                                         const tl::Shard& shard,
                                         float (&xs)[kRun + 1],
                                         float (&ds)[kRun + 1]) {
  if (vec && i0 + kRun <= n) {
    const float4 xq = *reinterpret_cast<const float4*>(x + i0);
    const float4 dq = *reinterpret_cast<const float4*>(d + i0);
    xs[0] = xq.x; xs[1] = xq.y; xs[2] = xq.z; xs[3] = xq.w;
    ds[0] = dq.x; ds[1] = dq.y; ds[2] = dq.z; ds[3] = dq.w;
  } else {
#pragma unroll
    for (int e = 0; e < kRun; ++e) {
      xs[e] = i0 + e < n ? x[i0 + e] : 0.0f;
      ds[e] = i0 + e < n ? d[i0 + e] : 0.0f;
    }
  }
  xs[kRun] = ds[kRun] = 0.0f;
  if constexpr (Body::kNeighbours) {
    if constexpr (kShard) {
#pragma unroll
      for (int e = 0; e < kRun; ++e) {
        if (i0 + e == n) {
          xs[e] = shard.edges[0];
          ds[e] = shard.edges[1];
        }
      }
    }
    xs[kRun] = __shfl_down_sync(kFull, xs[0], 1);
    ds[kRun] = __shfl_down_sync(kFull, ds[0], 1);
    if ((threadIdx.x & 31) == 31) {
      xs[kRun] = ds[kRun] = 0.0f;
      if (i0 + kRun < n) {
        xs[kRun] = x[i0 + kRun];
        ds[kRun] = d[i0 + kRun];
      } else if (kShard && i0 + kRun == n) {
        xs[kRun] = shard.edges[0];
        ds[kRun] = shard.edges[1];
      }
    }
  }
}

// Adds one run's terms of the row's trials to acc.  kInterior: every
// element of the run owns a term and has its forward neighbour, so the
// index tests drop out of the unrolled code.
template <typename Body, bool kInterior, int kTrials>
__device__ __forceinline__ void add_run(const float (&xs)[kRun + 1],
                                        const float (&ds)[kRun + 1],
                                        const float* a, int count,
                                        int64_t i0, int64_t terms,
                                        int64_t at0, int64_t n_total,
                                        double (&acc)[kTrials]) {
#pragma unroll
  for (int j = 0; j < kTrials; ++j) {
    if (j >= count) break;
    const float aj = a[j];
    float u[kRun + 1];
#pragma unroll
    for (int e = 0; e <= kRun; ++e) {
      u[e] = Body::kNeighbours || e < kRun
                 ? tl::trial_point(xs[e], ds[e], aj)
                 : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kRun; ++e) {
      if (!kInterior && i0 + e >= terms) break;
      acc[j] += static_cast<double>(
          Body::template f<kInterior>(u[e], u[e + 1], at0 + e, n_total));
    }
  }
}

// Row blockIdx.y takes trials k0 .. k0 + kTrials of the K; each thread
// keeps the sum of each in double over every run it owns, and the block
// sums them once, at the end, by warp shuffles.  kBatched: the batched walk
// over lanes of x, d, alphas and edges (the header); one instance is lane 0
// of a plain walk.
template <typename Body, bool kShard, bool kBatched, int kTrials>
__global__ void __launch_bounds__(tl::kThreads, kBlocksPerSM<kTrials>)
    multi_phi_kernel(const float* __restrict__ x, const float* __restrict__ d,
                     const float* __restrict__ alphas, int num_trials,
                     double* __restrict__ partials, int64_t n, bool vec,
                     tl::Shard shard, int parts) {
  __shared__ float a[kTrials];
  const tl::Walk w = tl::walk<kBatched>(parts);
  if constexpr (kBatched) {
    x += w.lane * n;
    d += w.lane * n;
    alphas += w.lane * num_trials;
    if constexpr (kShard) shard.edges += 2 * w.lane;
  }
  const int k0 = blockIdx.y * kTrials;
  const int count = min(kTrials, num_trials - k0);
  const int t = threadIdx.x;
  if (t < kTrials) a[t] = t < count ? alphas[k0 + t] : 0.0f;
  __syncthreads();
  double acc[kTrials];
#pragma unroll
  for (int j = 0; j < kTrials; ++j) acc[j] = 0.0;
  // A shard's block ends where its terms do: the global count of terms,
  // seen from this block's offset.
  const int64_t terms =
      kShard ? min(n, Body::terms(shard.n_global) - shard.start)
             : Body::terms(n);
  const int64_t start = kShard ? shard.start : 0;
  const int64_t n_total = kShard ? shard.n_global : n;
  for (int64_t base = w.first * kTile; base < terms; base += w.step * kTile) {
    const int64_t i0 = base + static_cast<int64_t>(threadIdx.x) * kRun;
    float xs[kRun + 1], ds[kRun + 1];
    load_run<Body, kShard>(x, d, i0, n, vec, shard, xs, ds);
    if (i0 + kRun <= terms && start + i0 + kRun < n_total) {
      add_run<Body, true, kTrials>(xs, ds, a, count, i0, terms, start + i0,
                                   n_total, acc);
    } else {
      add_run<Body, false, kTrials>(xs, ds, a, count, i0, terms, start + i0,
                                    n_total, acc);
    }
  }
  tl::block_sum_warps<kTrials>(
      acc, partials + static_cast<int64_t>(k0) * gridDim.x, count);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Launches both stages: the kernel at kTrials trials a row, then one block
// per trial over its partials.
template <bool kShard, int kTrials, typename Out>
int launch_rows(int body, const float* x, const float* d,
                const float* alphas, int num_trials, double* partials,
                Out* out, long long n, cudaStream_t s,
                const tl::Shard& shard) {
  const int rows = (num_trials + kTrials - 1) / kTrials;
  if (n < 1 || num_trials < 1 || rows > kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = row_blocks<kTrials>(n, rows);
  const bool vec = aligned16(x) && aligned16(d);
  const bool known = TL_DISPATCH_BODY(
      body, multi_phi_kernel<Body, kShard, false, kTrials>
      <<<dim3(blocks, rows), tl::kThreads, 0, s>>>(
          x, d, alphas, num_trials, partials, n, vec, shard, 0));
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  tl::finish_sums<<<num_trials, tl::kThreads, 0, s>>>(partials, blocks, out);
  return static_cast<int>(cudaGetLastError());
}

// The batched shard-local form at kTrials trials a row: each row of blocks
// walks every lane, parts blocks a lane, its row's share of one wave
// between them; then finish_rows over the (trial, lane) rows.
template <int kTrials>
int launch_rows_batched(int body, const float* x, const float* d,
                        const float* alphas, int num_trials,
                        double* partials, double* out, long long lanes,
                        long long n, cudaStream_t s, const tl::Shard& shard) {
  const int rows = (num_trials + kTrials - 1) / kTrials;
  if (n < 1 || num_trials < 1 || rows > kMaxRows || lanes < 1 ||
      lanes > tl::kMaxLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int budget = kBlocksPerSM<kTrials> * kSMs / rows;
  const int parts = tl::lane_parts(lanes, (n + kTile - 1) / kTile,
                                   budget > 1 ? budget : 1);
  const unsigned grid = static_cast<unsigned>(lanes * parts);
  // Every row starts 16-byte aligned only if n floats fill whole 16 bytes.
  const bool vec = aligned16(x) && aligned16(d) && n % 4 == 0;
  const bool known = TL_DISPATCH_BODY(
      body, multi_phi_kernel<Body, true, true, kTrials>
      <<<dim3(grid, rows), tl::kThreads, 0, s>>>(
          x, d, alphas, num_trials, partials, n, vec, shard, parts));
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  tl::launch_finish_rows<double>(partials, nullptr, parts,
                                 static_cast<int64_t>(num_trials) * lanes,
                                 false, out, s);
  return static_cast<int>(cudaGetLastError());
}

template <bool kShard, typename Out>
int launch(int body, const float* x, const float* d, const float* alphas,
           int num_trials, double* partials, Out* out, long long n,
           void* stream, const tl::Shard& shard) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return num_trials <= 8
             ? launch_rows<kShard, 8>(body, x, d, alphas, num_trials,
                                      partials, out, n, s, shard)
             : launch_rows<kShard, kWide>(body, x, d, alphas, num_trials,
                                          partials, out, n, s, shard);
}

}  // namespace

// body: 0 quadratic, 1 rosenbrock, 2 coupled quadratic.  x, d: n floats on
// the device.  alphas: num_trials floats on the device.  partials:
// num_trials * tl_max_blocks() doubles of scratch.  out: num_trials floats,
// phi at each alpha.  Returns the cudaError_t of the launches
// (cudaErrorInvalidValue for n < 1, an unknown body or a num_trials outside
// [1, kWide * 65535]).
extern "C" int tl_multi_phi_f32(int body, const float* x, const float* d,
                                const float* alphas, int num_trials,
                                double* partials, float* out, long long n,
                                void* stream) {
  return launch<false>(body, x, d, alphas, num_trials, partials, out, n,
                       stream, tl::Shard{});
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
  if (start < 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(body, x, d, alphas, num_trials, partials, out, n,
                      stream, tl::Shard{n_global, start, edges});
}

// The batched shard-local form: x, d are lanes rows of one shard's n
// elements, row-major (lanes, n); alphas: lanes * num_trials floats,
// row-major (lanes, num_trials), each lane's own trials; n_global, start:
// shared by the lanes; edges: 2 * lanes floats, row-major (lanes, 2), each
// lane's [next shard's first x, its first d].  partials: num_trials *
// (lanes + tl_max_blocks()) doubles of scratch.  out: num_trials * lanes
// doubles, row-major (num_trials, lanes), each lane's partials.
extern "C" int tl_multi_phi_local_batched_f32(
    int body, const float* x, const float* d, const float* alphas,
    int num_trials, double* partials, double* out, long long lanes,
    long long n, long long n_global, long long start, const float* edges,
    void* stream) {
  if (start < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const tl::Shard shard{n_global, start, edges};
  return num_trials <= 8
             ? launch_rows_batched<8>(body, x, d, alphas, num_trials,
                                      partials, out, lanes, n, s, shard)
             : launch_rows_batched<kWide>(body, x, d, alphas, num_trials,
                                          partials, out, lanes, n, s, shard);
}
