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
// (no fused multiply-add), and 2K floats come out.  The alphas are read
// from device memory: the search builds its ladder there and the host
// never reads it.
//
// The first design, one element per thread per step, 8 trials to a row of
// blocks and 1024 blocks to a row, each thread loading both neighbours of
// its element and rebuilding three trial points per element and trial,
// took 100 us at K = 36 and n = 2^20 (NVIDIA H100 80GB HBM3, 700 W).
// Skipping its block trees (5 rows x 1024 blocks, each two 8-level
// shared-memory trees) took 29% off, float32 sums 10%, 16-byte loads 8%.
// A float32 pair per sum (TwoSum, no conversion) cost more issue slots
// than the conversions it saved (86 us), so the sums stay in double.  This
// design:
// - each thread owns a run of kRun consecutive elements of a tile, loaded
//   16 bytes at a time, with the elements just before and after it from
//   the neighbouring lanes by shuffle (one load at a warp's edge), so a
//   trial rebuilds its chain neighbours once per element (kRun + 2 trial
//   points a run), with the correctly rounded trial_point, equal to their
//   owners' values; the TPU kernel carried them through SMEM and a halo
//   DMA;
// - a run whose elements all have both neighbours and a term takes the
//   bodies' fg<true>, with no index test and no branch per element and
//   trial (they were a sixth of the instructions);
// - kTrialsPerRow trials to a row of blocks, with their 2 kTrialsPerRow
//   float64 sums in registers and no spill at two blocks per SM, and the
//   rows' blocks together one wave (kBlockBudget), so each thread walks
//   several runs and widens d once per run;
// - the block sums by warp shuffles, once per block
//   (reduce.cuh::block_sum_warps).
// It takes 48.25 us at K = 36 and 18.67 at K = 8 (122 registers, two
// blocks per SM), against an issue ceiling of 31.6 us for the same 28
// operations per element and trial at one operation per lane per clock.
// K is a runtime count; the rows re-read x and d, mostly from L2.  Sums
// reduce per block in float64 and then per output in a fixed order
// (reduce.cuh), with no float atomics.  The edge is masked by index, so any
// n works.
//
// The shard-local form (kShard; replaces tpu_lbfgs/dist/pallas_sharded.py
// shardmap_multi_phi_dphi's per-shard call of _multi_phi_dphi_pallas with
// n, start and edges) runs the same kernel on one shard's blocks of x and
// d: term ownership and the zero-padded tail go by the global index
// (bodies.cuh::Shard), elements 0 and n - 1 take their outer neighbours
// from edges = [previous shard's last x and d, next shard's first x and d]
// in device memory, and the 2 K sums come back as float64,
// unrounded, for the caller's one float64 all-reduce.  The whole-vector
// form is the instantiation without kShard.
//
// The batched shard-local form (kShard and kBatched,
// tl_multi_phi_dphi_local_batched_f32; the reference's jax.vmap over
// shardmap_multi_phi_dphi, as sharded_vmap_minimize runs it) takes B lanes
// of one shard's blocks, (B, n) rows of x and d, each lane with its own K
// alphas, (B, K), and its own edges row of (B, 4); the lanes share start
// and n_global.  Each row of blocks walks every lane on the batched walk
// (reduce.cuh: block b on lane b / parts), and stage 2 is one thread per
// (sum, trial, lane) (reduce.cuh::finish_rows): (2, K, B) float64
// partials, unrounded.
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

constexpr int kTrialsPerRow = 18;
constexpr int kMaxRows = 65535;  // gridDim.y
constexpr int kRun = 4;          // consecutive elements per thread and tile
constexpr int kTile = tl::kThreads * kRun;
// Blocks of all rows together: two to each of an H100's 132 SMs, one wave.
constexpr int kBlockBudget = 264;
static_assert(kBlockBudget <= tl::kMaxBlocks, "partials hold kMaxBlocks");
constexpr unsigned kFull = 0xffffffffu;

inline int row_blocks(int64_t n, int rows) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t cap = kBlockBudget / rows > 1 ? kBlockBudget / rows : 1;
  return static_cast<int>(tiles < cap ? tiles : cap);
}

// Each thread owns a run of kRun consecutive elements of a tile, loaded 16
// bytes at a time; xs[1..kRun], ds[1..kRun] hold it and xs[0], xs[kRun+1]
// the elements just before and after it, from the neighbouring lanes by
// shuffle (one load at a warp's edge), so a trial's chain neighbours are
// rebuilt once per element, not twice.  Elements at and beyond n hold 0 (a
// body reads a neighbour behind its index tests only), but a shard's
// elements -1 and n are the edges.
template <typename Body, bool kShard>
__device__ __forceinline__ void load_window(const float* __restrict__ x,
                                            const float* __restrict__ d,
                                            int64_t i0, int64_t n, bool vec,
                                            const tl::Shard& shard,
                                            float (&xs)[kRun + 2],
                                            float (&ds)[kRun + 2]) {
  if (vec && i0 + kRun <= n) {
    const float4 xq = *reinterpret_cast<const float4*>(x + i0);
    const float4 dq = *reinterpret_cast<const float4*>(d + i0);
    xs[1] = xq.x; xs[2] = xq.y; xs[3] = xq.z; xs[4] = xq.w;
    ds[1] = dq.x; ds[2] = dq.y; ds[3] = dq.z; ds[4] = dq.w;
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      xs[j + 1] = i0 + j < n ? x[i0 + j] : 0.0f;
      ds[j + 1] = i0 + j < n ? d[i0 + j] : 0.0f;
    }
  }
  xs[0] = ds[0] = xs[kRun + 1] = ds[kRun + 1] = 0.0f;
  if constexpr (Body::kNeighbours) {
    if constexpr (kShard) {
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        if (i0 + j == n) {
          xs[j + 1] = shard.edges[2];
          ds[j + 1] = shard.edges[3];
        }
      }
    }
    const int lane = threadIdx.x & 31;
    xs[0] = __shfl_up_sync(kFull, xs[kRun], 1);
    ds[0] = __shfl_up_sync(kFull, ds[kRun], 1);
    xs[kRun + 1] = __shfl_down_sync(kFull, xs[1], 1);
    ds[kRun + 1] = __shfl_down_sync(kFull, ds[1], 1);
    if (lane == 0) {
      xs[0] = ds[0] = 0.0f;
      if (i0 >= 1 && i0 <= n) {
        xs[0] = x[i0 - 1];
        ds[0] = d[i0 - 1];
      } else if (kShard && i0 == 0) {
        xs[0] = shard.edges[0];
        ds[0] = shard.edges[1];
      }
    }
    if (lane == 31) {
      xs[kRun + 1] = ds[kRun + 1] = 0.0f;
      if (i0 + kRun < n) {
        xs[kRun + 1] = x[i0 + kRun];
        ds[kRun + 1] = d[i0 + kRun];
      } else if (kShard && i0 + kRun == n) {
        xs[kRun + 1] = shard.edges[2];
        ds[kRun + 1] = shard.edges[3];
      }
    }
  }
}

// Adds one run's terms of the row's trials to f_acc and g_acc.  kInterior:
// every element of the run has both neighbours and a term, so the bodies'
// index tests and the padded-tail test drop out of the unrolled code.
template <typename Body, bool kInterior, bool kShard>
__device__ __forceinline__ void add_run(
    const float (&xs)[kRun + 2], const float (&ds)[kRun + 2],
    const double (&dd)[kRun], const float* a, int count, int64_t i0,
    int64_t n, const tl::Shard& shard, double (&f_acc)[kTrialsPerRow],
    double (&g_acc)[kTrialsPerRow]) {
  const int64_t n_total = kShard ? shard.n_global : n;
#pragma unroll
  for (int j = 0; j < kTrialsPerRow; ++j) {
    if (j >= count) break;
    const float aj = a[j];
    float u[kRun + 2];
#pragma unroll
    for (int e = 0; e < kRun + 2; ++e) {
      u[e] = Body::kNeighbours || (e > 0 && e <= kRun)
                 ? tl::trial_point(xs[e], ds[e], aj)
                 : 0.0f;
    }
#pragma unroll
    for (int e = 1; e <= kRun; ++e) {
      const int64_t i = i0 + e - 1;
      const int64_t at = kShard ? shard.start + i : i;
      // An element of the zero-padded tail owns no term and has no
      // gradient.
      if (!kInterior && (i >= n || (kShard && at >= shard.n_global))) {
        continue;
      }
      const float gi = Body::template fg<kInterior>(u[e], u[e - 1], u[e + 1],
                                                    at, n_total, f_acc[j]);
      g_acc[j] += static_cast<double>(gi) * dd[e - 1];
    }
  }
}

// Row blockIdx.y takes trials k0 .. k0 + kTrialsPerRow of the K; each
// thread keeps f and g . d of each in double over every run it owns, and
// the block sums them once, at the end, by warp shuffles.  kBatched: the
// batched walk over lanes of x, d, alphas and edges (the header); one
// instance is lane 0 of a plain walk.
template <typename Body, bool kShard, bool kBatched>
__global__ void __launch_bounds__(tl::kThreads, 2)
    multi_phi_dphi_kernel(const float* __restrict__ x,
                          const float* __restrict__ d,
                          const float* __restrict__ alphas, int num_trials,
                          double* __restrict__ partials, int64_t n, bool vec,
                          tl::Shard shard, int parts) {
  __shared__ float a[kTrialsPerRow];
  const tl::Walk w = tl::walk<kBatched>(parts);
  if constexpr (kBatched) {
    x += w.lane * n;
    d += w.lane * n;
    alphas += w.lane * num_trials;
    if constexpr (kShard) shard.edges += 4 * w.lane;
  }
  const int k0 = blockIdx.y * kTrialsPerRow;
  const int count = min(kTrialsPerRow, num_trials - k0);
  const int t = threadIdx.x;
  if (t < kTrialsPerRow) a[t] = t < count ? alphas[k0 + t] : 0.0f;
  __syncthreads();
  double f_acc[kTrialsPerRow], g_acc[kTrialsPerRow];
#pragma unroll
  for (int j = 0; j < kTrialsPerRow; ++j) f_acc[j] = g_acc[j] = 0.0;
  const int64_t start = kShard ? shard.start : 0;
  const int64_t n_total = kShard ? shard.n_global : n;
  for (int64_t base = w.first * kTile; base < n; base += w.step * kTile) {
    const int64_t i0 = base + static_cast<int64_t>(threadIdx.x) * kRun;
    float xs[kRun + 2], ds[kRun + 2];
    load_window<Body, kShard>(x, d, i0, n, vec, shard, xs, ds);
    double dd[kRun];  // d widened once per run, not once per trial
#pragma unroll
    for (int e = 0; e < kRun; ++e) dd[e] = static_cast<double>(ds[e + 1]);
    if (i0 + kRun <= n && start + i0 >= 1 && start + i0 + kRun < n_total) {
      add_run<Body, true, kShard>(xs, ds, dd, a, count, i0, n, shard, f_acc,
                                  g_acc);
    } else {
      add_run<Body, false, kShard>(xs, ds, dd, a, count, i0, n, shard, f_acc,
                                   g_acc);
    }
  }
  const int64_t nb = gridDim.x;
  tl::block_sum_warps<kTrialsPerRow>(f_acc, partials + k0 * nb, count);
  tl::block_sum_warps<kTrialsPerRow>(
      g_acc, partials + (static_cast<int64_t>(num_trials) + k0) * nb, count);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Launches the kernel; returns its block count along x, or minus the
// cudaError_t for arguments it does not take.
template <bool kShard>
int launch(int body, const float* x, const float* d, const float* alphas,
           int num_trials, double* partials, long long n, void* stream,
           const tl::Shard& shard) {
  const int rows = (num_trials + kTrialsPerRow - 1) / kTrialsPerRow;
  if (n < 1 || num_trials < 1 || rows > kMaxRows) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = row_blocks(n, rows);
  const bool vec = aligned16(x) && aligned16(d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool known = TL_DISPATCH_BODY(
      body, multi_phi_dphi_kernel<Body, kShard, false>
      <<<dim3(blocks, rows), tl::kThreads, 0, s>>>(
          x, d, alphas, num_trials, partials, n, vec, shard, 0));
  if (!known) return -static_cast<int>(cudaErrorInvalidValue);
  return blocks;
}

// The batched shard-local form: each row of blocks walks every lane, parts
// blocks a lane, its row's share of one wave between them; then
// finish_rows over the (sum, trial, lane) rows.
int launch_batched(int body, const float* x, const float* d,
                   const float* alphas, int num_trials, double* partials,
                   double* out, long long lanes, long long n, void* stream,
                   const tl::Shard& shard) {
  const int rows = (num_trials + kTrialsPerRow - 1) / kTrialsPerRow;
  if (n < 1 || num_trials < 1 || rows > kMaxRows || lanes < 1 ||
      lanes > tl::kMaxLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int budget = kBlockBudget / rows;
  const int parts = tl::lane_parts(lanes, (n + kTile - 1) / kTile,
                                   budget > 1 ? budget : 1);
  const unsigned grid = static_cast<unsigned>(lanes * parts);
  // Every row starts 16-byte aligned only if n floats fill whole 16 bytes.
  const bool vec = aligned16(x) && aligned16(d) && n % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool known = TL_DISPATCH_BODY(
      body, multi_phi_dphi_kernel<Body, true, true>
      <<<dim3(grid, rows), tl::kThreads, 0, s>>>(
          x, d, alphas, num_trials, partials, n, vec, shard, parts));
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  tl::launch_finish_rows<double>(partials, nullptr, parts,
                                 2 * static_cast<int64_t>(num_trials) * lanes,
                                 false, out, s);
  return static_cast<int>(cudaGetLastError());
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
  const int blocks = launch<false>(body, x, d, alphas, num_trials, partials,
                                   n, stream, tl::Shard{});
  if (blocks < 0) return -blocks;
  tl::finish_sums<<<2 * num_trials, tl::kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(partials, blocks,
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
  if (start < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks =
      launch<true>(body, x, d, alphas, num_trials, partials, n, stream,
                   tl::Shard{n_global, start, edges});
  if (blocks < 0) return -blocks;
  tl::finish_sums<<<2 * num_trials, tl::kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(partials, blocks,
                                                         out);
  return static_cast<int>(cudaGetLastError());
}

// The batched shard-local form: x, d are lanes rows of one shard's n
// elements, row-major (lanes, n); alphas: lanes * num_trials floats,
// row-major (lanes, num_trials), each lane's own trials; n_global, start:
// shared by the lanes; edges: 4 * lanes floats, row-major (lanes, 4), each
// lane's [previous shard's last x, its last d, next shard's first x, its
// first d].  partials: 2 * num_trials * (lanes + tl_max_blocks()) doubles
// of scratch.  out: 2 * num_trials * lanes doubles, row-major (2,
// num_trials, lanes): each lane's partials of phi, then of dphi.
extern "C" int tl_multi_phi_dphi_local_batched_f32(
    int body, const float* x, const float* d, const float* alphas,
    int num_trials, double* partials, double* out, long long lanes,
    long long n, long long n_global, long long start, const float* edges,
    void* stream) {
  if (start < 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_batched(body, x, d, alphas, num_trials, partials, out, lanes,
                        n, stream, tl::Shard{n_global, start, edges});
}

// Blocks of the kernel (body) that fit on one SM of the current device, by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; -1 for an unknown body.
extern "C" int tl_multi_phi_dphi_blocks_per_sm(int body) {
  int blocks = -1;
  TL_DISPATCH_BODY(body, cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                             &blocks,
                             multi_phi_dphi_kernel<Body, false, false>,
                             tl::kThreads, 0));
  return blocks;
}
