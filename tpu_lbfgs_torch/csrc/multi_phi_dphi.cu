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
// The batched shard-local form (tl_multi_phi_dphi_local_batched_f32; the
// reference's jax.vmap over shardmap_multi_phi_dphi, as
// sharded_vmap_minimize runs it) takes B lanes of one shard's blocks,
// (B, n) rows of x and d, each lane with its own K alphas, (B, K), and its
// own edges row of (B, 4); the lanes share start and n_global, and
// (2, K, B) float64 partials come back, unrounded.  It has a kernel of its
// own (multi_phi_dphi_batched_kernel) for what sharded_vmap_minimize gives
// it, a few lanes of a long block (4 lanes of 2^20), where the
// one-instance template on the batched walk ran at 43-49% of its bound at
// K = 8 (bench/trial_bounds.py).  Each point below was settled by
// bench/kernel_ab.py in turns on an H100, against the design without it,
// at K = 8 in a middle and the last shard (K = 36 where it differs):
// - each row of blocks takes its trials of every lane on the batched walk
//   (reduce.cuh: block b on lane b / parts), one wave of blocks;
// - 8 trials a row for K <= 8 (18 a row: 7-16% slower), 18 above;
// - a thread owns a run of 8 consecutive elements of a tile, two 16-byte
//   loads of x and of d, both neighbours by shuffle: 10 trial points for 8
//   terms (runs of 4: 3-7% slower; Rosenbrock in the last shard 0.4%
//   faster); at 18 trials a row a chain body's runs of 8 spill (700-1400
//   bytes; K = 36 2-6% slower than the template), so its runs there are 4
//   (0.95-0.98 of the template's time; 12 trials a row in runs of 8:
//   coupled 0.93-0.94, Rosenbrock 0.97-1.01);
// - two blocks an SM, with the registers to fetch the next tile's run
//   before the current one's trials at 8 a row (three blocks: 80 registers
//   and spills, 28-51% slower; no fetch ahead: 1-2%; at 18 or 12 a row
//   the fetch ahead costs a chain body 2-7%);
// - a block walks a lane's last tile first (element by element), and a
//   warp takes the index-tested path as a whole: in a shard that ends the
//   vector, the warp holding its last element otherwise ran both paths
//   (3-4% slower in the last shard; last tile last: 2-5%);
// - the walk is rotated so that the lane's last tile falls to a block with
//   one tile fewer than the most: the last shard then takes a middle
//   one's time (without: 2-6% longer), though at K = 8 Rosenbrock's
//   middle shard takes 3% longer (128 registers and an 8-byte spill);
// - stage 2 is a warp per (sum, trial, lane) row by a fixed shuffle tree
//   where a lane has 32 parts or more, 66 at K = 8 and 33 at K = 36 at
//   that shape (reduce.cuh::launch_finish_rows_by_parts); one thread per
//   row: 5-8% slower.
// The float64 sums and g . d as exact float64 products stay; at K = 8 the
// kernel runs at 52-61% of its corrected bound, held by issue for the
// chain bodies and the float64 conversions for the quadratic
// (bench/trial_bounds.py).
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
// The batched kernel: its blocks an SM and, for a row of kTrials trials,
// the consecutive elements a thread owns in a tile and whether it fetches
// the next tile ahead, by what the registers allow at two blocks an SM
// (-Xptxas -v): at 18 trials a row a chain body's runs of 8 spill.
constexpr int kSMs = 132;  // an H100's
constexpr int kBatchedBlocksPerSM = 2;
static_assert(kBatchedBlocksPerSM * kSMs <= tl::kMaxBlocks,
              "partials hold kMaxBlocks");
template <typename Body, int kTrials>
constexpr int kBatchedRun = kTrials <= 8 || !Body::kNeighbours ? 8 : 4;
template <int kTrials>
constexpr bool kAhead = kTrials <= 8;

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
// kTrials, kLen: the row's width and the run's length (the batched
// kernel's differ).
template <typename Body, bool kInterior, bool kShard,
          int kTrials = kTrialsPerRow, int kLen = kRun>
__device__ __forceinline__ void add_run(
    const float (&xs)[kLen + 2], const float (&ds)[kLen + 2],
    const double (&dd)[kLen], const float* a, int count, int64_t i0,
    int64_t n, const tl::Shard& shard, double (&f_acc)[kTrials],
    double (&g_acc)[kTrials]) {
  const int64_t n_total = kShard ? shard.n_global : n;
#pragma unroll
  for (int j = 0; j < kTrials; ++j) {
    if (j >= count) break;
    const float aj = a[j];
    float u[kLen + 2];
#pragma unroll
    for (int e = 0; e < kLen + 2; ++e) {
      u[e] = Body::kNeighbours || (e > 0 && e <= kLen)
                 ? tl::trial_point(xs[e], ds[e], aj)
                 : 0.0f;
    }
#pragma unroll
    for (int e = 1; e <= kLen; ++e) {
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
// the block sums them once, at the end, by warp shuffles.
template <typename Body, bool kShard>
__global__ void __launch_bounds__(tl::kThreads, 2)
    multi_phi_dphi_kernel(const float* __restrict__ x,
                          const float* __restrict__ d,
                          const float* __restrict__ alphas, int num_trials,
                          double* __restrict__ partials, int64_t n, bool vec,
                          tl::Shard shard) {
  __shared__ float a[kTrialsPerRow];
  const tl::Walk w = tl::walk<false>(0);
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

// One run of a full tile of the batched kernel (every element and both its
// neighbours inside the row) as loaded: kLen elements of x and of
// d, 16 bytes at a time, and, in a warp's first thread, the element just
// before the run (the shard's previous edge before element 0), in its last
// thread the one just after it.
template <int kLen>
struct Run {
  float4 x[kLen / 4], d[kLen / 4];
  float xp, dp, xn, dn;
};

template <typename Body, int kLen>
__device__ __forceinline__ Run<kLen> fetch_run(const float* __restrict__ x,
                                               const float* __restrict__ d,
                                               int64_t i0,
                                               const tl::Shard& shard) {
  Run<kLen> r;
#pragma unroll
  for (int q = 0; q < kLen / 4; ++q) {
    r.x[q] = *reinterpret_cast<const float4*>(x + i0 + 4 * q);
    r.d[q] = *reinterpret_cast<const float4*>(d + i0 + 4 * q);
  }
  r.xp = r.dp = r.xn = r.dn = 0.0f;
  if constexpr (Body::kNeighbours) {
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      r.xp = i0 > 0 ? x[i0 - 1] : shard.edges[0];
      r.dp = i0 > 0 ? d[i0 - 1] : shard.edges[1];
    }
    if (lane == 31) {
      r.xn = x[i0 + kLen];
      r.dn = d[i0 + kLen];
    }
  }
  return r;
}

// A fetched run as load_window leaves a full tile's: xs[1..kLen] the run,
// xs[0] and xs[kLen + 1] its neighbours from the neighbouring threads by
// shuffle, a warp's edge threads their own.
template <typename Body, int kLen>
__device__ __forceinline__ void unpack_run(const Run<kLen>& r,
                                           float (&xs)[kLen + 2],
                                           float (&ds)[kLen + 2]) {
#pragma unroll
  for (int q = 0; q < kLen / 4; ++q) {
    xs[4 * q + 1] = r.x[q].x; xs[4 * q + 2] = r.x[q].y;
    xs[4 * q + 3] = r.x[q].z; xs[4 * q + 4] = r.x[q].w;
    ds[4 * q + 1] = r.d[q].x; ds[4 * q + 2] = r.d[q].y;
    ds[4 * q + 3] = r.d[q].z; ds[4 * q + 4] = r.d[q].w;
  }
  xs[0] = ds[0] = xs[kLen + 1] = ds[kLen + 1] = 0.0f;
  if constexpr (Body::kNeighbours) {
    const int lane = threadIdx.x & 31;
    xs[0] = __shfl_up_sync(kFull, xs[kLen], 1);
    ds[0] = __shfl_up_sync(kFull, ds[kLen], 1);
    xs[kLen + 1] = __shfl_down_sync(kFull, xs[1], 1);
    ds[kLen + 1] = __shfl_down_sync(kFull, ds[1], 1);
    if (lane == 0) {
      xs[0] = r.xp;
      ds[0] = r.dp;
    }
    if (lane == 31) {
      xs[kLen + 1] = r.xn;
      ds[kLen + 1] = r.dn;
    }
  }
}

// A run of a tile that is not full, element by element: element i0 - 1 + e
// in xs[e], x[i] inside the row, the shard's edges at -1 and n (a chain
// body's neighbours), 0 beyond.
template <typename Body, int kLen>
__device__ __forceinline__ void load_partial_run(
    const float* __restrict__ x, const float* __restrict__ d, int64_t i0,
    int64_t n, const tl::Shard& shard, float (&xs)[kLen + 2],
    float (&ds)[kLen + 2]) {
#pragma unroll
  for (int e = 0; e < kLen + 2; ++e) {
    const int64_t i = i0 - 1 + e;
    xs[e] = ds[e] = 0.0f;
    if (i >= 0 && i < n) {
      xs[e] = x[i];
      ds[e] = d[i];
    } else if (Body::kNeighbours && i == -1) {
      xs[e] = shard.edges[0];
      ds[e] = shard.edges[1];
    } else if (Body::kNeighbours && i == n) {
      xs[e] = shard.edges[2];
      ds[e] = shard.edges[3];
    }
  }
}

// Adds one run of the batched kernel's tiles: d widened once, then the
// row's trials, on the interior path where every element of the warp's
// runs has both neighbours and a term.  The test is the warp's, so a warp
// holding the vector's first or last element takes the index-tested path
// once and not both paths one after the other.
template <typename Body, int kTrials, int kLen>
__device__ __forceinline__ void add_batched_run(
    const float (&xs)[kLen + 2], const float (&ds)[kLen + 2], const float* a,
    int count, int64_t i0, int64_t n, const tl::Shard& shard,
    double (&f_acc)[kTrials], double (&g_acc)[kTrials]) {
  double dd[kLen];
#pragma unroll
  for (int e = 0; e < kLen; ++e) dd[e] = static_cast<double>(ds[e + 1]);
  const int64_t at0 = shard.start + i0;
  if (__all_sync(kFull, i0 + kLen <= n && at0 >= 1 &&
                            at0 + kLen < shard.n_global)) {
    add_run<Body, true, true, kTrials, kLen>(xs, ds, dd, a, count, i0, n,
                                             shard, f_acc, g_acc);
  } else {
    add_run<Body, false, true, kTrials, kLen>(xs, ds, dd, a, count, i0, n,
                                              shard, f_acc, g_acc);
  }
}

// The batched shard-local form (the header): block b of row blockIdx.y
// walks lane b / parts, every parts-th tile from b % parts on (rotated, as
// the walk below says).  The tiles before `full` are fetched one step
// ahead (kAhead), so a tile's loads are in flight while the tile before it
// runs its trials; the rest (a lane's last tile, or every tile of a row
// that is not 16-byte aligned) load element by element, and go first.
template <typename Body, int kTrials>
__global__ void __launch_bounds__(tl::kThreads, kBatchedBlocksPerSM)
    multi_phi_dphi_batched_kernel(const float* __restrict__ x,
                                  const float* __restrict__ d,
                                  const float* __restrict__ alphas,
                                  int num_trials,
                                  double* __restrict__ partials, int64_t n,
                                  bool vec, tl::Shard shard, int parts) {
  constexpr int kLen = kBatchedRun<Body, kTrials>;
  constexpr int kTileLen = tl::kThreads * kLen;
  __shared__ float a[kTrials];
  const tl::Walk w = tl::walk<true>(parts);
  x += w.lane * n;
  d += w.lane * n;
  alphas += w.lane * num_trials;
  shard.edges += 4 * w.lane;
  const int k0 = blockIdx.y * kTrials;
  const int count = min(kTrials, num_trials - k0);
  const int t = threadIdx.x;
  if (t < kTrials) a[t] = t < count ? alphas[k0 + t] : 0.0f;
  __syncthreads();
  double f_acc[kTrials], g_acc[kTrials];
#pragma unroll
  for (int j = 0; j < kTrials; ++j) f_acc[j] = g_acc[j] = 0.0;
  // Elements at and beyond n_global (the zero-padded tail) have no term
  // and no gradient: a block walks the tiles up to the last one that has.
  const int64_t live = min(n, shard.n_global - shard.start);
  const int64_t walked = live > 0 ? (live + kTileLen - 1) / kTileLen : 0;
  const int64_t full = vec ? min((n - 1) / kTileLen, walked) : 0;
  const int64_t off = static_cast<int64_t>(threadIdx.x) * kLen;
  float xs[kLen + 2], ds[kLen + 2];
  // A block takes the tiles (v + shift) mod walked, v = w.first, w.first +
  // w.step, ...: the walk rotated so that the lane's last tile, the one
  // tile the element path takes where the row is 16-byte aligned (and, in
  // a shard that ends the vector, the index tests), comes first in a block
  // with one tile fewer than the most, where it does not lengthen the wave.
  const int64_t rem = walked % w.step;
  const int64_t shift = walked > 0 ? (2 * walked - 1 - rem) % walked : 0;
  auto tile_of = [&](int64_t v) {
    const int64_t t = v + shift;
    return t < walked ? t : t - walked;
  };
  int64_t v = w.first;
  for (; v < walked && tile_of(v) >= full; v += w.step) {
    const int64_t i0 = tile_of(v) * kTileLen + off;
    load_partial_run<Body, kLen>(x, d, i0, n, shard, xs, ds);
    add_batched_run<Body, kTrials, kLen>(xs, ds, a, count, i0, n, shard,
                                         f_acc, g_acc);
  }
  // The rest are full tiles: with vec only the lane's last tile may not
  // be, and it comes first.
  if constexpr (kAhead<kTrials>) {
    if (v < walked) {
      Run<kLen> cur = fetch_run<Body, kLen>(x, d, tile_of(v) * kTileLen + off,
                                            shard);
      for (;;) {
        const int64_t next = v + w.step;
        Run<kLen> ahead;
        if (next < walked) {
          ahead = fetch_run<Body, kLen>(x, d, tile_of(next) * kTileLen + off,
                                        shard);
        }
        unpack_run<Body, kLen>(cur, xs, ds);
        add_batched_run<Body, kTrials, kLen>(xs, ds, a, count,
                                             tile_of(v) * kTileLen + off, n,
                                             shard, f_acc, g_acc);
        v = next;
        if (v >= walked) break;
        cur = ahead;
      }
    }
  } else {
    for (; v < walked; v += w.step) {
      const int64_t i0 = tile_of(v) * kTileLen + off;
      unpack_run<Body, kLen>(fetch_run<Body, kLen>(x, d, i0, shard), xs, ds);
      add_batched_run<Body, kTrials, kLen>(xs, ds, a, count, i0, n, shard,
                                           f_acc, g_acc);
    }
  }
  const int64_t nb = gridDim.x;
  tl::block_sum_warps<kTrials>(f_acc, partials + k0 * nb, count);
  tl::block_sum_warps<kTrials>(
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
      body, multi_phi_dphi_kernel<Body, kShard>
      <<<dim3(blocks, rows), tl::kThreads, 0, s>>>(
          x, d, alphas, num_trials, partials, n, vec, shard));
  if (!known) return -static_cast<int>(cudaErrorInvalidValue);
  return blocks;
}

// Launches the batched kernel for one body at kTrials trials a row: each
// row of blocks walks every lane, parts blocks a lane, its row's share of
// one wave between them.  Returns parts.
template <typename Body, int kTrials>
int launch_batched_rows(const float* x, const float* d, const float* alphas,
                        int num_trials, double* partials, long long lanes,
                        long long n, int rows, bool vec, cudaStream_t s,
                        const tl::Shard& shard) {
  constexpr int kTileLen = tl::kThreads * kBatchedRun<Body, kTrials>;
  const int budget = kBatchedBlocksPerSM * kSMs / rows;
  const int parts = tl::lane_parts(lanes, (n + kTileLen - 1) / kTileLen,
                                   budget > 1 ? budget : 1);
  multi_phi_dphi_batched_kernel<Body, kTrials>
      <<<dim3(static_cast<unsigned>(lanes * parts), rows), tl::kThreads, 0,
          s>>>(x, d, alphas, num_trials, partials, n, vec, shard, parts);
  return parts;
}

// The batched shard-local form at kTrials trials a row: the kernel, then
// stage 2 over the (sum, trial, lane) rows, by warps where a lane has many
// parts.
template <int kTrials>
int launch_batched(int body, const float* x, const float* d,
                   const float* alphas, int num_trials, double* partials,
                   double* out, long long lanes, long long n, cudaStream_t s,
                   const tl::Shard& shard) {
  const int rows = (num_trials + kTrials - 1) / kTrials;
  if (n < 1 || num_trials < 1 || rows > kMaxRows || lanes < 1 ||
      lanes > tl::kMaxLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Every row starts 16-byte aligned only if n floats fill whole 16 bytes.
  const bool vec = aligned16(x) && aligned16(d) && n % 4 == 0;
  int parts = 0;
  const bool known = TL_DISPATCH_BODY(
      body, parts = launch_batched_rows<Body, kTrials>(
                x, d, alphas, num_trials, partials, lanes, n, rows, vec, s,
                shard));
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  tl::launch_finish_rows_by_parts<double>(
      partials, parts, 2 * static_cast<int64_t>(num_trials) * lanes, out, s);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const tl::Shard shard{n_global, start, edges};
  return num_trials <= 8
             ? launch_batched<8>(body, x, d, alphas, num_trials, partials,
                                 out, lanes, n, s, shard)
             : launch_batched<kTrialsPerRow>(body, x, d, alphas, num_trials,
                                             partials, out, lanes, n, s,
                                             shard);
}

// Blocks of the kernel (body) that fit on one SM of the current device, by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; -1 for an unknown body.
extern "C" int tl_multi_phi_dphi_blocks_per_sm(int body) {
  int blocks = -1;
  TL_DISPATCH_BODY(body, cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                             &blocks,
                             multi_phi_dphi_kernel<Body, false>,
                             tl::kThreads, 0));
  return blocks;
}
