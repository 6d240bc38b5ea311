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
// written for 13 operations (8.76 us at n = 2^20 in float32, 17.53 in
// float64, on an H100).  So each element is touched once: the three vectors
// and the five products come out of the same read, and the products go to
// float64 running sums per thread, which fold once per block to one partial
// per sum (reduce.cuh).  alpha is read from device memory: the line search
// leaves it there and the host never waits for it.
//
// The first design, one element per thread per step, 1024 blocks, a
// 10-barrier shared-memory tree per block and, for the compensated form, a
// stage 2 whose one thread ran the Neumaier recurrence over the 1024
// partials, took 13.30 us plain and 29.24 us compensated in float32 (NVIDIA
// H100 80GB HBM3, 700 W).  This design:
// - each thread owns a run of kRun = 4 consecutive elements of a tile,
//   loaded and stored 16 bytes at a time where the pointers are aligned
//   (two 16-byte accesses a run in float64), element by element at the
//   ragged end, so any n works;
// - one wave of blocks, two a multiprocessor (2 took 5-13% off 4, and 3
//   sat between), each walking its tiles in a fixed order;
// - the block sums by warp shuffles (reduce.cuh::block_sum_warps);
// - stage 2 in one warp per sum, launched behind stage 1 by programmatic
//   dependent launch (reduce.cuh::launch_after), so its launch overlaps
//   stage 1's tail.
//
// Stage 2 adds each sum's block partials: in block order in each lane and
// by a fixed shuffle tree across lanes in the plain form
// (reduce.cuh::finish_sums_lanes); in the compensated form (the TPU
// kernel's `compensated` flag, which guards its sequential cross-block
// accumulation with _neumaier_add) by the Neumaier recurrence, one warp per
// sum (reduce.cuh::finish_sums_compensated).  In float64 the compensated
// form compensates stage 1 too: each thread keeps a (sum, compensation)
// pair per sum, adding each term by TwoSum, and the block folds the pairs
// by TwoSum, so the float64 result is that of a compensated sum over every
// term, which the partials' own rounding would otherwise hide.  (In
// float32 the float64 partials are already 2^-29 of a float32 unit apart
// from the exact sum.)
//
// The batched form (tl_iteration_tail_batched_*; the reference's jax.vmap
// over _iteration_tail_pallas, as vmap_minimize runs it under
// cfg.use_pallas) takes B lanes of n elements, a (B, n) row-major tensor
// each, one alpha per lane and gives five sums per lane.  It is the same
// kernel on a batched walk (reduce.cuh): block b works on lane b / parts,
// with parts blocks a lane chosen so that the grid holds about one wave,
// and stage 2 is one thread per (sum, lane) adding that lane's parts
// partials in block order (reduce.cuh::finish_rows; Neumaier where
// compensated).  At bench.py's batch cell, 4096 lanes of 1024, a lane is
// one tile and one block, and 35.05 us of bytes in float32 bound it.  A
// row whose start is off 16 bytes (n not a multiple of 4 elements in
// float32, of 2 in float64) takes the element path throughout.
//
// The kernel is a template on the scalar type, float or double.  The
// per-element arithmetic follows the plain PyTorch version
// (tpu_lbfgs_torch/kernels/fused_ops.py::iteration_tail_plain) op for op,
// and the library is built with -fmad=false, so the three vectors match it
// bit for bit; only the sums differ, by their order.
#include "reduce.cuh"

namespace {

constexpr int kSums = 5;
constexpr int kRun = 4;  // consecutive elements per thread and tile
constexpr int kTile = tl::kThreads * kRun;
constexpr int kSMs = 132;          // an H100's
constexpr int kBlocksPerSM = 2;    // one wave
constexpr int kWarps = tl::kThreads / 32;

int tile_blocks(int64_t n) {
  static_assert(kBlocksPerSM * kSMs <= tl::kMaxBlocks,
                "partials hold kMaxBlocks");
  const int64_t tiles = (n + kTile - 1) / kTile;
  return static_cast<int>(tiles < kBlocksPerSM * kSMs ? tiles
                                                      : kBlocksPerSM * kSMs);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// A run of kRun values at p[i0..]: 16-byte accesses where `vec` says the
// pointers are aligned and the run lies inside n, else one per element
// below n (0 beyond it).
template <typename T>
__device__ __forceinline__ void load_run(const T* __restrict__ p, int64_t i0,
                                         int64_t n, bool vec, T (&v)[kRun]) {
  if (vec && i0 + kRun <= n) {
    if constexpr (sizeof(T) == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i0);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
      const double2 a = reinterpret_cast<const double2*>(p + i0)[0];
      const double2 b = reinterpret_cast<const double2*>(p + i0)[1];
      v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kRun; ++e) v[e] = i0 + e < n ? p[i0 + e] : T(0);
  }
}
template <typename T>
__device__ __forceinline__ void store_run(T* __restrict__ p, int64_t i0,
                                          int64_t n, bool vec,
                                          const T (&v)[kRun]) {
  if (vec && i0 + kRun <= n) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p + i0) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
      reinterpret_cast<double2*>(p + i0)[0] = make_double2(v[0], v[1]);
      reinterpret_cast<double2*>(p + i0)[1] = make_double2(v[2], v[3]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kRun; ++e) {
      if (i0 + e < n) p[i0 + e] = v[e];
    }
  }
}

// The compensated block fold: each thread's (sum, comp) pairs, by a
// shuffle tree in each warp and then, by thread k, the warps' pairs of sum
// k in warp order, each addition of sums by TwoSum.  Writes the block's sum
// of scalar k to partials[k * gridDim.x + blockIdx.x] and its compensation
// kSums * gridDim.x further on.
__device__ __forceinline__ void block_sum_compensated(
    double (&acc)[kSums], double (&cmp)[kSums],
    double* __restrict__ partials) {
  __shared__ double sh[2][kSums][kWarps];
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) tl::fold_pair(acc[k], cmp[k], off);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      sh[0][k][threadIdx.x >> 5] = acc[k];
      sh[1][k][threadIdx.x >> 5] = cmp[k];
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < kSums) {
    double s = sh[0][t][0], c = sh[1][t][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      double e;
      tl::two_sum(s, sh[0][t][w], s, e);
      c = (c + sh[1][t][w]) + e;
    }
    const int64_t at = static_cast<int64_t>(t) * gridDim.x + blockIdx.x;
    partials[at] = s;
    partials[at + static_cast<int64_t>(kSums) * gridDim.x] = c;
  }
}

// kComp: a (sum, compensation) pair per sum in each thread, each term added
// by TwoSum (the exact rounding error of every addition goes into the
// compensation; six operations where the Neumaier step's compare and select
// take eight), and the compensated block fold (the float64 compensated
// form).
// kBatched: the batched walk (reduce.cuh), lane w.lane's row of each
// vector and its alpha; one instance is lane 0 of a plain walk.
template <typename T, bool kComp, bool kBatched>
__global__ void __launch_bounds__(tl::kThreads, kBlocksPerSM)
    iteration_tail_kernel(const T* __restrict__ x, const T* __restrict__ d,
                          const T* __restrict__ g,
                          const T* __restrict__ g_new,
                          const T* __restrict__ alpha, T* __restrict__ x_new,
                          T* __restrict__ s_row, T* __restrict__ y_row,
                          double* __restrict__ partials, int64_t n,
                          bool vec, int parts) {
  tl::allow_dependents();
  const tl::Walk w = tl::walk<kBatched>(parts);
  if constexpr (kBatched) {
    const int64_t row = w.lane * n;
    x += row;
    d += row;
    g += row;
    g_new += row;
    x_new += row;
    s_row += row;
    y_row += row;
  }
  const T a = alpha[w.lane];
  double acc[kSums] = {0.0, 0.0, 0.0, 0.0, 0.0};
  double cmp[kSums] = {0.0, 0.0, 0.0, 0.0, 0.0};
  for (int64_t base = w.first * kTile; base < n; base += w.step * kTile) {
    const int64_t i0 = base + static_cast<int64_t>(threadIdx.x) * kRun;
    T xs[kRun], ds[kRun], gs[kRun], gn[kRun];
    load_run(x, i0, n, vec, xs);
    load_run(d, i0, n, vec, ds);
    load_run(g, i0, n, vec, gs);
    load_run(g_new, i0, n, vec, gn);
    T s[kRun], y[kRun], xn[kRun];
#pragma unroll
    for (int e = 0; e < kRun; ++e) {
      s[e] = a * ds[e];
      y[e] = gn[e] - gs[e];
      xn[e] = xs[e] + s[e];
    }
    store_run(x_new, i0, n, vec, xn);
    store_run(s_row, i0, n, vec, s);
    store_run(y_row, i0, n, vec, y);
#pragma unroll
    for (int e = 0; e < kRun; ++e) {
      if (i0 + e >= n) break;
      const double terms[kSums] = {
          static_cast<double>(s[e]) * y[e], static_cast<double>(y[e]) * y[e],
          static_cast<double>(gn[e]) * gn[e],
          static_cast<double>(ds[e]) * gn[e],
          static_cast<double>(gs[e]) * gn[e]};
#pragma unroll
      for (int k = 0; k < kSums; ++k) {
        if constexpr (kComp) {
          double e;
          tl::two_sum(acc[k], terms[k], acc[k], e);
          cmp[k] += e;
        } else {
          acc[k] += terms[k];
        }
      }
    }
  }
  if constexpr (kComp) {
    block_sum_compensated(acc, cmp, partials);
  } else {
    tl::block_sum_warps<kSums>(acc, partials);
  }
}

template <typename T>
int launch(const T* x, const T* d, const T* g, const T* g_new, const T* alpha,
           T* x_new, T* s_row, T* y_row, double* partials, T* sums,
           long long n, int compensated, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = tile_blocks(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(x) && aligned16(d) && aligned16(g) &&
                   aligned16(g_new) && aligned16(x_new) && aligned16(s_row) &&
                   aligned16(y_row);
  // The float64 compensated form compensates stage 1 as well.
  constexpr bool kCompStage1 = sizeof(T) == 8;
  if (compensated && kCompStage1) {
    iteration_tail_kernel<T, kCompStage1, false>
        <<<blocks, tl::kThreads, 0, s>>>(x, d, g, g_new, alpha, x_new, s_row,
                                         y_row, partials, n, vec, 0);
  } else {
    iteration_tail_kernel<T, false, false><<<blocks, tl::kThreads, 0, s>>>(
        x, d, g, g_new, alpha, x_new, s_row, y_row, partials, n, vec, 0);
  }
  if (compensated) {
    tl::launch_finish_compensated<T>(
        partials,
        kCompStage1 ? partials + static_cast<int64_t>(kSums) * blocks
                    : nullptr,
        blocks, kSums, sums, s);
  } else {
    tl::launch_after(tl::finish_sums_lanes<T>, kSums, tl::kLanes, s,
                     partials, blocks, sums);
  }
  return static_cast<int>(cudaGetLastError());
}

// The batched form: lanes rows of n, each lane's tiles walked by parts
// blocks, then finish_rows over the kSums * lanes rows.
template <typename T>
int launch_batched(const T* x, const T* d, const T* g, const T* g_new,
                   const T* alpha, T* x_new, T* s_row, T* y_row,
                   double* partials, T* sums, long long lanes, long long n,
                   int compensated, void* stream) {
  if (n < 1 || lanes < 1 || lanes > tl::kMaxLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int parts = tl::lane_parts(lanes, (n + kTile - 1) / kTile,
                                   kBlocksPerSM * kSMs);
  const int64_t blocks = lanes * parts;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Every row starts 16-byte aligned only if n values fill whole 16 bytes.
  const bool vec = aligned16(x) && aligned16(d) && aligned16(g) &&
                   aligned16(g_new) && aligned16(x_new) && aligned16(s_row) &&
                   aligned16(y_row) && n * sizeof(T) % 16 == 0;
  constexpr bool kCompStage1 = sizeof(T) == 8;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (compensated && kCompStage1) {
    iteration_tail_kernel<T, kCompStage1, true><<<grid, tl::kThreads, 0, s>>>(
        x, d, g, g_new, alpha, x_new, s_row, y_row, partials, n, vec, parts);
  } else {
    iteration_tail_kernel<T, false, true><<<grid, tl::kThreads, 0, s>>>(
        x, d, g, g_new, alpha, x_new, s_row, y_row, partials, n, vec, parts);
  }
  tl::launch_finish_rows<T>(
      partials,
      compensated && kCompStage1 ? partials + kSums * blocks : nullptr,
      parts, kSums * lanes, compensated != 0, sums, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, d, g, g_new, x_new, s_row, y_row: n values on the device, float (_f32)
// or double (_f64).  alpha: one value on the device.  partials: 10 *
// tl_max_blocks() doubles of scratch (5 * tl_max_blocks() are enough but
// for the float64 compensated form).  sums: 5 values, in the order s.y,
// y.y, g_new.g_new, d.g_new, g.g_new.  compensated: nonzero for the
// Neumaier sums.  Returns the cudaError_t of the launches.
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

// The batched form.  x, d, g, g_new, x_new, s_row, y_row: lanes * n values,
// row-major (lanes, n).  alpha: lanes values.  partials: 10 * (lanes +
// tl_max_blocks()) doubles of scratch.  sums: 5 * lanes values, row-major
// (5, lanes) in the order above.  Returns the cudaError_t of the launches
// (cudaErrorInvalidValue for n < 1, or lanes outside [1, 2^31 - 1 -
// tl_max_blocks()]).
#define TL_ITERATION_TAIL_BATCHED_ENTRY(NAME, T)                             \
  extern "C" int NAME(const T* x, const T* d, const T* g, const T* g_new,    \
                      const T* alpha, T* x_new, T* s_row, T* y_row,          \
                      double* partials, T* sums, long long lanes,            \
                      long long n, int compensated, void* stream) {          \
    return launch_batched<T>(x, d, g, g_new, alpha, x_new, s_row, y_row,     \
                             partials, sums, lanes, n, compensated, stream); \
  }

TL_ITERATION_TAIL_BATCHED_ENTRY(tl_iteration_tail_batched_f32, float)
TL_ITERATION_TAIL_BATCHED_ENTRY(tl_iteration_tail_batched_f64, double)
