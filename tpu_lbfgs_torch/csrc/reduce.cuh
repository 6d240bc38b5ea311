// Deterministic two-stage sums shared by the kernels of this directory.
//
// Stage 1: every block of a grid-stride kernel folds its threads' running
// sums (kept in double) into one partial per scalar, by a fixed tree in
// shared memory (block_sum_to) or by warp shuffles (block_sum_warps).
// Stage 2: one block per scalar sums its partials in a
// fixed order.  No float atomics, and the block count depends on n alone,
// so a result repeats bit for bit from run to run and from card to card.
//
// Stage 2 may be launched behind stage 1 by programmatic dependent launch
// (launch_after): stage 1 calls allow_dependents() as it starts, so the
// stage-2 grid is put on the card while stage 1 runs, and stage 2
// (finish_sums_lanes, finish_sums_compensated, finish_rows,
// finish_rows_warps) waits in
// wait_for_prerequisites() until stage 1 has finished and its partials are
// visible.
//
// The batched forms (the reference's jax.vmap over a kernel) take B lanes
// of n contiguous elements each, a row-major (B, n) tensor, and give every
// lane its own sums.  Block b of a batched grid of B * parts blocks works
// on lane b / parts, on that lane's tiles b % parts, b % parts + parts, ...
// (walk), so no tile straddles two lanes and a lane's chain neighbours stay
// inside its own row.  A block's partial of sum k still lands at
// partials[k * gridDim.x + blockIdx.x], which is row k * B + lane of parts
// partials; stage 2 (finish_rows, or finish_rows_warps where a lane has
// many parts: launch_finish_rows_by_parts) adds each row in a fixed order.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tl {

constexpr int kThreads = 256;
// Cap on stage-1 blocks.  1024 blocks of 256 threads fill an H100's 132
// SMs about eight blocks deep; more blocks would only lengthen stage 2.
constexpr int kMaxBlocks = 1024;
// The most lanes a batched launch takes: its grid of lanes * parts <
// lanes + kMaxBlocks blocks must fit gridDim.x.
constexpr int64_t kMaxLanes = 2147483647LL - kMaxBlocks;

inline int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

// Blocks per lane of a batched launch over lanes of `tiles` tiles: enough
// that the grid holds about `target` blocks (target <= kMaxBlocks), at most
// one per tile, at least one.  So lanes * parts < lanes + target, and at
// bench.py's batch cell (4096 lanes of one tile) a block per lane.
inline int lane_parts(int64_t lanes, int64_t tiles, int target) {
  int64_t p = (target + lanes - 1) / lanes;
  if (p > tiles) p = tiles;
  return p < 1 ? 1 : static_cast<int>(p);
}

// Where a block works: its lane (0 for one instance), its first tile and
// the step between its tiles.
struct Walk {
  int64_t lane;
  int64_t first;
  int64_t step;
};

namespace {

// The walk of this block: one instance walks tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...; a batched grid as the header says.
template <bool kBatched>
__device__ __forceinline__ Walk walk(int parts) {
  if constexpr (kBatched) {
    const int64_t b = blockIdx.x;
    return {b / parts, b % parts, parts};
  } else {
    return {0, static_cast<int64_t>(blockIdx.x),
            static_cast<int64_t>(gridDim.x)};
  }
}

// Lets the grids launched behind this one by launch_after start now.
__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" :::);
}

// Waits until the grids this one was launched behind have finished and
// their writes are visible; no wait for an ordinary launch.
__device__ __forceinline__ void wait_for_prerequisites() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Launches kernel<<<blocks, threads, 0, s>>>(args...) so that it may start
// before the kernel ahead of it on s has finished (it must call
// wait_for_prerequisites() before it reads what that kernel wrote).  A
// CUDA graph captures the dependency as it is.
template <typename... P, typename... A>
inline cudaError_t launch_after(void (*kernel)(P...), int blocks, int threads,
                                cudaStream_t s, A... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<P>(args)...);
}

// Writes this block's sum of acc[k] over its threads to
// partials[k * gridDim.x + blockIdx.x], for k < count.  A kernel may call it
// more than once.
template <int K>
__device__ __forceinline__ void block_sum_to(const double (&acc)[K],
                                             double* __restrict__ partials,
                                             int count = K) {
  __shared__ double sh[K][kThreads];
  const int t = threadIdx.x;
  __syncthreads();  // an earlier call's reads of sh are done
#pragma unroll
  for (int k = 0; k < K; ++k) sh[k][t] = acc[k];
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (t < w) {
#pragma unroll
      for (int k = 0; k < K; ++k) sh[k][t] += sh[k][t + w];
    }
    __syncthreads();
  }
  if (t == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < count) {
        partials[static_cast<int64_t>(k) * gridDim.x + blockIdx.x] = sh[k][0];
      }
    }
  }
}

// The sum of v over the 32 lanes of a warp, in lane 0, by a fixed shuffle
// tree.  Every lane of the warp must call it.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// block_sum_to by warps: a shuffle tree inside each warp, then thread k
// adds the warps' sums of scalar k in warp order and writes
// partials[k * gridDim.x + blockIdx.x], for k < count.  Two barriers and
// kThreads / 32 doubles of shared memory per scalar, where block_sum_to
// takes ten barriers and kThreads doubles.  A kernel may call it more than
// once.
template <int K>
__device__ __forceinline__ void block_sum_warps(const double (&acc)[K],
                                                double* __restrict__ partials,
                                                int count = K) {
  constexpr int kWarps = kThreads / 32;
  static_assert(K <= kThreads, "one thread per scalar");
  __shared__ double sh[K][kWarps];
  double v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(acc[k]);
  __syncthreads();  // an earlier call's reads of sh are done
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) sh[k][threadIdx.x >> 5] = v[k];
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < K && t < count) {
    double s = sh[t][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += sh[t][w];
    partials[static_cast<int64_t>(t) * gridDim.x + blockIdx.x] = s;
  }
}

// Stage 2, launched with one block of kThreads per scalar: out[k] = sum of
// the nblocks partials of scalar k = blockIdx.x, rounded once to T (float
// or double, deduced from out).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    finish_sums(const double* __restrict__ partials, int nblocks,
                T* __restrict__ out) {
  __shared__ double sh[kThreads];
  const int t = threadIdx.x;
  const double* __restrict__ row =
      partials + static_cast<int64_t>(blockIdx.x) * nblocks;
  double a = 0.0;
  for (int b = t; b < nblocks; b += kThreads) a += row[b];
  sh[t] = a;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (t < w) sh[t] += sh[t + w];
    __syncthreads();
  }
  if (t == 0) out[blockIdx.x] = static_cast<T>(sh[0]);
}

// One step of the Neumaier recurrence: adds p to the running sum and, to
// comp, the low-order bits that addition dropped (those of p where
// |sum| >= |p|, else those of sum).
__device__ __forceinline__ void neumaier_add(double& sum, double& comp,
                                             double p) {
  const double t = sum + p;
  comp += fabs(sum) >= fabs(p) ? (sum - t) + p : (p - t) + sum;
  sum = t;
}

// TwoSum: s + e = a + b exactly, s the rounded sum (no branch; the library
// is built with -fmad=false and nvcc does not reassociate).
__device__ __forceinline__ void two_sum(double a, double b, double& s,
                                        double& e) {
  s = a + b;
  const double bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

// Folds the (sum, comp) pair of lane + off into this lane's: the sums by
// TwoSum, whose error goes into the compensation, the compensations by
// plain addition.  Every lane of the warp must call it.
__device__ __forceinline__ void fold_pair(double& sum, double& comp,
                                          int off) {
  const double s2 = __shfl_down_sync(0xffffffffu, sum, off);
  const double c2 = __shfl_down_sync(0xffffffffu, comp, off);
  double e;
  two_sum(sum, s2, sum, e);
  comp = (comp + c2) + e;
}

// Lanes of the one-warp stage 2 kernels below, and the partials each lane
// takes at most (nblocks <= kMaxBlocks).
constexpr int kLanes = 32;
constexpr int kLaneSteps = kMaxBlocks / kLanes;

// Stage 2 in one warp per sum, for the kernels that launch it behind stage
// 1 (launch_after): out[k] = sum of the nblocks partials of scalar k =
// blockIdx.x, rounded once to T.  Lane l loads the partials b = l, l + 32,
// ... all at once, adds them in block order, and a fixed shuffle tree adds
// the 32 lanes' sums (warp_sum).  One round of loads and five shuffles,
// where finish_sums takes a strided loop and an 8-level shared-memory tree.
template <typename T>
__global__ void __launch_bounds__(kLanes)
    finish_sums_lanes(const double* __restrict__ partials, int nblocks,
                      T* __restrict__ out) {
  const int lane = threadIdx.x;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * nblocks;
  wait_for_prerequisites();
  double v[kLaneSteps];
#pragma unroll
  for (int j = 0; j < kLaneSteps; ++j) {
    const int b = lane + kLanes * j;
    v[j] = b < nblocks ? partials[row + b] : 0.0;
  }
  double a = 0.0;
#pragma unroll
  for (int j = 0; j < kLaneSteps; ++j) a += v[j];
  a = warp_sum(a);
  if (lane == 0) out[blockIdx.x] = static_cast<T>(a);
}

// Compensated stage 2, one warp per sum k = blockIdx.x, launched with
// kLanes threads a block (launch_finish_compensated).  Lane l runs the
// Neumaier recurrence over the partials b = l, l + 32, l + 64, ... of sum k
// in block order; where stage 1 kept a compensation per partial (comps not
// null, the same layout as partials), the lane adds it to its own
// compensation after that partial.  Then the 32 (sum, compensation) pairs
// fold by a fixed shuffle tree (fold_pair: lane i takes lane i + 16, then
// i + 8, 4, 2, 1), and out[k] = sum + compensation, rounded once to T.
// The dependent chain is 32 steps and 5 folds, where the serial recurrence
// over up to 1024 partials was 1024 steps on one thread; the error stays
// that of the serial Neumaier sum: the rounding of the result plus terms
// of order 2^-106 of the sum of the partials' magnitudes.  The order
// depends on nblocks alone.  fused_ops.py::compensated_sum_plain mirrors
// it operation for operation.
template <typename T>
__global__ void __launch_bounds__(kLanes)
    finish_sums_compensated(const double* __restrict__ partials,
                            const double* __restrict__ comps, int nblocks,
                            T* __restrict__ out) {
  const int lane = threadIdx.x;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * nblocks;
  wait_for_prerequisites();
  double v[kLaneSteps], c[kLaneSteps];
#pragma unroll
  for (int j = 0; j < kLaneSteps; ++j) {
    const int b = lane + kLanes * j;
    v[j] = b < nblocks ? partials[row + b] : 0.0;
    c[j] = comps != nullptr && b < nblocks ? comps[row + b] : 0.0;
  }
  double sum = 0.0, comp = 0.0;
#pragma unroll
  for (int j = 0; j < kLaneSteps; ++j) {
    if (lane + kLanes * j < nblocks) {
      neumaier_add(sum, comp, v[j]);
      if (comps != nullptr) comp += c[j];
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) fold_pair(sum, comp, off);
  if (lane == 0) out[blockIdx.x] = static_cast<T>(sum + comp);
}

// Launches finish_sums_compensated for count sums of nblocks partials each
// (and their compensations, or nullptr) behind the stage-1 kernel on s
// (launch_after; a stage 1 that never calls allow_dependents lets it start
// when it ends, as an ordinary launch would).
template <typename T>
inline void launch_finish_compensated(const double* partials,
                                      const double* comps, int nblocks,
                                      int count, T* out, cudaStream_t s) {
  launch_after(finish_sums_compensated<T>, count, kLanes, s, partials, comps,
               nblocks, out);
}

// Stage 2 of a batched launch, one thread per row r < rows (a (sum, lane)
// pair, r = k * B + lane): out[r] = the sum of partials[r * parts ..
// r * parts + parts) in block order, rounded once to T.  Compensated, the
// row goes through the Neumaier recurrence, and where stage 1 kept a
// compensation per partial (comps not null, the same layout) it is added
// to the compensation after its partial.  With one part per lane, as at
// bench.py's batch cell, out[r] is that partial (plus its compensation)
// rounded once: 0 + p is exact and the recurrence adds nothing.  A lane's
// parts are few (lane_parts: about kMaxBlocks / B), so one thread adds
// them serially, the serial Neumaier sum where compensated.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    finish_rows(const double* __restrict__ partials,
                const double* __restrict__ comps, int parts, int64_t rows,
                bool compensated, T* __restrict__ out) {
  wait_for_prerequisites();
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= rows) return;
  const int64_t at = r * parts;
  double sum = 0.0, comp = 0.0;
  for (int j = 0; j < parts; ++j) {
    if (compensated) {
      neumaier_add(sum, comp, partials[at + j]);
      if (comps != nullptr) comp += comps[at + j];
    } else {
      sum += partials[at + j];
    }
  }
  out[r] = static_cast<T>(sum + comp);
}

// Launches finish_rows for `rows` rows of `parts` partials behind the
// stage-1 kernel on s (launch_after).
template <typename T>
inline void launch_finish_rows(const double* partials, const double* comps,
                               int parts, int64_t rows, bool compensated,
                               T* out, cudaStream_t s) {
  const int64_t blocks = (rows + kThreads - 1) / kThreads;
  launch_after(finish_rows<T>, static_cast<int>(blocks), kThreads, s,
               partials, comps, parts, rows, compensated, out);
}

// Stage 2 of a batched launch whose lanes have many parts (a few lanes of
// a long block, as the batched K-trial kernel runs at sharded_vmap_minimize's
// shapes: 66 parts a lane at 4 lanes), one warp per row r < rows, kThreads
// / 32 rows a block: lane l adds the row's partials l, l + 32, ... in block
// order, and a fixed shuffle tree adds the 32 lanes' sums (warp_sum);
// out[r] is rounded once to T.  The dependent chain is parts / 32 loads
// and adds and five shuffles, where finish_rows walks the whole row on one
// thread.  The order depends on parts alone.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    finish_rows_warps(const double* __restrict__ partials, int parts,
                      int64_t rows, T* __restrict__ out) {
  wait_for_prerequisites();
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (kThreads / kLanes) +
                    (threadIdx.x / kLanes);
  const int lane = threadIdx.x % kLanes;
  if (r >= rows) return;  // the whole warp
  const double* __restrict__ row = partials + r * parts;
  double a = 0.0;
  for (int b = lane; b < parts; b += kLanes) a += row[b];
  a = warp_sum(a);
  if (lane == 0) out[r] = static_cast<T>(a);
}

// Launches stage 2 of an uncompensated batched launch for `rows` rows of
// `parts` partials behind the stage-1 kernel on s (launch_after):
// finish_rows_warps where a lane has at least kLanes parts, so that each
// lane of a warp adds one or more, and finish_rows below that (at one part
// a lane, as at bench.py's batch cell, both give the partial itself).  The
// batched multi_phi takes stage 2 here; multi_phi_dphi, fused_vg and the
// tails keep finish_rows at every parts, as the order of their sums, and so
// their bits, stay those of their first batched design.
template <typename T>
inline void launch_finish_rows_by_parts(const double* partials, int parts,
                                        int64_t rows, T* out,
                                        cudaStream_t s) {
  if (parts < kLanes) {
    launch_finish_rows<T>(partials, nullptr, parts, rows, false, out, s);
    return;
  }
  constexpr int64_t per_block = kThreads / kLanes;
  const int64_t blocks = (rows + per_block - 1) / per_block;
  launch_after(finish_rows_warps<T>, static_cast<int>(blocks), kThreads, s,
               partials, parts, rows, out);
}

}  // namespace
}  // namespace tl
