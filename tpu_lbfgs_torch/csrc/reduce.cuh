// Deterministic two-stage sums shared by the kernels of this directory.
//
// Stage 1: every block of a grid-stride kernel folds its threads' running
// sums (kept in double) into one partial per scalar, by a fixed tree in
// shared memory (block_sum_to) or by warp shuffles (block_sum_warps).
// Stage 2: one block per scalar sums its partials in a
// fixed order.  No float atomics, and the block count depends on n alone,
// so a result repeats bit for bit from run to run and from card to card.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tl {

constexpr int kThreads = 256;
// Cap on stage-1 blocks.  1024 blocks of 256 threads fill an H100's 132
// SMs about eight blocks deep; more blocks would only lengthen stage 2.
constexpr int kMaxBlocks = 1024;

inline int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

namespace {

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

// Compensated stage 2, one block per sum: the block's threads bring the
// sum's partials into shared memory, then one thread runs the Neumaier
// recurrence over them in block order: a running sum and, beside it, the
// sum of the low-order bits each addition dropped.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    finish_sums_neumaier(const double* __restrict__ partials, int nblocks,
                         T* __restrict__ out) {
  __shared__ double sh[kMaxBlocks];
  const double* __restrict__ row =
      partials + static_cast<int64_t>(blockIdx.x) * nblocks;
  for (int b = threadIdx.x; b < nblocks; b += kThreads) sh[b] = row[b];
  __syncthreads();
  if (threadIdx.x != 0) return;
  double sum = 0.0, comp = 0.0;
  for (int b = 0; b < nblocks; ++b) {
    const double p = sh[b];
    const double t = sum + p;
    // |sum| >= |p|: the low-order bits of p were dropped, else those of sum.
    comp += fabs(sum) >= fabs(p) ? (sum - t) + p : (p - t) + sum;
    sum = t;
  }
  out[blockIdx.x] = static_cast<T>(sum + comp);
}

}  // namespace
}  // namespace tl
