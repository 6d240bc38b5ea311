// Deterministic two-stage sums shared by the kernels of this directory.
//
// Stage 1: every block of a grid-stride kernel folds its threads' running
// sums (kept in double) into one partial per scalar, by a fixed tree in
// shared memory.  Stage 2: one block per scalar sums its partials in a
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

}  // namespace
}  // namespace tl
