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

// block_sum_to for K sums taken kChunk at a time, so that the tree's shared
// memory stays at kChunk * kThreads doubles however large K is: sum k goes to
// partials[k * gridDim.x + blockIdx.x] as above.
template <int K, int kChunk>
__device__ __forceinline__ void block_sum_chunks(
    const double (&acc)[K], double* __restrict__ partials) {
  static_assert(K % kChunk == 0, "K must be a multiple of the chunk");
#pragma unroll
  for (int c = 0; c < K / kChunk; ++c) {
    double part[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) part[j] = acc[c * kChunk + j];
    block_sum_to<kChunk>(
        part, partials + static_cast<int64_t>(c) * kChunk * gridDim.x);
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
