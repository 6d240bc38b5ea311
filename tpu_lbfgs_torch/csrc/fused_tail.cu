// The solver's post-line-search tail for a suite problem in one pass.
//
// Replaces the Pallas kernel tpu_lbfgs/kernels/pallas_ops.py
// _make_tail_kernel (run by _fused_tail_pallas) with each body of
// TAIL_BODIES, with and without with_matvec, plain and compensated, with
// the ring rows in float32 or bfloat16.  One kernel, a template on the
// problem's body (bodies.cuh), the history's type and whether it forms the
// products; the history depth m is a runtime count.
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
// the ring's 2 m values per element with the products (8.76 us at n = 2^20;
// 33.80 us with an f32 ring at m = 10, 20.03 with a bf16 one, on an H100).
// So everything the iteration needs after the line search comes out of
// this one read of x, d and g, with the sums reduced in the same pass.
// alpha is read from device memory: the line search leaves it there and
// the host never waits for it.
//
// The first design, one element per thread per step with the 2 m ring
// sums in each thread's registers as float64, waited on latency: 90 us at
// m = 10 for the 33.80 us bound, 80-128 registers, three blocks per SM and
// five 8-level shared-memory trees per block (NVIDIA H100 80GB HBM3,
// 700 W).  Four blocks per SM, float32 sums, no trees or 16-byte loads
// each took a third off, none alone came near the bound, and forcing four
// blocks at m = 20 spilled and ran 2.5x slower.  So this kernel works in
// tiles of kTile elements:
// - each thread owns a run of kRun consecutive elements and loads and
//   stores it 16 bytes at a time (bfloat16 rows 8); a chain body's
//   neighbours x_new[i+-1] come from the thread's own registers and, at
//   the run's ends, from the neighbouring lanes by shuffle, with one load
//   at a warp's edge.  The TPU kernel shifted the formed x_new through an
//   SMEM carry and an 8-row halo DMA instead.  The ragged end is masked by
//   index, so any n works;
// - the products: the threads put y, widened to double, into shared
//   memory, and warp w takes ring rows w, w + 8, ... of S and Y, a row's
//   16-byte loads in flight together (eight a lane, four for bf16), and
//   adds its tile's share of each row into the block's partial in
//   global memory, tile after tile in a fixed order.  Each product is
//   formed and added in double, as the plain version's float64 matmul
//   forms it; the m rows are a runtime loop, so any m works, and no sum
//   of the ring lives in a register across tiles;
// - the seven sums stay in double in each thread and reduce once per block
//   by warp shuffles (reduce.cuh::block_sum_warps), not by trees.
// On the same card this design takes 45.90 us at m = 10 on an f32 ring (73%
// of the bytes bound; the tail without products and two torch.mv: 58.20),
// 38.40 on a bf16 ring, 11.49 without products (the main path's form;
// 14.5 before), with 64 registers and four blocks per SM.
// The ring is only read: the kernel writes the new rows to their own
// buffers, and the solver stores them after its curvature test and patches
// the slot's own entries of t1 and t2 from the exact sums.
//
// The compensated form (the TPU kernel's `compensated` flag) adds the block
// partials of the seven sums by the Neumaier recurrence, one warp per sum
// (reduce.cuh::finish_sums_compensated); t1 and t2 stay plain, as the TPU
// kernel's do.
//
// The shard-local form (kShard; replaces tpu_lbfgs/dist/pallas_sharded.py
// shardmap_fused_tail's per-shard call of _fused_tail_pallas with n, start
// and edges) runs the same kernel on one shard's blocks of x, d, g and the
// ring: term ownership and the zero-padded tail go by the global index
// (bodies.cuh::Shard), elements 0 and n - 1 take their outer trial-point
// neighbours from edges = [previous shard's last x and d, next shard's
// first x and d] in device memory through the same trial_point, and
// all 7 + 2 m sums come back as float64, unrounded (compensated: the
// Neumaier sum and its correction added in float64), for the caller's one
// packed float64 all-reduce.  The whole-vector form is the instantiation
// without kShard.
//
// The batched form (kBatched, tl_fused_tail_batched_f32; the reference's
// jax.vmap over _fused_tail_pallas, as solve_bounded / iterate run it over
// a batched state with fused_tail_for) takes B lanes: x, d, g and the two
// rows (B, n), the ring (B, m, n), one alpha per lane, and gives the
// 7 + 2 m sums per lane.  It is the same kernel on a batched walk
// (reduce.cuh): a block works on one lane's rows and that lane's own ring
// only, so a lane's trial-point chain ends at its own row's ends by the
// whole vector's index tests, and its products go to its own partials.
// Stage 2 is one thread per (sum, lane) (reduce.cuh::finish_rows: the
// seven sums by the Neumaier recurrence where compensated, t1 and t2
// plain).  A row whose start is off 16 bytes (n not a multiple of 4)
// takes the element path throughout, the ring's rows too.
//
// The batched shard-local form (kShard and kBatched,
// tl_fused_tail_local_batched_f32; the reference's jax.vmap over
// shardmap_fused_tail, as sharded_vmap_minimize runs it) is the batched
// form on B lanes of one shard's blocks: the lanes share start and
// n_global, each lane has its own alpha and its own edges row of (B, 4),
// and its 7 + 2 m sums come back as float64 partials, unrounded.
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
// The deepest ring the products form takes: its 7 + 2 m stage-2 blocks.
constexpr int kMaxDepth = 1 << 20;
// Each thread owns a run of kRun consecutive elements of a tile of kTile,
// loaded and stored 16 (bfloat16 rows: 8) bytes at a time.
constexpr int kRun = 4;
constexpr int kTile = tl::kThreads * kRun;
constexpr int kWarps = tl::kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

inline int tile_blocks(int64_t n) {
  const int64_t b = (n + kTile - 1) / kTile;
  return static_cast<int>(b < tl::kMaxBlocks ? b : tl::kMaxBlocks);
}

// A run of kRun floats at p[i0..]: one 16-byte access where `vec` says the
// pointers are aligned and the run lies inside n, else one per element
// below n (0 beyond it).
__device__ __forceinline__ void load_run(const float* __restrict__ p,
                                         int64_t i0, int64_t n, bool vec,
                                         float (&v)[kRun]) {
  if (vec && i0 + kRun <= n) {
    const float4 q = *reinterpret_cast<const float4*>(p + i0);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j) v[j] = i0 + j < n ? p[i0 + j] : 0.0f;
  }
}
__device__ __forceinline__ void store_run(float* __restrict__ p, int64_t i0,
                                          int64_t n, bool vec,
                                          const float (&v)[kRun]) {
  if (vec && i0 + kRun <= n) {
    *reinterpret_cast<float4*>(p + i0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (i0 + j < n) p[i0 + j] = v[j];
    }
  }
}
__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}
__device__ __forceinline__ void store_run(__nv_bfloat16* __restrict__ p,
                                          int64_t i0, int64_t n, bool vec,
                                          const float (&v)[kRun]) {
  if (vec && i0 + kRun <= n) {
    *reinterpret_cast<uint2*>(p + i0) =
        make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (i0 + j < n) p[i0 + j] = __float2bfloat16_rn(v[j]);
    }
  }
}

// One lane's share of row . y over a tile of len elements, y in shared
// memory as double: each product is formed and added in double, as the plain
// version's float64 matmul forms it.  A whole aligned tile takes
// kTile / 32 / V 16-byte loads a lane, all issued before the first is used.
__device__ __forceinline__ double row_dot(const float* __restrict__ row,
                                          const double* y, int64_t len,
                                          bool vec, int lane) {
  constexpr int V = 4, kLoads = kTile / V / 32;
  double v = 0.0;
  if (vec && len == kTile) {
    float4 q[kLoads];
#pragma unroll
    for (int c = 0; c < kLoads; ++c) {
      q[c] = reinterpret_cast<const float4*>(row)[lane + 32 * c];
    }
#pragma unroll
    for (int c = 0; c < kLoads; ++c) {
      const double* yy = y + (lane + 32 * c) * V;
      v += static_cast<double>(q[c].x) * yy[0];
      v += static_cast<double>(q[c].y) * yy[1];
      v += static_cast<double>(q[c].z) * yy[2];
      v += static_cast<double>(q[c].w) * yy[3];
    }
  } else {
    for (int64_t e = lane; e < len; e += 32) {
      v += static_cast<double>(row[e]) * y[e];
    }
  }
  return v;
}
// The same for a bfloat16 row, 8 values a load; a bfloat16 is the high half
// of the float it widens to.
__device__ __forceinline__ double row_dot(
    const __nv_bfloat16* __restrict__ row, const double* y, int64_t len,
    bool vec, int lane) {
  constexpr int V = 8, kLoads = kTile / V / 32;
  double v = 0.0;
  if (vec && len == kTile) {
    uint4 q[kLoads];
#pragma unroll
    for (int c = 0; c < kLoads; ++c) {
      q[c] = reinterpret_cast<const uint4*>(row)[lane + 32 * c];
    }
#pragma unroll
    for (int c = 0; c < kLoads; ++c) {
      const double* yy = y + (lane + 32 * c) * V;
      const unsigned w[4] = {q[c].x, q[c].y, q[c].z, q[c].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v += static_cast<double>(__uint_as_float(w[j] << 16)) * yy[2 * j];
        v += static_cast<double>(__uint_as_float(w[j] & 0xffff0000u)) *
             yy[2 * j + 1];
      }
    }
  } else {
    for (int64_t e = lane; e < len; e += 32) {
      v += static_cast<double>(__bfloat162float(row[e])) * y[e];
    }
  }
  return v;
}

// The tail with the history products, any m >= 1 (or, with kProducts
// false, without them).  Per tile: each thread forms its run of x_new, f,
// g_new, s and y, with the trial point's chain neighbours from its own
// registers and, at a run's two ends, from the neighbouring lanes by
// shuffle (one load at a warp's edge); it stores the run and puts y, in
// double, into shared memory.  Then warp w takes ring rows w, w + kWarps,
// ... of the 2 m rows of S and Y (each read once, 16 bytes a lane) against
// that y and adds its tile's sum of each row into the block's partial of
// t1 or t2 in global memory, tile after tile in a fixed order.  The seven
// sums stay in double in each thread and reduce once per block by warp
// shuffles.
//
// kBatched: the batched walk (reduce.cuh), lane w.lane's rows, ring and
// alpha; one instance is lane 0 of a plain walk.
template <typename Body, typename H, bool kProducts, bool kShard,
          bool kBatched>
__global__ void __launch_bounds__(tl::kThreads, 4)
    tail_tile_kernel(const float* __restrict__ x, const float* __restrict__ d,
                     const float* __restrict__ g,
                     const float* __restrict__ alpha,
                     const H* __restrict__ s_hist,
                     const H* __restrict__ y_hist, float* __restrict__ x_new,
                     float* __restrict__ g_new, H* __restrict__ s_row,
                     H* __restrict__ y_row, double* __restrict__ partials,
                     int64_t n, int m, bool vec, bool ring_vec,
                     tl::Shard shard, int parts) {
  __shared__ double ysh[kProducts ? kTile : 1];
  const tl::Walk w = tl::walk<kBatched>(parts);
  if constexpr (kBatched) {
    const int64_t row = w.lane * n;
    x += row;
    d += row;
    g += row;
    x_new += row;
    g_new += row;
    s_row += row;
    y_row += row;
    s_hist += row * m;
    y_hist += row * m;
  }
  const float a = alpha[w.lane];
  const int lane = threadIdx.x & 31;
  // A shard's outer neighbours; the whole vector has none (a body reads
  // x_new[-1] and x_new[n] behind its index tests only).
  float e_prev = 0.0f, e_next = 0.0f;
  if constexpr (kShard && Body::kNeighbours) {
    const float* edges = shard.edges + (kBatched ? 4 * w.lane : 0);
    e_prev = tl::trial_point(edges[0], edges[1], a);
    e_next = tl::trial_point(edges[2], edges[3], a);
  }
  double acc[kSums] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  const int64_t first = w.first * kTile;
  for (int64_t base = first; base < n; base += w.step * kTile) {
    const int64_t i0 = base + static_cast<int64_t>(threadIdx.x) * kRun;
    float xs[kRun], ds[kRun], gs[kRun];
    load_run(x, i0, n, vec, xs);
    load_run(d, i0, n, vec, ds);
    load_run(g, i0, n, vec, gs);
    float s[kRun], xn[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      s[j] = __fmul_rn(a, ds[j]);
      xn[j] = __fadd_rn(xs[j], s[j]);  // = trial_point(xs[j], ds[j], a)
    }
    float xn_prev = 0.0f, xn_next = 0.0f;
    if constexpr (Body::kNeighbours) {
      xn_prev = __shfl_up_sync(kFull, xn[kRun - 1], 1);
      xn_next = __shfl_down_sync(kFull, xn[0], 1);
      if (lane == 0 && i0 >= 1 && i0 <= n) {
        xn_prev = tl::trial_point(x[i0 - 1], d[i0 - 1], a);
      }
      if (lane == 31 && i0 + kRun < n) {
        xn_next = tl::trial_point(x[i0 + kRun], d[i0 + kRun], a);
      }
    }
    float gn[kRun], y[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int64_t i = i0 + j;
      gn[j] = 0.0f;
      y[j] = 0.0f;
      if (i >= n) continue;
      float xp = 0.0f, xf = 0.0f;
      if constexpr (Body::kNeighbours) {
        xp = i == 0 ? e_prev : (j > 0 ? xn[j - 1] : xn_prev);
        xf = i == n - 1 ? e_next : (j < kRun - 1 ? xn[j + 1] : xn_next);
      }
      if constexpr (kShard) {
        const int64_t at = shard.start + i;
        gn[j] = at < shard.n_global
                    ? Body::fg(xn[j], xp, xf, at, shard.n_global, acc[0])
                    : 0.0f;
      } else {
        gn[j] = Body::fg(xn[j], xp, xf, i, n, acc[0]);
      }
      y[j] = gn[j] - gs[j];
      acc[1] += static_cast<double>(s[j]) * y[j];
      acc[2] += static_cast<double>(y[j]) * y[j];
      acc[3] += static_cast<double>(gn[j]) * gn[j];
      acc[4] += static_cast<double>(ds[j]) * gn[j];
      acc[5] += static_cast<double>(gs[j]) * gn[j];
      acc[6] += static_cast<double>(y[j]) * gn[j];
    }
    store_run(x_new, i0, n, vec, xn);
    store_run(g_new, i0, n, vec, gn);
    store_run(s_row, i0, n, vec, s);
    store_run(y_row, i0, n, vec, y);
    if constexpr (kProducts) {
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        ysh[threadIdx.x * kRun + j] = static_cast<double>(y[j]);
      }
      __syncthreads();
      const int64_t len = n - base < kTile ? n - base : kTile;
      for (int r = threadIdx.x >> 5; r < 2 * m; r += kWarps) {
        const H* row = (r < m ? s_hist + static_cast<int64_t>(r) * n
                              : y_hist + static_cast<int64_t>(r - m) * n) +
                       base;
        const double v = tl::warp_sum(row_dot(row, ysh, len, ring_vec, lane));
        if (lane == 0) {
          double* slot = partials +
                         static_cast<int64_t>(kSums + r) * gridDim.x +
                         blockIdx.x;
          *slot = base == first ? v : *slot + v;
        }
      }
      __syncthreads();  // ysh is rewritten by the next tile
    }
  }
  tl::block_sum_warps<kSums>(acc, partials);
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
  int64_t lanes = 1;  // the batched form's lanes
};

// T: the type of the sums, float (rounded once) or double (a shard's
// partials, unrounded).
template <typename T>
void finish(const Args& p, int blocks, int m) {
  T* sums = static_cast<T*>(p.sums);
  if (p.compensated) {
    tl::launch_finish_compensated(p.partials, nullptr, blocks, kSums, sums,
                                  p.stream);
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

// The batched forms' stage 2: the seven sums of every lane (Neumaier where
// compensated), then t1 and t2 (plain), rows k * lanes + lane; T as in
// finish.
template <typename T>
void finish_batched(const Args& p, int blocks, int parts, int m) {
  T* sums = static_cast<T*>(p.sums);
  if (p.compensated && m > 0) {
    tl::launch_finish_rows(p.partials, nullptr, parts, kSums * p.lanes, true,
                           sums, p.stream);
    tl::launch_finish_rows(p.partials + static_cast<int64_t>(kSums) * blocks,
                           nullptr, parts, 2 * m * p.lanes, false,
                           sums + kSums * p.lanes, p.stream);
  } else {
    tl::launch_finish_rows(p.partials, nullptr, parts,
                           (kSums + 2 * m) * p.lanes, p.compensated, sums,
                           p.stream);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename Body, typename H, bool kShard>
void launch(const Args& p, int m) {
  const H* s_hist = static_cast<const H*>(p.s_hist);
  const H* y_hist = static_cast<const H*>(p.y_hist);
  H* s_row = static_cast<H*>(p.s_row);
  H* y_row = static_cast<H*>(p.y_row);
  const bool vec = aligned16(p.x) && aligned16(p.d) && aligned16(p.g) &&
                   aligned16(p.x_new) && aligned16(p.g_new) &&
                   aligned16(s_row) && aligned16(y_row);
  const bool ring_vec = m > 0 && aligned16(s_hist) && aligned16(y_hist) &&
                        p.n * static_cast<int64_t>(sizeof(H)) % 16 == 0;
  const int blocks = tile_blocks(p.n);
  if (m == 0) {
    tail_tile_kernel<Body, H, false, kShard, false>
        <<<blocks, tl::kThreads, 0, p.stream>>>(
            p.x, p.d, p.g, p.alpha, s_hist, y_hist, p.x_new, p.g_new, s_row,
            y_row, p.partials, p.n, 0, vec, false, p.shard, 0);
  } else {
    tail_tile_kernel<Body, H, true, kShard, false>
        <<<blocks, tl::kThreads, 0, p.stream>>>(
            p.x, p.d, p.g, p.alpha, s_hist, y_hist, p.x_new, p.g_new, s_row,
            y_row, p.partials, p.n, m, vec, ring_vec, p.shard, 0);
  }
  if (kShard) {
    finish<double>(p, blocks, m);
  } else {
    finish<float>(p, blocks, m);
  }
}

// The batched forms: p.lanes rows of p.n, each lane's tiles walked by parts
// blocks (about one kMaxBlocks grid in all, as the whole vector's).
template <typename Body, typename H, bool kShard>
void launch_batched(const Args& p, int m) {
  const H* s_hist = static_cast<const H*>(p.s_hist);
  const H* y_hist = static_cast<const H*>(p.y_hist);
  H* s_row = static_cast<H*>(p.s_row);
  H* y_row = static_cast<H*>(p.y_row);
  // Every row starts 16-byte aligned (the bfloat16 rows 8-byte) only if n
  // is a multiple of 4.
  const bool rows4 = p.n % 4 == 0;
  const bool vec = aligned16(p.x) && aligned16(p.d) && aligned16(p.g) &&
                   aligned16(p.x_new) && aligned16(p.g_new) &&
                   aligned16(s_row) && aligned16(y_row) && rows4;
  const bool ring_vec = m > 0 && aligned16(s_hist) && aligned16(y_hist) &&
                        p.n * static_cast<int64_t>(sizeof(H)) % 16 == 0;
  const int parts = tl::lane_parts(p.lanes, (p.n + kTile - 1) / kTile,
                                   tl::kMaxBlocks);
  const int64_t blocks = p.lanes * parts;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (m == 0) {
    tail_tile_kernel<Body, H, false, kShard, true>
        <<<grid, tl::kThreads, 0, p.stream>>>(
            p.x, p.d, p.g, p.alpha, s_hist, y_hist, p.x_new, p.g_new, s_row,
            y_row, p.partials, p.n, 0, vec, false, p.shard, parts);
  } else {
    tail_tile_kernel<Body, H, true, kShard, true>
        <<<grid, tl::kThreads, 0, p.stream>>>(
            p.x, p.d, p.g, p.alpha, s_hist, y_hist, p.x_new, p.g_new, s_row,
            y_row, p.partials, p.n, m, vec, ring_vec, p.shard, parts);
  }
  if (kShard) {
    finish_batched<double>(p, static_cast<int>(blocks), parts, m);
  } else {
    finish_batched<float>(p, static_cast<int>(blocks), parts, m);
  }
}

template <bool kShard, bool kBatched = false>
int run(int body, int hist_bf16, int m, const Args& p) {
  if (p.n < 1 || m < 0 || m > kMaxDepth || p.lanes < 1 ||
      p.lanes > tl::kMaxLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bool known;
  if constexpr (kBatched) {
    known = TL_DISPATCH_BODY(
        body, hist_bf16 ? launch_batched<Body, __nv_bfloat16, kShard>(p, m)
                        : launch_batched<Body, float, kShard>(p, m));
  } else {
    known = TL_DISPATCH_BODY(
        body, hist_bf16 ? launch<Body, __nv_bfloat16, kShard>(p, m)
                        : launch<Body, float, kShard>(p, m));
  }
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// body: 0 quadratic, 1 rosenbrock, 2 coupled quadratic.  hist_bf16: nonzero
// when the ring and the two rows are bfloat16, else they are float.  m: 0
// for no matvec (s_hist and y_hist are then not read), else the ring's depth,
// any m up to kMaxDepth.  compensated: nonzero for the Neumaier stage 2 of
// the seven sums.  x, d, g, x_new, g_new: n floats on the device; s_row,
// y_row: n ring values; s_hist, y_hist: m * n ring values, row-major
// (m, n); alpha: one float on the device.  partials: (7 + 2 m) *
// tl_max_blocks() doubles of scratch.  sums: 7 + 2 m floats, in the order
// f, s.y, y.y, g_new.g_new, d.g_new, g.g_new, y.g_new, t1[0..m), t2[0..m).
// Returns the cudaError_t of the launches (cudaErrorInvalidValue for n < 1,
// an unknown body or m outside [0, kMaxDepth]).
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

// The batched form: the same arguments over lanes lanes (x, d, g, x_new,
// g_new, s_row, y_row: (lanes, n) row-major; s_hist, y_hist: (lanes, m, n);
// alpha: lanes floats), then lanes.  partials: (7 + 2 m) * (lanes +
// tl_max_blocks()) doubles of scratch.  sums: (7 + 2 m) * lanes floats,
// row-major (7 + 2 m, lanes) in the order above.  Returns
// cudaErrorInvalidValue also for lanes outside [1, 2^31 - 1 -
// tl_max_blocks()].
extern "C" int tl_fused_tail_batched_f32(
    int body, int hist_bf16, int m, int compensated, const float* x,
    const float* d, const float* g, const float* alpha, const void* s_hist,
    const void* y_hist, float* x_new, float* g_new, void* s_row, void* y_row,
    double* partials, float* sums, long long lanes, long long n,
    void* stream) {
  const Args p{x, d, g, alpha, s_hist, y_hist, x_new, g_new, s_row, y_row,
               partials, sums, n, compensated != 0,
               static_cast<cudaStream_t>(stream), tl::Shard{}, lanes};
  return run<false, true>(body, hist_bf16, m, p);
}

// The batched shard-local form: the batched form's arguments over lanes
// lanes of one shard's blocks (n elements a row; s_hist, y_hist (lanes, m,
// n)), then n_global and start, shared by the lanes, and edges, 4 * lanes
// floats on the device, row-major (lanes, 4), each lane's [previous shard's
// last x, its last d, next shard's first x, its first d].  sums: (7 + 2 m)
// * lanes doubles, row-major (7 + 2 m, lanes), each lane's partials in the
// order above.
extern "C" int tl_fused_tail_local_batched_f32(
    int body, int hist_bf16, int m, int compensated, const float* x,
    const float* d, const float* g, const float* alpha, const void* s_hist,
    const void* y_hist, float* x_new, float* g_new, void* s_row, void* y_row,
    double* partials, double* sums, long long lanes, long long n,
    long long n_global, long long start, const float* edges, void* stream) {
  if (start < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args p{x, d, g, alpha, s_hist, y_hist, x_new, g_new, s_row, y_row,
               partials, sums, n, compensated != 0,
               static_cast<cudaStream_t>(stream),
               tl::Shard{n_global, start, edges}, lanes};
  return run<true, true>(body, hist_bf16, m, p);
}

// Blocks of the products form (body, ring type) that fit on one SM of the
// current device, by cudaOccupancyMaxActiveBlocksPerMultiprocessor; -1 for
// an unknown body.
extern "C" int tl_fused_tail_blocks_per_sm(int body, int hist_bf16) {
  int blocks = -1;
  TL_DISPATCH_BODY(
      body,
      if (hist_bf16) {
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks,
            tail_tile_kernel<Body, __nv_bfloat16, true, false, false>,
            tl::kThreads, 0);
      } else {
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, tail_tile_kernel<Body, float, true, false, false>,
            tl::kThreads, 0);
      });
  return blocks;
}
