// A suite problem's f(x) and analytic gradient in one read of x.
//
// Replaces the Pallas kernels tpu_lbfgs/kernels/pallas_ops.py
// _vg_quadratic_kernel, _vg_rosenbrock_kernel and _vg_coupled_kernel (run by
// _run_vg through fused_vg_quadratic, fused_vg_rosenbrock and
// fused_vg_coupled_quadratic).  One kernel, a template on the problem's body
// (bodies.cuh).
//
// Bound by device-memory bytes: 8 bytes move per element (x in, g out) for
// 3 to 15 flops, 2.50 us at n = 2^20 on an H100.  So the design reads x
// once and writes g once, and reduces f in the same pass (reduce.cuh).
//
// The first design, one element per thread per step with both neighbours
// loaded beside it, 1024 blocks, a 9-level shared-memory tree per block and
// stage 2 as a second ordinary launch, took 7.85 us for Rosenbrock (NVIDIA
// H100 80GB HBM3, 700 W), mostly fixed cost: the two launches and their
// block sums.  This design:
// - each thread owns a run of kRun = 4 consecutive elements of a tile,
//   loaded and stored 16 bytes at a time where x and g are aligned
//   (element by element otherwise and at the ragged end, so any n and any
//   offset work); a chain body's neighbours come from the thread's own
//   registers and, at the run's ends, from the neighbouring lanes by
//   shuffle, with one load at a warp's edge, where the TPU kernels needed
//   an SMEM carry and an 8-row halo DMA;
// - a run whose elements all have both neighbours and a term takes the
//   bodies' fg<true>, with no index test per element; the others (at most
//   two runs a vector) test their indices;
// - one wave of blocks (kBlocksPerSM a multiprocessor), each walking its
//   tiles in a fixed order;
// - the block sum by warp shuffles (reduce.cuh::block_sum_warps);
// - stage 2 in one warp (reduce.cuh::finish_sums_lanes), launched behind
//   stage 1 by programmatic dependent launch (reduce.cuh::launch_after):
//   its launch overlaps stage 1, where an ordinary launch waited for
//   stage 1 to drain.
//
// The per-element arithmetic is written in the order of the plain PyTorch
// versions (tpu_lbfgs_torch/kernels/fused_ops.py::VG_PLAIN), and the library
// is built with -fmad=false, so g matches them bit for bit.
//
// The shard-local form (kShard; replaces tpu_lbfgs/dist/pallas_sharded.py
// shardmap_fused_vg's per-shard call of local_fused_vg) runs the same
// kernel on one shard's block of x: element i has the global index
// start + i, a term exists where that index says so against the global
// unpadded length n_global (a zero-padded tail contributes nothing and gets
// zero gradient), and elements 0 and n - 1 take their outer neighbours
// from edges = [previous shard's last x, next shard's first x] in device
// memory; only the runs that hold them read edges, so every other run takes
// the same interior path as the whole vector's.  Its f is the float64 sum,
// unrounded: the caller adds the shards' partials in one float64
// all-reduce and rounds once.  The whole-vector form is the instantiation
// without kShard.
//
// The batched form (kBatched, tl_fused_vg_batched_f32; the reference's
// jax.vmap over _run_vg, as vmap_minimize runs a caller's
// fused_value_and_grad) takes B lanes of n elements, a (B, n) row-major x,
// and gives f per lane.  It is the same kernel on a batched walk
// (reduce.cuh): a block works on one lane's row only, so each lane's chain
// starts and ends at its own row's ends by the same index tests as one
// vector's (a lane's first element has no backward neighbour, its last no
// forward one and, for Rosenbrock, no term), and the warp-edge loads stay
// inside the row.  Stage 2 is one thread per lane
// (reduce.cuh::finish_rows).  A row whose start is off 16 bytes (n not a
// multiple of 4) takes the element path throughout.
//
// The batched shard-local form (kShard and kBatched,
// tl_fused_vg_local_batched_f32; the reference's jax.vmap over
// shardmap_fused_vg, as sharded_vmap_minimize runs it) takes B lanes of one
// shard's block, (B, n) rows that share start and n_global, and edges as
// (B, 2) rows, each lane's [previous shard's last x, next shard's first x].
// It is the batched walk with the shard's index tests: the block that
// walks a lane's first tile reads that lane's first edge, the block that
// walks its last tile its second, and each lane's f comes back as its
// float64 partial, unrounded.
#include "bodies.cuh"
#include "reduce.cuh"

namespace {

constexpr int kRun = 4;  // consecutive elements per thread and tile
constexpr int kTile = tl::kThreads * kRun;
constexpr int kSMs = 132;         // an H100's
constexpr int kBlocksPerSM = 4;   // one wave
constexpr unsigned kFull = 0xffffffffu;

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

template <typename Body, bool kShard, bool kBatched>
__global__ void __launch_bounds__(tl::kThreads, kBlocksPerSM)
    vg_kernel(const float* __restrict__ x, float* __restrict__ g,
              double* __restrict__ partials, int64_t n, bool vec,
              tl::Shard shard, int parts) {
  tl::allow_dependents();
  const tl::Walk w = tl::walk<kBatched>(parts);
  if constexpr (kBatched) {
    x += w.lane * n;
    g += w.lane * n;
  }
  double acc[1] = {0.0};
  const int lane = threadIdx.x & 31;
  const int64_t start = kShard ? shard.start : 0;
  const int64_t n_total = kShard ? shard.n_global : n;
  // A shard's outer neighbours: only the threads that will hold its first
  // and its last element read them, here, so that the loads overlap the
  // run's own (loaded where they are used, they held up those two warps).
  // A lane's first tile is its walk's tile 0, its last tile the one its
  // walk reaches at (last / kTile) mod step.
  float e_prev = 0.0f, e_next = 0.0f;
  if constexpr (kShard && Body::kNeighbours) {
    const float* edges = shard.edges + (kBatched ? 2 * w.lane : 0);
    const int64_t last = n - 1;
    if (w.first == 0 && threadIdx.x == 0) e_prev = edges[0];
    if ((last / kTile) % w.step == w.first &&
        (last % kTile) / kRun == threadIdx.x) {
      e_next = edges[1];
    }
  }
  for (int64_t base = w.first * kTile; base < n; base += w.step * kTile) {
    const int64_t i0 = base + static_cast<int64_t>(threadIdx.x) * kRun;
    const bool whole = vec && i0 + kRun <= n;
    float xs[kRun];
    if (whole) {
      const float4 q = *reinterpret_cast<const float4*>(x + i0);
      xs[0] = q.x; xs[1] = q.y; xs[2] = q.z; xs[3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < kRun; ++e) xs[e] = i0 + e < n ? x[i0 + e] : 0.0f;
    }
    // The run's outer neighbours, x[i0 - 1] and x[i0 + kRun] (0 outside
    // the block; a body reads them behind its index tests only).
    float xprev = 0.0f, xnext = 0.0f;
    if constexpr (Body::kNeighbours) {
      xprev = __shfl_up_sync(kFull, xs[kRun - 1], 1);
      xnext = __shfl_down_sync(kFull, xs[0], 1);
      if (lane == 0) xprev = i0 >= 1 && i0 <= n ? x[i0 - 1] : 0.0f;
      if (lane == 31) xnext = i0 + kRun < n ? x[i0 + kRun] : 0.0f;
    }
    float gs[kRun];
    if (i0 >= 1 && i0 + kRun < n && start + i0 + kRun < n_total) {
      // Every element has both neighbours in the block and, by its global
      // index, both neighbours and a term.
#pragma unroll
      for (int e = 0; e < kRun; ++e) {
        const float xp = e > 0 ? xs[e - 1] : xprev;
        const float xf = e < kRun - 1 ? xs[e + 1] : xnext;
        gs[e] = Body::template fg<true>(xs[e], xp, xf, start + i0 + e,
                                        n_total, acc[0]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kRun; ++e) {
        const int64_t i = i0 + e;
        gs[e] = 0.0f;
        if (i >= n) continue;
        float xp = e > 0 ? xs[e - 1] : xprev;
        float xf = e < kRun - 1 ? xs[e + 1] : xnext;
        if constexpr (kShard) {
          if (i == 0) xp = e_prev;
          if (i == n - 1) xf = e_next;
          const int64_t at = start + i;
          gs[e] = at < n_total ? Body::fg(xs[e], xp, xf, at, n_total, acc[0])
                               : 0.0f;
        } else {
          gs[e] = Body::fg(xs[e], xp, xf, i, n, acc[0]);
        }
      }
    }
    if (whole) {
      *reinterpret_cast<float4*>(g + i0) =
          make_float4(gs[0], gs[1], gs[2], gs[3]);
    } else {
#pragma unroll
      for (int e = 0; e < kRun; ++e) {
        if (i0 + e < n) g[i0 + e] = gs[e];
      }
    }
  }
  tl::block_sum_warps<1>(acc, partials);
}

// Both stages: the kernel on one wave of blocks, then finish_sums_lanes
// behind it.
template <bool kShard, typename Out>
int launch(int body, const float* x, float* g, double* partials, Out* f,
           long long n, void* stream, const tl::Shard& shard) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = tile_blocks(n);
  const bool vec = aligned16(x) && aligned16(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool known = TL_DISPATCH_BODY(
      body, vg_kernel<Body, kShard, false><<<blocks, tl::kThreads, 0, s>>>(
                x, g, partials, n, vec, shard, 0));
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  tl::launch_after(tl::finish_sums_lanes<Out>, 1, tl::kLanes, s, partials,
                   blocks, f);
  return static_cast<int>(cudaGetLastError());
}

// The batched forms: lanes rows of n, each lane's tiles walked by parts
// blocks, then finish_rows over the lanes (f in float, or a shard's float64
// partials).
template <bool kShard, typename Out>
int launch_batched(int body, const float* x, float* g, double* partials,
                   Out* f, long long lanes, long long n, void* stream,
                   const tl::Shard& shard) {
  if (n < 1 || lanes < 1 || lanes > tl::kMaxLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int parts = tl::lane_parts(lanes, (n + kTile - 1) / kTile,
                                   kBlocksPerSM * kSMs);
  const unsigned grid = static_cast<unsigned>(lanes * parts);
  // Every row starts 16-byte aligned only if n floats fill whole 16 bytes.
  const bool vec = aligned16(x) && aligned16(g) && n % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool known = TL_DISPATCH_BODY(
      body, vg_kernel<Body, kShard, true><<<grid, tl::kThreads, 0, s>>>(
                x, g, partials, n, vec, shard, parts));
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  tl::launch_finish_rows<Out>(partials, nullptr, parts, lanes, false, f, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// body: 0 quadratic, 1 rosenbrock, 2 coupled quadratic.  x, g: n floats on
// the device.  partials: tl_max_blocks() doubles of scratch.  f: 1 float.
// Returns the cudaError_t of the launches.
extern "C" int tl_fused_vg_f32(int body, const float* x, float* g,
                               double* partials, float* f, long long n,
                               void* stream) {
  return launch<false>(body, x, g, partials, f, n, stream, tl::Shard{});
}

// The shard-local form.  x, g: n floats, one shard's block.  n_global: the
// global unpadded length; start: the block's global offset; edges: 2 floats
// on the device, [previous shard's last x, next shard's first x] (read only
// by a chain-structured body).  f: 1 double, this shard's partial.
extern "C" int tl_fused_vg_local_f32(int body, const float* x, float* g,
                                     double* partials, double* f, long long n,
                                     long long n_global, long long start,
                                     const float* edges, void* stream) {
  if (start < 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(body, x, g, partials, f, n, stream,
                      tl::Shard{n_global, start, edges});
}

// The batched form.  x, g: lanes * n floats, row-major (lanes, n).
// partials: lanes + tl_max_blocks() doubles of scratch.  f: lanes floats.
// Returns the cudaError_t of the launches (cudaErrorInvalidValue for n < 1,
// an unknown body, or lanes outside [1, 2^31 - 1 - tl_max_blocks()]).
extern "C" int tl_fused_vg_batched_f32(int body, const float* x, float* g,
                                       double* partials, float* f,
                                       long long lanes, long long n,
                                       void* stream) {
  return launch_batched<false>(body, x, g, partials, f, lanes, n, stream,
                               tl::Shard{});
}

// The batched shard-local form.  x, g: lanes * n floats, row-major (lanes,
// n), each row one lane's block of one shard.  n_global, start: as the
// shard-local form's, shared by the lanes.  edges: 2 * lanes floats on the
// device, row-major (lanes, 2), each lane's [previous shard's last x, next
// shard's first x].  partials: lanes + tl_max_blocks() doubles of scratch.
// f: lanes doubles, each lane's partial.
extern "C" int tl_fused_vg_local_batched_f32(
    int body, const float* x, float* g, double* partials, double* f,
    long long lanes, long long n, long long n_global, long long start,
    const float* edges, void* stream) {
  if (start < 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_batched<true>(body, x, g, partials, f, lanes, n, stream,
                              tl::Shard{n_global, start, edges});
}
