// The suite problems' per-element bodies, shared by the four fused kernel
// families of this directory (fused_vg.cu, fused_tail.cu, multi_phi.cu,
// multi_phi_dphi.cu), each of which is a template on one of them.
//
// Replaces tpu_lbfgs/kernels/pallas_ops.py's _body_quadratic,
// _body_rosenbrock and _body_coupled (TAIL_BODIES) and _f_quadratic,
// _f_rosenbrock and _f_coupled (F_BODIES).
//
// A body sees one element xv at index i of n and, where kNeighbours is
// true, its chain neighbours xp = x[i-1] and xf = x[i+1] (the kernel loads
// or rebuilds them for 1 <= i and i < n-1 and passes 0 elsewhere; a body
// reads them only behind the same index tests).
//
//   f(xv, xf, i, n)           the term of the objective that element i owns;
//                             only called for i < terms(n); f<true> is for
//                             an element known to have its forward
//                             neighbour (i < n - 1)
//   fg(xv, xp, xf, i, n, acc) adds that term to acc (a double) and returns
//                             element i of the gradient; fg<true> is for an
//                             element known to have both neighbours and a
//                             term (1 <= i < n - 1), with the index tests
//                             taken out
//
// The arithmetic is float, each operation rounded once (the library is built
// with -fmad=false), in the order of the plain PyTorch versions in
// tpu_lbfgs_torch/kernels/fused_ops.py (quadratic_vg_plain,
// rosenbrock_vg_plain, coupled_vg_plain), so a kernel's gradient equals the
// plain version's bit for bit and its f differs only by the order in which
// the float terms are added in double.
#pragma once

#include <cstdint>

namespace tl {

// Where one shard's block lies in the global vector, for the shard-local
// form of a kernel (the sharded solve): the global unpadded length, the
// block's global offset, and the neighbouring shards' boundary elements in
// device memory (each kernel states their order).  Element i of the block
// has the global index start + i; a body is handed that index and n_global,
// so its index tests decide term ownership globally, and an element at or
// beyond n_global (the zero-padded tail) is given no term and zero
// gradient by the kernel.  The whole-vector form passes an empty Shard and
// never reads it.
struct Shard {
  int64_t n_global = 0;
  int64_t start = 0;
  const float* edges = nullptr;
};

// sum (x_i - 1)^2.
struct Quadratic {
  static constexpr bool kNeighbours = false;
  static __host__ __device__ int64_t terms(int64_t n) { return n; }

  template <bool kInterior = false>
  static __device__ __forceinline__ float f(float xv, float, int64_t,
                                            int64_t) {
    const float r = xv - 1.0f;
    return r * r;
  }

  template <bool kInterior = false>
  static __device__ __forceinline__ float fg(float xv, float, float, int64_t,
                                             int64_t, double& acc) {
    const float r = xv - 1.0f;
    acc += static_cast<double>(r * r);
    return 2.0f * r;
  }
};

// Chained Rosenbrock: sum_{i<n-1} 100 t_i^2 + (1 - x_i)^2,
// t_i = x_{i+1} - x_i^2; the last element owns no term.
struct Rosenbrock {
  static constexpr bool kNeighbours = true;
  static __host__ __device__ int64_t terms(int64_t n) { return n - 1; }

  template <bool kInterior = false>
  static __device__ __forceinline__ float f(float xv, float xf, int64_t,
                                            int64_t) {
    const float t = xf - xv * xv;
    const float e = 1.0f - xv;
    return 100.0f * t * t + e * e;
  }

  template <bool kInterior = false>
  static __device__ __forceinline__ float fg(float xv, float xp, float xf,
                                             int64_t i, int64_t n,
                                             double& acc) {
    float g = 0.0f;
    if (kInterior || i < n - 1) {
      const float t = xf - xv * xv;
      const float e = 1.0f - xv;
      acc += static_cast<double>(100.0f * t * t + e * e);
      g = 2.0f * (xv - 1.0f) - 400.0f * xv * t;
    }
    if (kInterior || i >= 1) g += 200.0f * (xv - xp * xp);
    return g;
  }
};

// The coupled (tridiagonal) quadratic with coefficient 1000:
// sum 1000 x_i^2 + sum_{i<n-1} 100 x_i x_{i+1}.
struct Coupled {
  static constexpr bool kNeighbours = true;
  static __host__ __device__ int64_t terms(int64_t n) { return n; }

  template <bool kInterior = false>
  static __device__ __forceinline__ float f(float xv, float xf, int64_t i,
                                            int64_t n) {
    float t = 1000.0f * xv * xv;
    if (kInterior || i < n - 1) t += 100.0f * (xv * xf);
    return t;
  }

  template <bool kInterior = false>
  static __device__ __forceinline__ float fg(float xv, float xp, float xf,
                                             int64_t i, int64_t n,
                                             double& acc) {
    acc += static_cast<double>(f<kInterior>(xv, xf, i, n));
    float g = 2000.0f * xv;
    if (kInterior || i < n - 1) g += 100.0f * xf;
    if (kInterior || i >= 1) g += 100.0f * xp;
    return g;
  }
};

}  // namespace tl

// Runs the statements with `Body` naming the body of this id (the order of
// the Python wrappers' BODY_IDS) and yields true; false for an unknown id.
#define TL_DISPATCH_BODY(body, ...)                                   \
  [&]() -> bool {                                                     \
    switch (body) {                                                   \
      case 0: { using Body = tl::Quadratic; __VA_ARGS__; return true; }  \
      case 1: { using Body = tl::Rosenbrock; __VA_ARGS__; return true; } \
      case 2: { using Body = tl::Coupled; __VA_ARGS__; return true; }    \
      default: return false;                                          \
    }                                                                 \
  }()
