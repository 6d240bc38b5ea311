// The compact direction's small-matrix chain for B instances at once.
//
// Replaces the Pallas kernel tpu_lbfgs/kernels/chain.py _make_chain_kernel
// (run by _chain_pallas under the custom_vmap rule of make_compact_chain).
// Per instance, with m pairs in a ring of physical slots:
//
//   rotate SY, YY, Sg, Yg to logical order, l <-> slot (base + l) % m,
//       base = (n_pairs - min(n_pairs, m)) % m;
//   valid[l] = l < min(n_pairs, m) [and SY_ll > skip_thr];
//   R = triu(SY) on valid pairs, 1 on the diagonal of invalid ones;
//   gamma = sy_hist / yy_hist at the newest slot (n_pairs - 1) % m;
//   R u = p1 (back substitution), t = D u + gamma YYm u - gamma p2,
//   R^T v = t (forward substitution);
//   v, u back to slot order (0 where invalid),
//   g_dot_d = -(gamma |g|^2 + v.p1 - gamma u.p2), and the fallback flag.
//
// Bound by nothing on this card: about 1 KB moves per instance at m = 10,
// 4.3 MB at B = 4096, some 1.3 us at 3.35 TB/s, and a few hundred flops.
// What the TPU kernel paid for, one XLA op per step of the chain, is gone
// with one launch.  So the design is the simple one: one thread per
// instance, m a template parameter so that every loop unrolls and the
// per-instance vectors (u, v, t, p1, p2, the diagonal) stay in registers.
// The rotation is a direct index into the instance's rows, read where it is
// needed, which gives the gather's NaN semantics that the TPU kernel's
// select chains were built to reproduce; no (8, 128) planes.
//
// The operations run in the order of the plain PyTorch version
// (tpu_lbfgs_torch/kernels/chain.py::chain_batched_plain), which is the
// Pallas kernel's, and the library is built with -fmad=false, so every
// output equals the plain version's bit for bit.  The kernel is a template
// on its scalar type: float for the batch solve, double for float64
// batches, where the reference's custom_vmap rule falls back to its
// vmapped jnp chain.
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kChainThreads = 128;

// Floor modulo, as Python's and numpy's % (C's % truncates toward zero).
__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

template <typename T, int M>
__global__ void __launch_bounds__(kChainThreads)
    compact_chain_kernel(const T* __restrict__ SY_p,
                         const T* __restrict__ YY_p,
                         const T* __restrict__ Sg_p,
                         const T* __restrict__ Yg_p,
                         const T* __restrict__ sy_hist,
                         const T* __restrict__ yy_hist,
                         const int* __restrict__ n_pairs,
                         const T* __restrict__ g_norm, T skip_thr,
                         int use_thr, T* __restrict__ v_phys,
                         T* __restrict__ u_phys, T* __restrict__ gamma_out,
                         T* __restrict__ gdd_out,
                         bool* __restrict__ fallback_out, int64_t B) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const T* SY = SY_p + b * M * M;
  const T* YY = YY_p + b * M * M;
  const T* Sg = Sg_p + b * M;
  const T* Yg = Yg_p + b * M;
  const T zero = T(0), one = T(1);

  const int np = n_pairs[b];
  const int hist = np < M ? np : M;
  const int base = floor_mod(np - hist, M);
  const int newest = floor_mod(np - 1, M);

  int slot[M];
  bool valid[M];
  T d_diag[M], p1[M], p2[M];
#pragma unroll
  for (int l = 0; l < M; ++l) {
    const int s = (base + l) % M;
    slot[l] = s;
    const T dg = SY[s * M + s];
    valid[l] = l < hist && (!use_thr || dg > skip_thr);
    d_diag[l] = valid[l] ? dg : one;
    p1[l] = valid[l] ? Sg[s] : zero;
    p2[l] = valid[l] ? Yg[s] : zero;
  }
  // R's entry above the diagonal, logical (l, q) with l < q.
  auto R = [&](int l, int q) -> T {
    return (valid[l] && valid[q]) ? SY[slot[l] * M + slot[q]] : zero;
  };

  const T gamma = sy_hist[b * M + newest] / yy_hist[b * M + newest];

  // back substitution, R u = p1
  T u[M];
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    T acc = p1[i];
#pragma unroll
    for (int j = i + 1; j < M; ++j) acc = acc - R(i, j) * u[j];
    u[i] = acc / d_diag[i];
  }
  // t = D u + gamma (YYm u) - gamma p2
  T t[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    T acc = zero;
#pragma unroll
    for (int q = 0; q < M; ++q) {
      const T yy = (valid[i] && valid[q]) ? YY[slot[i] * M + slot[q]] : zero;
      acc = acc + yy * u[q];
    }
    t[i] = d_diag[i] * u[i] + gamma * acc - gamma * p2[i];
  }
  // forward substitution, R^T v = t
  T v[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    T acc = t[i];
#pragma unroll
    for (int j = 0; j < i; ++j) acc = acc - R(j, i) * v[j];
    v[i] = acc / d_diag[i];
  }

  bool small_ok = true, bad_rho = false;
  T vdp1 = v[0] * p1[0], udp2 = u[0] * p2[0];
#pragma unroll
  for (int l = 0; l < M; ++l) {
    const T vz = valid[l] ? v[l] : zero;
    const T uz = valid[l] ? u[l] : zero;
    v_phys[b * M + slot[l]] = vz;
    u_phys[b * M + slot[l]] = uz;
    small_ok = small_ok && isfinite(vz) && isfinite(uz);
    bad_rho = bad_rho || (valid[l] && !isfinite(one / d_diag[l]));
    if (l > 0) {
      vdp1 = vdp1 + v[l] * p1[l];
      udp2 = udp2 + u[l] * p2[l];
    }
  }
  const bool bad_gamma = gamma <= zero || !isfinite(gamma);
  const T gn = g_norm[b];
  gamma_out[b] = gamma;
  gdd_out[b] = -(gamma * (gn * gn) + vdp1 - gamma * udp2);
  fallback_out[b] = bad_rho || bad_gamma || hist == 0 || !small_ok;
}

template <typename T, int M>
cudaError_t launch(const T* SY_p, const T* YY_p, const T* Sg_p,
                   const T* Yg_p, const T* sy_hist, const T* yy_hist,
                   const int* n_pairs, const T* g_norm, T skip_thr,
                   int use_thr, T* v_phys, T* u_phys, T* gamma, T* g_dot_d,
                   bool* fallback, int64_t B, cudaStream_t s) {
  const int64_t blocks = (B + kChainThreads - 1) / kChainThreads;
  compact_chain_kernel<T, M><<<static_cast<unsigned>(blocks), kChainThreads,
                               0, s>>>(SY_p, YY_p, Sg_p, Yg_p, sy_hist,
                                       yy_hist, n_pairs, g_norm, skip_thr,
                                       use_thr, v_phys, u_phys, gamma,
                                       g_dot_d, fallback, B);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const T* SY_p, const T* YY_p, const T* Sg_p, const T* Yg_p,
             const T* sy_hist, const T* yy_hist, const int* n_pairs,
             const T* g_norm, T skip_thr, int use_thr, T* v_phys, T* u_phys,
             T* gamma, T* g_dot_d, bool* fallback, long long B, int m,
             void* stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
#define TL_CHAIN_CASE(M)                                                    \
  case M:                                                                   \
    return static_cast<int>(launch<T, M>(                                   \
        SY_p, YY_p, Sg_p, Yg_p, sy_hist, yy_hist, n_pairs, g_norm, skip_thr, \
        use_thr, v_phys, u_phys, gamma, g_dot_d, fallback, B, s));
    TL_CHAIN_CASE(5)
    TL_CHAIN_CASE(10)
    TL_CHAIN_CASE(20)
#undef TL_CHAIN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// SY_p, YY_p: B * m * m values; Sg_p, Yg_p, sy_hist, yy_hist: B * m values;
// n_pairs: B ints; g_norm: B values; all row-major and on the device, in
// float (_f32) or double (_f64).  Outputs v_phys, u_phys: B * m values;
// gamma, g_dot_d: B values; fallback: B bools.  skip_thr is read only when
// use_thr is nonzero.  m must be 5, 10 or 20.  Returns the cudaError_t of
// the launch.
#define TL_CHAIN_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const T* SY_p, const T* YY_p, const T* Sg_p,           \
                      const T* Yg_p, const T* sy_hist, const T* yy_hist,     \
                      const int* n_pairs, const T* g_norm, T skip_thr,       \
                      int use_thr, T* v_phys, T* u_phys, T* gamma,           \
                      T* g_dot_d, bool* fallback, long long B, int m,        \
                      void* stream) {                                        \
    return dispatch<T>(SY_p, YY_p, Sg_p, Yg_p, sy_hist, yy_hist, n_pairs,    \
                       g_norm, skip_thr, use_thr, v_phys, u_phys, gamma,     \
                       g_dot_d, fallback, B, m, stream);                     \
  }

TL_CHAIN_ENTRY(tl_compact_chain_f32, float)
TL_CHAIN_ENTRY(tl_compact_chain_f64, double)
