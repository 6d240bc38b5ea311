// The compact direction's small-matrix chain for B instances at once.
//
// Replaces the Pallas kernel tpu_lbfgs/kernels/chain.py _make_chain_kernel
// (run by _chain_pallas under the custom_vmap rule of make_compact_chain).
// Per instance, with m pairs in a ring of physical slots:
//
//   rotate SY, YY, Sg, Yg to logical order, l <-> slot (base + l) % m,
//       base = (n_pairs - min(n_pairs, m)) % m;
//   valid[l] = l < min(n_pairs, m) [and SY_ll > skip_thr];
//   with `spread`, non-finite products as the reference's one-hot matmuls
//   spread them (chain.py::onehot_spread): SY_ll NaN unless every
//   non-finite entry of SY is SY_ll itself, and a fallback where a valid
//   pair meets a non-finite SY, YY, Sg or Yg;
//   R = triu(SY) on valid pairs, 1 on the diagonal of invalid ones;
//   gamma = sy_hist / yy_hist at the newest slot (n_pairs - 1) % m;
//   R u = p1 (back substitution), t = D u + gamma YYm u - gamma p2,
//   R^T v = t (forward substitution);
//   v, u back to slot order (0 where invalid),
//   g_dot_d = -(gamma |g|^2 + v.p1 - gamma u.p2), and the fallback flag.
//
// Bound by bytes on this card, and far from it: about 1 KB moves per
// instance at m = 10, 4.3 MB at B = 4096, 1.29 us at 3.35 TB/s, and a few
// hundred operations.  The first design, one thread per instance in blocks
// of 128 with m a template parameter (5, 10 or 20), took 14.76 us at B =
// 4096, m = 10 (NVIDIA H100 80GB HBM3, 700 W), and skipping its
// substitutions took only 2-4% off: it waited on its loads, 32 blocks on
// 132 SMs, every warp-wide load touching 32 sectors (adjacent lanes'
// matrices are 4 m^2 bytes apart).  This design:
// - a group of `lanes` lanes per instance (the power of two at or above m,
//   at most a warp), so B = 4096 at m = 10 is 512 blocks of 8 instances;
// - the block's SY, YY, Sg, Yg, sy_hist and yy_hist (contiguous in device
//   memory) staged into shared memory by asynchronous 16-byte copies
//   (cp.async: every copy of the block in flight at once, no registers),
//   and the valid masks applied there in place; the rotation is slot
//   arithmetic on the staged rows, which gives the gather's NaN semantics
//   that the TPU kernel's select chains were built to reproduce;
// - lane r owns logical rows r and r + lanes (m <= 64) and forms its row
//   of t = D u + gamma YYm u - gamma p2;
// - m = 5, 10 and 20 are instantiated with m a template parameter (kM),
//   every loop unrolled; where u and v fit in registers (f32 m = 5 and 10,
//   f64 m = 5: kInRegs) every lane of the group runs both substitutions
//   whole, so their ordered chains (row i of the back substitution
//   subtracts j = i + 1 .. m - 1 in order and cannot start before
//   u[i + 1]) wait on register latency only;
// - otherwise the back substitution goes one row a step by the lane that
//   owns it, u in shared memory, and the forward substitution as a column
//   sweep (row i subtracts R(j, i) v[j] for j ascending, each v[j]
//   broadcast by shuffle).
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

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxM = 64;              // the wrapper's chain.MAX_M
constexpr int kRows = kMaxM / 32;      // logical rows per lane
constexpr int kBlockThreads = 128;
constexpr int kSmemCap = 232448;       // a block's shared memory on an H100
constexpr unsigned kFull = 0xffffffffu;

// Floor modulo, as Python's and numpy's % (C's % truncates toward zero).
__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// log2 of the lanes per instance: the power of two at or above m, at most
// a warp.
__host__ __device__ constexpr int lane_bits_for(int m) {
  int bits = 0;
  while ((1 << bits) < m && bits < 5) ++bits;
  return bits;
}

// A block's shared memory for ipb instances of depth m: the staged inputs
// in slot order, as in device memory, then per instance u, the dot terms
// v_l p1_l and u_l p2_l, and the valid flags in logical order.  Each array
// starts on 16 bytes.
template <typename T>
struct Staged {
  T *SY, *YY, *Sg, *Yg, *syh, *yyh, *u, *vp, *up;
  int* valid;
};

__host__ __device__ inline size_t padded(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// The bytes of the layout; with s, carves it out of base.
template <typename T>
__host__ __device__ size_t carve(int m, int ipb, unsigned char* base,
                                 Staged<T>* s) {
  const size_t mat = padded(sizeof(T) * m * m * ipb);
  const size_t vec = padded(sizeof(T) * m * ipb);
  if (s != nullptr) {
    T** vecs[] = {&s->Sg, &s->Yg, &s->syh, &s->yyh, &s->u, &s->vp, &s->up};
    s->SY = reinterpret_cast<T*>(base);
    s->YY = reinterpret_cast<T*>(base + mat);
    for (int k = 0; k < 7; ++k) {
      *vecs[k] = reinterpret_cast<T*>(base + 2 * mat + k * vec);
    }
    s->valid = reinterpret_cast<int*>(base + 2 * mat + 7 * vec);
  }
  return 2 * mat + 7 * vec + padded(sizeof(int) * m * ipb);
}

// Starts the copy dst[0 .. count) = src[0 .. count) as asynchronous copies
// (cp.async: no registers, every copy of the block in flight at once), the
// block's threads on neighbouring addresses, 16 bytes a copy where both
// sides allow it.  The caller commits, waits and synchronises.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int64_t count) {
  int64_t done = 0;
  if (((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    constexpr int kPer = 16 / sizeof(T);
    const int64_t quads = count / kPer;
    for (int64_t q = threadIdx.x; q < quads; q += blockDim.x) {
      __pipeline_memcpy_async(dst + q * kPer, src + q * kPer, 16);
    }
    done = quads * kPer;
  }
  for (int64_t i = done + threadIdx.x; i < count; i += blockDim.x) {
    __pipeline_memcpy_async(dst + i, src + i, sizeof(T));
  }
}

// kM > 0 fixes m (and so the lanes) at compile time, which unrolls every
// loop over m; kM = 0 reads them from the arguments.
template <typename T, int kM>
__global__ void __launch_bounds__(kBlockThreads)
    compact_chain_kernel(const T* __restrict__ SY_p,
                         const T* __restrict__ YY_p,
                         const T* __restrict__ Sg_p,
                         const T* __restrict__ Yg_p,
                         const T* __restrict__ sy_hist,
                         const T* __restrict__ yy_hist,
                         const int* __restrict__ n_pairs,
                         const T* __restrict__ g_norm, T skip_thr,
                         int use_thr, int spread, T* __restrict__ v_phys,
                         T* __restrict__ u_phys, T* __restrict__ gamma_out,
                         T* __restrict__ gdd_out,
                         bool* __restrict__ fallback_out, int64_t B,
                         int m_arg, int bits_arg) {
  const int m = kM > 0 ? kM : m_arg;
  const int bits = kM > 0 ? lane_bits_for(kM) : bits_arg;
  const int lanes = 1 << bits;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ipb = blockDim.x >> bits;
  Staged<T> st;
  carve<T>(m, ipb, smem, &st);
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * ipb;
  const int nb = static_cast<int>(B - b0 < ipb ? B - b0 : ipb);
  const int mm = m * m;
  stage(st.SY, SY_p + b0 * mm, static_cast<int64_t>(nb) * mm);
  stage(st.YY, YY_p + b0 * mm, static_cast<int64_t>(nb) * mm);
  stage(st.Sg, Sg_p + b0 * m, static_cast<int64_t>(nb) * m);
  stage(st.Yg, Yg_p + b0 * m, static_cast<int64_t>(nb) * m);
  stage(st.syh, sy_hist + b0 * m, static_cast<int64_t>(nb) * m);
  stage(st.yyh, yy_hist + b0 * m, static_cast<int64_t>(nb) * m);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // A group past B (the last block's) repeats the block's last instance to
  // keep its warp's shuffles whole, and writes nothing.
  const int group = threadIdx.x >> bits;
  const bool live = group < nb;
  const int k = live ? group : nb - 1;
  const int lane = threadIdx.x & (lanes - 1);
  const int64_t b = b0 + k;
  T* SY = st.SY + k * mm;
  T* YY = st.YY + k * mm;
  T* u_s = st.u + k * m;
  T* vp_s = st.vp + k * m;
  T* up_s = st.up + k * m;
  int* valid_s = st.valid + k * m;
  const T zero = T(0), one = T(1);

  // The instance's non-finite products, counted by its group: of SY, and
  // of YY, Sg and Yg.
  int bad_sy = 0, bad_rest = 0;
  if (spread) {
    for (int e = lane; e < mm; e += lanes) {
      bad_sy += !isfinite(SY[e]);
      bad_rest += !isfinite(YY[e]);
    }
    for (int e = lane; e < m; e += lanes) {
      bad_rest += !isfinite(st.Sg[k * m + e]) + !isfinite(st.Yg[k * m + e]);
    }
    for (int off = lanes / 2; off > 0; off >>= 1) {
      bad_sy += __shfl_xor_sync(kFull, bad_sy, off, lanes);
      bad_rest += __shfl_xor_sync(kFull, bad_rest, off, lanes);
    }
  }
  const int np = n_pairs[b];
  const int hist = np < m ? np : m;
  const int base = floor_mod(np - hist, m);
  const int newest = floor_mod(np - 1, m);
  const T gamma = st.syh[k * m + newest] / st.yyh[k * m + newest];
  auto slot = [&](int l) {
    const int s = base + l;
    return s >= m ? s - m : s;
  };

  // This lane's rows i = lane + r * lanes, r < kRows.
  int sl[kRows];
  bool valid[kRows];
  T d_diag[kRows], p1[kRows], p2[kRows], u[kRows], acc[kRows], v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = lane + r * lanes;
    const bool own = i < m;
    sl[r] = own ? slot(i) : 0;
    T dg = SY[sl[r] * m + sl[r]];
    if (bad_sy && !(bad_sy == 1 && !isfinite(dg))) dg = T(NAN);
    valid[r] = own && i < hist && (!use_thr || dg > skip_thr);
    d_diag[r] = valid[r] ? dg : one;
    p1[r] = valid[r] ? st.Sg[k * m + sl[r]] : zero;
    p2[r] = valid[r] ? st.Yg[k * m + sl[r]] : zero;
    u[r] = acc[r] = v[r] = zero;
    if (own && live) valid_s[i] = valid[r];
  }
  __syncwarp();
  // R and YYm in place: an entry stays where both of its pairs are valid.
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (lane + r * lanes < m && live) {
#pragma unroll
      for (int q = 0; q < m; ++q) {
        if (!(valid[r] && valid_s[q])) {
          SY[sl[r] * m + slot(q)] = zero;
          YY[sl[r] * m + slot(q)] = zero;
        }
      }
    }
  }
  __syncwarp();

  // kInRegs: every lane keeps every row's p1, p2, diagonal, t, u and v in
  // registers, six arrays of kM values (kM <= 32: a lane owns row `lane` at
  // most).  Up to 40 bytes an array they fit beside the rest (f32 m = 10
  // takes 128 registers); above it (f32 m = 20, f64 m = 10) they spill and
  // run slower than the shared-memory steps.
  constexpr bool kInRegs = kM > 0 && kM * sizeof(T) <= 40;
  constexpr int kR = kInRegs ? kM : 1;
  T p1a[kR], p2a[kR], da[kR], ur[kR], vr[kR], ta[kR];
  if constexpr (kInRegs) {
#pragma unroll
    for (int i = 0; i < kM; ++i) {
      p1a[i] = __shfl_sync(kFull, p1[0], i, lanes);
      p2a[i] = __shfl_sync(kFull, p2[0], i, lanes);
      da[i] = __shfl_sync(kFull, d_diag[0], i, lanes);
    }
  }

  // back substitution, R u = p1: row i subtracts j = i+1 .. m-1 in order
  if constexpr (kInRegs) {
    // every lane of the group runs it whole, u in registers: the chain
    // waits on register latency only
#pragma unroll
    for (int i = kM - 1; i >= 0; --i) {
      const T* row = SY + slot(i) * kM;
      T a = p1a[i];
#pragma unroll
      for (int j = i + 1; j < kM; ++j) a = a - row[slot(j)] * ur[j];
      ur[i] = a / da[i];
    }
#pragma unroll
    for (int i = 0; i < kM; ++i) {
      if (lane == i) u[0] = ur[i];
    }
  } else {
    // one row a step, by the lane that owns it, u in shared memory
#pragma unroll
    for (int i = m - 1; i >= 0; --i) {
      const int r = i >> bits;
      if (lane == (i & (lanes - 1))) {
        const T* row = SY + slot(i) * m;
        T a = r == 0 ? p1[0] : p1[kRows - 1];
#pragma unroll
        for (int j = i + 1; j < m; ++j) a = a - row[slot(j)] * u_s[j];
        const T ui = a / (r == 0 ? d_diag[0] : d_diag[kRows - 1]);
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          if (rr == r) u[rr] = ui;
        }
        if (live) u_s[i] = ui;
      }
      __syncwarp();
    }
  }
  auto u_at = [&](int q) -> T {
    if constexpr (kInRegs) {
      return ur[q];
    } else {
      return u_s[q];
    }
  };
  // t = D u + gamma (YYm u) - gamma p2, the sum over q in index order
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (lane + r * lanes < m) {
      const T* row = YY + sl[r] * m;
      T a = zero;
#pragma unroll
      for (int q = 0; q < m; ++q) a = a + row[slot(q)] * u_at(q);
      acc[r] = d_diag[r] * u[r] + gamma * a - gamma * p2[r];
    }
  }
  // forward substitution, R^T v = t: row i subtracts j = 0 .. i-1 in order
  if constexpr (kInRegs) {
    // every lane runs it whole, by rows, t and v in registers
#pragma unroll
    for (int i = 0; i < kM; ++i) ta[i] = __shfl_sync(kFull, acc[0], i, lanes);
#pragma unroll
    for (int i = 0; i < kM; ++i) {
      T a = ta[i];
#pragma unroll
      for (int j = 0; j < i; ++j) a = a - SY[slot(j) * kM + slot(i)] * vr[j];
      vr[i] = a / da[i];
    }
#pragma unroll
    for (int i = 0; i < kM; ++i) {
      if (lane == i) v[0] = vr[i];
    }
  } else {
    // by columns, each v[j] broadcast by shuffle
#pragma unroll
    for (int j = 0; j < m; ++j) {
      const int rj = j >> bits;
      T mine = zero;
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        if (rr == rj && lane == (j & (lanes - 1))) {
          v[rr] = acc[rr] / d_diag[rr];
          mine = v[rr];
        }
      }
      const T vj = __shfl_sync(kFull, mine, j & (lanes - 1), lanes);
      const T* row = SY + slot(j) * m;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = lane + r * lanes;
        if (i > j && i < m) acc[r] = acc[r] - row[sl[r]] * vj;
      }
    }
  }

  int small_ok = 1, bad_rho = 0, any_valid = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = lane + r * lanes;
    if (i < m) {
      const T vz = valid[r] ? v[r] : zero;
      const T uz = valid[r] ? u[r] : zero;
      small_ok &= isfinite(vz) && isfinite(uz);
      bad_rho |= valid[r] && !isfinite(one / d_diag[r]);
      any_valid |= valid[r];
      if (live) {
        v_phys[b * m + sl[r]] = vz;
        u_phys[b * m + sl[r]] = uz;
        if (!kInRegs) {
          vp_s[i] = v[r] * p1[r];
          up_s[i] = u[r] * p2[r];
        }
      }
    }
  }
  for (int off = lanes / 2; off > 0; off >>= 1) {
    small_ok &= __shfl_xor_sync(kFull, small_ok, off, lanes);
    bad_rho |= __shfl_xor_sync(kFull, bad_rho, off, lanes);
    any_valid |= __shfl_xor_sync(kFull, any_valid, off, lanes);
  }
  __syncwarp();
  if (lane == 0 && live) {
    auto vp = [&](int l) -> T {
      if constexpr (kInRegs) {
        return vr[l] * p1a[l];
      } else {
        return vp_s[l];
      }
    };
    auto up = [&](int l) -> T {
      if constexpr (kInRegs) {
        return ur[l] * p2a[l];
      } else {
        return up_s[l];
      }
    };
    T vdp1 = vp(0), udp2 = up(0);
#pragma unroll
    for (int l = 1; l < m; ++l) {
      vdp1 = vdp1 + vp(l);
      udp2 = udp2 + up(l);
    }
    const bool bad_gamma = gamma <= zero || !isfinite(gamma);
    const T gn = g_norm[b];
    gamma_out[b] = gamma;
    gdd_out[b] = -(gamma * (gn * gn) + vdp1 - gamma * udp2);
    fallback_out[b] = bad_rho || bad_gamma || hist == 0 || !small_ok ||
                      (any_valid && (bad_sy || bad_rest));
  }
}

// Launches the instantiation for m (a fast path at 5, 10 and 20, the
// runtime one at any other m).
template <typename T, int kM>
cudaError_t launch_m(const T* SY_p, const T* YY_p, const T* Sg_p,
                     const T* Yg_p, const T* sy_hist, const T* yy_hist,
                     const int* n_pairs, const T* g_norm, T skip_thr,
                     int use_thr, int spread, T* v_phys, T* u_phys, T* gamma,
                     T* g_dot_d, bool* fallback, long long B, int m,
                     cudaStream_t s) {
  const int bits = lane_bits_for(m);
  int ipb = kBlockThreads >> bits;
  while (ipb > 1 && carve<T>(m, ipb, nullptr, nullptr) > kSmemCap) --ipb;
  const size_t smem = carve<T>(m, ipb, nullptr, nullptr);
  static const cudaError_t attr = cudaFuncSetAttribute(
      compact_chain_kernel<T, kM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCap);
  if (attr != cudaSuccess) return attr;
  const long long blocks = (B + ipb - 1) / ipb;
  compact_chain_kernel<T, kM><<<static_cast<unsigned>(blocks), ipb << bits,
                                smem, s>>>(
      SY_p, YY_p, Sg_p, Yg_p, sy_hist, yy_hist, n_pairs, g_norm, skip_thr,
      use_thr, spread, v_phys, u_phys, gamma, g_dot_d, fallback, B, m, bits);
  return cudaGetLastError();
}

template <typename T>
int launch(const T* SY_p, const T* YY_p, const T* Sg_p, const T* Yg_p,
           const T* sy_hist, const T* yy_hist, const int* n_pairs,
           const T* g_norm, T skip_thr, int use_thr, int spread, T* v_phys,
           T* u_phys, T* gamma, T* g_dot_d, bool* fallback, long long B,
           int m, void* stream) {
  if (B < 1 || m < 1 || m > kMaxM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
#define TL_CHAIN_CASE(M)                                                    \
  case M:                                                                   \
    return static_cast<int>(launch_m<T, M>(                                 \
        SY_p, YY_p, Sg_p, Yg_p, sy_hist, yy_hist, n_pairs, g_norm, skip_thr, \
        use_thr, spread, v_phys, u_phys, gamma, g_dot_d, fallback, B, m, s));
    TL_CHAIN_CASE(5)
    TL_CHAIN_CASE(10)
    TL_CHAIN_CASE(20)
#undef TL_CHAIN_CASE
    default:
      return static_cast<int>(launch_m<T, 0>(
          SY_p, YY_p, Sg_p, Yg_p, sy_hist, yy_hist, n_pairs, g_norm,
          skip_thr, use_thr, spread, v_phys, u_phys, gamma, g_dot_d,
          fallback, B, m, s));
  }
}

}  // namespace

// SY_p, YY_p: B * m * m values; Sg_p, Yg_p, sy_hist, yy_hist: B * m values;
// n_pairs: B ints; g_norm: B values; all row-major and on the device, in
// float (_f32) or double (_f64).  Outputs v_phys, u_phys: B * m values;
// gamma, g_dot_d: B values; fallback: B bools.  skip_thr is read only when
// use_thr is nonzero; spread nonzero spreads non-finite entries as the
// reference's one-hot products do.  m is 1 to 64.  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for B < 1 or m outside [1, 64]).
#define TL_CHAIN_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const T* SY_p, const T* YY_p, const T* Sg_p,           \
                      const T* Yg_p, const T* sy_hist, const T* yy_hist,     \
                      const int* n_pairs, const T* g_norm, T skip_thr,       \
                      int use_thr, int spread, T* v_phys, T* u_phys,         \
                      T* gamma, T* g_dot_d, bool* fallback, long long B,     \
                      int m, void* stream) {                                 \
    return launch<T>(SY_p, YY_p, Sg_p, Yg_p, sy_hist, yy_hist, n_pairs,      \
                     g_norm, skip_thr, use_thr, spread, v_phys, u_phys,      \
                     gamma, g_dot_d, fallback, B, m, stream);                \
  }

TL_CHAIN_ENTRY(tl_compact_chain_f32, float)
TL_CHAIN_ENTRY(tl_compact_chain_f64, double)
