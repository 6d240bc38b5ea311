"""The card's rates for the instructions that bound the K-trial kernels
(``bench/trial_bounds.py``): float64 adds and conversions from float32 to
float64, alone and together, and beside float32 adds, each per SM per
clock.

    python3 -m tpu_lbfgs_torch.bench.pipe_rates

A microbenchmark, on no solve's path.  One kernel per pattern, built with
``nvcc`` and the port's flags (``kernels/_build.py``: sm_90a,
-fmad=false), each thread running eight (or four) independent chains of
inline PTX so that the compiler can neither drop nor merge the
instructions.  Every SM gets about eight blocks of 256 threads, and each
block records its SM (``%smid``) and the ``clock64`` cycles at which its
loop starts and ends, so the rate of one SM in instructions per clock is

    its blocks * 256 threads * instructions per thread
        / (last end - first start on that SM)

(the median SM), independent of the clock the card ran at and of how the
blocks were spread over the SMs.

The patterns:

- ``dadd``: add.rn.f64, the float64 pipe;
- ``cvt``: cvt.f64.f32 alone, its input changed by a float32 add every
  step and its result taken by an integer xor of its high word (three
  issue slots a conversion, so it reads at most 42.7);
- ``cvt_dadd``: cvt.f64.f32 then add.rn.f64 into a float64 sum, the
  K-trial kernels' per-term step, counted as its conversions;
- ``cvt_dadd_8fadd``: the same step beside eight float32 adds (11 issue
  slots a conversion, so 11.6 a clock if issue and the conversions
  overlapped fully), counted as its conversions.

It prints one line per pattern and, last, one JSON object of the rates.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import statistics
import subprocess
import sys

import torch

from ..kernels import _build

SOURCE = r"""
#include <cstdint>

constexpr int kChains = 8;

__device__ __forceinline__ void f32_add(float& a, float b) {
  asm volatile("add.rn.f32 %0, %0, %1;" : "+f"(a) : "f"(b));
}
__device__ __forceinline__ void f64_add(double& a, double b) {
  asm volatile("add.rn.f64 %0, %0, %1;" : "+d"(a) : "d"(b));
}
__device__ __forceinline__ double widen(float a) {
  double r;
  asm volatile("cvt.f64.f32 %0, %1;" : "=d"(r) : "f"(a));
  return r;
}

template <int kPattern>
__global__ void __launch_bounds__(256, 4) pipe_kernel(int steps, float seed,
                                                   double* sink,
                                                   long long* cycles) {
  float f[kChains], g[kChains];
  double acc[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) {
    f[j] = seed + threadIdx.x * 1e-3f + j;
    g[j] = f[j] * 0.5f;
    acc[j] = f[j];
  }
  // cvt keeps a running xor besides its chains, so it runs four.
  constexpr int kRun = kPattern == 1 ? kChains / 2 : kChains;
  unsigned h = 0;
  __syncthreads();
  const long long t0 = clock64();
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if constexpr (kPattern == 0) f64_add(acc[j], 1e-17);
      // A float32 add changes f every step, so that no conversion is
      // loop-invariant (the compiler would hoist it).
      if constexpr (kPattern == 1) {
        f32_add(f[j], 1e-7f);
        h ^= static_cast<unsigned>(__double2hiint(widen(f[j])));
      }
      if constexpr (kPattern >= 2) {
        f32_add(f[j], 1e-7f);
        f64_add(acc[j], widen(f[j]));
      }
      if constexpr (kPattern == 3) {
#pragma unroll
        for (int e = 0; e < 8; ++e) f32_add(g[j], 1e-7f);
      }
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  double total = h;
#pragma unroll
  for (int j = 0; j < kChains; ++j) total += acc[j] + f[j] + g[j];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = total;
  if (threadIdx.x == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    cycles[3 * blockIdx.x] = sm;
    cycles[3 * blockIdx.x + 1] = t0;
    cycles[3 * blockIdx.x + 2] = t1;
  }
}

extern "C" int pipe_run(int pattern, int blocks, int steps, double* sink,
                        long long* cycles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pattern) {
    case 0: pipe_kernel<0><<<blocks, 256, 0, s>>>(steps, 1.f, sink, cycles); break;
    case 1: pipe_kernel<1><<<blocks, 256, 0, s>>>(steps, 1.f, sink, cycles); break;
    case 2: pipe_kernel<2><<<blocks, 256, 0, s>>>(steps, 1.f, sink, cycles); break;
    case 3: pipe_kernel<3><<<blocks, 256, 0, s>>>(steps, 1.f, sink, cycles); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

# (name, pattern id, chains a thread)
PATTERNS = (("dadd", 0, 8), ("cvt", 1, 4), ("cvt_dadd", 2, 8),
            ("cvt_dadd_8fadd", 3, 8))
THREADS, BLOCKS_PER_SM = 256, 8


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _sm_rates(records, per_block: int) -> list:
    """Instructions per clock of each SM: its blocks' instructions over the
    cycles from its first block's start to its last block's end (one SM's
    clock64 counter times all of them)."""
    spans = {}
    for sm, t0, t1 in records:
        lo, hi, count = spans.get(sm, (t0, t1, 0))
        spans[sm] = (min(lo, t0), max(hi, t1), count + 1)
    return [count * per_block / (hi - lo) for lo, hi, count in spans.values()]


def _build_lib():
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    key = hashlib.sha256((SOURCE + " ".join(flags)).encode()).hexdigest()
    out = _build.BUILD_ROOT / "pipe_rates" / key[:16]
    lib = out / "libpipe_rates.so"
    if not lib.is_file():
        out.mkdir(parents=True, exist_ok=True)
        src = out / "pipe_rates.cu"
        src.write_text(SOURCE)
        subprocess.run([_build.find_nvcc(), *flags, "-shared", "-o", str(lib),
                        str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).pipe_run
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("pipe_rates needs a CUDA device", file=sys.stderr)
        return 1
    run = _build_lib()
    card = _smi("name,power.limit")
    max_mhz = float(_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, steps = BLOCKS_PER_SM * sms, 4096
    sink = torch.empty(blocks * THREADS, dtype=torch.float64, device="cuda")
    cycles = torch.empty(3 * blocks, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for name, pattern, chains in PATTERNS:
        per_sm = []
        for _ in range(5):
            err = run(pattern, blocks, steps, sink.data_ptr(),
                      cycles.data_ptr(), stream)
            if err:
                raise RuntimeError(f"pipe_rates {name}: CUDA error {err}")
            torch.cuda.synchronize()
            per_sm.append(statistics.median(_sm_rates(
                cycles.view(-1, 3).tolist(),
                THREADS * chains * steps)))
        rate = statistics.median(per_sm)
        rates[name] = rate
        print(f"[pipe] {name}: {rate:.2f} thread-instructions per SM per "
              f"clock ({min(per_sm):.2f}-{max(per_sm):.2f} over 5 runs), "
              f"{rate * sms * max_mhz * 1e6 / 1e12:.2f} T/s at {sms} SMs and "
              f"{max_mhz:.0f} MHz")
    print(f"[pipe] card: {card}; SM clock after the runs "
          f"{_smi('clocks.sm')}, max {max_mhz:.0f} MHz")
    print(json.dumps({"card": card, "sms": sms, "max_sm_mhz": max_mhz,
                      "per_sm_per_clock": rates}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
