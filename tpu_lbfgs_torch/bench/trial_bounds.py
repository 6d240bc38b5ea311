"""The least time the K-trial kernels could take on the card, for the build
the port has.

The kernels (``csrc/multi_phi.cu``, ``csrc/multi_phi_dphi.cu``) are built
with ``-fmad=false`` (``kernels/_build.py``), and every term goes through
float64: ``multi_phi`` converts each float32 term to float64 and adds it
there; ``multi_phi_dphi`` does so for f's term and for g_i, multiplies g_i
by d_i in float64 and adds both.  So three limits hold besides the bytes:

- **issue**: every instruction takes an issue slot of its own, and an SM
  issues 128 thread-instructions a clock (4 schedulers of 32 threads);
- **the float64 pipe**: conversions from float32 to float64 at 16 per
  SM per clock, float64 adds and multiplies at 64 (CUDA's throughput
  table for compute capability 9.0).  ``bench/pipe_rates.py`` reads about
  15 conversions and 62 adds a clock on an H100, and a conversion
  followed by an add at the conversions' own rate: the adds overlap the
  conversions, so a term's time on the pipe is the larger of its
  conversions' and its adds' and multiplies', not their sum;
- **bytes**: each input read once and each output written once, at
  3.35 TB/s, as chip_smoke counts them.

The bound is the largest of the three: it takes issue and the float64
pipe as fully overlapped, which the card reaches only in part
(``bench/pipe_rates.py``'s ``cvt_dadd_8fadd`` reads about 86% of it), so a
kernel's time stays above it.  Instructions, conversions and float64
operations per element and trial are counted from the SASS of the built
library (``bench/sass_count.py``), for each kernel function: the
unrolled trial loop's block for one trial of a run, on the path of a run
whose elements all own a term, over the run's elements.  Left out: the
trial loop's exit test (an ISETP and a BRA a block, which every form
keeps), and the per-run work that K trials share (loads, shuffles, the
conversions of d that ``multi_phi_dphi`` hoists out of the trial loop).

The old bound, which the ``kernels`` line of chip_smoke keeps, takes the
larger of the bytes and an operation count per element and trial (the
trial points, the body, the float64 adds) at the float32 peak of
67 TFLOP/s, which counts a fused multiply-add as two operations.
"""
from __future__ import annotations

KERNELS = ("multi_phi", "multi_phi_batched", "multi_phi_dphi")
BODIES = ("quadratic", "rosenbrock", "coupled_quadratic")

# NVIDIA H100 SXM: SMs, the maximum SM clock (nvidia-smi
# --query-gpu=clocks.max.sm), and the rates above.
SMS = 132
CLOCK_HZ = 1.98e9
ISSUE_PER_SM_CLOCK = 128
CVT_PER_SM_CLOCK = 16
F64_PER_SM_CLOCK = 64
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# Per element and trial, from the SASS (bench/sass_count.py), keyed by
# the kernel function and the body: (instructions, conversions, float64
# adds and multiplies).  One trial's block on the interior path, over the
# run's elements, without the exit test's ISETP and BRA.
# - "multi_phi": multi_phi_kernel, the one-instance, whole-vector and
#   shard-local forms, runs of 4: 8 FMUL + 8 FADD (quadratic), 21 + 17
#   (Rosenbrock), 21 + 9 (coupled), each with 4 F2F.F64.F32 and 4 DADD;
# - "multi_phi_batched": multi_phi_batched_kernel, the batched shard-local
#   form, runs of 8 (9 trial points for 8 terms where the body has a
#   forward neighbour): 16 FMUL + 16 FADD, 41 + 33, 41 + 17, each with 8
#   F2F.F64.F32 and 8 DADD;
# - "multi_phi_dphi": multi_phi_dphi_kernel, every form (the batched one
#   too), runs of 4: 8 FMUL + 12 FADD, 35 + 35, 32 + 18, each with 8
#   F2F.F64.F32, 4 DMUL and 8 DADD.
SASS = {
    ("multi_phi", "quadratic"): (6.0, 1, 1),
    ("multi_phi", "rosenbrock"): (11.5, 1, 1),
    ("multi_phi", "coupled_quadratic"): (9.5, 1, 1),
    ("multi_phi_batched", "quadratic"): (6.0, 1, 1),
    ("multi_phi_batched", "rosenbrock"): (11.25, 1, 1),
    ("multi_phi_batched", "coupled_quadratic"): (9.25, 1, 1),
    ("multi_phi_dphi", "quadratic"): (10.0, 2, 3),
    ("multi_phi_dphi", "rosenbrock"): (22.5, 2, 3),
    ("multi_phi_dphi", "coupled_quadratic"): (17.5, 2, 3),
}

# The old model's operations per element and trial.
OLD_OPS = {
    "multi_phi": {"quadratic": 6, "rosenbrock": 13, "coupled_quadratic": 10},
    "multi_phi_dphi": {"quadratic": 9, "rosenbrock": 28,
                       "coupled_quadratic": 19},
}


def trial_bound(kernel: str, body: str, elems: int, k: int,
                n_bytes: int) -> dict:
    """The bounds of one call of ``kernel`` (a key of ``SASS``) with
    ``body`` over ``elems`` elements (all lanes together) at ``k`` trials,
    moving ``n_bytes``, in milliseconds: ``bytes``, ``issue``, ``f64`` (the
    float64 pipe), ``corrected`` = (the largest, its name), and ``old`` =
    (the old model's bound, "bytes" or "operations")."""
    insns, cvts, f64 = SASS[kernel, body]
    terms = elems * k
    per_clock = SMS * CLOCK_HZ
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    issue = terms * insns / (ISSUE_PER_SM_CLOCK * per_clock) * 1e3
    pipe = terms * max(cvts / CVT_PER_SM_CLOCK, f64 / F64_PER_SM_CLOCK) \
        / per_clock * 1e3
    old_ops = terms * OLD_OPS[kernel.replace("_batched", "")][body] \
        / F32_OPS_PER_S * 1e3
    limits = {"bytes": by_bytes, "issue": issue, "f64": pipe}
    worst = max(limits, key=limits.get)
    return {**limits, "corrected": (limits[worst], worst),
            "old": ((by_bytes, "bytes") if by_bytes >= old_ops
                    else (old_ops, "operations"))}
