#!/usr/bin/env python3
"""Bring-up check of tpu_lbfgs_torch on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from tpu_lbfgs_torch/csrc, holds each
against its plain PyTorch version on the card, and drives nine paths,
each solve with the kernels' launch counts set to 0 just before it and
read just after.  The solves run their iterations in blocks replayed as
CUDA graphs (tpu_lbfgs_torch.core.blocks): a launch recorded into a
graph's capture runs on every replay, and the counts count what the card
ran, with the replayed part apart, so each check holds a solve to one
launch per iteration the graphs stepped.  The paths:

- the single instance (chained Rosenbrock, d = 2^20, float32, m = 10,
  compact_incremental direction, Armijo backtracking on the directional
  polynomial) through tpu_lbfgs_torch.minimize, over the Rosenbrock value
  and gradient and fused tail kernels;
- the batch (4096 instances of d = 1024 in bounded lockstep, the same
  solver with fidelity="fixed" and the pair skip) through
  tpu_lbfgs_torch.vmap_minimize, over the batched compact chain kernel,
  then a short solve of the same batch at m = 7 through the kernel and
  through its plain version;
- the batch solve on the kernels ([batch-kernels]): the batched forms of
  iteration_tail, fused_vg, the fused tail and combine_direction (the
  reference's jax.vmap over its kernels) against their batched plain
  versions at the batch cell, at 3 lanes of d = 2^20 + 37 and at 65,537
  lanes of 64; then on the batch cell vmap_minimize with use_pallas=True
  and the fused Rosenbrock value and gradient (200 iterations, over the
  batched iteration_tail, vg and compact chain kernels, lane for lane as
  the same solve through the plain versions; 20 iterations in float64),
  solve_bounded over the batched state with the fused tail of each body
  and form (its products on a float32 and a bfloat16 ring, without them,
  compensated), the public combine entry on the states those leave, and
  the command line's --batch 64 --dim 1024 --pallas in float32 and in
  float64;
- direct evaluation (the reference protocol's f32 stack: REFERENCE_PARALLEL,
  compact_incremental, ls_eval="direct", no alpha rescue) under each of the
  8 line searches at d = 2^20 from U(-10, 10), over the value and gradient
  and fused tail kernels and, for the speculative twins, the K-trial
  multi_phi and multi_phi_dphi kernels;
- every line search on a batch ([batch-search]): the batch cell (4096 x
  1024, float32, direct evaluation) under each of the 8 searches in
  bounded lockstep for 20 iterations, under
  torch.cuda.set_sync_debug_mode("error") so that a host read fails it,
  over the batched compact chain kernel, against the same solve in
  float64; then one instance at d = 2^20 under each search, solve_bounded
  (its searches' fixed-trip loop, the same sync mode) against
  solve_from_state (their read-driven loop), bit for bit, both timed,
  over the value and gradient, fused tail and K-trial kernels;
- the general path, a caller's own objective at d = 2^20 in float32 with
  use_pallas=True and no fused tail, over the iteration_tail kernel every
  iteration: chained Rosenbrock under each of the three directions, the
  coupled quadratic from its plain f and grad, an objective differentiated
  by autograd under the default configuration, and one solve with damping,
  compensated dots, a trace and the periodic product refresh; then the
  public combine_direction kernel entry on the states those solves leave;
- the command line, tpu_lbfgs_torch.cli.main in process with --dim 1048576
  --dtype float32 --pallas: each of rosenbrock, quadratic and
  coupled_quadratic on the polynomial, the two quadratics under the
  speculative Armijo and Wolfe searches in direct mode, and Rosenbrock with
  a bfloat16 history (whose products "auto" puts into the tail); then,
  through minimize (the command line has no flag for them), the fused tail
  with and without its in-kernel history products on a float32 and on a
  bfloat16 ring and the compensated tail; over the
  quadratic and coupled bodies of the four fused kernel families, every
  form of the fused tail and the combine kernel on a bfloat16 ring;
- the sharded solve, tpu_lbfgs_torch.dist.sharded_minimize on 4 spawned
  processes that share the one card over gloo (NCCL takes one rank per
  card), global d = 2^22 in float32 (d_local = 2^20): chained Rosenbrock on
  the main path's configuration for 100 iterations, then shorter solves of
  each problem under the speculative Armijo and Wolfe searches in direct
  mode, with t1 and t2 in the tail on a bfloat16 ring, at an unaligned d,
  and of the quadratic on the polynomial; over the shard-local forms of
  the four fused kernel families, each against the single-device port at
  the same d, and where those two float32 solves part, beside the same
  solve in float64 as the witness.  Before it, in one process, each
  shard-local kernel is held against its plain version and, the shards
  joined, against the whole-vector kernel, at d = 2^20, 2^20 + 37 and 293
  and at the shapes this phase hands them (d = 2^22 and 2^22 + 37 in 4
  shards).  Four ranks on one card share it, so the phase's times are a
  correctness run's cost and no scaling number;
- the batched, sharded solve ([dist-batch]),
  tpu_lbfgs_torch.dist.sharded_vmap_minimize on 4 spawned processes laid
  out as a 2 x 2 (b, d) mesh on the one card (gloo): 8 instances of d =
  2^21 in float32, 4 lanes of d_local = 2^20 a rank, on bench.py's
  configuration in both lockstep modes, under the speculative Armijo and
  Wolfe searches in direct mode for each problem, with t1 and t2 in the
  tail on a bfloat16 ring, and for the coupled quadratic at an unaligned
  d; over the batched shard-local forms of the four fused kernel
  families, one launch for all of a rank's lanes, every lane against the
  same batch on one device.  Before it, in one process, each batched
  shard-local kernel is held against its batched plain version and, lane
  by lane, against the one-instance shard-local kernel, at 4 lanes of
  2^20 and of 2^20 + 10 and at 4096 lanes of 512 per shard.

Between the command line and the sharded solve, [route] checks on the card
that no wrapper of a problem-specific kernel takes its plain version by
itself: a float64 tensor raises, and the command line under --dtype
float64 warns and says what it builds; the tail's products at m = 7 launch
without a warning.

After the sharded solve, four phases drive the experiment harnesses and
the checkpoints at the sizes their users run:

- [checkpoint]: the single instance's configuration at d = 2^20 in
  float32, two make_solve_segment segments of 50 iterations cut by
  tpu_lbfgs_torch.io.save_state / load_state, against the same two
  segments uncut, every field bit for bit, on a float32 ring and on a
  bfloat16 ring with the history products in the tail; the file holds the
  reference's schema key, (m, R, L) ring and casts;
- [giant]: fused_vg and the fused tail with its products (m = 10)
  against their plain versions on the same inputs at d = 2^26 on a
  bfloat16 ring and d = 1e8 on a float32 ring (vectors and rows bit for
  bit, sums within 1e-9 of sum|terms| beyond 1 ulp); then
  tpu_lbfgs_torch.bench.giant.main at d = 2^26 (float32 ring,
  bfloat16 ring, the bfloat16 ring in segments) and d = 1e8 (float32
  ring, 8 GB), m = 10, the products in the tail: a finite f, one fused
  tail launch per iteration run, and its rate on the traffic model at
  most 1.05 of the card's memory rate; each line beside the device time
  per iteration;
- [tol]: time_to_tolerance_refined at d = 2^11, float32 on the main path
  to 1e-3, then float64 on the card to 1e-5 within 100 iterations;
- [protocol]: the reference protocol's cells from U(-1000, 1000) at d =
  10,000: the three float32 parallel-configuration cells that the
  reference records as line_search_failed at iteration 1 end so here, and
  a float64 cell on the quadratic converges.

After [bench], [cpu-baseline] drives the CPU baseline: the C++ oracle
(tpu_lbfgs_torch.native, native/oracle.cpp built by g++ at first use, its
build seconds and the host's CPU printed) at d = 2^20 through
bench_cpu_native beside [bench]'s bench_gpu rate and their ratio; the
oracle against minimize in float64 on the card, the same algorithm, over
20 iterations (statuses equal, f within 1e-6 at each); the north-star
function with the oracle's float64 stage (refine_backend="native") at d
= 2^11 to 1e-5; run_protocol with the oracle's cells at d = 10,000 for
Armijo Backtracking, whose row gets cuda_per_iter_speedup; and the
command line's --backend native against a direct native_lbfgs call.

After [batch], [graph] holds the solve loops' CUDA graphs to the same
blocks run eagerly (tpu_lbfgs_torch.eager_loops): bench.py's solve at d =
2^20 for 400 iterations and the batch cell for 200, bit for bit and timed
in turns; a solve of each while form that its tol ends inside a block;
replayed blocks under torch.cuda.set_sync_debug_mode("error"); the
graphs' capture seconds and private pool at d = 2^20 and 2^26; the block
length timed at 5, 20 and 50; and, after every timed phase, device
kernels per iteration from torch.profiler, replayed against eager.

After [checkpoint], six phases drive what the port added last:

- [dist-own]: a caller's own objectives through sharded_minimize on 4
  spawned ranks sharing the card over gloo, d = 2^22 in float64,
  partitioned by DTensor: chained Rosenbrock written out, against the
  suite's Rosenbrock by name and the single-device minimize of the same f
  (f to 1e-10 over 40 iterations, alphas equal), and a pseudo-Huber
  objective outside the suite against its single-device solve; the
  collectives of one evaluation and the ms per iteration, which is a
  correctness run's cost;
- [checkpoint-sharded], in the same job: the [dist] configuration on the
  kernel path in float32 saved at iteration 20 by save_state_sharded on
  the 4 ranks, loaded onto 4, 2 and 1 rank(s) and resumed to 40 by
  solve_shard_from_state, against the uncut solve (bit for bit on 4);
- [scaling]: bench.scaling.scaling_sweep at 1, 2 and 4 ranks on the one
  card, each row with its stack label, which is no scaling number;
- [profile]: utils.profiling.profile_solve on the main path writes a
  torch.profiler trace that names the fused tail kernel once per iteration;
- [debug-nans]: a gradient that turns NaN raises FloatingPointError under
  core.solver.set_debug_nans, and the main path with the check gives the
  iterates it gives without;
- [examples]: each examples/torch_*.py at its defaults on the card.

It checks that each solve went through its kernels, that its output is
sound and equals the plain versions' over the first iterations, and that
one iteration of each polynomial path never waits on the device; then it
times the two polynomial solves, and prints each line search's time,
trials and host reads per iteration.
Every check raises on failure, so the exit code is 0 only when all pass.
The last line of output is a JSON record of the device; the line before
it records each kernel: its launches on its path, its largest deviation
from the plain version, its time, the plain version's, the least time the
card could take for the same bytes and operations, and, where one PyTorch
call computes the same function, that call's time.  Without a CUDA device
it exits with an error and prints no record.
"""
import contextlib
import itertools
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

D = 1 << 20                 # bench.py's size
RAGGED = D + 37             # no multiple of any block or lane width
SEED = 42                   # bench.py's seed
MAIN_ITERS = 200
TRACE_ITERS = 20
BENCH_ITERS = 400
BATCH, BATCH_D = 4096, 1024  # bench.py's batch cell
RAGGED_BATCH = BATCH + 37
BATCH_ITERS = 200
# The batched chain takes any m from 1 to 64: checked at these, timed at
# CHAIN_TIMED_M; the batch solve also runs CHAIN_SOLVE_ITERS iterations at
# m = 7, a depth the first kernel refused.
CHAIN_M = (3, 5, 7, 10, 20)
CHAIN_TIMED_M = (5, 10, 20)
CHAIN_SOLVE_M = 7
CHAIN_SOLVE_ITERS = 20

# Kernel against plain version, float32 on the card.  Output vectors: the
# kernels are built with -fmad=false and round where the plain version does,
# so they are expected equal; the check allows 2 ulp.  Sums: both add the
# same float32 terms in float64, in different orders, so
# |kernel - plain| <= 1e-5 * sum of |terms| (the error bound of a sum scales
# with the absolute terms, not with a cancelled total).
VEC_ULPS = 2.0
SUM_RTOL = 1e-5
# Main path, kernels against plain versions: equal alpha at every one of
# the first TRACE_ITERS iterations, f within 1e-4 relative (the float32 sums
# differ in order and the trajectory amplifies that slowly).
TRACE_F_RTOL = 1e-4
# The batched chain kernel against its plain version, in float32 and in
# float64: both run the same operations in the same order (-fmad=false), so
# every output is expected equal bit for bit (NaN where the plain version
# has NaN), and
# the batch solve's first TRACE_ITERS iterations with the kernel and with
# the plain chain equal too: alpha equal, f within 0 relative.
CHAIN_ABS_TOL = 0.0
BATCH_TRACE_F_RTOL = 0.0
# The K-trial kernels' trial counts: spec_width (8), and the Wolfe tree's
# (R+1)(R+2)/2 = 36 at R = spec_width - 1, at the main path's sizes and at
# one of 293 (a full block of 256 threads and a ragged one), where every
# term is a large share of its sum.
TRIALS = (8, 36)
TRIAL_D = (D, RAGGED, 293)
# These kernels return sums and no vector, so the sums are held tight: both
# sides add the same float32 terms in float64, in orders that differ by at
# most about n * 2^-53 of sum|terms| (1.2e-10 at n = 2^20), and round once
# to float32, which may differ by one ulp more.  So |kernel - plain| <=
# 1e-9 * sum|terms| + 1 float32 ulp of plain: a term dropped or formed
# wrong (about 1e-6 of sum|terms| at n = 2^20) fails.
TRIAL_SUM_RTOL = 1e-9
# The direct-evaluation phase: iterations per line search, and the box of
# x0 (scripts/convergence_profiles.py: from the published U(-1000, 1000)
# the interpolating searches fail at iteration 1 in float32).  A twin's
# first TRACE_ITERS iterations with its K-trial kernel and with the plain
# version take equal alphas and f within TRACE_F_RTOL.
DIRECT_ITERS = 100
DIRECT_BOX = 10.0
# [batch-search]: every line search in direct mode on the batch cell
# (SEARCH_ITERS iterations of 4096 x 1024, bounded lockstep) and on one
# instance at d = 2^20 (SEARCH_D_ITERS iterations under each loop).  The
# float32 batch against the same solve in float64 from the same start: the
# status equal on at least SEARCH_LANE_SHARE of the lanes, and on that
# share of the lanes that run in both, f within SEARCH_F_RTOL relative.  Not every
# lane: float32 rounding moves a lane's alphas, and a few lanes part (on
# the CPU at 512 x 1024, armijo_interpolation failed one float32 lane that
# float64 kept, and one lane ended 475x apart; every other search kept
# every lane's status, f within 8.1e-5, median 2-4e-7).
SEARCH_ITERS = 20
# The search whose capture on the batch cell, each loop a WHILE node,
# [batch-search] holds to its eager fixed-trip blocks: the interpolating
# Wolfe search (captured, 6.26-6.27 ms an iteration against 44.93-50.89
# eager, capture 0.10 s, on an H100 80GB HBM3 at 700 W,
# torch_records/graph_costs.py --gated).
SEARCH_CAPTURE = "wolfe_interpolation"
SEARCH_D_ITERS = 10
SEARCH_LANE_SHARE = 0.99
SEARCH_F_RTOL = 1e-3
# The general path.  iteration_tail against its plain version: the three
# vectors bit for bit, each sum within TRIAL_SUM_RTOL of sum|terms| plus
# one ulp of the working dtype (float64 partials in another order; the
# compensated float32 plain version sums float32 chunks, whose own rounding
# stays below one ulp of a sum this size).  combine_direction runs its plain
# version's operations in its order: bit for bit, tolerance 0.
TAIL_D = (D, RAGGED, 293)
COMBINE_D = (D, RAGGED)
# fused_vg around its runs of 4 elements and its warps' 32 runs, at the
# main path's ragged size, and at an x that starts one float past a 16-byte
# boundary (VG_OFFSET_N; the kernel then takes its element-wise path): g
# bit for bit against the plain version, f within TRIAL_SUM_RTOL of
# sum|terms| plus one float32 ulp.  local_fused_vg at blocks of VG_LOCAL_N
# elements, 4 of them over a global d one element short (the last block
# holds a padded element): each block's g bit for bit, its float64 f within
# TRIAL_SUM_RTOL of sum|terms|, the blocks' g joined against the
# whole-vector kernel's bit for bit.
VG_N = (1, 2, 3, 4, 5, 255, 257, RAGGED)
VG_OFFSET_N = (5, 257, RAGGED)
VG_LOCAL_N = (1, 2, 3, 257)
# The compensated sums on the data of tests/test_torch_kernels.py::
# test_compensated_tail_tracks_f64_on_lossy_data at d = 2^20 (g_new near 1,
# so a running float32 sum of its squares loses bits): each compensated sum
# of iteration_tail (float32, float64) and of the fused tail (each body)
# within LOSSY_F32_ULPS float32 units in the last place of the exact sum
# (math.fsum of the float64 products, which equal the kernels' terms) and
# no further from it than the same kernel's uncompensated sum.
LOSSY_SEED = 11
LOSSY_F32_ULPS = 64.0
COMBINE_ABS_TOL = 0.0
GENERAL_ITERS = 60
GENERAL_WARMUP = 5
OPTIONS_ITERS = 120
OPTIONS_REFRESH = 50
# The command line.  Full width, depth cut: the Rosenbrock solves run
# CLI_ITERS iterations at tol = 0; the quadratics converge at the default
# tol = 1e-5 in a few.  The fused tail with its history products (t1, t2)
# against its plain version: each of the 2 m sums within TRIAL_SUM_RTOL of
# sum|terms| plus one float32 ulp, as the K-trial sums are held, and two
# calls give bit-equal sums.  GIANT and MATVEC_D are the other sizes at
# which the tail's forms are timed for the with_matvec rule.
CLI_ITERS = 100
CLI_ARGS = ["--dim", str(D), "--dtype", "float32", "--pallas", "--json"]
TAIL_M = (5, 10, 20)
GIANT = 1 << 24
MATVEC_D = (1 << 16, 1 << 18)   # the smaller sizes the with_matvec rule reads
# The roofline's peaks for one H100 SXM (NVIDIA's data sheet): device memory
# and float32 outside the tensor cores.  Every arithmetic operation is
# counted at the float32 rate, the float64 additions of the sums too.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def say(*parts):
    print(*parts, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def ran(launches):
    """The kernels of a launch count that ran, for a printed line."""
    return {name: n for name, n in launches.items() if n}


# The solves run their iterations in blocks replayed as CUDA graphs
# (tpu_lbfgs_torch.core.blocks).  A kernel wrapper called while a graph is
# captured records its launch into the graph, and each replay runs it:
# kernels.launch_counts() counts what the card ran, eager launches and
# replays together, kernels.replay_counts() the replayed part (each
# graph's captured launches times its replays).  Each capture starts with
# one warm-up iteration, every lane masked off, which runs every kernel of
# an iteration once more, eagerly.  A solve that ends inside a block steps
# on, frozen, to the block's end.  The checks below hold a solve in blocks
# to one launch per iteration the graphs stepped.

def reset_counts():
    """Zero the kernels' launch counts and the block runner's counts
    together, just before a solve."""
    from tpu_lbfgs_torch import kernels
    from tpu_lbfgs_torch.core import blocks

    kernels.reset_launches()
    blocks.reset_stats()


def per_step(name, eager=0):
    """Whether kernel ``name`` ran once per iteration stepped in blocks
    since reset_counts(): its replayed launches equal those iterations
    (none where the blocks ran eagerly, blocks.eager_loops), and its
    launches in all those plus one per capture's warm-up iteration and
    ``eager`` launches outside the blocks."""
    from tpu_lbfgs_torch import kernels
    from tpu_lbfgs_torch.core import blocks

    st = blocks.stats
    replayed = st["steps"] if st["replays"] else 0
    return (kernels.replay_counts()[name] == replayed
            and kernels.launch_counts()[name]
            == st["steps"] + st["warmups"] + eager)


def one_per_iteration(name, k, eager=0):
    """Whether kernel ``name`` ran once per iteration of a solve of ``k``
    iterations since reset_counts(): ``k`` launches (+ ``eager``) where the
    solve kept its per-iteration loop; in blocks, ``per_step``, with ``k``
    among the iterations stepped and fewer than a block past it."""
    from tpu_lbfgs_torch import kernels
    from tpu_lbfgs_torch.core import blocks

    steps = blocks.stats["steps"]
    if steps == 0:
        return kernels.launch_counts()[name] == k + eager
    return per_step(name, eager) and k <= steps < k + blocks.BLOCK_ITERS


def blocks_note():
    """The block runner's counts since reset_counts(), for a line."""
    from tpu_lbfgs_torch.core import blocks

    st = blocks.read_stats()
    return (f"{st['steps']} iterations in blocks ({st['replays']} replays, "
            f"{st['captures']} captures in {st['capture_s']:.3f} s of "
            f"{st['graph_nodes']} nodes and {st['while_nodes']} WHILE nodes, "
            f"{st['gated_turns']} gated search turns, {st['warmups']} "
            f"warm-up iterations, {st['host_reads']} host reads of the "
            "loop's flags)")


def ulps(a, b):
    """Largest distance between a and b in units of b's last place."""
    b_abs = b.abs()
    spacing = torch.nextafter(b_abs, torch.full_like(b_abs, float("inf"))) \
        - b_abs
    return ((a - b).abs() / spacing).max().item()


def device_ms(fn):
    """Device time of one call of fn, from CUDA events around a few calls.
    The card first spins on a sleep kernel (about 0.1 s) while the host
    queues every call, so the events time back-to-back device work, not
    the host.  The card reaching the first event before the host has
    queued the last call means the launch queue filled up and blocked the
    host; the calls are then timed again, fewer of them."""
    fn()
    torch.cuda.synchronize()
    for reps in (10, 4, 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_ahead = not start.query()
        end.synchronize()
        if queued_ahead:
            say(f"[timing]   {reps} calls queued ahead of the card")
            return start.elapsed_time(end) / reps
    raise AssertionError("the host never queued the timed calls ahead of "
                         "the card")


def bound_ms(n_bytes, n_ops):
    """The least time the card could take: the larger of the bytes over the
    memory rate (each input read once, each output written once) and the
    operations over the float32 peak; and which of the two it is."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / F32_OPS_PER_S * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def trial_bound_note(bounds, ms):
    """A K-trial kernel's bound for the build the port has
    (tpu_lbfgs_torch/bench/trial_bounds.py: issue at one slot an operation,
    float64 conversions and adds on their pipe, bytes) and the share of it
    the kernel's time ``ms`` reaches, for its line."""
    limit, by = bounds["corrected"]
    return (f"corrected bound {limit * 1e3:.2f} us by {by} (issue "
            f"{bounds['issue'] * 1e3:.2f}, float64 pipe "
            f"{bounds['f64'] * 1e3:.2f}, bytes {bounds['bytes'] * 1e3:.2f}): "
            f"{limit / ms:.0%} of it")


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[card] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} | CUDA {torch.version.cuda} | "
        f"matmul.allow_tf32 was {was}, set False: float32 matmuls run in "
        "full float32")
    return card


def phase_build():
    from tpu_lbfgs_torch.kernels import _build

    t0 = time.perf_counter()
    path, compile_s, report = _build.build()
    lib = _build.load()
    say(f"[build] {path.relative_to(_build._PKG.parent)}: nvcc "
        f"{compile_s:.2f} s, total {time.perf_counter() - t0:.2f} s "
        f"({'reused' if compile_s == 0 else 'compiled'})")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say(f"[build]   {line.strip()}")
    for body, name in enumerate(("quadratic", "rosenbrock",
                                 "coupled_quadratic")):
        per_sm = [lib.tl_fused_tail_blocks_per_sm(body, bf16)
                  for bf16 in (0, 1)]
        dphi = lib.tl_multi_phi_dphi_blocks_per_sm(body)
        say(f"[build] blocks of 256 threads per SM: {name} fused "
            f"tail with products {per_sm[0]} (f32 ring), {per_sm[1]} (bf16 "
            f"ring); multi_phi_dphi {dphi}")
        check(min(per_sm + [dphi]) >= 1, f"{name}: a kernel fits no SM")


def _kernel_inputs(n, dev):
    rng = np.random.default_rng(SEED)
    as_t = lambda a: torch.from_numpy(a).to(device=dev, dtype=torch.float32)
    x = as_t(rng.uniform(-2.0, 2.0, n))
    d = as_t(rng.uniform(-1.0, 1.0, n))
    g = as_t(rng.uniform(-1.0, 1.0, n))
    return x, d, g


def _f_abs_terms(problem, u):
    """sum |terms of f| at u (float64): the scale of f's rounding error.
    Only the coupled quadratic has terms of either sign."""
    import tpu_lbfgs_torch as tt

    if problem == "coupled_quadratic":
        return (1000.0 * u * u).sum(-1) + (100.0 * u[..., :-1]
                                           * u[..., 1:]).abs().sum(-1)
    return tt.get_problem(problem).f(u)


def _tail_sums_check(problem, out_k, out_p, d, g):
    """Largest error of the tail's seven sums, kernel against plain, in
    units of each sum's sum|terms|; and beyond one ulp of the plain sum."""
    xn, gn, s, y = (out_p[i].double() for i in (0, 2, 3, 4))
    dd, gg = d.double(), g.double()
    scales = [_f_abs_terms(problem, xn), (s * y).abs().sum(), (y * y).sum(),
              (gn * gn).sum(), (dd * gn).abs().sum(), (gg * gn).abs().sum(),
              (y * gn).abs().sum()]
    sums_k = [out_k[1]] + list(out_k[5:11])
    sums_p = [out_p[1]] + list(out_p[5:11])
    err = max(((a.double() - b.double()).abs() / sc).item()
              for a, b, sc in zip(sums_k, sums_p, scales))
    over = max(_beyond_ulp(a, b, sc)
               for a, b, sc in zip(sums_k, sums_p, scales))
    return err, over


def phase_kernels(dev):
    """The value-and-gradient kernel and the fused tail (no matvec, float32
    rows, plain sums) of every body against their plain versions."""
    from tpu_lbfgs_torch.kernels import fused_ops as ops

    rec = {}
    alpha = torch.full((), 0.125, dtype=torch.float32, device=dev)
    for problem, n in itertools.product(ops.BODY_IDS, TAIL_D):
        x, d, g = _kernel_inputs(n, dev)
        vg_name, tail_name = f"{problem}_vg", f"{problem}_fused_tail"
        vg_plain = ops.VG_PLAIN[problem]
        tail = ops.make_fused_tail(problem, vg_plain, with_matvec=False)
        # value and gradient
        f_k, g_k = ops.fused_vg(problem, x)
        f_p, g_p = vg_plain(x)
        torch.cuda.synchronize()
        vg_ulp = ulps(g_k, g_p)
        vg_abs = (g_k - g_p).abs().max().item()
        f_rel = abs(f_k.item() - f_p.item()) / _f_abs_terms(
            problem, x.double()).item()
        say(f"[kernel] {vg_name} d={n}: g max abs err {vg_abs:.3e}, "
            f"{vg_ulp:.2f} ulp (tol {VEC_ULPS}), bit-equal "
            f"{torch.equal(g_k, g_p)}; f err {f_rel:.3e} of sum|terms| "
            f"(tol {SUM_RTOL})")
        check(vg_ulp <= VEC_ULPS and f_rel <= SUM_RTOL,
              f"{vg_name} disagrees with its plain version at d={n}")
        # fused tail
        out_k = tail(x, d, alpha, g)
        out_p = ops.fused_tail_plain(vg_plain, x, d, alpha, g)
        torch.cuda.synchronize()
        tail_abs, tail_ulp, same = 0.0, 0.0, True
        for i in (0, 2, 3, 4):
            tail_abs = max(tail_abs, (out_k[i] - out_p[i]).abs().max().item())
            tail_ulp = max(tail_ulp, ulps(out_k[i], out_p[i]))
            same &= torch.equal(out_k[i], out_p[i])
        sum_err, _ = _tail_sums_check(problem, out_k, out_p, d, g)
        check(out_k[11] is None and out_k[12] is None, "t1/t2 must be None")
        say(f"[kernel] {tail_name} d={n}: vectors max abs err "
            f"{tail_abs:.3e}, {tail_ulp:.2f} ulp (tol {VEC_ULPS}), bit-equal "
            f"{same}; 7 sums max err {sum_err:.3e} of sum|terms| (tol "
            f"{SUM_RTOL})")
        check(tail_ulp <= VEC_ULPS and sum_err <= SUM_RTOL,
              f"{tail_name} disagrees with its plain version at d={n}")
        if problem != "rosenbrock":     # the new bodies: bit for bit
            check(torch.equal(g_k, g_p) and same,
                  f"{problem}: kernel vectors must equal the plain "
                  f"version's bit for bit at d={n}")
        if n != D:
            continue
        # Per element: x in and g out, 3 (quadratic) to 18 (Rosenbrock)
        # operations; the tail x, d, g in and x_new, g_new, s, y out and
        # about 22 more.
        body_ops = {"quadratic": 4, "rosenbrock": 18,
                    "coupled_quadratic": 9}[problem]
        rec[vg_name] = {
            "max_abs_err": vg_abs,
            "ms": device_ms(lambda: ops.fused_vg(problem, x)),
            "plain_ms": device_ms(lambda: vg_plain(x)),
            "bound": bound_ms(8 * n + 4, body_ops * n)}
        rec[tail_name] = {
            "max_abs_err": tail_abs,
            "ms": device_ms(lambda: tail(x, d, alpha, g)),
            "plain_ms": device_ms(lambda: ops.fused_tail_plain(
                vg_plain, x, d, alpha, g)),
            "bound": bound_ms(28 * n + 4 + 28, (body_ops + 22) * n)}
        for name in (vg_name, tail_name):
            r = rec[name]
            say(f"[kernel] {name} d={n}: {r['ms'] * 1e3:.2f} us on the "
                f"card, plain version {r['plain_ms'] * 1e3:.2f} us, bound "
                f"{r['bound'][0] * 1e3:.2f} us by {r['bound'][1]}")
    return rec


def phase_vg_shapes(dev, card):
    """fused_vg and local_fused_vg at the shapes that take their
    element-wise paths (VG_N, VG_OFFSET_N, VG_LOCAL_N)."""
    from tpu_lbfgs_torch.dist.shardmap_vg import local_vg_plain
    from tpu_lbfgs_torch.kernels import fused_ops as ops

    tiny = torch.finfo(torch.float64).tiny
    for problem in ops.BODY_IDS:
        plain = ops.VG_PLAIN[problem]
        shapes = [(n, 0) for n in VG_N] + [(n, 1) for n in VG_OFFSET_N]
        worst, same = 0.0, True
        for n, offset in shapes:
            x = _kernel_inputs(n + offset, dev)[0][offset:]
            check(x.is_contiguous()
                  and (x.data_ptr() % 16 != 0) == bool(offset),
                  "the offset x must start off a 16-byte boundary")
            f_k, g_k = ops.fused_vg(problem, x)
            f_p, g_p = plain(x)
            torch.cuda.synchronize()
            scale = _f_abs_terms(problem, x.double()).clamp(min=tiny)
            over = _beyond_ulp(f_k, f_p, scale)
            ok = torch.equal(g_k, g_p) and over <= TRIAL_SUM_RTOL
            check(ok, f"{problem}_vg at d={n} offset {offset}: g bit-equal "
                  f"{torch.equal(g_k, g_p)}, f {over:.3e} of sum|terms| "
                  "beyond 1 ulp")
            worst, same = max(worst, over), same and ok
        say(f"[kernel] {problem}_vg at d = {', '.join(map(str, VG_N))} and "
            f"one float off a 16-byte boundary at d = "
            f"{', '.join(map(str, VG_OFFSET_N))}: g bit-equal to the plain "
            f"version {same}, f {worst:.3e} of sum|terms| beyond 1 ulp (tol "
            f"{TRIAL_SUM_RTOL}) on {card}")

        errs, same = 0.0, True
        for d_local in VG_LOCAL_N:
            shards = 4
            n = shards * d_local - 1
            x = _kernel_inputs(n, dev)[0]
            xp = torch.nn.functional.pad(x, (0, 1))
            scale = _f_abs_terms(problem, x.double()).clamp(min=tiny)
            g_whole = ops.fused_vg(problem, x)[1]
            parts = []
            for r in range(shards):
                xl = _block(xp, r, d_local)
                e_vg = _shard_edges(xp, xp, r, d_local)[[0, 2]].contiguous()
                f_k, g_k = ops.local_fused_vg(problem, xl, n, r * d_local,
                                              e_vg)
                f_p, g_p = local_vg_plain(problem, xl, n, r * d_local, e_vg)
                torch.cuda.synchronize()
                same &= torch.equal(g_k, g_p)
                errs = max(errs, ((f_k - f_p).abs() / scale).item())
                parts.append(g_k)
            joined = torch.cat(parts)
            same &= (torch.equal(joined[:n], g_whole)
                     and joined[n].item() == 0.0)
        say(f"[kernel] {problem}_vg_local at blocks of "
            f"{', '.join(map(str, VG_LOCAL_N))} (4 blocks, d one short): g "
            f"bit-equal to the plain version and, joined, to the whole-vector "
            f"kernel {same}; float64 f {errs:.3e} of sum|terms| (tol "
            f"{TRIAL_SUM_RTOL}) on {card}")
        check(same and errs <= TRIAL_SUM_RTOL,
              f"{problem}_vg_local disagrees at small blocks")


def _lossy_inputs(n, dev):
    """tests/test_torch_kernels.py's lossy data at n elements, float32 on
    the card: g_new, g, x, d."""
    rng = np.random.default_rng(LOSSY_SEED)
    gn = (1.0 + 1e-3 * rng.standard_normal(n)).astype(np.float32)
    g = (1e-3 * rng.standard_normal(n)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    d = rng.standard_normal(n).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (gn, g, x, d)]


def _f_terms(problem, u):
    """f's float32 terms at u, formed as the plain versions form them."""
    if problem == "quadratic":
        r = u - 1.0
        return r * r
    if problem == "rosenbrock":
        t1 = u[1:] - u[:-1] * u[:-1]
        t2 = 1.0 - u[:-1]
        return 100.0 * t1 * t1 + t2 * t2
    t = 1000.0 * u * u
    t[:-1] += 100.0 * (u[:-1] * u[1:])
    return t


def _lossy_check(label, terms, comp, plain, card):
    """Each compensated sum against math.fsum of its float64 terms: within
    LOSSY_F32_ULPS float32 ulps and no further than the plain sum."""
    worst_ulps, margin = 0.0, float("inf")
    for t, c, p in zip(terms, comp, plain):
        exact = math.fsum(t.double().cpu().tolist())
        unit = float(np.spacing(np.float32(abs(exact))))
        err_c, err_p = abs(c.item() - exact), abs(p.item() - exact)
        worst_ulps = max(worst_ulps, err_c / unit)
        margin = min(margin, err_p - err_c)
        check(err_c <= LOSSY_F32_ULPS * unit and err_c <= err_p,
              f"{label}: compensated sum {c.item()!r} is {err_c:.3e} from "
              f"the exact {exact!r} (plain {p.item()!r}, {err_p:.3e}; "
              f"float32 ulp {unit:.3e})")
    say(f"[kernel] {label} on the lossy data, d={D}: {len(terms)} "
        f"compensated sums within {worst_ulps:.3e} float32 ulps of math.fsum "
        f"of their float64 terms (tol {LOSSY_F32_ULPS}), none further from "
        f"it than the plain form's (closest margin {margin:.3e}) on {card}")


def phase_compensated(dev, card):
    """The compensated sums of iteration_tail and the fused tail against
    the exact sums on the lossy data, and both forms' times."""
    from tpu_lbfgs_torch.kernels import fused_ops as ops

    gn32, g32, x32, d32 = _lossy_inputs(D, dev)
    for dt in (torch.float32, torch.float64):
        gn, g, x, d = (t.to(dt) for t in (gn32, g32, x32, d32))
        alpha = torch.full((), 0.37, dtype=dt, device=dev)
        plain = ops.iteration_tail(x, d, alpha, g, gn)
        comp = ops.iteration_tail(x, d, alpha, g, gn, accurate=True)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(plain[:3], comp[:3])),
              "iteration_tail's vectors depend on the compensated flag")
        # The kernel's terms: float64 products of the working values, exact
        # for float32 values, rounded once for float64 ones, as here.
        s, y, gd, dd, gg = (t.double() for t in (comp[1], comp[2], gn, d, g))
        terms = [s * y, y * y, gd * gd, dd * gd, gg * gd]
        _lossy_check(f"iteration_tail {dt}", terms, comp[3:], plain[3:], card)
        size = x.element_size()
        bound = bound_ms(size * (7 * D + 6), 13 * D)
        times = [device_ms(lambda a=a: ops.iteration_tail(
            x, d, alpha, g, gn, accurate=a)) for a in (False, True)]
        say(f"[kernel] iteration_tail {dt} d={D}: plain {times[0] * 1e3:.2f} "
            f"us, compensated {times[1] * 1e3:.2f} us, bound "
            f"{bound[0] * 1e3:.2f} us by {bound[1]} on {card}")

    alpha = torch.full((), 0.37, dtype=torch.float32, device=dev)
    for problem in ops.BODY_IDS:
        vg_plain = ops.VG_PLAIN[problem]
        forms = [ops.make_fused_tail(problem, vg_plain, with_matvec=False,
                                     accurate_dots=a) for a in (False, True)]
        plain, comp = (tail(x32, d32, alpha, g32) for tail in forms)
        torch.cuda.synchronize()
        check(all(torch.equal(plain[i], comp[i]) for i in (0, 2, 3, 4)),
              f"{problem}: the fused tail's vectors depend on the flag")
        xn, gd, s, y = (comp[i].double() for i in (0, 2, 3, 4))
        dd, gg = d32.double(), g32.double()
        terms = [_f_terms(problem, comp[0]), s * y, y * y, gd * gd, dd * gd,
                 gg * gd, y * gd]
        sums = lambda out: [out[1], *out[5:11]]
        _lossy_check(f"{problem}_fused_tail", terms, sums(comp), sums(plain),
                     card)
        if problem == "rosenbrock":
            bound = bound_ms(28 * D + 32, 40 * D)
            times = [device_ms(lambda tail=tail: tail(x32, d32, alpha, g32))
                     for tail in forms]
            say(f"[kernel] rosenbrock_fused_tail d={D}: plain "
                f"{times[0] * 1e3:.2f} us, compensated {times[1] * 1e3:.2f} "
                f"us, bound {bound[0] * 1e3:.2f} us by {bound[1]} on {card}")


def _ring(rng_gen, m, n, dev, hdtype):
    """An (m, n) ring of U(-1, 1) values made on the card."""
    return (2.0 * torch.rand((m, n), generator=rng_gen, device=dev,
                             dtype=torch.float32) - 1.0).to(hdtype)


def _tail_form_check(problem, out_k, out_p, d, g, S, Y, m, hdtype, where):
    """A fused tail form's outputs against its plain version's on the same
    inputs: x_new, g_new and the two rows bit for bit (the rows in the
    ring's dtype), the 7 sums and, with the products, t1 and t2 each within
    TRIAL_SUM_RTOL of sum|terms| beyond one ulp.  Returns those two
    errors."""
    same = all(torch.equal(out_k[i], out_p[i])
               and out_k[i].dtype == out_p[i].dtype for i in (0, 2, 3, 4))
    check(same and out_k[3].dtype == hdtype,
          f"fused tail vectors differ from plain ({where})")
    _, over = _tail_sums_check(problem, out_k, out_p, d, g)
    t_over = 0.0
    if m:
        y = (out_p[2] - g).double().abs()
        for i, ring in ((11, S), (12, Y)):
            check(out_k[i].shape == (m,) and out_k[i].dtype == torch.float32,
                  f"t1/t2 must be ({m},) float32 ({where})")
            # Row by row, so that no float64 copy of a giant ring is made.
            scale = torch.stack([row.double().abs() @ y for row in ring])
            t_over = max(t_over, _beyond_ulp(out_k[i], out_p[i], scale))
    else:
        check(out_k[11] is None and out_k[12] is None,
              f"t1/t2 must be None ({where})")
    check(over <= TRIAL_SUM_RTOL and t_over <= TRIAL_SUM_RTOL,
          f"fused tail sums differ from plain ({where}): 7 sums "
          f"{over:.3e}, t1/t2 {t_over:.3e} beyond 1 ulp")
    return over, t_over


def phase_tail_forms(dev):
    """The fused tail's other forms against the plain version: the
    in-kernel history products at m = 5, 10, 20 and 7 on a float32 and a
    bfloat16 ring (bfloat16 rows without the matvec too), and the
    compensated sums, each called twice (bit-equal sums); then their times
    beside the route they replace, at d = 2^16, 2^18, 2^20 and 2^24, for
    the with_matvec rule."""
    from tpu_lbfgs_torch.core.solver import _matvec
    from tpu_lbfgs_torch.kernels import fused_ops as ops

    rec, errs = {}, {}
    alpha = torch.full((), 0.125, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    hist = {"f32": torch.float32, "bf16": torch.bfloat16}
    for problem, n in itertools.product(ops.BODY_IDS, TAIL_D):
        x, d, g = _kernel_inputs(n, dev)
        vg_plain = ops.VG_PLAIN[problem]
        forms = [(h, m, False) for h in hist for m in (0,) + TAIL_M + (7,)
                 if (h, m) != ("f32", 0)]
        forms += [("f32", 0, True), ("bf16", 10, True)]
        worst = {"sum": 0.0, "t": 0.0}
        for h, m, accurate in forms:
            S, Y = (_ring(gen, max(m, 1), n, dev, hist[h]) for _ in range(2))
            tail = ops.make_fused_tail(problem, vg_plain, with_matvec=m > 0,
                                       accurate_dots=accurate)
            out_k = tail(x, d, alpha, g, S, Y)
            again = tail(x, d, alpha, g, S, Y)
            out_p = ops.fused_tail_plain(vg_plain, x, d, alpha, g, S, Y,
                                         m > 0, accurate)
            torch.cuda.synchronize()
            where = (f"{problem} d={n} ring {h} matvec m={m} "
                     f"compensated={accurate}")
            check(all(a is None and b is None or torch.equal(a, b)
                      for a, b in zip(out_k, again)),
                  f"two calls of the fused tail differ ({where})")
            over, t_over = _tail_form_check(problem, out_k, out_p, d, g,
                                            S, Y, m, hist[h], where)
            worst["sum"] = max(worst["sum"], over)
            worst["t"] = max(worst["t"], t_over)
            errs[problem, n, h, m, accurate] = max(
                (a.float() - b.float()).abs().max().item()
                for a, b in zip(out_k, out_p) if a is not None)
        say(f"[kernel] {problem}_fused_tail forms d={n}: {len(forms)} forms "
            f"(ring f32/bf16, matvec m=0,5,10,20,7, compensated): vectors "
            f"bit-equal, two calls bit-equal, 7 sums {worst['sum']:.3e} and t1/t2 "
            f"{worst['t']:.3e} of sum|terms| beyond 1 ulp (tol "
            f"{TRIAL_SUM_RTOL})")

    # Times, Rosenbrock body (the other bodies do less arithmetic on the
    # same bytes).  Beside each form: the plain version, and for the matvec
    # the route it replaces in the solver, the tail without it followed by
    # core.solver._matvec twice (two torch.mv; a bfloat16 ring is widened
    # first).  library_ms is two torch.mv on the ring as it is stored.
    problem, vg_plain = "rosenbrock", ops.VG_PLAIN["rosenbrock"]
    for n in MATVEC_D + (D, GIANT):
        x = 4.0 * torch.rand(n, generator=gen, device=dev) - 2.0
        d, g = (2.0 * torch.rand(n, generator=gen, device=dev) - 1.0
                for _ in range(2))
        base = ops.make_fused_tail(problem, vg_plain, with_matvec=False)
        for h, m in (("f32", 10), ("bf16", 10), ("f32", 5), ("f32", 20),
                     ("bf16", 5), ("bf16", 20), ("bf16", 0)):
            if n != D and m not in (0, 10) or n < D and m == 0:
                continue
            S, Y = (_ring(gen, max(m, 1), n, dev, hist[h]) for _ in range(2))
            tail = ops.make_fused_tail(problem, vg_plain, with_matvec=m > 0)
            ms = device_ms(lambda: tail(x, d, alpha, g, S, Y))
            size = S.element_size()
            # x, d, g and the ring in; x_new, g_new and the two rows out;
            # 40 operations per element and 4 per ring value.
            bound = bound_ms(n * (20 + 2 * size + 2 * m * size) + 32 + 8 * m,
                             n * (40 + 8 * m))
            line = (f"[kernel] rosenbrock_fused_tail d={n} ring {h} "
                    f"matvec m={m}: {ms * 1e3:.2f} us, bound "
                    f"{bound[0] * 1e3:.2f} us by {bound[1]}")
            r = {"ms": ms, "bound": bound,
                 "max_abs_err": errs[problem, D, h, m, False]}
            if n == D:
                r["plain_ms"] = device_ms(lambda: ops.fused_tail_plain(
                    vg_plain, x, d, alpha, g, S, Y, m > 0))
                line += f", plain version {r['plain_ms'] * 1e3:.2f} us"
            if m:
                y_row = base(x, d, alpha, g, S, Y)[4]
                base_ms = device_ms(lambda: base(x, d, alpha, g, S, Y))
                route_ms = device_ms(lambda: (
                    _matvec(S, y_row, torch.float32),
                    _matvec(Y, y_row, torch.float32)))
                line += (f"; without the matvec {base_ms * 1e3:.2f} us + the "
                         f"solver's two products {route_ms * 1e3:.2f} us = "
                         f"{(base_ms + route_ms) * 1e3:.2f} us")
                r["route_ms"] = base_ms + route_ms
                if h == "f32":
                    r["library_ms"] = device_ms(lambda: (
                        torch.mv(S, y_row), torch.mv(Y, y_row)))
                    line += (f"; two torch.mv alone "
                             f"{r['library_ms'] * 1e3:.2f} us")
            say(line)
            if n == D:
                rec[f"rosenbrock_fused_tail[ring {h}, matvec m={m}]"] = r
            del S, Y
        if n == D:
            comp = ops.make_fused_tail(problem, vg_plain, with_matvec=False,
                                       accurate_dots=True)
            r = {"ms": device_ms(lambda: comp(x, d, alpha, g)),
                 "plain_ms": device_ms(lambda: ops.fused_tail_plain(
                     vg_plain, x, d, alpha, g, accurate=True)),
                 "bound": bound_ms(28 * n + 32, 40 * n),
                 "max_abs_err": errs[problem, D, "f32", 0, True]}
            say(f"[kernel] rosenbrock_fused_tail d={n} compensated: "
                f"{r['ms'] * 1e3:.2f} us, plain version "
                f"{r['plain_ms'] * 1e3:.2f} us, bound "
                f"{r['bound'][0] * 1e3:.2f} us by {r['bound'][1]}")
            rec["rosenbrock_fused_tail[compensated]"] = r
    return rec


def _chain_inputs(rng, B, m):
    """Ring states with empty, partial and wrapped histories, pairs below
    the skip threshold, zero pivots, a negative newest s.y and NaN entries
    (the cases of tests/test_chain.py), float64 numpy."""
    SY = rng.uniform(0.1, 2.0, (B, m, m))
    SY[:, np.arange(m), np.arange(m)] += 2.0
    YY = rng.uniform(0.1, 2.0, (B, m, m))
    Sg, Yg = rng.uniform(-1, 1, (B, m)), rng.uniform(-1, 1, (B, m))
    syh, yyh = rng.uniform(0.1, 2.0, (B, m)), rng.uniform(0.1, 2.0, (B, m))
    n_pairs = rng.integers(0, 4 * m, (B,))
    gn = rng.uniform(0.1, 10.0, (B,))
    for i in range(0, B, 7):
        SY[i, i % m, i % m] = 0.0                          # zero pivots
    syh[3::11] = -1.0                                      # bad gamma
    SY[5::13, 0, 1] = np.nan                               # NaN entries
    SY[9::17, 1, 1] = 1e-12                                # skipped pairs
    return SY, YY, Sg, Yg, syh, yyh, n_pairs, gn


def phase_chain(dev):
    from tpu_lbfgs_torch.kernels import chain

    rec = {}
    for m, B, dt in itertools.product(CHAIN_M, (BATCH, RAGGED_BATCH),
                                      (torch.float32, torch.float64)):
        arrays = _chain_inputs(np.random.default_rng(SEED), B, m)
        args = [torch.from_numpy(a).to(dev, dt) for a in arrays[:6]]
        args += [torch.from_numpy(arrays[6]).to(dev, torch.int32),
                 torch.from_numpy(arrays[7]).to(dev, dt)]
        for thr in (None, 1e-10):
            k = chain.compact_chain_batched(*args, m=m, skip_thr=thr)
            p = chain.chain_batched_plain(*args, m=m, skip_thr=thr)
            torch.cuda.synchronize()
            where = f"m={m} B={B} {dt} skip={thr}"
            check(torch.equal(k[4], p[4]),
                  f"compact_chain fallback flags differ ({where})")
            err, same_nan = 0.0, True
            for a, b in zip(k[:4], p[:4]):
                check(a.dtype == dt, f"compact_chain returned {a.dtype}")
                same_nan &= torch.equal(a.isnan(), b.isnan())
                ok = ~b.isnan()
                err = max(err, (a[ok] - b[ok]).abs().max().item())
            n_fb = int(k[4].sum())
            say(f"[kernel] compact_chain {where}: fallback equal ({n_fb} "
                f"lanes), NaN equal {same_nan}, max abs err {err:.3e} (tol "
                f"{CHAIN_ABS_TOL})")
            check(same_nan and err <= CHAIN_ABS_TOL and 0 < n_fb < B,
                  f"compact_chain disagrees with its plain version ({where})")
            rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
        if m in CHAIN_TIMED_M and B == BATCH:
            ms = device_ms(lambda: chain.compact_chain_batched(
                *args, m=m, skip_thr=1e-10))
            plain_ms = device_ms(lambda: chain.chain_batched_plain(
                *args, m=m, skip_thr=1e-10))
            # Per instance: SY, YY, four (m,) vectors and g_norm in the
            # working dtype, n_pairs as int32; v, u, gamma, g.d out and the
            # flag; two triangular solves, the YY product and the dots,
            # about 6 m^2 + 10 m operations.
            size = torch.finfo(dt).bits // 8
            bound = bound_ms(B * (size * (2 * m * m + 6 * m + 3) + 4 + 1),
                             B * (6 * m * m + 10 * m))
            say(f"[kernel] compact_chain m={m} B={B} {dt}: {ms * 1e3:.2f} us "
                f"on the card, plain version {plain_ms * 1e3:.2f} us, bound "
                f"{bound[0] * 1e3:.2f} us by {bound[1]}")
            if dt == torch.float32 and m == 10:    # the batch solve's
                rec["ms"], rec["plain_ms"], rec["bound"] = ms, plain_ms, bound
    return rec


def _trial_abs_terms(problem, x, d, alphas):
    """Per trial, sum |f terms| and sum |g_i d_i| in float64 at the float32
    trial points: the scale of each sum's rounding error."""
    from tpu_lbfgs_torch.kernels.fused_ops import VG_PLAIN

    f_abs, g_abs = [], []
    for a in alphas.unbind(0):
        u = (x + a * d).double()
        f_abs.append(_f_abs_terms(problem, u))
        g_abs.append((VG_PLAIN[problem](u)[1] * d.double()).abs().sum())
    return torch.stack(f_abs), torch.stack(g_abs)


def _beyond_ulp(a, b, scale):
    """Largest |a - b| beyond one ulp of b in its dtype, in units of scale
    (NaN where either side is NaN)."""
    b_abs = b.abs()
    ulp = torch.nextafter(b_abs, torch.full_like(b_abs, float("inf"))) - b_abs
    over = ((a.double() - b.double()).abs() - ulp.double()).clamp(min=0.0)
    return (over / scale).max().item()


def phase_trial_kernels(dev):
    """multi_phi and multi_phi_dphi of every body against their plain
    versions, each called twice (bit-equal sums)."""
    from tpu_lbfgs_torch.bench import trial_bounds
    from tpu_lbfgs_torch.kernels import fused_ops
    from tpu_lbfgs_torch.kernels import line_search_ops as ops

    rec = {}
    rng = np.random.default_rng(SEED)
    for problem, n, k in itertools.product(fused_ops.BODY_IDS, TRIAL_D,
                                           TRIALS):
        names = (f"{problem}_multi_phi", f"{problem}_multi_phi_dphi")
        for name in names:
            rec.setdefault(name, {"max_abs_err": 0.0})
        f_plain = fused_ops.F_PLAIN[problem]
        vg_plain = fused_ops.VG_PLAIN[problem]
        phi_kernel = ops.make_multi_phi(problem, None)
        dphi_kernel = ops.make_multi_phi_dphi(problem, None)
        x, d, _ = _kernel_inputs(n, dev)
        alphas = torch.from_numpy(2.0 ** rng.integers(-6, 3, k)
                                  * rng.uniform(0.5, 1.0, k)).to(
            device=dev, dtype=torch.float32)
        phi_k = phi_kernel(x, d, alphas)
        phi_p = ops.multi_phi_plain(f_plain, x, d, alphas)
        f_k, g_k = dphi_kernel(x, d, alphas)
        f_p, g_p = ops.multi_phi_dphi_plain(vg_plain, x, d, alphas)
        again = (phi_kernel(x, d, alphas), *dphi_kernel(x, d, alphas))
        torch.cuda.synchronize()
        check(all(map(torch.equal, (phi_k, f_k, g_k), again)),
              f"two calls of {problem}'s K-trial kernels differ at d={n} "
              f"K={k}")
        f_abs, g_abs = _trial_abs_terms(problem, x, d, alphas)
        for name, pairs in ((names[0], ((phi_k, phi_p, f_abs),)),
                            (names[1], ((f_k, f_p, f_abs),
                                        (g_k, g_p, g_abs)))):
            check(all(a.shape == (k,) and a.dtype == torch.float32
                      for a, _, _ in pairs),
                  f"{name} must return ({k},) float32 sums")
            errs = [((a.double() - b.double()).abs() / s).max().item()
                    for a, b, s in pairs]
            overs = [_beyond_ulp(a, b, s) for a, b, s in pairs]
            abs_err = max((a - b).abs().max().item() for a, b, _ in pairs)
            say(f"[kernel] {name} d={n} K={k}: max abs err {abs_err:.3e}, "
                f"max err {max(errs):.3e} of sum|terms|, {max(overs):.3e} "
                f"beyond 1 ulp (tol {TRIAL_SUM_RTOL} of sum|terms| + 1 ulp)")
            check(all(v <= TRIAL_SUM_RTOL for v in overs),
                  f"{name} disagrees with its plain version at d={n} K={k}")
            if n == D:
                rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"],
                                               abs_err)
        if n != D:
            continue
        times = {
            names[0]: (lambda: phi_kernel(x, d, alphas),
                       lambda: ops.multi_phi_plain(f_plain, x, d, alphas)),
            names[1]: (lambda: dphi_kernel(x, d, alphas),
                       lambda: ops.multi_phi_dphi_plain(vg_plain, x, d,
                                                        alphas)),
        }
        for name, (kernel, plain) in times.items():
            # The record keeps the K the direct path gives each kernel most:
            # 8 for multi_phi, the 36-node tree for multi_phi_dphi; the
            # other K is timed for the Rosenbrock body only.
            kept = k == (8 if name == names[0] else 36)
            if not kept and problem != "rosenbrock":
                continue
            ms, plain_ms = device_ms(kernel), device_ms(plain)
            # x, d and K alphas in, K (or 2 K) sums out; per element and
            # trial two trial points (one for the quadratic), the body's
            # term and its float64 add, with phi' the gradient and g_i d_i
            # as well.
            outs = 1 if name == names[0] else 2
            bounds = trial_bounds.trial_bound(
                name[len(problem) + 1:], problem, n, k,
                8 * n + 4 * k + 4 * outs * k)
            bound = bounds["old"]
            say(f"[kernel] {name} d={n} K={k}: {ms * 1e3:.2f} us on the "
                f"card, plain version {plain_ms * 1e3:.2f} us, bound "
                f"{bound[0] * 1e3:.2f} us by {bound[1]}; "
                f"{trial_bound_note(bounds, ms)}")
            if kept:
                rec[name].update(ms=ms, plain_ms=plain_ms, bound=bound)
    return rec


def phase_general_kernels(dev):
    """iteration_tail and combine_direction against their plain versions."""
    from tpu_lbfgs_torch.kernels import fused_ops as ops

    rec = {"iteration_tail": {"max_abs_err": 0.0},
           "combine_direction": {"max_abs_err": 0.0}}
    rng = np.random.default_rng(SEED)
    for n, dt in itertools.product(TAIL_D, (torch.float32, torch.float64)):
        x, d, g, gn = (torch.from_numpy(rng.uniform(-1.0, 1.0, n)).to(dev, dt)
                       for _ in range(4))
        x = 2.0 * x
        alpha = torch.full((), 0.125, dtype=dt, device=dev)
        for accurate in (False, True):
            out_k = ops.iteration_tail(x, d, alpha, g, gn, accurate=accurate)
            out_p = ops.iteration_tail_plain(x, d, alpha, g, gn, accurate)
            torch.cuda.synchronize()
            where = f"d={n} {dt} accurate={accurate}"
            same = all(torch.equal(a, b) and a.dtype == dt
                       for a, b in zip(out_k[:3], out_p[:3]))
            s, y = out_p[1].double(), out_p[2].double()
            dd, gg, gnn = d.double(), g.double(), gn.double()
            scales = [(s * y).abs().sum(), (y * y).sum(), (gnn * gnn).sum(),
                      (dd * gnn).abs().sum(), (gg * gnn).abs().sum()]
            check(all(a.dtype == dt and a.dim() == 0 for a in out_k[3:]),
                  f"iteration_tail must return 0-d {dt} sums")
            errs = [((a.double() - b.double()).abs() / sc).item()
                    for a, b, sc in zip(out_k[3:], out_p[3:], scales)]
            overs = [_beyond_ulp(a, b, sc)
                     for a, b, sc in zip(out_k[3:], out_p[3:], scales)]
            abs_err = max((a - b).abs().max().item()
                          for a, b in zip(out_k, out_p))
            say(f"[kernel] iteration_tail {where}: x_new, s, y bit-equal "
                f"{same}; 5 sums max abs err {abs_err:.3e}, max err "
                f"{max(errs):.3e} of sum|terms|, {max(overs):.3e} beyond 1 "
                f"ulp (tol {TRIAL_SUM_RTOL} of sum|terms| + 1 ulp)")
            check(same and all(v <= TRIAL_SUM_RTOL for v in overs),
                  f"iteration_tail disagrees with its plain version ({where})")
            if n == D and dt == torch.float32:
                r = rec["iteration_tail"]
                r["max_abs_err"] = max(r["max_abs_err"], abs_err)
            if n == D:
                ms = device_ms(lambda: ops.iteration_tail(
                    x, d, alpha, g, gn, accurate=accurate))
                plain_ms = device_ms(lambda: ops.iteration_tail_plain(
                    x, d, alpha, g, gn, accurate))
                # x, d, g, g_new and alpha in; x_new, s, y and 5 sums out;
                # 13 operations per element.
                size = x.element_size()
                bound = bound_ms(size * (7 * n + 6), 13 * n)
                say(f"[kernel] iteration_tail {where}: {ms * 1e3:.2f} us on "
                    f"the card, plain version {plain_ms * 1e3:.2f} us, bound "
                    f"{bound[0] * 1e3:.2f} us by {bound[1]}")
                if dt == torch.float32 and not accurate:
                    rec["iteration_tail"].update(ms=ms, plain_ms=plain_ms,
                                                 bound=bound)

    for n, m, dt in itertools.product(COMBINE_D, TAIL_M,
                                      (torch.float32, torch.float64)):
        if dt == torch.float64 and m != 10:
            continue
        g = torch.from_numpy(rng.uniform(-1.0, 1.0, n)).to(dev, dt)
        S, Y = (torch.from_numpy(rng.uniform(-1.0, 1.0, (m, n))).to(dev, dt)
                for _ in range(2))
        v, u = (torch.from_numpy(rng.uniform(-1.0, 1.0, m)).to(dev, dt)
                for _ in range(2))
        gamma = torch.full((), 0.8, dtype=dt, device=dev)
        r_k = ops.combine_direction(g, S, Y, v, u, gamma)
        r_p = ops.combine_direction_plain(g, S, Y, v, u, gamma)
        r_l = ops.combine_direction_matmul(g, S, Y, v, u, gamma)
        torch.cuda.synchronize()
        where = f"d={n} m={m} {dt}"
        abs_err = (r_k - r_p).abs().max().item()
        lib_err = (r_k - r_l).abs().max().item()
        say(f"[kernel] combine_direction {where}: max abs err {abs_err:.3e} "
            f"against plain (tol {COMBINE_ABS_TOL}: the same operations in "
            f"the same order), {lib_err:.3e} against the torch.mv route "
            f"(another order; max |r| {r_p.abs().max().item():.3e})")
        check(r_k.dtype == dt and r_k.shape == (n,)
              and abs_err <= COMBINE_ABS_TOL,
              f"combine_direction disagrees with its plain version ({where})")
        check(lib_err <= 1e-4 * r_p.abs().max().item(),
              f"combine_direction is far from the torch.mv route ({where})")
        if dt == torch.float32:
            r = rec["combine_direction"]
            r["max_abs_err"] = max(r["max_abs_err"], abs_err)
        if n == D:
            ms = device_ms(lambda: ops.combine_direction(g, S, Y, v, u,
                                                         gamma))
            plain_ms = device_ms(lambda: ops.combine_direction_plain(
                g, S, Y, v, u, gamma))
            library_ms = device_ms(lambda: ops.combine_direction_matmul(
                g, S, Y, v, u, gamma))
            # g, S, Y, v, u and gamma in, r out; 4 m + 1 operations per
            # element.
            size = g.element_size()
            bound = bound_ms(size * ((2 * m + 2) * n + 2 * m + 1),
                             (4 * m + 1) * n)
            say(f"[kernel] combine_direction {where}: {ms * 1e3:.2f} us on "
                f"the card, plain version {plain_ms * 1e3:.2f} us, the "
                f"torch.mv route {library_ms * 1e3:.2f} us, bound "
                f"{bound[0] * 1e3:.2f} us by {bound[1]}")
            if dt == torch.float32 and m == 10:
                rec["combine_direction"].update(
                    ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                    bound=bound)

    # The same over a bfloat16 ring under float32 (each ring value widened
    # as it is read, the coefficients float32): bit for bit against the
    # plain version.  The matrix-vector route casts the coefficients down
    # to bfloat16 first, as the reference's does, so it is another function
    # of v and u: held to 2^-8 of sum |coefficient| max |ring|.
    form = "combine_direction[ring bf16]"
    rec[form] = {"max_abs_err": 0.0}
    for n, m in itertools.product(TAIL_D, TAIL_M):
        g = torch.from_numpy(rng.uniform(-1.0, 1.0, n)).to(dev, torch.float32)
        S, Y = (torch.from_numpy(rng.uniform(-1.0, 1.0, (m, n))).to(
            dev, torch.bfloat16) for _ in range(2))
        v, u = (torch.from_numpy(rng.uniform(-1.0, 1.0, m)).to(
            dev, torch.float32) for _ in range(2))
        gamma = torch.full((), 0.8, dtype=torch.float32, device=dev)
        r_k = ops.combine_direction(g, S, Y, v, u, gamma)
        r_p = ops.combine_direction_plain(g, S, Y, v, u, gamma)
        r_l = ops.combine_direction_matmul(g, S, Y, v, u, gamma)
        torch.cuda.synchronize()
        abs_err = (r_k - r_p).abs().max().item()
        lib_err = (r_k - r_l).abs().max().item()
        lib_tol = 2.0 ** -8 * (v.abs().sum() + u.abs().sum()).item()
        say(f"[kernel] combine_direction d={n} m={m} bfloat16 ring: max abs "
            f"err {abs_err:.3e} against plain (tol {COMBINE_ABS_TOL}), "
            f"{lib_err:.3e} against the matrix-vector route with bfloat16 "
            f"coefficients (tol {lib_tol:.3e})")
        check(r_k.dtype == torch.float32 and r_k.shape == (n,)
              and abs_err <= COMBINE_ABS_TOL and lib_err <= lib_tol,
              f"combine_direction on a bfloat16 ring disagrees (d={n} m={m})")
        rec[form]["max_abs_err"] = max(rec[form]["max_abs_err"], abs_err)
        if n == D and m == 10:
            ms = device_ms(lambda: ops.combine_direction(g, S, Y, v, u,
                                                         gamma))
            plain_ms = device_ms(lambda: ops.combine_direction_plain(
                g, S, Y, v, u, gamma))
            route_ms = device_ms(lambda: ops.combine_direction_matmul(
                g, S, Y, v, u, gamma))
            # g and the bfloat16 ring in, r out; 4 m + 1 operations.
            bound = bound_ms(4 * (2 * n + 2 * m + 1) + 2 * 2 * m * n,
                             (4 * m + 1) * n)
            say(f"[kernel] combine_direction d={n} m={m} bfloat16 ring: "
                f"{ms * 1e3:.2f} us on the card, plain version "
                f"{plain_ms * 1e3:.2f} us, the solver's matrix-vector route "
                f"(widens the ring) {route_ms * 1e3:.2f} us, bound "
                f"{bound[0] * 1e3:.2f} us by {bound[1]}")
            rec[form].update(ms=ms, plain_ms=plain_ms, bound=bound)
    return rec


def _bench_cfg(tt, iters):
    return tt.LBFGSConfig(line_search="backtracking",
                          direction="compact_incremental", m=10,
                          use_pallas=True, ls_eval="polynomial",
                          max_iters=iters, tol=0.0)


def phase_main_path(dev):
    import tpu_lbfgs_torch as tt
    from tpu_lbfgs_torch import kernels
    from tpu_lbfgs_torch.bench.harness import _x0

    p = tt.get_problem("rosenbrock")
    x0 = _x0(D, SEED, torch.float32, dev)
    f0 = p.f(x0).item()
    vg = tt.fused_value_and_grad("rosenbrock")
    tail = tt.fused_tail_for("rosenbrock")
    cfg = _bench_cfg(tt, MAIN_ITERS)
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    r = tt.minimize(p.f, x0, cfg, value_and_grad=vg, dir_poly=p.dir_poly,
                    fused_tail=tail)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()

    f, k = r.f.item(), r.iterations.item()
    say(f"[main] minimize d={D} float32, {k} iterations in {wall:.3f} s: "
        f"f {f0:.6e} -> {f:.6e}, |g| {r.g_norm.item():.4e}, status "
        f"{tt.Status.NAMES[r.status.item()]}, guards {r.guards.tolist()}, "
        f"launches {ran(launches)} (replayed "
        f"{ran(kernels.replay_counts())}); {blocks_note()}")
    check(r.status.item() == tt.Status.MAX_ITERS and k == MAIN_ITERS,
          "the solve must run its 200 iterations to max_iters")
    check(r.x.shape == (D,) and bool(torch.isfinite(r.x).all())
          and np.isfinite(f) and f < f0, "f must be finite and decrease")
    check(one_per_iteration("rosenbrock_fused_tail", k)
          and kernels.replay_counts()["rosenbrock_fused_tail"] == k,
          "the fused tail kernel must launch once per iteration, each "
          "replayed from a graph")
    check(launches["rosenbrock_vg"] >= 1, "the vg kernel must launch")

    # The first iterations with the kernels and with the plain versions,
    # both on the card, from the same state.
    traces = {}
    for label, use_kernels in (("kernels", True), ("plain", False)):
        vg_ = tt.fused_value_and_grad("rosenbrock", use_pallas=use_kernels)
        tail_ = tt.fused_tail_for("rosenbrock", use_pallas=use_kernels)
        s = tt.init_state(vg_, x0, cfg.m)
        alphas, fs = [], []
        for _ in range(TRACE_ITERS):
            s = tt.iterate(cfg, p.f, vg_, s, p.dir_poly, tail_)
            alphas.append(s.alpha.item())
            fs.append(s.f.item())
        traces[label] = (alphas, fs, s)
    (a_k, f_k, state), (a_p, f_p, _) = traces["kernels"], traces["plain"]
    f_rel = max(abs(a - b) / abs(b) for a, b in zip(f_k, f_p))
    say(f"[main] first {TRACE_ITERS} iterations, kernels vs plain on the "
        f"card: alpha equal {a_k == a_p}, f max rel err {f_rel:.3e} "
        f"(tol {TRACE_F_RTOL}); alphas {a_k}")
    check(a_k == a_p, "alpha differs between kernels and plain versions")
    check(f_rel <= TRACE_F_RTOL, "f differs between kernels and plain")
    check(f_k[-1] < f0, "f must decrease over the first iterations")
    return launches, state, cfg


def phase_no_sync(state, cfg):
    import tpu_lbfgs_torch as tt

    p = tt.get_problem("rosenbrock")
    vg = tt.fused_value_and_grad("rosenbrock")
    tail = tt.fused_tail_for("rosenbrock")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = tt.iterate(cfg, p.f, vg, state, p.dir_poly, tail)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(bool(torch.isfinite(state.f)), "f must stay finite")
    say("[sync] one iterate under torch.cuda.set_sync_debug_mode('error'): "
        "no host synchronisation")


def phase_bench(card):
    import tpu_lbfgs_torch as tt
    from tpu_lbfgs_torch import kernels
    from tpu_lbfgs_torch.bench.harness import bench_gpu

    from tpu_lbfgs_torch.core import blocks

    reset_counts()
    r = bench_gpu(problem="rosenbrock", d=D, iters=BENCH_ITERS,
                  cfg=_bench_cfg(tt, BENCH_ITERS), repeats=3)
    check(np.isfinite(r.final_f) and r.iterations == BENCH_ITERS,
          "bench_gpu must finish its iterations with a finite f")
    # One warm-up run, which captures the graphs (after one warm-up
    # iteration), and three timed runs that replay them.
    got = kernels.launch_counts()
    check(per_step("rosenbrock_fused_tail")
          and blocks.stats["steps"] == 4 * BENCH_ITERS
          and blocks.stats["warmups"] == 1 and got["rosenbrock_vg"] == 4,
          f"bench_gpu must run the fused kernels, once per iteration from "
          f"the graphs, launches {ran(got)}; {blocks_note()}")
    d = r.details
    say(f"[bench] {r.name}: {r.iters_per_s:.2f} iterations/s "
        f"({BENCH_ITERS} iterations, best of 3 runs {r.wall_s:.4f} s, "
        f"runs {[round(w, 4) for w in d['repeat_walls_s']]}; graphs "
        f"captured in the warm-up run in {d['capture_s']:.3f} s, "
        f"{d['host_reads_per_solve']:.0f} host reads per timed solve) on "
        f"{card}")
    return r.iters_per_s


def _batch_cfg(tt, iters):
    # tpu_lbfgs/bench/harness.py::bench_batch's configuration.
    return tt.LBFGSConfig(line_search="backtracking",
                          direction="compact_incremental", m=10,
                          ls_eval="polynomial", fidelity="fixed",
                          pair_skip_threshold=1e-10, max_iters=iters,
                          tol=0.0)


def _batch_x0(dev):
    # bench_batch's draw: U(-2, 2) of shape (B, d) from seed 42.
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.uniform(-2.0, 2.0, (BATCH, BATCH_D))).to(
        device=dev, dtype=torch.float32)


def phase_batch(dev):
    import tpu_lbfgs_torch as tt
    from tpu_lbfgs_torch import kernels
    from tpu_lbfgs_torch.core import direction
    from tpu_lbfgs_torch.kernels import chain

    p = tt.get_problem("rosenbrock")
    x0 = _batch_x0(dev)
    f0 = p.f(x0)
    cfg = _batch_cfg(tt, BATCH_ITERS)
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    r = tt.vmap_minimize(p.f, x0, cfg, grad=p.grad, dir_poly=p.dir_poly,
                         lockstep="bounded")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    note = blocks_note()

    counts = torch.bincount(r.status.long(), minlength=4).tolist()
    status = {tt.Status.NAMES[i]: n for i, n in enumerate(counts) if n}
    ok = r.status != tt.Status.LINE_SEARCH_FAILED
    mean0, mean1 = f0.mean().item(), r.f.mean().item()
    say(f"[batch] vmap_minimize B={BATCH} d={BATCH_D} float32 bounded, "
        f"{BATCH_ITERS} iterations in {wall:.3f} s: mean f {mean0:.6e} -> "
        f"{mean1:.6e}, max |g| {r.g_norm.max().item():.4e}, status {status}, "
        f"guards {r.guards.sum(0).tolist()}, launches {ran(launches)}; "
        f"{note}")
    check(bool((r.iterations == BATCH_ITERS).all()),
          "every lane must run its 200 iterations")
    check(one_per_iteration("compact_chain", BATCH_ITERS),
          "the chain kernel must launch once per iteration")
    check(r.x.shape == (BATCH, BATCH_D) and r.f.shape == (BATCH,)
          and bool(torch.isfinite(r.f[ok]).all())
          and bool(torch.isfinite(r.x[ok]).all()) and mean1 < mean0,
          "mean f must fall and f stay finite on every lane that ran")

    # The first iterations with the chain kernel and with the plain chain,
    # both on the card, from the same state.
    vg = tt.make_value_and_grad(p.f, p.grad)
    traces = {}
    for label in ("kernel", "plain"):
        s = tt.init_state(vg, x0, cfg.m)
        alphas, fs = [], []
        if label == "plain":
            direction.compact_chain_batched = chain.chain_batched_plain
        try:
            for _ in range(TRACE_ITERS):
                s = tt.iterate(cfg, p.f, vg, s, p.dir_poly)
                alphas.append(s.alpha)
                fs.append(s.f)
        finally:
            direction.compact_chain_batched = chain.compact_chain_batched
        traces[label] = (torch.stack(alphas), torch.stack(fs), s)
    (a_k, f_k, state), (a_p, f_p, _) = traces["kernel"], traces["plain"]
    f_rel = ((f_k - f_p).abs() / f_p.abs()).max().item()
    same_alpha = torch.equal(a_k, a_p)
    say(f"[batch] first {TRACE_ITERS} iterations, chain kernel vs plain on "
        f"the card: alpha equal on every lane {same_alpha}, f max rel err "
        f"{f_rel:.3e} (tol {BATCH_TRACE_F_RTOL})")
    check(same_alpha, "alpha differs between the chain kernel and plain")
    check(f_rel <= BATCH_TRACE_F_RTOL, "f differs between kernel and plain")
    phase_batch_any_m(dev, p, x0)
    return launches, state, cfg


def phase_batch_any_m(dev, p, x0):
    """A short f32 batch solve at m = CHAIN_SOLVE_M through the chain
    kernel, against the same solve through chain_batched_plain: x, f and
    g_norm equal bit for bit, one chain launch per iteration."""
    import tpu_lbfgs_torch as tt
    from tpu_lbfgs_torch import kernels
    from tpu_lbfgs_torch.core import direction
    from tpu_lbfgs_torch.kernels import chain

    cfg = _batch_cfg(tt, CHAIN_SOLVE_ITERS).replace(m=CHAIN_SOLVE_M)
    runs = {}
    for label in ("kernel", "plain"):
        if label == "plain":
            direction.compact_chain_batched = chain.chain_batched_plain
        reset_counts()
        try:
            r = tt.vmap_minimize(p.f, x0, cfg, grad=p.grad,
                                 dir_poly=p.dir_poly, lockstep="bounded")
            torch.cuda.synchronize()
        finally:
            direction.compact_chain_batched = chain.compact_chain_batched
        runs[label] = (r, kernels.launch_counts()["compact_chain"],
                       one_per_iteration("compact_chain", CHAIN_SOLVE_ITERS))
    (rk, nk, each), (rp, np_, _) = runs["kernel"], runs["plain"]
    same = all(torch.equal(a.isnan(), b.isnan())
               and torch.equal(a.nan_to_num(), b.nan_to_num())
               for a, b in ((rk.x, rp.x), (rk.f, rp.f),
                            (rk.g_norm, rp.g_norm)))
    ok = rk.status != tt.Status.LINE_SEARCH_FAILED
    say(f"[batch] m={CHAIN_SOLVE_M} B={BATCH} d={BATCH_D} float32, "
        f"{CHAIN_SOLVE_ITERS} iterations: chain launches {nk} (plain run "
        f"{np_}), x, f, g_norm bit-equal to the plain chain's solve {same}, "
        f"mean f {rk.f.mean().item():.6e}")
    check(each and np_ == 0,
          f"the m={CHAIN_SOLVE_M} batch solve must launch the chain kernel "
          "once per iteration")
    check(same and bool(torch.isfinite(rk.f[ok]).all()),
          f"the m={CHAIN_SOLVE_M} batch solve differs from the plain chain's")


def phase_batch_no_sync(state, cfg):
    import tpu_lbfgs_torch as tt

    p = tt.get_problem("rosenbrock")
    vg = tt.make_value_and_grad(p.f, p.grad)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = tt.iterate(cfg, p.f, vg, state, p.dir_poly)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(state.f.shape == (BATCH,), "a batched state must stay batched")
    say("[sync] one batched iterate (B=4096) under "
        "torch.cuda.set_sync_debug_mode('error'): no host synchronisation")


# [graph]: the solve loops as blocks of iterations replayed as CUDA graphs
# (tpu_lbfgs_torch.core.blocks) against the same blocks run eagerly
# (blocks.eager_loops, the counterpart of jax.disable_jit).  bench.py's
# solve (solve_from_state) at D for BENCH_ITERS iterations and the batch
# cell (solve_bounded) for BATCH_ITERS: the replayed run equal to the eager
# one bit for bit (x, f, g_norm, k, status, guards, n_fev, n_gev), and both
# timed in turns (eager, graphs, graphs, eager; each mode keeps its runner
# in a blocks.Kept, the graphs captured in a warm-up run before, as the
# harnesses capture in theirs); a solve of each while form (minimize,
# make_solve_segment, vmap_minimize lockstep "while") that tol ends inside a
# block, bit for bit; blocks replayed under set_sync_debug_mode("error");
# the graphs' capture seconds and private pool at D and GRAPH_POOL_D; the
# block length timed at GRAPH_BLOCKS; short solves (GRAPH_SHORT) as a
# caller's minimize runs them, each capturing afresh, against eager blocks
# and against capture forced below blocks.CAPTURE_MIN_ITERS; and an
# objective that reads the host, whose capture must fail naming it.
# Device kernels per iteration, replayed against eager, come from
# torch.profiler after every timed phase (phase_graph_kernels).
GRAPH_FIELDS = ("x", "f", "g_norm", "iterations", "status", "guards",
                "n_fev", "n_gev")
GRAPH_BLOCKS = (5, 20, 50)
GRAPH_POOL_D = 1 << 26
GRAPH_TOL_ITERS = 200
GRAPH_SYNC_BLOCKS = 5
GRAPH_SHORT = ((1 << 12, (20, 40, 100)), (D, (20, 40, 100)))
GRAPH_FREED_BYTES = 1 << 31


def _graph_same(a, b):
    """The result fields on which a and b differ, bit for bit (a NaN equal
    to a NaN in its place)."""
    def same(u, v):
        if u.dtype != v.dtype:
            return False
        if not u.is_floating_point():
            return torch.equal(u, v)
        return (torch.equal(u.isnan(), v.isnan())
                and torch.equal(u.nan_to_num(), v.nan_to_num()))

    return [n for n in GRAPH_FIELDS if not same(getattr(a, n),
                                                getattr(b, n))]


def _graph_mode(blocks, mode):
    import contextlib

    return blocks.eager_loops() if mode == "eager" \
        else contextlib.nullcontext()


def _graph_turns(label, blocks, run, iters, lanes=1):
    """run(kept) eager and replayed: the first of each bit for bit, then
    timed in turns, each mode keeping its runner in its own blocks.Kept,
    so that its first run (the graphs' capture) is a warm-up.  Returns the
    iterations/s of each mode (instance-iterations/s for a batch), the
    capture seconds and the replayed result."""
    out, walls = {}, {"eager": [], "graphs": []}
    kept = {mode: blocks.Kept() for mode in walls}
    capture = dict(blocks.stats)
    for mode in ("eager", "graphs"):
        with _graph_mode(blocks, mode):
            out[mode] = run(kept[mode])
    torch.cuda.synchronize()
    capture_s = blocks.stats["capture_s"] - capture["capture_s"]
    differ = _graph_same(out["eager"], out["graphs"])
    for mode in ("eager", "graphs", "graphs", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _graph_mode(blocks, mode):
            run(kept[mode])
        torch.cuda.synchronize()
        walls[mode].append(time.perf_counter() - t0)
    rate = {mode: [lanes * iters / w for w in ws]
            for mode, ws in walls.items()}
    say(f"[graph] {label}: replayed against eager, fields that differ "
        f"{differ}; in turns (eager, graphs, graphs, eager) "
        + ("instance-iterations/s" if lanes > 1 else "iterations/s")
        + f" eager {[round(v, 2) for v in rate['eager']]}, graphs "
        f"{[round(v, 2) for v in rate['graphs']]} (ms/iteration eager "
        f"{[round(w / iters * 1e3, 4) for w in walls['eager']]}, graphs "
        f"{[round(w / iters * 1e3, 4) for w in walls['graphs']]}); "
        f"captured in the warm-up run in {capture_s:.3f} s")
    check(not differ, f"[graph] {label}: the replayed solve differs from "
          f"the eager one in {differ}")
    return rate, capture_s, out["graphs"]


def _graph_pool(label, blocks, tt, cfg, p, vg, tail, x0, card):
    """The private pool of a block's graph: the card's reserved memory
    after the capture against before it (empty caches on both sides), and
    the capture's seconds."""
    from tpu_lbfgs_torch.core.solver import _stepper

    state = tt.init_state(vg, x0, cfg.m)
    drv = blocks.BlockRunner(cfg, _stepper(cfg, p.f, vg, p.dir_poly, tail),
                             state, masked=True)
    drv.start(None)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before_b, before_s = torch.cuda.memory_reserved(), blocks.stats[
        "capture_s"]
    drv.run(blocks.BLOCK_ITERS)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pool = torch.cuda.memory_reserved() - before_b
    capture_s = blocks.stats["capture_s"] - before_s
    ring = 2 * state.s_hist.numel() * state.s_hist.element_size()
    say(f"[graph] {label}: one block of {blocks.BLOCK_ITERS} iterations "
        f"captured in {capture_s:.3f} s (a warm-up iteration included), "
        f"its private pool {pool / 1e6:.1f} MB beside a ring of "
        f"{ring / 1e6:.1f} MB, on {card}")
    check(bool(torch.isfinite(drv.s.f)), f"[graph] {label}: f must stay "
          "finite")
    return pool


def _driver_version():
    """The CUDA driver API's version, as cuDriverGetVersion gives it."""
    import ctypes

    version = ctypes.c_int()
    err = ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(
        ctypes.byref(version))
    check(err == 0, f"cuDriverGetVersion failed: {err}")
    return f"{version.value // 1000}.{version.value % 1000 // 10}"


def phase_graph_if(dev):
    """[graph-if]: what the gated line-search driver stands on
    (linesearch.strategies, kernels.graph_if): a CUDA graph WHILE node.
    The versions of torch, the CUDA runtime and the driver; whether
    torch's own capture methods for conditional nodes exist (the port does
    not use them: some torch releases lack them); then a graph whose WHILE
    node, added through csrc/graph_if.cu, adds 1 to a counter on the
    device while the counter is under N, its condition kernel a node of
    the body graph's own after the captured turn, replayed with N = 5 and
    then N = 0: the total and the turns the condition kernels counted,
    exact."""
    from tpu_lbfgs_torch.kernels import graph_if

    methods = {name: hasattr(torch.cuda.CUDAGraph, name)
               for name in ("begin_capture_to_if_node",
                            "begin_capture_to_while_loop_node",
                            "end_capture_to_conditional_node")}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    say(f"[graph-if] torch {torch.__version__}, CUDA runtime "
        f"{torch.version.cuda}, driver API {_driver_version()} (driver "
        f"{smi.stdout.strip().splitlines()[0]}); torch's conditional-node "
        f"capture methods {methods}; the port adds its WHILE nodes through "
        "csrc/graph_if.cu")
    total = torch.zeros((), device=dev)
    limit = torch.zeros((), device=dev)
    pred = torch.zeros((), dtype=torch.bool, device=dev)
    turns = torch.zeros(1, dtype=torch.int64, device=dev)
    graph, pool = torch.cuda.CUDAGraph(), torch.cuda.graph_pool_handle()
    gate = graph_if.GraphGate(turns)

    def turn():
        total.add_(1.0)
        torch.lt(total, limit, out=pred)

    with torch.cuda.graph(graph, pool=pool):
        graph_if.route_to_pool(dev.index, pool)
        torch.lt(total, limit, out=pred)
        gate.loop(pred, turn)
        nodes = graph_if.capture_nodes(torch.cuda.current_stream())
    gate.close()
    got, want = [], []
    for n in (5, 0):
        total.zero_()
        turns.zero_()
        limit.fill_(float(n))
        graph.replay()
        got.append((total.item(), turns.item()))
        want.append((float(n), n))
    say(f"[graph-if] a WHILE node whose turn adds 1 while the total is "
        f"under N, replayed with N = 5 then N = 0: (total, turns counted) "
        f"{got} (want {want}); {gate.nodes} WHILE node in a graph of "
        f"{nodes} nodes, its body {gate.body_nodes} nodes (the turn's and "
        "the condition kernel)")
    check(got == want, "the WHILE node ran other than N turns")
    check(gate.nodes == 1 and gate.body_nodes >= 2,
          "the WHILE node's body must hold the turn and its condition "
          "kernel")


def phase_graph(dev, card):
    """[graph]: the block runner's graphs against its eager blocks, at the
    main path's and the batch cell's widths."""
    import tpu_lbfgs_torch as tt
    from tpu_lbfgs_torch.bench.harness import _x0
    from tpu_lbfgs_torch.core import blocks
    from tpu_lbfgs_torch.core.solver import _stepper

    rose = tt.get_problem("rosenbrock")
    vg = tt.fused_value_and_grad("rosenbrock")
    tail = tt.fused_tail_for("rosenbrock")
    x0 = _x0(D, SEED, torch.float32, dev)
    cfg = _bench_cfg(tt, BENCH_ITERS)

    def single(kept=None):
        # minimize's solve, with a runner kept across the calls.
        state = tt.init_state(vg, x0, cfg.m)
        return tt.finalize_result(cfg, tt.solve_from_state(
            cfg, rose.f, vg, state, rose.dir_poly, tail, kept=kept))

    bx = _batch_x0(dev)
    bcfg = _batch_cfg(tt, BATCH_ITERS)
    bvg = tt.make_value_and_grad(rose.f, rose.grad)

    def batch(kept=None):
        # vmap_minimize's bounded solve, with a runner kept across the calls.
        state = tt.init_state(bvg, bx, bcfg.m)
        return tt.finalize_result(bcfg, tt.solve_bounded(
            bcfg, rose.f, bvg, state, rose.dir_poly, kept=kept))

    # Bit for bit and in turns, at the block length the solver takes.
    reset_counts()
    _graph_turns(f"bench.py's solve d={D} float32, {BENCH_ITERS} "
                 "iterations", blocks, single, BENCH_ITERS)
    _graph_turns(f"the batch cell B={BATCH} d={BATCH_D} float32 bounded, "
                 f"{BATCH_ITERS} iterations", blocks, batch, BATCH_ITERS,
                 BATCH)

    # A solve of each while form whose tol ends it inside a block.
    cq = tt.get_problem("coupled_quadratic")
    cvg = tt.fused_value_and_grad("coupled_quadratic")
    ctail = tt.fused_tail_for("coupled_quadratic")
    ccfg = _bench_cfg(tt, GRAPH_TOL_ITERS).replace(tol=1e-5)
    xq = torch.from_numpy(np.random.default_rng(SEED).uniform(
        -1.0, 1.0, D)).to(dev, torch.float32)
    mixed = bx.clone()
    mixed[: BATCH // 2] = 1.0 + 0.1 * (2.0 * torch.rand(
        BATCH // 2, BATCH_D, generator=torch.Generator(dev).manual_seed(SEED),
        device=dev) - 1.0)
    forms = {
        "minimize": lambda: tt.minimize(
            cq.f, xq, ccfg, value_and_grad=cvg, dir_poly=cq.dir_poly,
            fused_tail=ctail),
        "make_solve_segment": lambda: tt.finalize_result(
            ccfg, tt.make_solve_segment(
                ccfg, cq.f, value_and_grad=cvg, iters=GRAPH_TOL_ITERS,
                dir_poly=cq.dir_poly, fused_tail=ctail)(
                tt.init_state(cvg, xq, ccfg.m))),
        "vmap_minimize while": lambda: tt.vmap_minimize(
            rose.f, mixed, bcfg.replace(tol=1e-3), grad=rose.grad,
            dir_poly=rose.dir_poly, lockstep="while"),
    }
    for label, run in forms.items():
        res = {}
        for mode in ("eager", "graphs"):
            reset_counts()
            with _graph_mode(blocks, mode):
                res[mode] = run()
            torch.cuda.synchronize()
            reads = blocks.stats["host_reads"]
            note = blocks_note()
        r = res["graphs"]
        differ = _graph_same(res["eager"], r)
        iters = r.iterations.reshape(-1)
        ended = (r.status.reshape(-1) == tt.Status.CONVERGED) \
            & (iters % blocks.BLOCK_ITERS != 0)
        top = int(iters.max())
        say(f"[graph] {label}, tol ends it: iterations "
            f"{sorted(set(iters.tolist()))[:12]}, converged inside a block "
            f"on {int(ended.sum())} of {iters.numel()} lanes; replayed "
            f"against eager, fields that differ {differ}; {note}")
        check(not differ and bool(ended.any()),
              f"[graph] {label}: the replayed solve must end inside a "
              f"block as the eager one does ({differ})")
        check(reads <= math.ceil(top / blocks.BLOCK_ITERS) + 2,
              f"[graph] {label}: {reads} host reads for {top} iterations")

    # Blocks replayed with no host synchronisation: a block of the main
    # path's while form and of the batch cell's bounded form, captured
    # first, then replayed under set_sync_debug_mode("error").
    for label, c, x, fn, masked in (
            (f"d={D} while", cfg, x0, (vg, rose.dir_poly, tail), True),
            (f"B={BATCH} d={BATCH_D} bounded", bcfg, bx,
             (tt.make_value_and_grad(rose.f, rose.grad), rose.dir_poly),
             False)):
        c = c.replace(max_iters=1 << 30)
        step = _stepper(c, rose.f, fn[0], *fn[1:], bounded=not masked)
        drv = blocks.BlockRunner(c, step, tt.init_state(fn[0], x, c.m),
                                 masked)
        drv.start(None)
        drv.run(blocks.BLOCK_ITERS)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(GRAPH_SYNC_BLOCKS):
                drv.run(blocks.BLOCK_ITERS)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(drv.s.f).all()), f"[graph] {label}: f "
              "must stay finite")
        say(f"[sync] {GRAPH_SYNC_BLOCKS} replayed blocks of "
            f"{blocks.BLOCK_ITERS} iterations, {label}, under "
            "torch.cuda.set_sync_debug_mode('error'): no host "
            "synchronisation")

    # The graphs' private pool, at D and at GRAPH_POOL_D.
    _graph_pool(f"d={D}", blocks, tt, cfg, rose, vg, tail, x0, card)
    big = _x0(GRAPH_POOL_D, SEED, torch.float32, dev)
    _graph_pool(f"d={GRAPH_POOL_D}", blocks, tt, cfg, rose, vg, tail, big,
                card)
    del big
    torch.cuda.empty_cache()

    # The block length: each of GRAPH_BLOCKS, graphs captured in a warm-up
    # run, two timed runs.
    keep = blocks.BLOCK_ITERS
    try:
        for n in GRAPH_BLOCKS:
            blocks.BLOCK_ITERS = n
            line = []
            for label, run, iters, lanes in (
                    (f"d={D}", single, BENCH_ITERS, 1),
                    (f"B={BATCH} d={BATCH_D}", batch, BATCH_ITERS, BATCH)):
                kept = blocks.Kept()
                before = dict(blocks.stats)
                run(kept)
                torch.cuda.synchronize()
                cap = blocks.stats["capture_s"] - before["capture_s"]
                walls = []
                for _ in range(2):
                    before = dict(blocks.stats)
                    t0 = time.perf_counter()
                    run(kept)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                reads = blocks.stats["host_reads"] - before["host_reads"]
                rates = [round(lanes * iters / w, 2) for w in walls]
                line.append(f"{label} {rates} (capture {cap:.3f} s, "
                            f"{reads} host reads a solve)")
            say(f"[graph] blocks of {n}: "
                + "; ".join(line) + f" (it/s, instance-it/s) on {card}")
    finally:
        blocks.BLOCK_ITERS = keep

    _graph_short(tt, blocks, rose, vg, tail, dev, card)
    _graph_host_read(tt, blocks, rose, dev)


def _graph_short(tt, blocks, rose, vg, tail, dev, card):
    """Short solves as a caller's minimize runs them, a runner and its
    capture per call: "rule" (the default: blocks captured only from a
    budget of CAPTURE_MIN_ITERS), "eager" (eager_loops) and "forced"
    (CAPTURE_MIN_ITERS set to 0), in turns, bit for bit."""
    import contextlib

    def forced():
        keep = blocks.CAPTURE_MIN_ITERS
        blocks.CAPTURE_MIN_ITERS = 0
        try:
            yield
        finally:
            blocks.CAPTURE_MIN_ITERS = keep

    modes = {"rule": contextlib.nullcontext, "eager": blocks.eager_loops,
             "forced": contextlib.contextmanager(forced)}
    from tpu_lbfgs_torch.bench.harness import _x0

    for d, lengths in GRAPH_SHORT:
        x = _x0(d, SEED, torch.float32, dev)
        for n in lengths:
            cfg = _bench_cfg(tt, n)
            walls, outs, replays = {m: [] for m in modes}, {}, {}
            for m in ("rule", "eager", "forced", "forced", "eager", "rule"):
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with modes[m]():
                    r = tt.minimize(rose.f, x, cfg, value_and_grad=vg,
                                    dir_poly=rose.dir_poly, fused_tail=tail)
                torch.cuda.synchronize()
                walls[m].append(time.perf_counter() - t0)
                outs.setdefault(m, r)
                replays[m] = blocks.stats["replays"]
            differ = sorted({f for m in ("eager", "forced")
                             for f in _graph_same(outs["rule"], outs[m])})
            say(f"[graph] short solve d={d} {n} iterations, each call "
                f"capturing afresh: walls s rule "
                f"{[round(w, 4) for w in walls['rule']]} "
                f"({'captured' if replays['rule'] else 'eager'} blocks), "
                f"eager {[round(w, 4) for w in walls['eager']]}, capture "
                f"forced {[round(w, 4) for w in walls['forced']]}; fields "
                f"that differ {differ}; on {card}")
            check(not differ, f"[graph] short solve d={d} {n}: the modes "
                  f"differ in {differ}")
            check(bool(replays["rule"]) == (n >= blocks.CAPTURE_MIN_ITERS)
                  and replays["forced"] and not replays["eager"],
                  f"[graph] short solve d={d} {n}: the wrong blocks "
                  "captured")


def _graph_host_read(tt, blocks, rose, dev):
    """An objective that reads the host (.item()) cannot be captured: the
    solve raises a RuntimeError naming the objective and eager_loops(), and
    runs under eager_loops(), equal there to the same solve of the
    problem's own f.  The failed capture leaves the caching allocator free
    to return memory: a freed GRAPH_FREED_BYTES goes back to the card at
    torch.cuda.empty_cache().  Twice: on bench.py's path, where the read
    breaks the block's own capture, and in direct mode, where the objective
    reads only while a WHILE node's body is captured (the search's gated
    turn; its first turn runs with no gate), so that the capture breaks
    inside the body."""
    from tpu_lbfgs_torch.bench.harness import _x0
    from tpu_lbfgs_torch.linesearch import strategies

    def in_body():
        return bool(getattr(strategies._GATE, "_open", None))

    x = _x0(1 << 12, SEED, torch.float32, dev)
    bench = _bench_cfg(tt, blocks.CAPTURE_MIN_ITERS).replace(
        use_pallas=False)
    direct = bench.replace(ls_eval="direct")
    for label, cfg, when in (("bench.py's path", bench, lambda: True),
                             ("direct mode, inside a WHILE node", direct,
                              in_body)):
        def reads_host(x, when=when):
            if when() and bool((x.abs() > 1e30).any()):
                return rose.f(x) * 0
            return rose.f(x)

        try:
            tt.minimize(reads_host, x, cfg, grad=rose.grad,
                        dir_poly=rose.dir_poly)
            err = None
        except RuntimeError as e:
            err = str(e)
        torch.cuda.synchronize()
        with blocks.eager_loops():
            r = tt.minimize(reads_host, x, cfg, grad=rose.grad,
                            dir_poly=rose.dir_poly)
            want = tt.minimize(rose.f, x, cfg, grad=rose.grad,
                               dir_poly=rose.dir_poly)
        differ = _graph_same(r, want)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved()
        freed = torch.empty(GRAPH_FREED_BYTES, dtype=torch.uint8, device=dev)
        del freed
        torch.cuda.empty_cache()
        kept = torch.cuda.memory_reserved() - before
        say(f"[graph] an objective that reads the host, {label}: the "
            f"captured solve raised {err!r}; under eager_loops() it ran "
            f"{r.iterations.item()} iterations, fields that differ from the "
            f"problem's own f {differ}; then {GRAPH_FREED_BYTES} bytes "
            f"freed, {kept} of them still reserved after "
            "torch.cuda.empty_cache()")
        check(kept <= 0, f"[graph] {label}: after a failed capture the "
              "allocator must return freed memory to the card")
        check(err is not None and "f=" in err and "reads_host" in err
              and "eager_loops()" in err, f"[graph] {label}: a capture of "
              "an objective that reads the host must raise naming it and "
              "eager_loops()")
        check(not differ, f"[graph] {label}: the host-reading objective's "
              f"eager solve differs in {differ}")


#: Profiler sessions per count in phase_graph_kernels: torch.profiler drops
#: device records now and then, never adds one, so a count is the most of
#: these sessions.
PROFILE_REPEATS = 3
#: Seconds each profiler session of phase_graph_kernels waits on the host
#: after it starts and before it ends, and the spin kernels it launches on
#: each side of the block (torch.cuda._sleep, SENTINEL_CYCLES each).  The
#: records torch.profiler lost were a session's first kernels (on an NVIDIA
#: H100 80GB HBM3, torch_records/profiler_counts.py): the sentinels stand
#: where the lost records were, and are not counted.
PROFILE_EDGE_S = 0.02
SENTINELS = 8
SENTINEL_CYCLES = 100_000
#: Seconds the process of phase_graph_kernels may take (about 40 on an
#: NVIDIA H100 80GB HBM3).
GRAPH_KERNELS_TIMEOUT_S = 600


def phase_graph_kernels_fresh():
    """phase_graph_kernels in a process of its own, after every timed
    phase.  torch.profiler loses more device records the longer its
    process has run: in this script's own process, at its end, 10 records
    of nearly every session in both modes, so one session of each count
    in three could be whole (on an NVIDIA H100 80GB HBM3); in a fresh
    process it lost none in 288 sessions of the same blocks
    (torch_records/profiler_counts.py)."""
    proc = subprocess.run(
        [sys.executable, "-X", "faulthandler", "-u", __file__,
         "--graph-kernels"], capture_output=True, text=True,
        timeout=GRAPH_KERNELS_TIMEOUT_S,
        env=dict(os.environ, PYTHONPATH=os.getcwd()))
    for line in proc.stdout.splitlines():
        if line.startswith("[graph]"):
            say(line)
    check(proc.returncode == 0, "[graph] the profiler's kernel counts "
          f"failed (exit {proc.returncode}): "
          f"{(proc.stdout + proc.stderr)[-3000:]}")


def phase_graph_kernels(dev):
    """Device kernels per iteration of the main path's and the batch
    cell's blocks, replayed against eager, from torch.profiler after every
    timed phase: (kernels of a block of BLOCK_ITERS - kernels of a block of
    one) / (BLOCK_ITERS - 1), so the block's own copies and flags drop
    out.  The profiler loses device records and never adds one
    (torch_records/profiler_counts.py, on an NVIDIA H100 80GB HBM3): more
    the longer its process has run (phase_graph_kernels_fresh), and now
    and then many of one session's (a replayed block of 20 once counted
    6,309 of its 6,537), so each count is the most of PROFILE_REPEATS
    sessions.  The records lost were a session's first kernels, so each
    session waits PROFILE_EDGE_S at its edges and puts SENTINELS spin
    kernels on each side of the block, and counts every device record but
    theirs.  Every session's count, and the sentinels it kept, are
    printed, and the comparison is made once, exactly."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import tpu_lbfgs_torch as tt
    from tpu_lbfgs_torch.bench.harness import _x0
    from tpu_lbfgs_torch.core import blocks
    from tpu_lbfgs_torch.core.solver import _stepper

    rose = tt.get_problem("rosenbrock")
    n = blocks.BLOCK_ITERS
    paths = (
        (f"d={D} while", _bench_cfg(tt, 1), _x0(D, SEED, torch.float32, dev),
         (tt.fused_value_and_grad("rosenbrock"), rose.dir_poly,
          tt.fused_tail_for("rosenbrock")), True),
        (f"B={BATCH} d={BATCH_D} bounded", _batch_cfg(tt, 1),
         _batch_x0(dev), (tt.make_value_and_grad(rose.f, rose.grad),
                          rose.dir_poly), False))
    for label, cfg, x, fn, masked in paths:
        cfg = cfg.replace(max_iters=1 << 30)
        step = _stepper(cfg, rose.f, fn[0], *fn[1:], bounded=not masked)
        per_block, sessions = {}, {}
        for mode in ("eager", "graphs"):
            with _graph_mode(blocks, mode):
                drv = blocks.BlockRunner(cfg, step, tt.init_state(
                    fn[0], x, cfg.m), masked)
            drv.start(None)
            drv.run(n)
            drv.run(1)
            counts = []
            for length in (n, 1):
                seen = []
                for _ in range(PROFILE_REPEATS):
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        time.sleep(PROFILE_EDGE_S)
                        for _ in range(SENTINELS):
                            torch.cuda._sleep(SENTINEL_CYCLES)
                        drv.run(length)
                        for _ in range(SENTINELS):
                            torch.cuda._sleep(SENTINEL_CYCLES)
                        torch.cuda.synchronize()
                        time.sleep(PROFILE_EDGE_S)
                    records = [e for e in prof.key_averages()
                               if e.device_type == DeviceType.CUDA]
                    kept = sum(e.count for e in records
                               if "spin_kernel" in e.key)
                    seen.append((sum(e.count for e in records) - kept,
                                 kept))
                counts.append(max(c for c, _ in seen))
                sessions[f"{mode} {length}"] = seen
            per_block[mode] = counts
        (e_n, e_1), (g_n, g_1) = per_block["eager"], per_block["graphs"]
        say(f"[graph] {label}: device kernels per iteration from "
            f"torch.profiler, replayed {(g_n - g_1) / (n - 1):.2f}, eager "
            f"{(e_n - e_1) / (n - 1):.2f} (a block of {n}: {g_n} replayed, "
            f"{e_n} eager; of one: {g_1}, {e_1}; each the most of its "
            f"sessions, as (kernels, sentinels of {2 * SENTINELS}), "
            f"{sessions})")
        check(g_n > 0 and (g_n, g_1) == (e_n, e_1),
              f"[graph] {label}: the replayed blocks run other kernels than "
              "the eager ones")


# [batch-kernels]: the batched forms of iteration_tail, fused_vg, the fused
# tail and combine_direction (the reference's jax.vmap over its kernels).
# Each against its batched plain version on the card at the batch cell, at
# 3 lanes of the main path's ragged size (every row off 16 bytes, a
# thousand tiles a lane) and at more lanes than a grid's y dimension takes:
# vectors bit for bit, each lane's sums, t1 and t2 within TRIAL_SUM_RTOL of
# that lane's sum|terms| beyond one ulp (the float64 partials add in
# another order), the combine bit for bit (the same operations in the same
# order).  Then the slice at full width: vmap_minimize under
# cfg.use_pallas with the caller's fused vg (BATCH_ITERS iterations, and
# BK_F64_ITERS in float64), solve_bounded over a batched state with the
# fused tail (BK_TAIL_ITERS with the products on each ring, BK_SHORT_ITERS
# for the other bodies and forms), the public combine entry on the states
# those leave, and the command line's --batch --pallas.  Kernels against
# plain versions over the first TRACE_ITERS iterations: alpha equal on
# every lane and f within BK_TRACE_F_RTOL of its dtype.  The sums add in
# two orders, so f may part in its last bits (BATCH_TRACE_F_RTOL, 0, is
# for the chain, whose kernel runs its plain version's operations in their
# order).  On an NVIDIA H100 80GB HBM3 f read 0 relative in float32 and
# 5.1e-13 in float64; the limits are about 16 float32 ulps and 200 times
# the float64 reading.  The
# compensated float32 plain version forms its products in float32
# (utils.accurate.compensated_dot), up to 2^-24 of sum|terms| from the
# kernel's exact float64 products; so a compensated float32 form's dots are
# held to the exact sum of the same float32 terms (their float64 products
# are exact, summed in float64) rounded to float32, under the same rule.
BK_SHAPES = ((BATCH, BATCH_D), (3, RAGGED), (65_537, 64))
BK_TAIL_FORMS = ([(h, m, False) for h in ("f32", "bf16")
                  for m in (0,) + TAIL_M + (7,)]
                 + [("f32", 0, True), ("bf16", 10, True)])
BK_COMBINE_M = TAIL_M + (7,)
BK_TRACE_F_RTOL = {torch.float32: 1e-6, torch.float64: 1e-10}
BK_F64_ITERS = 20
BK_TAIL_ITERS = 50
BK_SHORT_ITERS = 20
BK_CLI = ["--batch", "64", "--dim", "1024", "--pallas", "--poly-ls",
          "--max-iters", "50", "--json"]
# tpu_lbfgs/cli.py's record of a --batch seed.
BK_CLI_KEYS = {"seed", "batch", "converged", "mean_iterations", "mean_f",
               "max_g_norm", "wall_s"}


def _bk_inputs(gen, lanes, n, dev, dt=torch.float32):
    """x ~ U(-2, 2), d, g, g_new ~ U(-1, 1) as (lanes, n) rows and one step
    per lane, 2^U(-6, 2), made on the card; lane 0's step is 0 (a lane
    whose search failed)."""
    def uni(lo, hi, shape):
        return (lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev,
                                            dtype=torch.float64)).to(dt)
    x, d, g, gn = (uni(lo, hi, (lanes, n))
                   for lo, hi in ((-2.0, 2.0), (-1.0, 1.0), (-1.0, 1.0),
                                  (-1.0, 1.0)))
    alpha = torch.exp2(uni(-6.0, 2.0, (lanes,)).double()).to(dt)
    alpha[0] = 0.0
    return x, d, g, gn, alpha


def _bk_over(got, want, scales):
    """Largest per-lane |got - want| beyond one ulp of want, in units of the
    lane's sum|terms|, over pairs of per-lane sums."""
    return max(_beyond_ulp(a, b, s.clamp(min=1e-300))
               for a, b, s in zip(got, want, scales))


def _bk_exact_dots(pairs):
    """Each a . b over the last axis from float64 products, which are exact
    for float32 a and b, rounded once to float32."""
    return [(a.double() * b.double()).sum(-1).float() for a, b in pairs]


def _bk_tail_check(problem, out_k, out_p, d, g, S, Y, m, hdtype, where,
                   alpha_rows=None):
    """A batched fused tail against its plain version: x_new, g_new and the
    two rows bit for bit, each lane's 7 sums and t1 / t2 within
    TRIAL_SUM_RTOL of its sum|terms| beyond one ulp (given ``alpha_rows``,
    the steps as a (B, 1) column, a compensated form: the six dots against
    their exact sums, see BK_SHAPES).  Returns the largest of those
    errors."""
    same = all(torch.equal(out_k[i], out_p[i])
               and out_k[i].dtype == out_p[i].dtype for i in (0, 2, 3, 4))
    check(same and out_k[3].dtype == hdtype,
          f"batched fused tail vectors differ from plain ({where})")
    xn, gn, s, y = (out_p[i].double() for i in (0, 2, 3, 4))
    dd, gg = d.double(), g.double()
    scales = [_f_abs_terms(problem, xn), (s * y).abs().sum(-1),
              (y * y).sum(-1), (gn * gn).sum(-1), (dd * gn).abs().sum(-1),
              (gg * gn).abs().sum(-1), (y * gn).abs().sum(-1)]
    want = list(out_p[5:11])
    if alpha_rows is not None:
        # The float32 s and y the sums are formed from (the rows may be
        # bfloat16): s = alpha d and y = g_new - g, as the kernel rounds
        # them.
        gn32 = out_p[2]
        s32, y32 = alpha_rows * d, gn32 - g
        want = _bk_exact_dots([(s32, y32), (y32, y32), (gn32, gn32),
                               (d, gn32), (g, gn32), (y32, gn32)])
    over = _bk_over([out_k[1]] + list(out_k[5:11]), [out_p[1]] + want,
                    scales)
    if m:
        ya = (out_p[2] - g).double().abs().unsqueeze(-1)
        for i, ring in ((11, S), (12, Y)):
            check(out_k[i].shape == (len(g), m)
                  and out_k[i].dtype == torch.float32,
                  f"t1/t2 must be (B, {m}) float32 ({where})")
            scale = torch.bmm(ring.double().abs(), ya).squeeze(-1)
            over = max(over, _beyond_ulp(out_k[i], out_p[i],
                                         scale.clamp(min=1e-300)))
    else:
        check(out_k[11] is None and out_k[12] is None,
              f"t1/t2 must be None ({where})")
    check(over <= TRIAL_SUM_RTOL,
          f"batched fused tail sums differ from plain ({where}): "
          f"{over:.3e} of sum|terms| beyond 1 ulp")
    return over


def phase_batch_kernel_checks(dev):
    """Each batched kernel against its batched plain version at BK_SHAPES,
    then timed at the batch cell.  Returns the kernels line's records of
    the batched forms."""
    from tpu_lbfgs_torch.kernels import fused_ops as ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    hist = {"f32": torch.float32, "bf16": torch.bfloat16}
    rec = {}

    def keep(name, err):
        r = rec.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)

    def max_abs(a, b):
        return max((u.double() - v.double()).abs().max().item()
                   for u, v in zip(a, b) if u is not None)

    for lanes, n in BK_SHAPES:
        where0 = f"B={lanes} d={n}"
        # iteration_tail: float32 and float64, plain and compensated.
        worst = 0.0
        for dt in (torch.float32, torch.float64):
            x, d, g, gn, alpha = _bk_inputs(gen, lanes, n, dev, dt)
            for acc in (False, True):
                out_k = ops.iteration_tail(x, d, alpha, g, gn, accurate=acc)
                out_p = ops.iteration_tail_plain(x, d, alpha, g, gn, acc)
                torch.cuda.synchronize()
                where = f"{where0} {dt} accurate={acc}"
                check(all(torch.equal(a, b) and a.dtype == dt
                          for a, b in zip(out_k[:3], out_p[:3])),
                      f"batched iteration_tail vectors differ ({where})")
                check(all(a.shape == (lanes,) and a.dtype == dt
                          for a in out_k[3:]),
                      f"batched iteration_tail must return ({lanes},) sums")
                s, y = out_p[1].double(), out_p[2].double()
                dd, gg, gnn = d.double(), g.double(), gn.double()
                scales = [(s * y).abs().sum(-1), (y * y).sum(-1),
                          (gnn * gnn).sum(-1), (dd * gnn).abs().sum(-1),
                          (gg * gnn).abs().sum(-1)]
                want = out_p[3:]
                if acc and dt == torch.float32:
                    want = _bk_exact_dots([(out_p[1], out_p[2]),
                                           (out_p[2], out_p[2]), (gn, gn),
                                           (d, gn), (g, gn)])
                over = _bk_over(out_k[3:], want, scales)
                check(over <= TRIAL_SUM_RTOL,
                      f"batched iteration_tail sums differ ({where}): "
                      f"{over:.3e}")
                worst = max(worst, over)
                keep("iteration_tail_batched" if dt == torch.float32
                     else "iteration_tail_batched[f64]",
                     max_abs(out_k, out_p))
        say(f"[batch-kernels] iteration_tail {where0}: f32 / f64, plain / "
            f"compensated: x_new, s, y bit-equal, 5 sums per lane "
            f"{worst:.3e} of sum|terms| beyond 1 ulp (tol {TRIAL_SUM_RTOL})")

        x, d, g, _, alpha = _bk_inputs(gen, lanes, n, dev)
        for problem in ops.BODY_IDS:
            vg_plain = ops.VG_PLAIN[problem]
            f_k, g_k = ops.fused_vg(problem, x)
            f_p, g_p = vg_plain(x)
            torch.cuda.synchronize()
            over = _bk_over([f_k], [f_p], [_f_abs_terms(problem, x.double())])
            check(torch.equal(g_k, g_p) and f_k.shape == (lanes,)
                  and over <= TRIAL_SUM_RTOL,
                  f"batched {problem}_vg differs from plain ({where0}): g "
                  f"bit-equal {torch.equal(g_k, g_p)}, f {over:.3e}")
            keep(f"{problem}_vg_batched", max_abs((f_k, g_k), (f_p, g_p)))
            worst = 0.0
            for h, m, acc in BK_TAIL_FORMS:
                S, Y = ((2.0 * torch.rand((lanes, max(m, 1), n),
                                          generator=gen, device=dev) - 1.0
                         ).to(hist[h]) for _ in range(2))
                tail = ops.make_fused_tail(problem, vg_plain,
                                           with_matvec=m > 0,
                                           accurate_dots=acc)
                out_k = tail(x, d, alpha, g, S, Y)
                again = tail(x, d, alpha, g, S, Y)
                out_p = ops.fused_tail_plain(vg_plain, x, d, alpha, g, S, Y,
                                             m > 0, acc)
                torch.cuda.synchronize()
                where = f"{problem} {where0} ring {h} m={m} compensated={acc}"
                check(all(a is None and b is None or torch.equal(a, b)
                          for a, b in zip(out_k, again)),
                      f"two calls of the batched fused tail differ ({where})")
                worst = max(worst, _bk_tail_check(problem, out_k, out_p, d,
                                                  g, S, Y, m, hist[h], where,
                                                  alpha[:, None] if acc
                                                  else None))
                form = {("f32", 0, False): "",
                        ("f32", 10, False): "[ring f32, matvec m=10]",
                        ("bf16", 10, False): "[ring bf16, matvec m=10]",
                        ("f32", 0, True): "[compensated]"}.get((h, m, acc))
                if form is not None and (problem == "rosenbrock"
                                         or not form):
                    keep(f"{problem}_fused_tail_batched{form}",
                         max_abs(out_k, out_p))
                del S, Y, out_k, again, out_p
            say(f"[batch-kernels] {problem} {where0}: vg g bit-equal, f "
                f"{over:.3e}; fused tail, {len(BK_TAIL_FORMS)} forms (ring "
                f"f32/bf16, m=0,5,10,20,7, compensated): vectors and two "
                f"calls bit-equal, 7 sums and t1/t2 per lane {worst:.3e} of "
                f"sum|terms| beyond 1 ulp (tol {TRIAL_SUM_RTOL})")

        # combine_direction: float32, float64 (m = 10) and a bfloat16 ring
        # under float32, bit for bit.
        for (dt, hd), m in itertools.product(
                ((torch.float32, torch.float32),
                 (torch.float64, torch.float64),
                 (torch.float32, torch.bfloat16)), BK_COMBINE_M):
            if dt == torch.float64 and m != 10:
                continue
            gv = x.to(dt)
            S, Y = ((2.0 * torch.rand((lanes, m, n), generator=gen,
                                      device=dev) - 1.0).to(hd)
                    for _ in range(2))
            v, u = ((2.0 * torch.rand((lanes, m), generator=gen, device=dev,
                                      dtype=torch.float64) - 1.0).to(dt)
                    for _ in range(2))
            gamma = (0.5 + torch.rand(lanes, generator=gen, device=dev,
                                      dtype=torch.float64)).to(dt)
            r_k = ops.combine_direction(gv, S, Y, v, u, gamma)
            r_p = ops.combine_direction_plain(gv, S, Y, v, u, gamma)
            torch.cuda.synchronize()
            check(r_k.dtype == dt and r_k.shape == (lanes, n)
                  and torch.equal(r_k, r_p),
                  f"batched combine_direction differs from plain ({where0} "
                  f"m={m} {dt} ring {hd})")
            if dt == torch.float32:
                keep("combine_direction_batched" if hd == torch.float32
                     else "combine_direction_batched[ring bf16]",
                     (r_k - r_p).abs().max().item())
            del S, Y
        say(f"[batch-kernels] combine_direction {where0}: m=5,10,20,7 f32, "
            f"m=10 f64, m=5,10,20,7 bf16 ring: bit-equal to plain")

    # Times at the batch cell.  Bounds: each input read once, each output
    # written once, at the card's memory rate (every form is bound by
    # bytes); the operations as in [kernel].
    lanes, n = BATCH, BATCH_D
    bn = lanes * n
    x, d, g, gn, alpha = _bk_inputs(gen, lanes, n, dev)

    def timed(name, kernel, plain, bound, library=None, extra="",
              library_label="the bmm route"):
        r = rec.setdefault(name, {"max_abs_err": 0.0})
        r.update(ms=device_ms(kernel), plain_ms=device_ms(plain),
                 bound=bound)
        line = (f"[batch-kernels] {name} B={lanes} d={n}{extra}: "
                f"{r['ms'] * 1e3:.2f} us on the card, plain version "
                f"{r['plain_ms'] * 1e3:.2f} us")
        if library is not None:
            r["library_ms"] = device_ms(library)
            line += f", {library_label} {r['library_ms'] * 1e3:.2f} us"
        say(line + f", bound {bound[0] * 1e3:.2f} us by {bound[1]}")

    for dt, name in ((torch.float32, "iteration_tail_batched"),
                     (torch.float64, "iteration_tail_batched[f64]")):
        xs, ds, gs, gns, als = (t.to(dt) for t in (x, d, g, gn, alpha))
        size = xs.element_size()
        bound = bound_ms(size * (7 * bn + 6 * lanes), 13 * bn)
        timed(name, lambda: ops.iteration_tail(xs, ds, als, gs, gns),
              lambda: ops.iteration_tail_plain(xs, ds, als, gs, gns), bound)
        comp_ms = device_ms(lambda: ops.iteration_tail(xs, ds, als, gs, gns,
                                                       accurate=True))
        say(f"[batch-kernels] {name} B={lanes} d={n} compensated: "
            f"{comp_ms * 1e3:.2f} us on the card")
    body_ops = {"quadratic": 4, "rosenbrock": 18, "coupled_quadratic": 9}
    for problem in ops.BODY_IDS:
        vg_plain = ops.VG_PLAIN[problem]
        timed(f"{problem}_vg_batched", lambda: ops.fused_vg(problem, x),
              lambda: vg_plain(x),
              bound_ms(8 * bn + 4 * lanes, body_ops[problem] * bn))
        tail = ops.make_fused_tail(problem, vg_plain, with_matvec=False)
        timed(f"{problem}_fused_tail_batched",
              lambda: tail(x, d, alpha, g),
              lambda: ops.fused_tail_plain(vg_plain, x, d, alpha, g),
              bound_ms(28 * bn + 32 * lanes, (body_ops[problem] + 22) * bn))
    vg_plain = ops.VG_PLAIN["rosenbrock"]
    comp = ops.make_fused_tail("rosenbrock", vg_plain, with_matvec=False,
                               accurate_dots=True)
    timed("rosenbrock_fused_tail_batched[compensated]",
          lambda: comp(x, d, alpha, g),
          lambda: ops.fused_tail_plain(vg_plain, x, d, alpha, g,
                                       accurate=True),
          bound_ms(28 * bn + 32 * lanes, 40 * bn))
    m = 10
    for h in ("f32", "bf16"):
        S, Y = ((2.0 * torch.rand((lanes, m, n), generator=gen, device=dev)
                 - 1.0).to(hist[h]) for _ in range(2))
        size = S.element_size()
        tail = ops.make_fused_tail("rosenbrock", vg_plain, with_matvec=True)
        # The library call: t1 = S y and t2 = Y y alone, two torch.bmm on
        # the ring as it is stored (on a bf16 ring y is rounded to bf16:
        # another function).
        y_col = g.unsqueeze(-1).to(S.dtype)
        timed(f"rosenbrock_fused_tail_batched[ring {h}, matvec m={m}]",
              lambda: tail(x, d, alpha, g, S, Y),
              lambda: ops.fused_tail_plain(vg_plain, x, d, alpha, g, S, Y,
                                           True),
              bound_ms(bn * (20 + 2 * size + 2 * m * size)
                       + lanes * (32 + 8 * m), bn * (40 + 8 * m)),
              lambda: (torch.bmm(S, y_col), torch.bmm(Y, y_col)),
              library_label="t1, t2 by two torch.bmm")
        v, u = (2.0 * torch.rand((lanes, m), generator=gen, device=dev) - 1.0
                for _ in range(2))
        gamma = 0.5 + torch.rand(lanes, generator=gen, device=dev)
        name = ("combine_direction_batched" if h == "f32"
                else "combine_direction_batched[ring bf16]")
        # g, the ring, v, u and gamma in, r out; 4 m + 1 operations.
        bound = bound_ms(4 * (2 * bn + 2 * m * lanes + lanes)
                         + 2 * m * bn * size, (4 * m + 1) * bn)
        args = (x, S, Y, v, u, gamma)
        library = (lambda: ops.combine_direction_matmul(*args)) \
            if h == "f32" else None
        timed(name, lambda: ops.combine_direction(*args),
              lambda: ops.combine_direction_plain(*args), bound, library,
              f" m={m}")
        if h == "bf16":
            say(f"[batch-kernels] {name}: the solver's bmm route (bfloat16 "
                f"coefficients, the ring widened) "
                f"{device_ms(lambda: ops.combine_direction_matmul(*args)) * 1e3:.2f}"
                " us")
        del S, Y
    return rec


def _bk_trace(tt, cfg, p, x0, vg, tail=None):
    """alpha and f of the first TRACE_ITERS bounded iterations from x0."""
    s = tt.init_state(vg, x0, cfg.m, cfg.history_dtype)
    alphas, fs = [], []
    for _ in range(TRACE_ITERS):
        s = tt.iterate(cfg, p.f, vg, s, p.dir_poly, tail, bounded=True)
        alphas.append(s.alpha)
        fs.append(s.f)
    return torch.stack(alphas), torch.stack(fs), s


def _bk_same_trace(label, kern, plain):
    """Kernels against plain versions over TRACE_ITERS iterations: alpha
    equal on every lane, f within BK_TRACE_F_RTOL of its dtype."""
    (a_k, f_k, _), (a_p, f_p, _) = kern, plain
    f_rel = ((f_k.double() - f_p.double()).abs()
             / f_p.double().abs().clamp(min=1e-300)).max().item()
    same = torch.equal(a_k, a_p)
    tol = BK_TRACE_F_RTOL[f_p.dtype]
    say(f"[batch-kernels] {label}: first {TRACE_ITERS} iterations, kernels "
        f"vs plain on the card: alpha equal on every lane {same}, f max rel "
        f"err {f_rel:.3e} (tol {tol})")
    check(same and f_rel <= tol,
          f"{label}: the kernels and the plain versions part")


def phase_batch_kernel_slice(dev):
    """The batch solve on the kernels at the batch cell.  Returns the
    launches of each batched form on these solves."""
    import tpu_lbfgs_torch as tt
    from tpu_lbfgs_torch import kernels
    from tpu_lbfgs_torch.core import blocks
    from tpu_lbfgs_torch.core.direction import compute_direction_with_aux
    from tpu_lbfgs_torch.kernels import fused_ops as ops

    launches = {}
    rose = tt.get_problem("rosenbrock")
    x0 = _batch_x0(dev)
    mean0 = rose.f(x0).mean().item()

    # (a) vmap_minimize under cfg.use_pallas with the caller's fused vg,
    # timed in turns against the [batch] path (plain tail, the problem's f
    # and gradient: its f sums float32 terms in float32, the vg's in
    # float64, so it is another trajectory and only its time is compared);
    # then the same solve through the kernels' plain versions, whose every
    # lane must end as the kernels' does.  A lane whose line search fails
    # stops there: with a kernel's f, summed apart from the directional
    # polynomial's float32 c0, a few lanes fail in both packages (ROADMAP
    # Queue 3, F11), so every other lane must run every iteration.
    # The warm-up solves load each path's kernels; each timed solve
    # captures its own graphs, as every call of vmap_minimize does.
    cfg = _batch_cfg(tt, BATCH_ITERS).replace(use_pallas=True)
    plain_cfg = cfg.replace(use_pallas=False)
    fused = tt.fused_value_and_grad("rosenbrock")
    kw = {True: dict(value_and_grad=fused), False: dict(grad=rose.grad)}
    walls = {True: [], False: []}
    for on in (True, False):
        tt.vmap_minimize(rose.f, x0, (cfg if on else plain_cfg).replace(
            max_iters=blocks.BLOCK_ITERS), dir_poly=rose.dir_poly,
            lockstep="bounded", **kw[on])
    for on in (True, False, False, True):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        r = tt.vmap_minimize(rose.f, x0, cfg if on else plain_cfg,
                             dir_poly=rose.dir_poly, lockstep="bounded",
                             **kw[on])
        torch.cuda.synchronize()
        walls[on].append(time.perf_counter() - t0)
        if on:
            got, res = kernels.launch_counts(), r
            warm = blocks.stats["warmups"]
            each = all(per_step(name) for name in (
                "iteration_tail_batched", "compact_chain")) and per_step(
                "rosenbrock_vg_batched", eager=1)
    r = res
    ref = tt.vmap_minimize(
        rose.f, x0, plain_cfg, dir_poly=rose.dir_poly, lockstep="bounded",
        value_and_grad=tt.fused_value_and_grad("rosenbrock",
                                               use_pallas=False))
    ok = r.status != tt.Status.LINE_SEARCH_FAILED
    mean1 = r.f.mean().item()
    ms = [w / BATCH_ITERS * 1e3 for w in walls[True]]
    ms_plain = [w / BATCH_ITERS * 1e3 for w in walls[False]]
    counts = torch.bincount(r.status.long(), minlength=4).tolist()
    status = {tt.Status.NAMES[i]: c for i, c in enumerate(counts) if c}
    same_end = bool((r.status == ref.status).all()
                    and (r.iterations == ref.iterations).all())
    both = ok & (ref.status != tt.Status.LINE_SEARCH_FAILED)
    f_rel = ((r.f - ref.f).double().abs()
             / ref.f.double().abs().clamp(min=1e-300))[both]
    say(f"[batch-kernels] vmap_minimize B={BATCH} d={BATCH_D} float32 "
        f"bounded, use_pallas=True, fused vg, {BATCH_ITERS} iterations: "
        f"mean f {mean0:.6e} -> {mean1:.6e}, status {status}, launches "
        f"{ran(got)}; ms/iteration {[round(v, 3) for v in ms]} "
        f"({BATCH * 1e3 / min(ms):.0f} instance-iterations/s), the [batch] "
        f"path in the same turns {[round(v, 3) for v in ms_plain]} "
        f"({BATCH * 1e3 / min(ms_plain):.0f})")
    say(f"[batch-kernels] the same solve through the plain versions: every "
        f"lane's status and iterations equal {same_end}, f max rel err "
        f"{f_rel.max().item():.3e}, median {f_rel.median().item():.3e} on "
        f"the {int(both.sum())} lanes that ran in both")
    check(same_end, "the batch solve on the kernels ends a lane otherwise "
          "than the same solve through the plain versions")
    check(bool(((r.iterations == BATCH_ITERS) | ~ok).all()),
          "every lane whose line search holds must run its 200 iterations")
    # Once per iteration replayed and once in the capture's warm-up
    # iteration; the vg once more, in init_state.
    check(warm == 1 and got["iteration_tail_batched"] == BATCH_ITERS + warm
          and got["rosenbrock_vg_batched"] == BATCH_ITERS + warm + 1
          and got["compact_chain"] == BATCH_ITERS + warm and each,
          f"the batch solve must launch iteration_tail and compact_chain "
          f"once per iteration, replayed, and the vg once more: {ran(got)}")
    check(not any(n for k, n in got.items()
                  if k not in ("iteration_tail_batched",
                               "rosenbrock_vg_batched", "compact_chain")),
          f"the batch solve launched another kernel: {ran(got)}")
    check(bool(torch.isfinite(r.f[ok]).all()) and mean1 < mean0,
          "mean f must fall and f stay finite on every lane that ran")
    launches["iteration_tail_batched"] = got["iteration_tail_batched"]
    launches["rosenbrock_vg_batched"] = got["rosenbrock_vg_batched"]
    traces = {on: _bk_trace(tt, cfg.replace(use_pallas=on), rose, x0,
                            tt.fused_value_and_grad("rosenbrock",
                                                    use_pallas=on))
              for on in (True, False)}
    _bk_same_trace("vmap_minimize use_pallas", traces[True], traces[False])
    state = traces[True][2]
    vg = tt.fused_value_and_grad("rosenbrock")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = tt.iterate(cfg, rose.f, vg, state, rose.dir_poly,
                           bounded=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(state.f.shape == (BATCH,), "a batched state must stay batched")
    say("[sync] one batched iterate on the kernels (B=4096) under "
        "torch.cuda.set_sync_debug_mode('error'): no host synchronisation")

    # float64: the iteration_tail kernel's float64 form on the same solve.
    x64 = x0.double()
    cfg64 = _batch_cfg(tt, BK_F64_ITERS).replace(use_pallas=True)
    reset_counts()
    r64 = tt.vmap_minimize(rose.f, x64, cfg64, grad=rose.grad,
                           dir_poly=rose.dir_poly, lockstep="bounded")
    torch.cuda.synchronize()
    n64 = kernels.launch_counts()["iteration_tail_batched"]
    each64 = one_per_iteration("iteration_tail_batched", BK_F64_ITERS)
    vg64 = tt.make_value_and_grad(rose.f, rose.grad)
    _bk_same_trace("vmap_minimize use_pallas float64",
                   _bk_trace(tt, cfg64, rose, x64, vg64),
                   _bk_trace(tt, cfg64.replace(use_pallas=False), rose, x64,
                             vg64))
    check(each64 and bool((r64.iterations == BK_F64_ITERS).all())
          and r64.f.mean().item() < mean0,
          f"the float64 batch solve must launch iteration_tail once per "
          f"iteration ({n64})")
    launches["iteration_tail_batched[f64]"] = n64

    # (b) solve_bounded over a batched state with the fused tail: the
    # products on each ring, then the other bodies and forms, shorter.
    runs = [("rosenbrock", "[ring f32, matvec m=10]", None, True, False,
             BK_TAIL_ITERS),
            ("rosenbrock", "[ring bf16, matvec m=10]", "bfloat16", True,
             False, BK_TAIL_ITERS),
            ("rosenbrock", "", None, False, False, BK_SHORT_ITERS),
            ("rosenbrock", "[compensated]", None, False, True,
             BK_SHORT_ITERS),
            ("quadratic", "", None, False, False, BK_SHORT_ITERS),
            ("coupled_quadratic", "", None, False, False, BK_SHORT_ITERS)]
    ring_states = {}
    for problem, form, hd, products, acc, iters in runs:
        p = tt.get_problem(problem)
        c = _batch_cfg(tt, iters).replace(history_dtype=hd,
                                          accurate_dots=acc)
        vg = tt.fused_value_and_grad(problem)
        tail = tt.fused_tail_for(problem, with_matvec=products, m=c.m,
                                 accurate_dots=acc)
        label = f"solve_bounded {problem} fused tail{form or ' [m=0]'}"
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        st = tt.init_state(vg, x0, c.m, c.history_dtype)
        out = tt.solve_bounded(c, p.f, vg, st, p.dir_poly, tail)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = kernels.launch_counts()
        tail_name = f"{problem}_fused_tail_batched"
        each = all(one_per_iteration(name, iters)
                   for name in (tail_name, "compact_chain"))
        ok = out.status != tt.Status.LINE_SEARCH_FAILED
        f0, f1 = p.f(x0).mean().item(), out.f.mean().item()
        say(f"[batch-kernels] {label}: {iters} iterations in {wall:.3f} s "
            f"({wall / iters * 1e3:.3f} ms/iteration), mean f {f0:.6e} -> "
            f"{f1:.6e}, launches {ran(got)}; {blocks_note()}")
        check(each and got[f"{problem}_vg_batched"] == 1
              and bool(((out.k == iters) | ~ok).all()),
              f"{label}: one fused tail per iteration, one vg, "
              f"{ran(got)}")
        check(bool(torch.isfinite(out.f[ok]).all()) and f1 < f0,
              f"{label}: mean f must fall and f stay finite")
        launches[tail_name + form] = got[tail_name]
        launches[f"{problem}_vg_batched"] = max(
            launches.get(f"{problem}_vg_batched", 0),
            got[f"{problem}_vg_batched"])
        if products:
            plain_tail = tt.fused_tail_for(problem, with_matvec=True, m=c.m,
                                           use_pallas=False)
            _bk_same_trace(
                label, _bk_trace(tt, c, p, x0, vg, tail),
                _bk_trace(tt, c, p, x0, tt.fused_value_and_grad(
                    problem, use_pallas=False), plain_tail))
            ring_states[hd] = (c, out)

    # (c) the public combine entry on the states (b) left, against the
    # direction the solver takes (its bmm route), on the lanes without a
    # fallback: a float32 ring within 1e-4 of each lane's max |d|; on the
    # bfloat16 ring the bmm route rounds the coefficients to bfloat16, so
    # within 2^-8 of each lane's sum |coefficient| max |row|.
    for hd, (c, st) in ring_states.items():
        d_ref, aux, fb = compute_direction_with_aux(
            c.replace(direction="compact"), st)
        kernels.reset_launches()
        r_vec = ops.combine_direction(st.g, st.s_hist, st.y_hist, aux.v_phys,
                                      aux.u_phys, aux.gamma)
        name = ("combine_direction_batched" if hd is None
                else "combine_direction_batched[ring bf16]")
        n_comb = kernels.launch_counts()["combine_direction_batched"]
        keep_lanes = ~fb
        err = (r_vec + d_ref).abs().amax(-1)
        if hd is None:
            tol = 1e-4 * d_ref.abs().amax(-1).clamp(min=1e-30)
        else:
            s_max = st.s_hist.float().abs().amax(-1)
            y_max = st.y_hist.float().abs().amax(-1)
            tol = 2.0 ** -8 * ((aux.v_phys.abs() * s_max).sum(-1)
                               + aux.gamma.abs()
                               * (aux.u_phys.abs() * y_max).sum(-1)
                               ).clamp(min=1e-30)
        worst = (err / tol)[keep_lanes].max().item()
        say(f"[batch-kernels] combine_direction(use_pallas=True) on the "
            f"batched {'bfloat16' if hd else 'float32'} ring against the "
            f"solver's direction: max err {worst:.3e} of each lane's "
            f"tolerance, {int(keep_lanes.sum())} of {BATCH} lanes without a "
            f"fallback, launches {n_comb}")
        check(n_comb == 1 and int(keep_lanes.sum()) > 0 and worst <= 1.0,
              f"{name} and the solver's direction part")
        launches[name] = n_comb

    # (d) the command line's --batch --pallas, in float32 and in float64:
    # iteration_tail's batched kernel is built for both.
    for argv in (BK_CLI, BK_CLI + ["--dtype", "float64"]):
        reset_counts()
        doc = _cli_main(argv)
        got = kernels.launch_counts()
        rec = doc["results"][0]
        say(f"[batch-kernels] python -m tpu_lbfgs_torch {' '.join(argv)}: "
            f"{rec}, launches {ran(got)}; {blocks_note()}")
        n_tail = got["iteration_tail_batched"]
        steps = blocks.stats["steps"]
        check(set(rec) == BK_CLI_KEYS and doc["config"]["pallas"]
              and per_step("iteration_tail_batched") and 1 <= steps <= 50
              and rec["mean_iterations"] <= steps
              and np.isfinite(rec["mean_f"]),
              f"{' '.join(argv)} must run iteration_tail's batched kernel "
              f"and print the reference's batch record")
    return launches


def _direct_cfg(tt, strategy, iters):
    # bench/reference_protocol.py::run_tpu_cell's float32 stack, no rescue.
    return tt.REFERENCE_PARALLEL.replace(
        line_search=strategy, direction="compact_incremental",
        ls_eval="direct", use_pallas=True, alpha_rescue_floor=None,
        max_iters=iters, tol=0.0)


# The state fields [direct] holds bit for bit between the read-driven and
# the gated solve.
DIRECT_FIELDS = ("x", "f", "g", "k", "n_fev", "n_gev", "guards", "status")


def _twin_kernel(strategy):
    """The K-trial kernel a direct-mode twin launches once per round."""
    return ("rosenbrock_multi_phi" if strategy == "backtracking_speculative"
            else "rosenbrock_multi_phi_dphi")


def _direct_solver(tt, use_kernels=True):
    return dict(
        value_and_grad=tt.fused_value_and_grad("rosenbrock"),
        fused_tail=tt.fused_tail_for("rosenbrock"),
        phi_batch=tt.multi_phi_for("rosenbrock", use_pallas=use_kernels),
        phi_dphi_batch=tt.multi_phi_dphi_for("rosenbrock",
                                             use_pallas=use_kernels))


def twin_rounds(reads, got, vg, own):
    """(rounds, the K-trial kernel's launches in them) of a direct-mode
    twin's solve since reset_counts().  Read-driven, each round is one host
    read, and so is each scalar zoom turn of
    wolfe_interpolation_speculative's phase B (one vg launch each past
    init_state's).  On the gated driver nothing is read: each iteration
    stepped runs its first round with no gate, the card counts the gated
    turns (the zoom turns among them), and a capture's warm-up launches
    are set aside (blocks.stats["warmup_launches"])."""
    from tpu_lbfgs_torch.core import blocks

    st = blocks.read_stats()
    warm = st["warmup_launches"]
    zoom = got[vg] - warm[vg] - 1
    if st["replays"]:
        return st["steps"] + st["gated_turns"] - zoom, got[own] - warm[own]
    return reads - zoom, got[own]


# WHILE nodes of a captured direct-mode iteration: one per search loop, the
# bracketing twin's two phases two.
DIRECT_LOOPS = {"wolfe_interpolation_speculative": 2}


def _iteration_nodes(tt, blocks, cfg, p, vg, x0, args):
    """(WHILE nodes, other nodes) per iteration of one block of the direct
    solve under ``cfg``, captured by a runner of its own (stats reset)."""
    from tpu_lbfgs_torch.core import solver

    drv = blocks.BlockRunner(cfg, solver._stepper(cfg, p.f, vg, *args),
                             tt.init_state(vg, x0, cfg.m), masked=True,
                             graphed=True, gated=True)
    blocks.reset_stats()
    drv.start(None)
    drv.run(drv.block)
    st = blocks.read_stats()
    return st["while_nodes"] / drv.block, st["graph_nodes"] / drv.block


def phase_direct(dev):
    """[direct]: each of the 8 line searches in direct mode at d = 2^20 for
    DIRECT_ITERS iterations, through minimize's solve, read-driven on the
    per-iteration loop (eager_loops()) and on the gated driver in captured
    blocks (each search loop a WHILE node): a kept runner captures in a
    first solve, and the measured one replays under
    set_sync_debug_mode("error").  The two bit-equal in x, f, g, k, the
    counts, the guards and the kernel launches; their walls in turns.
    Each search's captured iteration holds one WHILE node per search loop
    and as many nodes under 4x its caps (ls_safety_cap, ls_max_iters) as
    under its own (_iteration_nodes)."""
    import tpu_lbfgs_torch as tt
    from tpu_lbfgs_torch import kernels
    from tpu_lbfgs_torch.core import blocks
    from tpu_lbfgs_torch.kernels import line_search_ops
    from tpu_lbfgs_torch.linesearch import strategies

    p = tt.get_problem("rosenbrock")
    rng = np.random.default_rng(SEED)
    x0 = torch.from_numpy(rng.uniform(-DIRECT_BOX, DIRECT_BOX, D)).to(
        device=dev, dtype=torch.float32)
    f0 = p.f(x0).item()
    solver = _direct_solver(tt)
    vg = solver["value_and_grad"]
    args = (None, solver["fused_tail"], solver["phi_batch"],
            solver["phi_dphi_batch"])
    trial_kernels = tuple(line_search_ops.launches)
    launches = dict.fromkeys(trial_kernels, 0)
    for strategy in tt.config.LINE_SEARCH_METHODS:
        cfg = _direct_cfg(tt, strategy, DIRECT_ITERS)
        kept = blocks.Kept()

        def solve(kept=None, cfg=cfg):
            # minimize's solve (solve_to_result), with a kept runner.
            state = tt.init_state(vg, x0, cfg.m)
            return tt.solve_from_state(cfg, p.f, vg, state, *args, kept=kept)

        blocks.reset_stats()
        solve(kept)                         # the capture
        capture_s = blocks.stats["capture_s"]
        nodes = {c: _iteration_nodes(tt, blocks, cfg.replace(
            ls_safety_cap=c * cfg.ls_safety_cap,
            ls_max_iters=c * cfg.ls_max_iters), p, vg, x0, args)
            for c in (1, 4)}
        runs, walls = {}, {"read-driven": [], "gated": []}
        for mode in ("read-driven", "gated", "gated", "read-driven"):
            torch.cuda.synchronize()
            reset_counts()
            strategies.reset_host_reads()
            t0 = time.perf_counter()
            if mode == "gated":
                torch.cuda.set_sync_debug_mode("error")
                try:
                    r = solve(kept)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            else:
                with tt.eager_loops():
                    r = solve()
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t0)
            if mode not in runs:
                r = r.replace(**{n: getattr(r, n).clone()
                                 for n in DIRECT_FIELDS})
                reads = strategies.host_reads["line_search"]
                got = kernels.launch_counts()
                runs[mode] = (r, got, reads, dict(blocks.read_stats()),
                              twin_rounds(reads, got, "rosenbrock_vg",
                                          _twin_kernel(strategy))
                              if strategy.endswith("_speculative") else None)
        (a, got_a, reads_a, st_a, rounds_a), \
            (b, got_b, reads_b, st_b, rounds_b) = \
            runs["read-driven"], runs["gated"]
        k, n_fev, f = b.k.item(), b.n_fev.item(), b.f.item()
        differ = [n for n in DIRECT_FIELDS
                  if not torch.equal(getattr(a, n), getattr(b, n))]
        # init_state charges one evaluation, each iteration its tail's one.
        trials = n_fev - 1 - k
        ms = {m: ", ".join(f"{w / k * 1e3:.3f}" for w in ws)
              for m, ws in walls.items()}
        say(f"[direct] {strategy}: {k} iterations, {trials / k:.2f} trials/"
            f"iteration; ms/iteration in turns read-driven "
            f"{ms['read-driven']} ({reads_a / k:.2f} line-search host reads/"
            f"iteration +1 for the loop), gated {ms['gated']} (replayed "
            f"under set_sync_debug_mode('error'): {reads_b} line-search "
            f"reads, {st_b['host_reads']} loop reads, {st_b['gated_turns']} "
            f"gated turns; capture {capture_s:.3f} s; a captured iteration "
            f"{nodes[1][0]:g} WHILE nodes and {nodes[1][1]:g} other nodes, "
            f"at 4x ls_safety_cap and ls_max_iters {nodes[4][0]:g} and "
            f"{nodes[4][1]:g}); f {f0:.6e} -> {f:.6e}, |g| "
            f"{b.g_norm.item():.4e}, status "
            f"{tt.Status.NAMES[b.status.item()]}, guards {b.guards.tolist()}"
            f", launches {ran(got_b)} (read-driven {ran(got_a)}); fields "
            f"that differ {differ}")
        check(b.status.item() == tt.Status.MAX_ITERS and k == DIRECT_ITERS,
              f"{strategy}: the solve must run its {DIRECT_ITERS} iterations")
        check(nodes[1] == nodes[4]
              and nodes[1][0] == DIRECT_LOOPS.get(strategy, 1),
              f"{strategy}: a captured iteration must hold one WHILE node "
              f"per search loop, whatever the caps: {nodes}")
        check(b.x.shape == (D,) and bool(torch.isfinite(b.x).all())
              and np.isfinite(f) and f < f0,
              f"{strategy}: f must be finite and decrease")
        check(not differ and ran(got_a) == ran(got_b),
              f"{strategy}: the gated solve differs from the read-driven "
              f"one in {differ}, launches {ran(got_b)} against {ran(got_a)}")
        check(reads_b == 0 and st_b["host_reads"]
              == 1 + -(-DIRECT_ITERS // blocks.BLOCK_ITERS)
              and st_b["steps"] == DIRECT_ITERS and st_b["replays"]
              and not st_b["captures"],
              f"{strategy}: the gated solve must replay its blocks and read "
              f"1 + ceil(n / {blocks.BLOCK_ITERS}) times; {blocks_note()}")
        check(got_b["rosenbrock_fused_tail"] == k
              and got_b["rosenbrock_vg"] >= 1,
              f"{strategy}: the tail kernel must launch once per iteration "
              "and the vg kernel at least once")
        batched = sum(got_b[name] for name in trial_kernels)
        if strategy.endswith("_speculative"):
            own = _twin_kernel(strategy)
            for label, (rounds, n) in (("read-driven", rounds_a),
                                       ("gated", rounds_b)):
                check(rounds > 0 and n == rounds
                      and batched == got_b[own],
                      f"{strategy} {label}: {own} must launch once per round "
                      f"({rounds} rounds, {n} launches)")
        else:
            check(batched == 0, f"{strategy} must not launch a K-trial kernel")
        for name in trial_kernels:
            launches[name] += got_b[name]

    # Each twin's first iterations with its K-trial kernel and with the
    # plain version, both on the card, from the same state.
    plain = _direct_solver(tt, use_kernels=False)
    for twin in ("backtracking_speculative", "wolfe_interpolation_speculative",
                 "backtracking_wolfe_speculative"):
        cfg = _direct_cfg(tt, twin, DIRECT_ITERS)
        traces = {}
        for label, s in (("kernel", solver), ("plain", plain)):
            st = tt.init_state(s["value_and_grad"], x0, cfg.m)
            alphas, fs = [], []
            for _ in range(TRACE_ITERS):
                st = tt.iterate(cfg, p.f, s["value_and_grad"], st, None,
                                s["fused_tail"], s["phi_batch"],
                                s["phi_dphi_batch"])
                alphas.append(st.alpha.item())
                fs.append(st.f.item())
            traces[label] = (alphas, fs)
        (a_k, f_k), (a_p, f_p) = traces["kernel"], traces["plain"]
        f_rel = max(abs(a - b) / abs(b) for a, b in zip(f_k, f_p))
        say(f"[direct] {twin}, first {TRACE_ITERS} iterations, K-trial "
            f"kernel vs plain on the card: alpha equal {a_k == a_p}, f max "
            f"rel err {f_rel:.3e} (tol {TRACE_F_RTOL}); alphas {a_k}")
        check(a_k == a_p, f"{twin}: alpha differs between kernel and plain")
        check(f_rel <= TRACE_F_RTOL, f"{twin}: f differs between kernel and "
              "plain")
    return launches


def phase_batch_search(dev, card):
    """[batch-search]: every line search on bench.py's batch cell in direct
    mode, then one instance at d = 2^20 under both line-search loops.

    The batch: 4096 x 1024, float32, m = 10, compact_incremental, direct
    evaluation, SEARCH_ITERS iterations of vmap_minimize(lockstep=
    "bounded") as a caller runs it (its blocks eager, the fixed trip: a
    budget below blocks.CAPTURE_MIN_ITERS), under
    torch.cuda.set_sync_debug_mode("error"), so a host read fails the
    run; held against the same solve in float64 on the card
    (SEARCH_LANE_SHARE of the lanes with the same status and f within
    SEARCH_F_RTOL); the chain kernel launches once per iteration.  Then
    SEARCH_CAPTURE over two blocks' worth, a budget that captures, its
    search loops as WHILE nodes, against its eager fixed-trip blocks, bit
    for bit.  One instance: solve_bounded (fixed-trip searches, under the
    same sync mode) and the gated driver (captured though the budget is
    below the rule's, a kept runner replaying under the same sync mode)
    against solve_from_state read-driven (eager_loops()) over the same
    SEARCH_D_ITERS iterations of the direct stack of [direct]: x bit for
    bit, the same counts (the gated one's launches too); all timed.
    Returns the profiler jobs of the single-instance runs, counted after
    every timed phase (phase_launch_counts)."""
    import tpu_lbfgs_torch as tt
    from tpu_lbfgs_torch import kernels
    from tpu_lbfgs_torch.core import blocks
    from tpu_lbfgs_torch.linesearch import strategies

    p = tt.get_problem("rosenbrock")
    x0 = _batch_x0(dev)
    for strategy in tt.config.LINE_SEARCH_METHODS:
        cfg = _batch_cfg(tt, SEARCH_ITERS).replace(line_search=strategy,
                                                   ls_eval="direct")
        # One iteration first, outside the check and the counts: it loads
        # the kernels and puts the searches' tables on the card.
        tt.vmap_minimize(p.f, x0, cfg.replace(max_iters=1), grad=p.grad,
                         lockstep="bounded")
        torch.cuda.synchronize()
        reset_counts()
        strategies.reset_host_reads()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            r = tt.vmap_minimize(p.f, x0, cfg, grad=p.grad,
                                 lockstep="bounded")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = kernels.launch_counts()
        reads = strategies.host_reads["line_search"]
        each = one_per_iteration("compact_chain", SEARCH_ITERS) \
            and blocks.stats["steps"] == SEARCH_ITERS
        note = blocks_note()
        ref = tt.vmap_minimize(p.f, x0.double(), cfg, grad=p.grad,
                               lockstep="bounded")
        counts = torch.bincount(r.status.long(), minlength=4).tolist()
        ref_counts = torch.bincount(ref.status.long(), minlength=4).tolist()
        same_status = (r.status == ref.status).double().mean().item()
        ok = (r.status != tt.Status.LINE_SEARCH_FAILED) \
            & (ref.status != tt.Status.LINE_SEARCH_FAILED)
        rel = ((r.f.double() - ref.f) / ref.f).abs()[ok]
        close = (rel <= SEARCH_F_RTOL).double().mean().item()
        trials = ((r.n_fev - 1 - r.iterations).double()
                  / r.iterations).mean().item()
        say(f"[batch-search] {strategy}: B={BATCH} d={BATCH_D} float32 "
            f"direct, bounded, {SEARCH_ITERS} iterations in {wall:.3f} s "
            f"({wall / SEARCH_ITERS * 1e3:.3f} ms/iteration, "
            f"{BATCH * SEARCH_ITERS / wall:.0f} instance-it/s), "
            f"{trials:.2f} trials/iteration/lane, line-search host reads "
            f"{reads}, under set_sync_debug_mode('error'); mean f "
            f"{r.f.mean().item():.6e} (float64 {ref.f.mean().item():.6e}), "
            f"f rel err vs float64 median {rel.median().item():.3e} max "
            f"{rel.max().item():.3e}, within {SEARCH_F_RTOL} on "
            f"{100 * close:.2f}% of the lanes that ran in both; status "
            f"counts {counts} (float64 {ref_counts}), equal on "
            f"{100 * same_status:.2f}% of the lanes; launches {ran(got)}; "
            f"{note}; on {card}")
        check(reads == 0, f"{strategy}: the bounded batch read on the host")
        check(each,
              f"{strategy}: the chain kernel must launch once per iteration")
        check(same_status >= SEARCH_LANE_SHARE,
              f"{strategy}: statuses differ from the float64 run")
        check(bool(torch.isfinite(r.f[ok]).all())
              and close >= SEARCH_LANE_SHARE,
              f"{strategy}: f differs from the float64 run")

    _search_capture(tt, blocks, p, x0, card)

    # One instance at d = 2^20: the two loops over the same iterations.
    rng = np.random.default_rng(SEED)
    x1 = torch.from_numpy(rng.uniform(-DIRECT_BOX, DIRECT_BOX, D)).to(
        device=dev, dtype=torch.float32)
    solver = _direct_solver(tt)
    vg = solver["value_and_grad"]
    args = (None, solver["fused_tail"], solver["phi_batch"],
            solver["phi_dphi_batch"])
    jobs = []
    fields = ("x", "f", "g", "k", "n_fev", "n_gev", "guards")
    for strategy in tt.config.LINE_SEARCH_METHODS:
        cfg = _direct_cfg(tt, strategy, SEARCH_D_ITERS)
        tt.solve_bounded(cfg.replace(max_iters=1), p.f, vg,
                         tt.init_state(vg, x1, cfg.m), *args)
        # The gated column captures whatever the budget of
        # blocks.GATED_CAPTURE_MIN_ITERS says; its kept runner captures
        # first, outside the counts.
        kept = blocks.Kept()

        def gated(state, cfg=cfg, kept=kept):
            least = blocks.GATED_CAPTURE_MIN_ITERS
            blocks.GATED_CAPTURE_MIN_ITERS = 0
            try:
                return tt.solve_from_state(cfg, p.f, vg, state, *args,
                                           kept=kept)
            finally:
                blocks.GATED_CAPTURE_MIN_ITERS = least

        gated(tt.init_state(vg, x1, cfg.m))
        runs = {}
        for mode in ("read-driven", "fixed-trip", "gated"):
            torch.cuda.synchronize()
            reset_counts()
            strategies.reset_host_reads()
            t0 = time.perf_counter()
            # init_state's vg launch counts, as under minimize.
            state = tt.init_state(vg, x1, cfg.m)
            if mode == "read-driven":
                with tt.eager_loops():
                    out = tt.solve_from_state(cfg, p.f, vg, state, *args)
            else:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = tt.solve_bounded(cfg, p.f, vg, state, *args) \
                        if mode == "fixed-trip" else gated(state)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            runs[mode] = (out, time.perf_counter() - t0,
                          kernels.launch_counts(),
                          strategies.host_reads["line_search"],
                          one_per_iteration("rosenbrock_fused_tail",
                                            out.k.item()))
            if mode != "gated":
                jobs.append((f"[batch-search] d={D} {strategy} {mode}",
                             x1, vg, cfg.m,
                             lambda s, cfg=cfg, b=mode == "fixed-trip":
                             tt.iterate(cfg, p.f, vg, s, *args,
                                        bounded=b)))
        (a, wall_a, got_a, reads_a, each_a), \
            (b, wall_b, got_b, reads_b, each_b), \
            (c, wall_c, got_c, reads_c, each_c) = \
            runs["read-driven"], runs["fixed-trip"], runs["gated"]
        k = b.k.item()
        same = all(torch.equal(getattr(a, n), getattr(b, n)) for n in fields)
        same_c = all(torch.equal(getattr(a, n), getattr(c, n))
                     for n in fields) and ran(got_a) == ran(got_c)
        say(f"[batch-search] d={D} {strategy}, {k} iterations: read-driven "
            f"{wall_a / k * 1e3:.3f} ms/iteration, {reads_a / k:.2f} host "
            f"reads/iteration, kernel launches/iteration "
            f"{sum(got_a.values()) / k:.2f} {ran(got_a)}; fixed-trip "
            f"{wall_b / k * 1e3:.3f} ms/iteration, {reads_b} host reads "
            f"under set_sync_debug_mode('error'), kernel launches/iteration "
            f"{sum(got_b.values()) / k:.2f} {ran(got_b)}; gated, replayed "
            f"{wall_c / k * 1e3:.3f} ms/iteration, {reads_c} line-search "
            f"host reads under the same mode, kernel launches/iteration "
            f"{sum(got_c.values()) / k:.2f} {ran(got_c)}; x, f, g and counts "
            f"bit-equal: fixed-trip {same}, gated (launches too) {same_c}; "
            f"f {b.f.item():.6e}, on {card}")
        check(k == SEARCH_D_ITERS and reads_b == 0 and reads_c == 0,
              f"{strategy}: solve_bounded and the gated solve must run "
              f"{SEARCH_D_ITERS} iterations and read nothing")
        check(same, f"{strategy}: the fixed-trip loop's solve differs from "
              "the read-driven one")
        check(same_c, f"{strategy}: the gated solve differs from the "
              "read-driven one")
        for got, each in ((got_a, each_a), (got_b, each_b), (got_c, each_c)):
            check(each and got["rosenbrock_vg"] >= 1,
                  f"{strategy}: the tail kernel must launch once per "
                  "iteration and the vg kernel at least once")
            if strategy.endswith("_speculative"):
                own = ("rosenbrock_multi_phi"
                       if strategy == "backtracking_speculative"
                       else "rosenbrock_multi_phi_dphi")
                check(got[own] >= k, f"{strategy}: {own} must launch at "
                      "least once per iteration")
    return jobs


def _search_capture(tt, blocks, p, x0, card):
    """SEARCH_CAPTURE on the batch cell under vmap_minimize(lockstep=
    "bounded") for two blocks' worth of iterations, a budget that
    captures: its blocks captured, every search loop a WHILE node,
    against the same blocks eager (eager_loops(): the fixed trip), bit for
    bit, the chain kernel once per iteration in both, and both walls with
    the capture's seconds."""
    n = 2 * blocks.BLOCK_ITERS
    cfg = _batch_cfg(tt, n).replace(line_search=SEARCH_CAPTURE,
                                    ls_eval="direct")
    out, walls, notes = {}, {}, {}
    for mode in ("eager", "captured"):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (tt.eager_loops() if mode == "eager"
              else contextlib.nullcontext()):
            out[mode] = tt.vmap_minimize(p.f, x0, cfg, grad=p.grad,
                                         lockstep="bounded")
        torch.cuda.synchronize()
        walls[mode] = time.perf_counter() - t0
        check(per_step("compact_chain") and blocks.stats["steps"] == n
              and bool(blocks.stats["replays"]) == (mode == "captured")
              and bool(blocks.stats["while_nodes"]) == (mode == "captured"),
              f"[batch-search] {SEARCH_CAPTURE} {mode}: the chain kernel "
              "must launch once per iteration, replayed when captured, "
              "its loops as WHILE nodes")
        notes[mode] = blocks_note()
    differ = _graph_same(out["eager"], out["captured"])
    say(f"[batch-search] {SEARCH_CAPTURE} B={BATCH} d={BATCH_D} float32 "
        f"direct, bounded, {n} iterations: eager fixed-trip blocks "
        f"{walls['eager']:.3f} s, captured gated {walls['captured']:.3f} s "
        f"({notes['captured']}); fields that differ {differ}; on {card}")
    check(not differ, f"[batch-search] {SEARCH_CAPTURE}: the captured gated "
          f"turns differ from the eager fixed trip in {differ}")


def _launches_per_iteration(step, state, iters=2):
    """Device kernels (and copies) launched per call of ``step``, counted
    by torch.profiler over ``iters`` calls; None where the profiler sees no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            state = step(state)
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA)
    return n / iters if n else None


def beale_like(x):
    """examples/02_custom_problem.py's objective, a smooth non-convex
    function over pairs of coordinates, with no gradient given."""
    a, b = x[..., ::2], x[..., 1::2]
    return torch.sum((1.5 - a + a * b) ** 2 + (2.25 - a + a * b**2) ** 2,
                     dim=-1)


def _general_solve(label, tt, f, x0, cfg, jobs, expect_status=None,
                   **solver):
    """One solve of the general path through tt.minimize: launches read
    around it, f must fall, iteration_tail must launch once per iteration
    and no fused tail kernel at all.  Appends to ``jobs`` what
    phase_launch_counts needs to count this solve's device launches per
    iteration later: the profiler is kept away from every timed phase."""
    from tpu_lbfgs_torch import kernels
    from tpu_lbfgs_torch.linesearch import strategies

    f0 = f(x0).item()
    # A few iterations first, outside the clock and the counts: the first
    # launch of every kernel of the path loads it.
    tt.minimize(f, x0, cfg.replace(max_iters=GENERAL_WARMUP), **solver)
    torch.cuda.synchronize()
    reset_counts()
    strategies.reset_host_reads()
    t0 = time.perf_counter()
    r = tt.minimize(f, x0, cfg, **solver)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = kernels.launch_counts()
    reads = strategies.host_reads["line_search"]
    k, fk = r.iterations.item(), r.f.item()
    each = one_per_iteration("iteration_tail", k)
    status = tt.Status.NAMES[r.status.item()]

    vg = tt.make_value_and_grad(f, solver.get("grad"),
                                solver.get("value_and_grad"))
    jobs.append((label, x0, vg, cfg.m, lambda s: tt.iterate(
        cfg, f, vg, s, solver.get("dir_poly"))))
    say(f"[general] {label}: {k} iterations in {wall:.3f} s, "
        f"{wall / max(k, 1) * 1e3:.3f} ms/iteration, "
        f"{reads / max(k, 1):.2f} line-search host reads/iteration (+1 for "
        f"the loop condition); f {f0:.6e} -> {fk:.6e}, |g| "
        f"{r.g_norm.item():.4e}, status {status}, guards "
        f"{r.guards.tolist()}, launches {ran(got)}; {blocks_note()}, the "
        "captures inside the wall")
    check(k > 0 and r.x.shape == x0.shape and bool(torch.isfinite(r.x).all())
          and np.isfinite(fk) and fk < f0,
          f"{label}: f must be finite and decrease")
    check(each and got["rosenbrock_fused_tail"] == 0,
          f"{label}: iteration_tail must launch once per iteration")
    if expect_status is not None:
        check(r.status.item() == expect_status,
              f"{label}: status {status}")
    return r, got


def phase_launch_counts(jobs):
    """Device launches per iteration of each general-path solve (and of
    [batch-search]'s single-instance runs), after
    every timed phase: a profiler session can leave its tracing hooks on
    the launches that follow."""
    import tpu_lbfgs_torch as tt

    for label, x0, vg, m, step in jobs:
        state = tt.init_state(vg, x0, m)
        for _ in range(2):
            state = step(state)
        per_it = _launches_per_iteration(step, state)
        tag = "" if label.startswith("[") else "[general] "
        say(f"{tag}{label}: "
            + ("device launches/iteration not measured (the profiler saw "
               "no device activity)" if per_it is None
               else f"{per_it:.0f} device launches/iteration"))


def phase_general(dev):
    import tpu_lbfgs_torch as tt
    from tpu_lbfgs_torch import kernels
    from tpu_lbfgs_torch.bench.harness import _x0
    from tpu_lbfgs_torch.core import blocks
    from tpu_lbfgs_torch.core.direction import compute_direction_with_aux
    from tpu_lbfgs_torch.kernels import chain
    from tpu_lbfgs_torch.kernels import fused_ops as ops

    rose = tt.get_problem("rosenbrock")
    x0 = _x0(D, SEED, torch.float32, dev)
    vg = tt.fused_value_and_grad("rosenbrock")
    launches = launches_combine = 0
    jobs = []

    # (a) chained Rosenbrock through the value-and-gradient kernel, each
    # direction, Armijo backtracking on the directional polynomial.
    for direction in tt.config.DIRECTION_METHODS:
        cfg = tt.LBFGSConfig(line_search="backtracking", direction=direction,
                             m=10, use_pallas=True, ls_eval="polynomial",
                             max_iters=GENERAL_ITERS, tol=0.0)
        r, got = _general_solve(f"rosenbrock {direction}", tt, rose.f, x0,
                                cfg, jobs, tt.Status.MAX_ITERS,
                                value_and_grad=vg, dir_poly=rose.dir_poly)
        check(one_per_iteration("rosenbrock_vg", r.iterations.item(),
                                eager=1),
              "the vg kernel must launch once per iteration and at the start")
        launches += got["iteration_tail"]

        # The first iterations with the tail kernel and with its plain
        # version, both on the card, from the same state.
        traces = {}
        for label, use_kernel in (("kernel", True), ("plain", False)):
            c = cfg.replace(use_pallas=use_kernel)
            st = tt.init_state(vg, x0, cfg.m)
            alphas, fs = [], []
            for _ in range(TRACE_ITERS):
                st = tt.iterate(c, rose.f, vg, st, rose.dir_poly)
                alphas.append(st.alpha.item())
                fs.append(st.f.item())
            traces[label] = (alphas, fs, st)
        (a_k, f_k, state), (a_p, f_p, _) = traces["kernel"], traces["plain"]
        f_rel = max(abs(a - b) / abs(b) for a, b in zip(f_k, f_p))
        say(f"[general] rosenbrock {direction}, first {TRACE_ITERS} "
            f"iterations, tail kernel vs plain on the card: alpha equal "
            f"{a_k == a_p}, f max rel err {f_rel:.3e} (tol {TRACE_F_RTOL})")
        check(a_k == a_p and f_rel <= TRACE_F_RTOL,
              f"{direction}: the tail kernel and its plain version part")

        # One iterate of this path never waits on the device.
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state = tt.iterate(cfg, rose.f, vg, state, rose.dir_poly)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(bool(torch.isfinite(state.f)), "f must stay finite")
        say(f"[sync] one {direction} iterate of the general path under "
            "torch.cuda.set_sync_debug_mode('error'): no host "
            "synchronisation")

        # The public kernel entry of the compact direction's combine, as a
        # caller would use it: from this state's small-matrix head, against
        # the direction the solver takes (which keeps the torch.mv route).
        if direction != "two_loop":
            c = cfg.replace(direction="compact")
            d_ref, aux, fb = compute_direction_with_aux(c, state)
            kernels.reset_launches()
            r_vec = ops.combine_direction(state.g, state.s_hist, state.y_hist,
                                          aux.v_phys, aux.u_phys, aux.gamma)
            n_comb = kernels.launch_counts()["combine_direction"]
            scale = d_ref.abs().max().item()
            err = (r_vec + d_ref).abs().max().item() / scale
            say(f"[general] combine_direction(use_pallas=True) on the "
                f"{direction} state against the solver's direction: max err "
                f"{err:.3e} of max |d| (tol 1e-4), fallback {bool(fb)}, "
                f"launches {n_comb}")
            check(n_comb == 1 and not bool(fb) and err <= 1e-4,
                  "the combine kernel and the solver's direction part")
            launches_combine += n_comb

    # (b) the coupled quadratic from its plain f and gradient, two-loop,
    # every trial a direct evaluation: converges.
    cq = tt.get_problem("coupled_quadratic")
    xq = torch.from_numpy(np.random.default_rng(SEED).uniform(
        -1.0, 1.0, D)).to(dev, torch.float32)
    cfg = tt.LBFGSConfig(direction="two_loop", ls_eval="direct",
                         use_pallas=True, max_iters=100, tol=1e-2)
    r, got = _general_solve("coupled_quadratic two_loop direct", tt, cq.f, xq,
                            cfg, jobs, tt.Status.CONVERGED, grad=cq.grad)
    launches += got["iteration_tail"]

    # (c) an objective with no gradient: autograd's, under the default
    # configuration apart from use_pallas (and the iteration budget).
    xb = torch.from_numpy(np.random.default_rng(SEED).uniform(
        -0.5, 0.5, D)).to(dev, torch.float32)
    cfg = tt.LBFGSConfig(use_pallas=True, max_iters=GENERAL_ITERS)
    r, got = _general_solve("beale_like autograd default config", tt,
                            beale_like, xb, cfg, jobs)
    check(not r.x.requires_grad, "the result must carry no graph")
    launches += got["iteration_tail"]

    # (d) damping, compensated dots (the kernel's Neumaier stage 2), a
    # trace and the periodic product refresh in one solve.
    cfg = tt.LBFGSConfig(direction="compact_incremental", damping=0.2,
                         accurate_dots=True, record_trace=True,
                         refresh_interval=OPTIONS_REFRESH, use_pallas=True,
                         max_iters=OPTIONS_ITERS, tol=0.0)
    r, got = _general_solve("rosenbrock damping accurate_dots trace refresh",
                            tt, rose.f, x0, cfg, jobs, tt.Status.MAX_ITERS,
                            grad=rose.grad)
    # The traced solve runs in blocks: one read to start and one per block
    # of each refresh segment; under eager_loops() it keeps the
    # per-iteration loop, whose trace it must equal bit for bit.
    reads, steps = blocks.stats["host_reads"], blocks.stats["steps"]
    segments = [min(OPTIONS_REFRESH, OPTIONS_ITERS - i)
                for i in range(0, OPTIONS_ITERS, OPTIONS_REFRESH)]
    want_reads = 1 + sum(-(-n // blocks.BLOCK_ITERS) for n in segments)
    with tt.eager_loops():
        eager = tt.minimize(rose.f, x0, cfg, grad=rose.grad)
    differ = [n for n in tt.Trace._fields
              if not torch.equal(getattr(r.trace, n), getattr(eager.trace, n))]
    differ += _graph_same(r, eager)
    say(f"[general] the traced solve in blocks: {steps} iterations stepped, "
        f"{reads} host reads (1 + one per block of each refresh segment "
        f"{segments}: {want_reads}); against the per-iteration loop's "
        f"trace and result (eager_loops()), fields that differ {differ}")
    check(steps == OPTIONS_ITERS and reads == want_reads and not differ,
          "the traced solve must run in blocks and equal the per-iteration "
          f"trace bit for bit ({reads} reads, {steps} steps, {differ})")
    tr = r.trace
    check(tr is not None and tr.f.shape == (OPTIONS_ITERS,)
          and tr.guards.shape == (OPTIONS_ITERS, tt.Guard.N)
          and bool(torch.isfinite(tr.f).all())
          and torch.equal(tr.f[-1], r.f)
          and torch.equal(tr.guards[-1], r.guards)
          and tr.n_fev[-1].item() == r.n_fev.item(),
          "the trace must hold max_iters rows ending at the result")
    say(f"[general] trace: {OPTIONS_ITERS} rows; f[0] {tr.f[0].item():.6e}, "
        f"f[-1] {tr.f[-1].item():.6e}; damped "
        f"{r.guards[tt.Guard.DAMPED].item()} iterations")
    launches += got["iteration_tail"]
    return {"iteration_tail": launches,
            "combine_direction": launches_combine}, jobs


def _cli_main(argv):
    """tpu_lbfgs_torch.cli.main(argv) in process; its --json document."""
    import contextlib
    import io

    from tpu_lbfgs_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli.main(argv)
    check(code == 0, f"the command line exited with {code} on {argv}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _first_alphas(tt, p, cfg, x0, solver, iters):
    """alpha and f of the first ``iters`` iterations from x0."""
    st = tt.init_state(solver["value_and_grad"], x0, cfg.m,
                       cfg.history_dtype)
    alphas, fs = [], []
    for _ in range(iters):
        st = tt.iterate(cfg, p.f, solver["value_and_grad"], st,
                        solver.get("dir_poly"), solver["fused_tail"],
                        solver.get("phi_batch"), solver.get("phi_dphi_batch"))
        alphas.append(st.alpha.item())
        fs.append(st.f.item())
    return alphas, fs, st


def _suite_solver(tt, problem, cfg, use_kernels, **tail_kw):
    """What the command line hands to minimize under --pallas, with the
    kernels or with their plain versions."""
    poly = cfg.ls_eval == "polynomial"
    tail_kw = {**dict(with_matvec="auto", m=cfg.m, d=D,
                      history_dtype=cfg.history_dtype,
                      accurate_dots=cfg.accurate_dots), **tail_kw}
    return dict(
        value_and_grad=tt.fused_value_and_grad(problem,
                                               use_pallas=use_kernels),
        fused_tail=tt.fused_tail_for(problem, use_pallas=use_kernels,
                                     **tail_kw),
        dir_poly=tt.get_problem(problem).dir_poly if poly else None,
        phi_batch=None if poly else tt.multi_phi_for(
            problem, use_pallas=use_kernels),
        phi_dphi_batch=None if poly else tt.multi_phi_dphi_for(
            problem, use_pallas=use_kernels))


def _check_suite_launches(label, problem, cfg, k, got, reads):
    """The kernels a --pallas solve of ``k`` iterations must have gone
    through: the fused tail once per iteration, the value and gradient once
    at the start (and once per scalar zoom turn of the direct Wolfe twin),
    a twin's K-trial kernel once per round."""
    vg = got[f"{problem}_vg"]
    check(one_per_iteration(f"{problem}_fused_tail", k),
          f"{label}: {problem}_fused_tail must launch once per iteration "
          f"({k}), launches {ran(got)}; {blocks_note()}")
    check(vg >= 1 and (vg == 1 or cfg.ls_eval == "direct"),
          f"{label}: {problem}_vg must launch once per solve, launches "
          f"{ran(got)}")
    check(got["iteration_tail"] == 0,
          f"{label}: the fused tail replaces iteration_tail")
    if cfg.ls_eval == "direct" and cfg.line_search.endswith("_speculative"):
        own = (f"{problem}_multi_phi"
               if cfg.line_search == "backtracking_speculative"
               else f"{problem}_multi_phi_dphi")
        rounds, n = twin_rounds(reads, got, f"{problem}_vg", own)
        check(rounds > 0 and n == rounds,
              f"{label}: {own} must launch once per round ({rounds} rounds, "
              f"launches {ran(got)}; {blocks_note()})")


def _kernels_vs_plain(label, tt, problem, cfg, x0, iters, **tail_kw):
    """The first iterations with the kernels and with their plain versions,
    both on the card, from the same start: equal alphas, f within
    TRACE_F_RTOL of itself or of 1e-9 of the starting f (the residue a
    quadratic falls to), whichever is larger.  Returns the state the
    kernels reach."""
    p = tt.get_problem(problem)
    a_k, f_k, state = _first_alphas(
        tt, p, cfg, x0, _suite_solver(tt, problem, cfg, True, **tail_kw),
        iters)
    a_p, f_p, _ = _first_alphas(
        tt, p, cfg, x0, _suite_solver(tt, problem, cfg, False, **tail_kw),
        iters)
    floor = 1e-9 * abs(p.f(x0).item())
    f_err = max(abs(a - b) / max(abs(b), floor) for a, b in zip(f_k, f_p))
    say(f"[cli] {label}, first {iters} iterations, kernels vs plain on the "
        f"card: alpha equal {a_k == a_p}, f max rel err {f_err:.3e} (tol "
        f"{TRACE_F_RTOL})")
    check(a_k == a_p and f_err <= TRACE_F_RTOL,
          f"{label}: the kernels and their plain versions part (alphas "
          f"{a_k} vs {a_p})")
    return state


def phase_cli(dev):
    """The command line at full width, then the fused tail's forms that it
    has no flag for through minimize.  Returns the launches of each kernel
    form on these solves."""
    import tpu_lbfgs_torch as tt
    from tpu_lbfgs_torch import kernels
    from tpu_lbfgs_torch.core.direction import compute_direction_with_aux
    from tpu_lbfgs_torch.kernels import fused_ops as ops
    from tpu_lbfgs_torch.linesearch import strategies

    # The command line's own start: U(-2, 2) from numpy's default_rng(42).
    x0 = torch.from_numpy(np.random.default_rng(SEED).uniform(
        -2.0, 2.0, D)).to(dev, torch.float32)
    launches = {}

    def count(got, form=None):
        for name, n in got.items():
            if n:
                key = name if form is None or not name.endswith(
                    "_fused_tail") else f"{name}[{form}]"
                launches[key] = launches.get(key, 0) + n

    poly = ["--poly-ls", "--direction", "compact_incremental"]
    fixed = ["--max-iters", str(CLI_ITERS), "--tol", "0"]
    runs = [("rosenbrock", poly + fixed, None)]
    runs += [(q, poly, None) for q in ("quadratic", "coupled_quadratic")]
    runs += [(q, ["--line-search", ls], None)
             for ls in ("backtracking_speculative",
                        "wolfe_interpolation_speculative")
             for q in ("coupled_quadratic", "quadratic")]
    # "auto" puts the history products of a bfloat16 ring into the tail.
    runs += [("rosenbrock", poly + fixed + ["--history-dtype", "bfloat16"],
              "ring bf16, matvec m=10")]
    bf16_state = bf16_cfg = None
    for problem, flags, form in runs:
        argv = CLI_ARGS + ["--problem", problem] + flags
        label = " ".join(["--problem", problem] + flags)
        p = tt.get_problem(problem)
        f0 = p.f(x0).item()
        # A few iterations first, outside the clock and the counts.
        _cli_main(argv + ["--max-iters", str(GENERAL_WARMUP)])
        torch.cuda.synchronize()
        reset_counts()
        strategies.reset_host_reads()
        doc = _cli_main(argv)
        got = kernels.launch_counts()
        reads = strategies.host_reads["line_search"]
        rec, args = doc["results"][0], doc["config"]
        k, f = rec["iterations"], rec["f"]
        say(f"[cli] {label}: status {rec['status']}, {k} iterations in "
            f"{rec['wall_s']:.3f} s (x0 drawn inside), "
            f"{rec['wall_s'] / max(k, 1) * 1e3:.3f} ms/iteration, n_fev "
            f"{rec['n_fev']}, {reads} line-search host reads; f {f0:.6e} -> "
            f"{f:.6e}, |g| {rec['g_norm']:.4e}, guards {rec['guards']}, "
            f"launches {ran(got)}")
        check(k > 0 and np.isfinite(f) and f < f0
              and rec["status"] in ("converged", "max_iters"),
              f"{label}: f must be finite and decrease, status "
              f"{rec['status']}")
        if "--tol" in flags:
            check(k == CLI_ITERS and rec["status"] == "max_iters",
                  f"{label}: the solve must run its {CLI_ITERS} iterations")
        cfg = tt.LBFGSConfig(
            m=args["history"], max_iters=args["max_iters"], tol=args["tol"],
            line_search=args["line_search"], direction=args["direction"],
            fidelity=args["fidelity"], c1=args["c1"], c2=args["c2"],
            use_pallas=True,
            ls_eval="polynomial" if args["poly_ls"] else "direct",
            history_dtype=args["history_dtype"])
        _check_suite_launches(label, problem, cfg, k, got, reads)
        count(got, form)
        state = _kernels_vs_plain(label, tt, problem, cfg, x0,
                                  min(TRACE_ITERS, k))
        if args["history_dtype"] == "bfloat16":
            check(state.s_hist.dtype == torch.bfloat16,
                  "--history-dtype bfloat16 must store a bfloat16 ring")
            bf16_state, bf16_cfg = state, cfg

    # The combine kernel's public entry on the bfloat16 ring that solve
    # left, against the direction the solver takes from it.  The solver's
    # matrix-vector route rounds the coefficients to bfloat16, the kernel
    # keeps them float32: they may differ by 2^-8 of sum |coefficient| max
    # |row|.
    d_ref, aux, fb = compute_direction_with_aux(
        bf16_cfg.replace(direction="compact"), bf16_state)
    kernels.reset_launches()
    r_vec = ops.combine_direction(bf16_state.g, bf16_state.s_hist,
                                  bf16_state.y_hist, aux.v_phys, aux.u_phys,
                                  aux.gamma)
    n_comb = kernels.launch_counts()["combine_direction"]
    S_max = bf16_state.s_hist.float().abs().amax(-1)
    Y_max = bf16_state.y_hist.float().abs().amax(-1)
    tol = 2.0 ** -8 * ((aux.v_phys.abs() * S_max).sum()
                       + aux.gamma.abs() * (aux.u_phys.abs() * Y_max).sum()
                       ).item()
    err = (r_vec + d_ref).abs().max().item()
    say(f"[cli] combine_direction(use_pallas=True) on the bfloat16 ring "
        f"against the solver's direction: max abs err {err:.3e} (tol "
        f"{tol:.3e}, max |d| {d_ref.abs().max().item():.3e}), fallback "
        f"{bool(fb)}, launches {n_comb}")
    check(n_comb == 1 and not bool(fb) and err <= tol,
          "the combine kernel on a bfloat16 ring and the solver's direction "
          "part")
    launches["combine_direction[ring bf16]"] = n_comb

    # Through minimize: the tail with its in-kernel history products, and
    # the compensated tail (cfg.accurate_dots).
    rose = tt.get_problem("rosenbrock")
    f0 = rose.f(x0).item()
    forms = [(f"ring {h}, matvec m={m}",
              dict(m=m, history_dtype=None if h == "f32" else "bfloat16"),
              dict(with_matvec=True), CLI_ITERS if m == 10 else 40)
             for h, m in (("f32", 10), ("bf16", 10), ("f32", 5), ("f32", 20),
                          ("bf16", 5), ("bf16", 20))]
    forms.append(("ring bf16, matvec m=0", dict(history_dtype="bfloat16"),
                  dict(with_matvec=False), 40))
    forms.append(("compensated", dict(accurate_dots=True),
                  dict(with_matvec=False), CLI_ITERS))
    for form, cfg_kw, tail_kw, iters in forms:
        cfg = tt.LBFGSConfig(**{**dict(
            line_search="backtracking", direction="compact_incremental",
            m=10, use_pallas=True, ls_eval="polynomial", max_iters=iters,
            tol=0.0), **cfg_kw})
        solver = _suite_solver(tt, "rosenbrock", cfg, True, **tail_kw)
        label = f"minimize rosenbrock fused tail [{form}]"
        tt.minimize(rose.f, x0, cfg.replace(max_iters=GENERAL_WARMUP),
                    **solver)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        r = tt.minimize(rose.f, x0, cfg, **solver)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = kernels.launch_counts()
        k, f = r.iterations.item(), r.f.item()
        say(f"[cli] {label}: {k} iterations in {wall:.3f} s, "
            f"{wall / k * 1e3:.3f} ms/iteration; f {f0:.6e} -> {f:.6e}, |g| "
            f"{r.g_norm.item():.4e}, status "
            f"{tt.Status.NAMES[r.status.item()]}, guards {r.guards.tolist()}, "
            f"launches {ran(got)}")
        check(k == iters and np.isfinite(f) and f < f0,
              f"{label}: the solve must run its {iters} iterations and f "
              "fall")
        _check_suite_launches(label, "rosenbrock", cfg, k, got, 0)
        count(got, form)
        _kernels_vs_plain(label, tt, "rosenbrock", cfg, x0, TRACE_ITERS,
                          **tail_kw)

    # The with_matvec rule end to end: the same solve with the history
    # products in the tail and in the solver, in turns, on each ring.
    for h in ("f32", "bf16"):
        cfg = tt.LBFGSConfig(
            line_search="backtracking", direction="compact_incremental",
            m=10, use_pallas=True, ls_eval="polynomial", max_iters=CLI_ITERS,
            tol=0.0, history_dtype=None if h == "f32" else "bfloat16")
        walls = {False: [], True: []}
        for turn in (False, True, True, False, False, True):
            solver = _suite_solver(tt, "rosenbrock", cfg, True,
                                   with_matvec=turn)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            r = tt.minimize(rose.f, x0, cfg, **solver)
            torch.cuda.synchronize()
            walls[turn].append((time.perf_counter() - t0) / CLI_ITERS * 1e3)
            check(r.iterations.item() == CLI_ITERS, "the solve must run on")
            _check_suite_launches(f"with_matvec={turn}, ring {h}",
                                  "rosenbrock", cfg, CLI_ITERS,
                                  kernels.launch_counts(), 0)
        say(f"[cli] with_matvec end to end, ring {h}, m=10, {CLI_ITERS} "
            f"iterations each, ms/iteration in turns: in the solver "
            f"{[round(w, 3) for w in walls[False]]}, in the tail "
            f"{[round(w, 3) for w in walls[True]]}")
    return launches


def phase_routing(dev):
    """No wrapper leaves a tensor on the card to its plain version by
    itself: what a problem-specific kernel is not built for (another dtype
    than float32) raises, and the entries that know the dtype route it in
    the open, with a warning.  The tail's products take any depth."""
    import warnings

    import tpu_lbfgs_torch as tt
    from tpu_lbfgs_torch import kernels
    from tpu_lbfgs_torch.kernels import fused_ops as ops
    from tpu_lbfgs_torch.kernels import line_search_ops as ls

    n, problem = 4096, "rosenbrock"
    x64 = torch.linspace(-1.0, 1.0, n, dtype=torch.float64, device=dev)
    a64 = torch.full((1,), 0.125, dtype=torch.float64, device=dev)
    k64 = torch.tensor([0.5, 0.25, 0.125], dtype=torch.float64, device=dev)
    e2, e4 = (torch.zeros(c, dtype=torch.float32, device=dev) for c in (2, 4))
    refused = {
        "fused_vg": lambda: ops.fused_vg(problem, x64),
        "fused_tail": lambda: tt.fused_tail_for(problem)(x64, x64, a64, x64),
        "multi_phi": lambda: tt.multi_phi_for(problem)(x64, x64, k64),
        "multi_phi_dphi": lambda: tt.multi_phi_dphi_for(problem)(x64, x64,
                                                               k64),
        "local_fused_vg": lambda: ops.local_fused_vg(problem, x64, n, 0, e2),
        "local_fused_tail": lambda: ops.local_fused_tail(
            problem, x64, x64, a64, x64, None, None, False, n, 0, e4),
        "local_multi_phi": lambda: ls.local_multi_phi(problem, x64, x64, k64,
                                                      n, 0, e2),
        "local_multi_phi_dphi": lambda: ls.local_multi_phi_dphi(
            problem, x64, x64, k64, n, 0, e4),
    }
    kernels.reset_launches()
    for name, call in refused.items():
        try:
            call()
        except TypeError:
            continue
        check(False, f"{name} must raise TypeError for a float64 tensor on "
              "the card")
    check(not any(kernels.launch_counts().values()),
          "a refused call must launch nothing")

    def caught(fn):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = fn()
        return out, [str(w.message) for w in seen]

    # --pallas --dtype float64: the command line warns and hands the solver
    # the plain versions; no problem-specific kernel runs, and it says so.
    argv = ["--problem", problem, "--dim", str(n), "--dtype", "float64",
            "--pallas", "--json", "--poly-ls", "--direction",
            "compact_incremental", "--max-iters", "5", "--tol", "0"]
    kernels.reset_launches()
    doc, said = caught(lambda: _cli_main(argv))
    got = kernels.launch_counts()
    check(doc["results"][0]["iterations"] == 5
          and any("float32 programs" in w for w in said)
          and not any(got.values()),
          f"--pallas --dtype float64 must warn and run the plain versions, "
          f"warnings {said}, launches {ran(got)}")
    # with_matvec=True at m = 7: the products take any depth, so
    # fused_tail_for builds them without a word, and the tail kernel
    # launches every iteration with t1 and t2.
    x32 = x64.float()
    ring = torch.zeros(7, n, dtype=torch.float32, device=dev)
    p = tt.get_problem(problem)
    cfg = tt.LBFGSConfig(m=7, line_search="backtracking",
                         direction="compact_incremental",
                         ls_eval="polynomial", use_pallas=True, max_iters=5,
                         tol=0.0)
    tail, said7 = caught(lambda: tt.fused_tail_for(
        problem, with_matvec=True, m=7, d=n))
    t1 = tail(x32, x32, a64.float(), x32, ring, ring)[11]
    reset_counts()
    r = tt.minimize(p.f, x32, cfg, dir_poly=p.dir_poly, fused_tail=tail,
                    value_and_grad=tt.fused_value_and_grad(problem))
    got = kernels.launch_counts()
    check(not said7 and t1.shape == (7,) and int(r.iterations) == 5
          and one_per_iteration(f"{problem}_fused_tail", 5)
          and got[f"{problem}_vg"] == 1,
          f"with_matvec=True at m = 7 must launch the tail with its products "
          f"without a warning, warnings {said7}, launches {ran(got)}")
    say(f"[route] float64 tensors on the card: all {len(refused)} "
        "problem-specific wrappers raise TypeError; --pallas --dtype float64 "
        "warns and runs the plain versions (no launch); "
        "fused_tail_for(with_matvec=True, m=7) launches the tail with its "
        f"products, no warning ({ran(got)})")


def phase_bench_batch(card):
    from tpu_lbfgs_torch.bench.harness import bench_batch

    r = bench_batch(problem="rosenbrock", batch=BATCH, d=BATCH_D,
                    iters=BATCH_ITERS, repeats=3)
    check(np.isfinite(r.final_f) and r.iterations == BATCH_ITERS,
          "bench_batch must finish its iterations with a finite f")
    d = r.details
    say(f"[bench] {r.name}: {r.iters_per_s:.2f} instance-iterations/s "
        f"({BATCH_ITERS} iterations of {BATCH} lanes, best of 3 runs "
        f"{r.wall_s:.4f} s, runs "
        f"{[round(w, 4) for w in d['repeat_walls_s']]}, status "
        f"counts {d['status_counts']}; graphs captured in the warm-up run "
        f"in {d['capture_s']:.3f} s, {d['host_reads_per_solve']:.0f} host "
        f"reads per timed solve) on {card}")


# [cpu-baseline]: the C++ oracle (tpu_lbfgs_torch.native, native/oracle.cpp
# built by g++ at first use) on the host, after [bench].  bench_cpu_native at
# bench.py's d for CPU_ITERS iterations, best of 3, beside [bench]'s
# bench_gpu rate (bench.py's ratio: the main path against the oracle's
# reference algorithm, two_loop and direct Armijo backtracking).  The oracle
# against minimize in float64 on the card (plain versions, the same
# algorithm) from -1.2 + U(-0.1, 0.1) at d = 2^20 over CPU_ITERS
# iterations: statuses equal and f within CPU_F_RTOL at every iteration (the
# two add their sums in other orders).  time_to_tolerance_refined with the
# oracle's float64 stage at TOL_D; run_protocol with the oracle's cells at
# PROTOCOL_D, seeds PROTOCOL_SEEDS, for Armijo Backtracking, which iterates
# on both backends from the published box, so that its row has
# cuda_per_iter_speedup; --backend native against native_lbfgs.
CPU_ITERS = 20
CPU_F_RTOL = 1e-6
CPU_CLI_ARGS = ["--backend", "native", "--problem", "rosenbrock", "--dim",
                "1000", "--json"]


def phase_cpu_baseline(card, gpu_rate):
    import tpu_lbfgs_torch as tt
    from tpu_lbfgs_torch.bench.harness import (
        bench_cpu_native,
        host_cpu,
        time_to_tolerance_refined,
    )
    from tpu_lbfgs_torch.bench.reference_protocol import (
        TABLE_I_STRATEGIES,
        run_protocol,
    )
    from tpu_lbfgs_torch.native import binding, native_lbfgs

    cpu = host_cpu()
    t0 = time.perf_counter()
    lib = binding.build()
    say(f"[cpu-baseline] C++ oracle built by g++ "
        f"{' '.join(binding.CXX_FLAGS)} in {time.perf_counter() - t0:.2f} s "
        f"({lib.parent.name}); host CPU {cpu}, {os.cpu_count()} logical "
        "cores, the oracle on one")

    r = bench_cpu_native(problem="rosenbrock", d=D, iters=CPU_ITERS,
                         repeats=3)
    check(np.isfinite(r.final_f) and r.iterations == CPU_ITERS,
          "bench_cpu_native must finish its iterations with a finite f")
    say(f"[cpu-baseline] {r.name}: {r.iters_per_s:.3f} iterations/s "
        f"({CPU_ITERS} iterations, float64, best of 3 runs {r.wall_s:.4f} s, "
        f"runs {[round(w, 4) for w in r.details['repeat_walls_s']]}) on "
        f"{cpu}; [bench] bench_gpu {gpu_rate:.2f} iterations/s on {card}: "
        f"{gpu_rate / r.iters_per_s:.2f}x the CPU baseline per iteration")

    # The same algorithm on both sides: the oracle on the host, minimize in
    # float64 on the card.
    x0 = -1.2 + np.random.default_rng(SEED).uniform(-0.1, 0.1, D)
    cfg = tt.LBFGSConfig(line_search="backtracking", direction="two_loop",
                         max_iters=CPU_ITERS, tol=0.0, record_trace=True)
    t0 = time.perf_counter()
    nat = native_lbfgs("rosenbrock", x0, cfg, record_trace=True)
    nat_s = time.perf_counter() - t0
    p = tt.get_problem("rosenbrock")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = tt.minimize(p.f, torch.from_numpy(x0).cuda(), cfg, grad=p.grad)
    k = int(res.iterations)
    card_s = time.perf_counter() - t0
    # The oracle's trace_f[i] is f before step i, the solver's after it.
    f_nat = np.append(nat["trace_f"][1:], nat["f"])
    f_card = res.trace.f[:k].cpu().numpy()
    status = tt.Status.NAMES[int(res.status)]
    rel = (np.abs(f_card - f_nat[:k]) / np.abs(f_nat[:k])).max() if k \
        else np.inf
    alphas = int((res.trace.alpha[:k].cpu().numpy()
                  == nat["trace_alpha"][:k]).sum())
    say(f"[cpu-baseline] native_lbfgs vs minimize float64 on the card, "
        f"backtracking, two_loop, d={D} from -1.2 + U(-0.1, 0.1): "
        f"{nat['status']} / {status} after {nat['iterations']} / {k} "
        f"iterations, f {nat['f']:.12g} / {float(res.f):.12g}, largest "
        f"relative f difference over the iterations {rel:.3e}, {alphas} of "
        f"{k} alphas equal, n_fev {nat['n_fev']} / {int(res.n_fev)}; "
        f"{nat_s:.3f} s on the host, {card_s:.3f} s on {card}")
    check(nat["status"] == status and nat["iterations"] == k == CPU_ITERS
          and rel <= CPU_F_RTOL,
          f"[cpu-baseline] the oracle and the float64 solve must agree in "
          f"status and in f within {CPU_F_RTOL} at every iteration")

    rt = time_to_tolerance_refined(d=TOL_D, refine_backend="native")
    say(f"[cpu-baseline] time_to_tolerance_refined(d={TOL_D}, coarse_tol="
        f"1e-3, tol=1e-5, refine_backend='native'): {json.dumps(rt)}; the "
        f"float64 stage on {cpu}")
    check(rt["status"] == "converged" and rt["g_norm"] <= 1e-5
          and rt["refine_iterations"] <= TOL_REFINE_MAX,
          f"[cpu-baseline] the oracle's stage must converge to 1e-5 within "
          f"{TOL_REFINE_MAX} iterations")

    report = run_protocol(problem="rosenbrock", dims=(PROTOCOL_D,),
                          seeds=PROTOCOL_SEEDS, out=None, isolate=False,
                          strategies=TABLE_I_STRATEGIES[:1])
    for c in report["cells"]:
        say(f"[cpu-baseline] protocol d={PROTOCOL_D} {c['backend']}: "
            f"{c.get('statuses')}, iterations "
            f"{c.get('per_seed_iterations')}, walls "
            f"{c.get('per_seed_wall_s')} s, {c.get('iters_per_s')} it/s "
            f"on {c.get('device')}")
    rows = report["per_iteration_speedups"]
    say(f"[cpu-baseline] per-iteration rows (card {card}, host {cpu}): "
        f"{json.dumps(rows)}")
    check(len(rows) == 1 and rows[0].get("cuda_per_iter_speedup"),
          "[cpu-baseline] the protocol must give a cuda_per_iter_speedup "
          "row for Armijo Backtracking")

    rec = _cli_main(CPU_CLI_ARGS)["results"][0]
    want = native_lbfgs("rosenbrock",
                        np.random.default_rng(42).uniform(-2.0, 2.0, 1000),
                        tt.LBFGSConfig())
    say(f"[cpu-baseline] cli {' '.join(CPU_CLI_ARGS)}: {json.dumps(rec)}")
    check(all(rec[key] == want[key] for key in
              ("status", "iterations", "f", "g_norm", "n_fev", "n_gev")),
          "[cpu-baseline] --backend native must give native_lbfgs's solve "
          "of the same x0")


# --- the sharded solve -------------------------------------------------------
# The shard-local kernel forms: d, the shard counts, and the depth of the
# ring for t1 and t2.  Each shard's kernel against its plain version:
# vectors bit for bit, the float64 sums within TRIAL_SUM_RTOL of the whole
# vector's sum|terms|; the shards' vectors joined against the whole-vector
# kernel's bit for bit, and their sums added against its float32 sums within
# the same bound plus one float32 ulp.
SHARD_COUNTS = (4, 3)
SHARD_M = 10
# The [dist] phase: ranks on the one card (gloo), the global d (d_local =
# 2^20, the size every kernel is timed at), and its depth.  Against the
# single-device port at the same d: the first TRACE_ITERS alphas and the
# status equal, f over those iterations within DIST_F_RTOL.  The two float32
# solves differ in how their sums are added (the kernels' by the order of
# float64 additions; dir_poly's coefficients and the history products in
# float32 on one device, as float64 partials across shards), and a
# Rosenbrock trajectory amplifies last bits: after 20 iterations each stood
# 3e-5 to 9e-5 from the same solve in float64 and 1e-4 from the other.
# Where they part by more than DIST_F_WITNESS, that float64 solve is run and
# printed beside them.
DIST_RANKS = 4
DIST_D = 1 << 22
DIST_ITERS = 100
DIST_SHORT_ITERS = 40
DIST_F_RTOL = 1e-3
DIST_F_WITNESS = 1e-6       # beyond it a float64 solve is run as the witness
DIST_TIMEOUT_S = 300.0
# The shard-local kernel checks also run at the shapes the [dist] phase
# hands the kernels: d = 2^22 and 2^22 + 37 in 4 shards (d_local = 2^20 and
# 2^20 + 10, start = r d_local).
SHARD_FULL_WIDTH = ((DIST_D, DIST_RANKS), (DIST_D + 37, DIST_RANKS))


def _shard_inputs(n, shards, dev):
    """Global x, d, g of n elements and an (m, n) ring, zero-padded to a
    multiple of the shard count."""
    x, d, g = _kernel_inputs(n, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    S, Y = (_ring(gen, SHARD_M, n, dev, torch.float32) for _ in range(2))
    pad = (-n) % shards
    padded = [torch.nn.functional.pad(t, (0, pad)) for t in (x, d, g, S, Y)]
    return (x, d, g, S, Y), padded


def _block(t, r, d_local):
    return t[..., r * d_local:(r + 1) * d_local].clone(
        memory_format=torch.contiguous_format)


def _shard_edges(xp, dp, r, d_local):
    """The four boundary values of shard r, [prev x, prev d, next x, next
    d], wrapping around at the two ends as the exchange does."""
    lo, hi = r * d_local - 1, ((r + 1) * d_local) % xp.numel()
    return torch.stack([xp[lo], dp[lo], xp[hi], dp[hi]])


def phase_shard_kernels(dev):
    """The shard-local forms of the four kernel families, in one process:
    each shard is handed its block, its start and its edges."""
    from tpu_lbfgs_torch.bench import trial_bounds
    from tpu_lbfgs_torch.dist.shardmap_vg import local_vg_plain
    from tpu_lbfgs_torch.kernels import fused_ops as ops
    from tpu_lbfgs_torch.kernels import line_search_ops as ls

    rng = np.random.default_rng(SEED)
    alpha = torch.full((), 0.125, dtype=torch.float32, device=dev)
    worst = {}      # largest |kernel - plain| per (problem, family)
    shapes = list(itertools.product(TAIL_D, SHARD_COUNTS))
    shapes += list(SHARD_FULL_WIDTH)
    for problem, (n, shards) in itertools.product(ops.BODY_IDS, shapes):
        (x, d, g, S, Y), (xp, dp, gp, Sp, Yp) = _shard_inputs(n, shards, dev)
        d_local = xp.numel() // shards
        alphas = {k: torch.from_numpy(
            2.0 ** rng.integers(-6, 3, k) * rng.uniform(0.5, 1.0, k)).to(
            device=dev, dtype=torch.float32) for k in TRIALS}
        # The whole-vector kernels and the scale of each sum.
        f_w, g_w = ops.fused_vg(problem, x)
        tail_w = ops._fused_tail_kernel(problem, x, d, alpha.reshape(1), g, S,
                                        Y, True, False)
        xn, gn, sr, yr = (tail_w[i].double() for i in (0, 2, 3, 4))
        dd, gg = d.double(), g.double()
        yS, yY = (S.double() * yr).abs().sum(-1), (Y.double() * yr).abs().sum(-1)
        tail_scales = torch.cat([torch.stack([
            _f_abs_terms(problem, xn), (sr * yr).abs().sum(), (yr * yr).sum(),
            (gn * gn).sum(), (dd * gn).abs().sum(), (gg * gn).abs().sum(),
            (yr * gn).abs().sum()]), yS, yY])
        tail_sums_w = torch.cat([torch.stack([tail_w[1], *tail_w[5:11]]),
                                 tail_w[11], tail_w[12]])
        trial_w = {k: (ls._launch("multi_phi", problem, x, d, a, 1),
                       ls._launch("multi_phi_dphi", problem, x, d, a, 2))
                   for k, a in alphas.items()}
        trial_scales = {k: _trial_abs_terms(problem, x, d, a)
                        for k, a in alphas.items()}
        vg_scale = _f_abs_terms(problem, x.double())

        parts = {"g": [], "tail": [[], [], [], []]}
        sums = {"f": 0.0, "tail": 0.0,
                **{("phi", k): 0.0 for k in TRIALS},
                **{("dphi", k): 0.0 for k in TRIALS}}
        errs = {"vg": 0.0, "tail": 0.0, "multi_phi": 0.0,
                "multi_phi_dphi": 0.0}
        abs_errs = dict(errs)
        same = True
        for r in range(shards):
            start = r * d_local
            xl, dl, gl, Sl, Yl = (_block(t, r, d_local)
                                  for t in (xp, dp, gp, Sp, Yp))
            e4 = _shard_edges(xp, dp, r, d_local)
            e_vg, e_phi = e4[[0, 2]].contiguous(), e4[2:].contiguous()
            # value and gradient
            f_k, g_k = ops.local_fused_vg(problem, xl, n, start, e_vg)
            f_p, g_p = local_vg_plain(problem, xl, n, start, e_vg)
            same &= torch.equal(g_k, g_p)
            abs_errs["vg"] = max(abs_errs["vg"],
                                 (g_k - g_p).abs().max().item())
            errs["vg"] = max(errs["vg"], ((f_k - f_p).abs() / vg_scale).item())
            parts["g"].append(g_k)
            sums["f"] = sums["f"] + f_k
            # the tail with t1, t2
            out_k = ops.local_fused_tail(problem, xl, dl, alpha, gl, Sl, Yl,
                                         True, n, start, e4)
            same &= torch.equal(out_k[4], ops.local_fused_tail(
                problem, xl, dl, alpha, gl, Sl, Yl, True, n, start, e4)[4])
            out_p = ops.fused_tail_local_plain(problem, xl, dl, alpha, gl, Sl,
                                               Yl, True, n, start, e4)
            for i in range(4):
                same &= torch.equal(out_k[i], out_p[i])
                abs_errs["tail"] = max(
                    abs_errs["tail"],
                    (out_k[i].float() - out_p[i].float()).abs().max().item())
                parts["tail"][i].append(out_k[i])
            errs["tail"] = max(errs["tail"], ((out_k[4] - out_p[4]).abs()
                                              / tail_scales).max().item())
            sums["tail"] = sums["tail"] + out_k[4]
            # the K-trial evaluators
            for k, a in alphas.items():
                f_abs, g_abs = trial_scales[k]
                phi_k = ls.local_multi_phi(problem, xl, dl, a, n, start, e_phi)
                phi_p = ls.multi_phi_local_plain(problem, xl, dl, a, n, start,
                                                 e_phi)
                fk, gk = ls.local_multi_phi_dphi(problem, xl, dl, a, n, start,
                                                 e4)
                same &= all(map(torch.equal, (fk, gk), ls.local_multi_phi_dphi(
                    problem, xl, dl, a, n, start, e4)))
                fp, gp_ = ls.multi_phi_dphi_local_plain(problem, xl, dl, a, n,
                                                        start, e4)
                errs["multi_phi"] = max(
                    errs["multi_phi"], ((phi_k - phi_p).abs() / f_abs).max().item())
                errs["multi_phi_dphi"] = max(
                    errs["multi_phi_dphi"],
                    ((fk - fp).abs() / f_abs).max().item(),
                    ((gk - gp_).abs() / g_abs).max().item())
                abs_errs["multi_phi"] = max(
                    abs_errs["multi_phi"], (phi_k - phi_p).abs().max().item())
                abs_errs["multi_phi_dphi"] = max(
                    abs_errs["multi_phi_dphi"], (fk - fp).abs().max().item(),
                    (gk - gp_).abs().max().item())
                sums["phi", k] = sums["phi", k] + phi_k
                sums["dphi", k] = sums["dphi", k] + torch.cat([fk, gk])
        torch.cuda.synchronize()
        # Joined vectors against the whole-vector kernels; the padded tail
        # must be zero in g, g_new, s and y.
        joined = [torch.cat(parts["g"])] + [torch.cat(v)
                                            for v in parts["tail"]]
        whole = [g_w, tail_w[0], tail_w[2], tail_w[3], tail_w[4]]
        joined_same = all(torch.equal(j[:n], w) for j, w in zip(joined, whole))
        pad_zero = all(not j[n:].any().item()
                       for j in (joined[0], joined[2], joined[3], joined[4]))
        over = max(
            _beyond_ulp(sums["f"].float(), f_w, vg_scale),
            _beyond_ulp(sums["tail"].float(), tail_sums_w, tail_scales),
            *(_beyond_ulp(sums["phi", k].float(), trial_w[k][0],
                          trial_scales[k][0]) for k in TRIALS),
            *(_beyond_ulp(sums["dphi", k].float(), trial_w[k][1],
                          torch.cat(trial_scales[k])) for k in TRIALS))
        say(f"[kernel] shard-local {problem} d={n} in {shards} shards "
            f"(d_local {d_local}): vectors bit-equal to the plain versions "
            f"and the tail's and multi_phi_dphi's sums to a second call's "
            f"{same}, joined bit-equal to the whole-vector kernels "
            f"{joined_same}, padded tail zero {pad_zero}; float64 sums "
            f"against plain: vg {errs['vg']:.2e}, tail with t1, t2 (m = "
            f"{SHARD_M}) {errs['tail']:.2e}, multi_phi {errs['multi_phi']:.2e}"
            f", multi_phi_dphi {errs['multi_phi_dphi']:.2e} of sum|terms| "
            f"(tol {TRIAL_SUM_RTOL}); added sums against the whole-vector "
            f"kernels {over:.2e} beyond 1 ulp (tol {TRIAL_SUM_RTOL})")
        check(same and joined_same and pad_zero,
              f"shard-local {problem} vectors differ at d={n}, {shards} shards")
        check(max(errs.values()) <= TRIAL_SUM_RTOL and over <= TRIAL_SUM_RTOL,
              f"shard-local {problem} sums differ at d={n}, {shards} shards")
        for family, e in abs_errs.items():
            worst[problem, family] = max(worst.get((problem, family), 0.0), e)

    # Times at d_local = 2^20: shard 1 of 4 of a global d = 2^22, beside the
    # whole-vector kernel on the same block.  max_abs_err is the largest
    # |kernel - plain| over every shape above, all four shards of this one
    # included (SHARD_FULL_WIDTH).
    rec = {}
    n = DIST_RANKS * D
    x, d, g = _kernel_inputs(n, dev)
    xl, dl, gl = (_block(t, 1, D) for t in (x, d, g))
    e4 = _shard_edges(x, d, 1, D)
    e_vg, e_phi = e4[[0, 2]].contiguous(), e4[2:].contiguous()
    a8, a36 = (torch.linspace(1e-3, 1.0, k, device=dev) for k in TRIALS)
    for problem in ops.BODY_IDS:
        body_ops = {"quadratic": 4, "rosenbrock": 18,
                    "coupled_quadratic": 9}[problem]
        trial = {
            "multi_phi": trial_bounds.trial_bound(
                "multi_phi", problem, D, 8, 8 * D + 4 * 8 + 8 * 8 + 8),
            "multi_phi_dphi": trial_bounds.trial_bound(
                "multi_phi_dphi", problem, D, 36,
                8 * D + 4 * 36 + 16 * 36 + 16)}
        tail = ops.make_fused_tail(problem, None, with_matvec=False)
        forms = {
            "vg": (lambda: ops.local_fused_vg(problem, xl, n, D, e_vg),
                   lambda: local_vg_plain(problem, xl, n, D, e_vg),
                   lambda: ops.fused_vg(problem, xl),
                   bound_ms(8 * D + 8 + 8, body_ops * D)),
            "fused_tail": (
                lambda: ops.local_fused_tail(problem, xl, dl, alpha, gl, None,
                                             None, False, n, D, e4),
                lambda: ops.fused_tail_local_plain(
                    problem, xl, dl, alpha, gl, None, None, False, n, D, e4),
                lambda: tail(xl, dl, alpha.reshape(1), gl),
                bound_ms(28 * D + 4 + 56 + 16, (body_ops + 22) * D)),
            "multi_phi": (
                lambda: ls.local_multi_phi(problem, xl, dl, a8, n, D, e_phi),
                lambda: ls.multi_phi_local_plain(problem, xl, dl, a8, n, D,
                                                 e_phi),
                lambda: ls._launch("multi_phi", problem, xl, dl, a8, 1),
                trial["multi_phi"]["old"]),
            "multi_phi_dphi": (
                lambda: ls.local_multi_phi_dphi(problem, xl, dl, a36, n, D,
                                                e4),
                lambda: ls.multi_phi_dphi_local_plain(problem, xl, dl, a36, n,
                                                      D, e4),
                lambda: ls._launch("multi_phi_dphi", problem, xl, dl, a36, 2),
                trial["multi_phi_dphi"]["old"]),
        }
        for family, (local, plain, whole, bound) in forms.items():
            name = f"{problem}_{family}_local"
            r = rec[name] = {"max_abs_err": worst[problem, family.replace(
                "fused_tail", "tail")], "ms": device_ms(local),
                "plain_ms": device_ms(plain), "bound": bound}
            note = (f"; {trial_bound_note(trial[family], r['ms'])}"
                    if family in trial else "")
            say(f"[kernel] {name} d_local={D} (of d={n}): {r['ms'] * 1e3:.2f}"
                f" us on the card, the whole-vector kernel on the same block "
                f"{device_ms(whole) * 1e3:.2f} us, plain version "
                f"{r['plain_ms'] * 1e3:.2f} us, bound {bound[0] * 1e3:.2f} us "
                f"by {bound[1]}{note}")
    return rec


def _dist_jobs():
    """The sharded solves of the [dist] phase: (label, problem, d, iterations,
    config keywords, sharded_minimize keywords)."""
    poly = dict(line_search="backtracking", direction="compact_incremental",
                ls_eval="polynomial")
    spec = dict(direction="compact_incremental", ls_eval="direct")
    jobs = [("main", "rosenbrock", DIST_D, DIST_ITERS, poly, {})]
    for problem in ("coupled_quadratic", "rosenbrock", "quadratic"):
        # Rosenbrock runs on at tol = 0: the iterations that are compared.
        iters = TRACE_ITERS if problem == "rosenbrock" else DIST_SHORT_ITERS
        for search in ("backtracking_speculative",
                       "wolfe_interpolation_speculative"):
            jobs.append((f"{problem} {search}", problem, DIST_D, iters,
                         dict(spec, line_search=search), {}))
    jobs += [
        ("t1, t2 in the tail on a bf16 ring", "rosenbrock", DIST_D,
         DIST_SHORT_ITERS, dict(poly, history_dtype="bfloat16"),
         dict(with_matvec=True)),
        ("unaligned d", "rosenbrock", DIST_D + 37, DIST_SHORT_ITERS, poly, {}),
        ("quadratic polynomial", "quadratic", DIST_D, DIST_SHORT_ITERS, poly,
         {}),
    ]
    return jobs


def _dist_x0(d, dev):
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.uniform(-2.0, 2.0, d)).to(
        device=dev, dtype=torch.float32)


def _dist_cfg_kw(problem, iters, cfg_kw):
    # Rosenbrock runs its iterations at tol = 0; the quadratics converge at
    # the default tol = 1e-5 in a few, as on the command line.
    tol = 0.0 if problem == "rosenbrock" else 1e-5
    return dict(m=10, use_pallas=True, max_iters=iters, tol=tol,
                record_trace=True, **cfg_kw)


def phase_dist(dev, card):
    """The sharded solve at full width: DIST_RANKS processes on the one card
    (gloo; NCCL takes one rank per card), each through the shard-local
    kernels, against the single-device port at the same d."""
    import tpu_lbfgs_torch as tt
    from tpu_lbfgs_torch.dist.launch import spawn_ranks

    from tpu_lbfgs_torch.dist.launch import solve_cases

    jobs = _dist_jobs()
    # x0 ~ U(-2, 2) from SEED, as _dist_x0 draws it for the single device.
    cases = [dict(problem=problem, d=d, dtype="float32", seed=SEED, box=2.0,
                  cfg=_dist_cfg_kw(problem, iters, cfg_kw), kw=kw,
                  gather=False)
             for _, problem, d, iters, cfg_kw, kw in jobs]
    t0 = time.perf_counter()
    ranks = spawn_ranks(solve_cases, DIST_RANKS, cases, "cuda:0",
                        backend="gloo", timeout_s=DIST_TIMEOUT_S,
                        threads=None)
    say(f"[dist] {DIST_RANKS} ranks on {card} (gloo, one process each, all "
        f"on cuda:0), {len(jobs)} solves in "
        f"{time.perf_counter() - t0:.1f} s with start-up.  The ranks share "
        "one card, so the times below are a correctness run's cost, not a "
        "scaling number.")
    launches = {}
    for j, (label, problem, d, iters, cfg_kw, kw) in enumerate(jobs):
        per_rank = [r[j] for r in ranks]
        for r in per_rank:
            r["alphas"] = r["trace"]["alpha"].tolist()
            r["fs"] = r["trace"]["f"].tolist()
        r0 = per_rank[0]
        for key in ("f", "alphas", "fs", "status", "iterations", "n_fev",
                    "all_reduces", "edge_exchanges"):
            check(all(r[key] == r0[key] for r in per_rank),
                  f"[dist] {label}: the ranks disagree on {key}")
        k = r0["iterations"]
        d_local = -(-d // DIST_RANKS)
        check(all(r["x_local_shape"] == (d_local,) and r["x_local_finite"]
                  for r in per_rank) and np.isfinite(r0["f"]),
              f"[dist] {label}: each rank must hold a finite ({d_local},) "
              "block and a finite f")
        # The same solve on one device, whole vector.
        p = tt.get_problem(problem)
        cfg = tt.LBFGSConfig(**_dist_cfg_kw(problem, iters, cfg_kw))
        tail_kw = {}
        if "with_matvec" in kw:
            tail_kw["with_matvec"] = kw["with_matvec"]
        solver = _suite_solver(tt, problem, cfg, True, **tail_kw)
        single = tt.minimize(p.f, _dist_x0(d, dev), cfg, **solver)
        a_s, f_s = single.trace.alpha.tolist(), single.trace.f.tolist()
        # Compared over the iterations that start with f above 1e-9 of the
        # first f: below it a float32 quadratic's Armijo test is decided by
        # rounding, and the two solves (whose sums differ in their last
        # bits) backtrack apart on their way to the same minimum.
        f0 = abs(p.f(_dist_x0(d, dev)).item())
        floor = 1e-9 * f0
        n_cmp = 0
        while (n_cmp < min(TRACE_ITERS, k, int(single.iterations))
               and min(([f0] + r0["fs"])[n_cmp], ([f0] + f_s)[n_cmp]) > floor):
            n_cmp += 1
        f_err = max((abs(a - b) / max(abs(b), floor) for a, b in
                     zip(r0["fs"][:n_cmp], f_s[:n_cmp])), default=0.0)
        same_alpha = r0["alphas"][:n_cmp] == a_s[:n_cmp]
        f_end = abs(r0["f"] - single.f.item()) / max(abs(single.f.item()),
                                                     floor)
        vg = r0["launches"].get(f"{problem}_vg_local", 0)
        tail = r0["launches"].get(f"{problem}_fused_tail_local", 0)
        say(f"[dist] {label}: {problem} d={d} (d_local {d_local}) "
            f"{cfg.line_search}/{cfg.ls_eval}, {k} iterations, status "
            f"{tt.Status.NAMES[r0['status']]} (single device "
            f"{tt.Status.NAMES[int(single.status)]}), f {r0['f']:.6e}; per "
            f"rank: launches {r0['launches']}, "
            f"{r0['all_reduces'] / k:.2f} all-reduces and "
            f"{r0['edge_exchanges'] / k:.2f} edge exchanges per iteration, "
            f"{r0['wall_s'] / k * 1e3:.2f} ms per iteration (4 ranks sharing "
            f"the card: not a scaling number); against the single-device "
            f"port: first {n_cmp} alphas equal {same_alpha}, f over them "
            f"within {f_err:.2e} (tol {DIST_F_RTOL}), final f within "
            f"{f_end:.2e}")
        check(all(r["launches"] == r0["launches"] for r in per_rank),
              f"[dist] {label}: the ranks' launch counts differ")
        check(tail == k and vg >= 1 and (vg == 1 or cfg.ls_eval == "direct"),
              f"[dist] {label}: each rank must launch the shard-local tail "
              f"once per iteration and vg once per solve, got "
              f"{r0['launches']}")
        check(all(name.endswith("_local") for name in r0["launches"]),
              f"[dist] {label}: a whole-vector kernel ran on a shard: "
              f"{r0['launches']}")
        if cfg.ls_eval == "direct":
            own = (f"{problem}_multi_phi_local"
                   if cfg.line_search == "backtracking_speculative"
                   else f"{problem}_multi_phi_dphi_local")
            check(r0["launches"].get(own, 0) >= k,
                  f"[dist] {label}: {own} must launch at least once per "
                  f"iteration, got {r0['launches']}")
        if problem == "quadratic":
            check(r0["edge_exchanges"] == 0,
                  "[dist] the quadratic has no chain terms and must exchange "
                  "no edges")
        else:
            check(r0["edge_exchanges"] >= k,
                  f"[dist] {label}: a chain problem exchanges its edges")
        check(n_cmp >= 1 and r0["status"] == int(single.status)
              and same_alpha and f_err <= DIST_F_RTOL,
              f"[dist] {label}: the sharded solve parts from the "
              f"single-device port (alphas {r0['alphas'][:n_cmp]} vs "
              f"{a_s[:n_cmp]})")
        for name, count in r0["launches"].items():
            launches.setdefault(name, count)
        n_all = min(TRACE_ITERS, k, int(single.iterations))
        if n_cmp < n_all or f_err > DIST_F_WITNESS:
            # Where the two float32 solves part (in f beyond DIST_F_WITNESS,
            # or in alpha past the floor), the witness is the same solve in
            # float64 on one device (plain versions, the same x0 widened):
            # it says which of the two carries the rounding.
            wide = tt.minimize(p.f, _dist_x0(d, dev).double(),
                               cfg.replace(use_pallas=False),
                               **_suite_solver(tt, problem, cfg, False,
                                               **tail_kw))
            a_w, f_w = (t.tolist()[:n_all] for t in (wide.trace.alpha,
                                                     wide.trace.f))

            def f_off(fs):
                return max((abs(a - b) / max(abs(b), floor)
                            for a, b in zip(fs[:n_cmp], f_w)), default=0.0)

            line = (f"[dist] {label}: witness, float64 on one device "
                    f"({int(wide.iterations)} iterations, status "
                    f"{tt.Status.NAMES[int(wide.status)]}, f "
                    f"{wide.f.item():.6e}): f over the first {n_cmp} "
                    f"iterations against it: sharded float32 within "
                    f"{f_off(r0['fs']):.2e}, single-device float32 within "
                    f"{f_off(f_s):.2e}")
            if n_cmp < n_all:
                line += (f"; alphas of iterations {n_cmp + 1}-{n_all}: "
                         f"sharded float32 {r0['alphas'][n_cmp:n_all]}, "
                         f"single-device float32 {a_s[n_cmp:n_all]}, float64 "
                         f"{a_w[n_cmp:]}; equal to the float64 solve's: "
                         f"sharded {r0['alphas'][n_cmp:n_all] == a_w[n_cmp:]}"
                         f", single-device float32 "
                         f"{a_s[n_cmp:n_all] == a_w[n_cmp:]}")
            say(line)
    return launches


# --- the batch on the 2-D mesh ([dist-batch]) ------------------------------
# sharded_vmap_minimize on DB_RANKS processes laid out as a DB_ROWS x
# (DB_RANKS / DB_ROWS) (b, d) mesh on the one card (gloo), DB_BATCH instances
# of DB_D: each rank holds DB_LANES lanes of d_local = 2^20, the width every
# kernel is timed at.  First the batched shard-local kernels in one process,
# shards emulated by start and edges, at DB_KERNEL_SHAPES (lanes, global d)
# in DB_SHARDS shards: DB_LANES lanes of 2^21, of DB_RAGGED (d_local = 2^20
# + 10, shard 1 ending in padding) and the batch cell cut in two (4096 lanes
# of d_local = 512).  Each against its batched plain version (vectors bit
# for bit, float64 sums within TRIAL_SUM_RTOL of the lane's sum|terms|),
# every lane against the one-instance shard-local kernel on that lane alone
# (the same rule), and lane 0 bit for bit, sums included, when every other
# lane's inputs are replaced (no value crosses a lane).  Then the solves,
# each lane against the same batch on one device under [dist]'s rule: the
# single-device port's batch solve on the batched kernels (vmap_minimize's
# state and solve with the batched fused tail, whose products t1, t2 are
# added in float64 and rounded once, as the sharded solve's partials are).
# vmap_minimize itself forms the history products in float32, and its f
# parts from the sharded solve's beyond DIST_F_RTOL within TRACE_ITERS
# iterations (PERF.md, PR 13), so its numbers are printed beside the check,
# not held to it.
DB_RANKS = 4
DB_ROWS = 2
DB_SHARDS = DB_RANKS // DB_ROWS
DB_BATCH = 8
DB_LANES = DB_BATCH // DB_ROWS
DB_D = 1 << 21
DB_RAGGED = 2 * (D + 10) - 3
DB_ITERS = 40
DB_KERNEL_SHAPES = ((DB_LANES, DB_D), (DB_LANES, DB_RAGGED),
                    (BATCH, 2 * 512))
# The fused tail's forms checked: (ring dtype, products, compensated).
# The main path's form comes first.
DB_TAIL_FORMS = (("float32", False, False), ("float32", True, False),
                 ("bfloat16", True, False), ("float32", False, True))


def _db_inputs(lanes, n, dev, seed):
    """(lanes, n) rows of x ~ U(-2, 2), d, g ~ U(-1, 1) and two (lanes,
    SHARD_M, n) rings zero-padded to a multiple of DB_SHARDS, as the solver
    pads them; one step per lane and K per lane, 2^U(-6, 2); made on the
    card."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def uni(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev,
                                           dtype=torch.float32)

    pad = (-n) % DB_SHARDS
    x, d, g = (torch.nn.functional.pad(uni(lo, hi, (lanes, n)), (0, pad))
               for lo, hi in ((-2.0, 2.0), (-1.0, 1.0), (-1.0, 1.0)))
    S, Y = (torch.nn.functional.pad(uni(-1.0, 1.0, (lanes, SHARD_M, n)),
                                    (0, pad)) for _ in range(2))
    alpha = torch.exp2(uni(-6.0, 2.0, (lanes,)))
    alphas = {k: torch.exp2(uni(-6.0, 2.0, (lanes, k))) for k in TRIALS}
    return x, d, g, S, Y, alpha, alphas


def _db_edges(x, d, r, d_local):
    """Each lane's four boundary values of shard r, (lanes, 4) = [prev x,
    prev d, next x, next d], wrapping around as the exchange does."""
    lo, hi = r * d_local - 1, ((r + 1) * d_local) % x.shape[-1]
    return torch.stack([x[:, lo], d[:, lo], x[:, hi], d[:, hi]],
                       dim=-1).contiguous()


def _db_rel(a, b, scale):
    """Largest |a - b| in units of scale (per lane and sum), float64."""
    return ((a.double() - b.double()).abs()
            / scale.double().clamp(min=1e-300)).max().item()


def _db_tail_scales(problem, out, d, g, S, Y, m):
    """Per lane, sum|terms| of each of the tail's 7 + 2 m sums over the
    block, from the plain version's outputs: (lanes, 7 + 2 m)."""
    xn, gn, s, y = (out[i].double() for i in range(4))
    dd, gg = d.double(), g.double()
    cols = [_f_abs_terms(problem, xn), (s * y).abs().sum(-1),
            (y * y).sum(-1), (gn * gn).sum(-1), (dd * gn).abs().sum(-1),
            (gg * gn).abs().sum(-1), (y * gn).abs().sum(-1)]
    scales = torch.stack(cols, dim=-1)
    if m:
        ya = y.abs()
        rings = [(ring.double().abs() * ya[:, None, :]).sum(-1)
                 for ring in (S, Y)]
        scales = torch.cat([scales] + rings, dim=-1)
    return scales


def _db_trial_scales(problem, x, d, alphas):
    """Per lane and trial, sum |f terms| and sum |g_i d_i| over the block
    at the float32 trial points: (lanes, K) each."""
    from tpu_lbfgs_torch.kernels.fused_ops import VG_PLAIN

    f_abs, g_abs = [], []
    for a in alphas.unbind(-1):
        u = (x + a[:, None] * d).double()
        f_abs.append(_f_abs_terms(problem, u))
        g_abs.append((VG_PLAIN[problem](u)[1] * d.double()).abs().sum(-1))
    return torch.stack(f_abs, dim=-1), torch.stack(g_abs, dim=-1)


def _db_families(problem, xl, dl, gl, Sl, Yl, alpha, alphas, n, start, e4):
    """Each batched shard-local kernel's call and its plain version's, by
    family and form: {name: (kernel call, plain call)}."""
    from tpu_lbfgs_torch.dist.shardmap_vg import local_vg_plain
    from tpu_lbfgs_torch.kernels import fused_ops as ops
    from tpu_lbfgs_torch.kernels import line_search_ops as ls

    e_vg, e_phi = e4[:, [0, 2]].contiguous(), e4[:, 2:].contiguous()
    calls = {"vg": (lambda: ops.local_fused_vg(problem, xl, n, start, e_vg),
                    lambda: local_vg_plain(problem, xl, n, start, e_vg))}
    for hname, products, comp in DB_TAIL_FORMS:
        hd = getattr(torch, hname)
        S, Y = (Sl.to(hd), Yl.to(hd)) if products else (None, None)
        form = f"tail[{hname}{' m=' + str(SHARD_M) if products else ''}" \
            f"{' compensated' if comp else ''}]"

        def tail(fn, S=S, Y=Y, products=products, comp=comp):
            return lambda: fn(problem, xl, dl, alpha, gl, S, Y, products, n,
                              start, e4, comp)

        calls[form] = (tail(ops.local_fused_tail),
                       tail(ops.fused_tail_local_plain))
    for k, a in alphas.items():
        calls[f"multi_phi[K={k}]"] = (
            lambda a=a: ls.local_multi_phi(problem, xl, dl, a, n, start,
                                           e_phi),
            lambda a=a: ls.multi_phi_local_plain(problem, xl, dl, a, n,
                                                 start, e_phi))
        calls[f"multi_phi_dphi[K={k}]"] = (
            lambda a=a: ls.local_multi_phi_dphi(problem, xl, dl, a, n, start,
                                                e4),
            lambda a=a: ls.multi_phi_dphi_local_plain(problem, xl, dl, a, n,
                                                      start, e4))
    return calls


def _db_form(name):
    """(products, compensated, ring dtype) of a tail form's name."""
    hd = torch.bfloat16 if "bfloat16" in name else torch.float32
    return "m=" in name, "compensated" in name, hd


def _db_one_instance(problem, name, xl, dl, gl, Sl, Yl, alpha, alphas, n,
                     start, e4):
    """``lane(j)``: the one-instance shard-local kernel of a family and form
    on lane j of the batched inputs alone."""
    from tpu_lbfgs_torch.kernels import fused_ops as ops
    from tpu_lbfgs_torch.kernels import line_search_ops as ls

    if name == "vg":
        e_vg = e4[:, [0, 2]].contiguous()
        return lambda j: ops.local_fused_vg(problem, xl[j], n, start,
                                            e_vg[j])
    if name.startswith("tail"):
        products, comp, hd = _db_form(name)
        S, Y = (Sl.to(hd), Yl.to(hd)) if products else (None, None)
        return lambda j: ops.local_fused_tail(
            problem, xl[j], dl[j], alpha[j], gl[j],
            S[j] if products else None, Y[j] if products else None,
            products, n, start, e4[j], comp)
    a = alphas[int(name.split("K=")[1].rstrip("]"))]
    if name.startswith("multi_phi_dphi"):
        return lambda j: ls.local_multi_phi_dphi(problem, xl[j], dl[j], a[j],
                                                 n, start, e4[j])
    e_phi = e4[:, 2:].contiguous()
    return lambda j: ls.local_multi_phi(problem, xl[j], dl[j], a[j], n, start,
                                        e_phi[j])


def _db_split(name, out):
    """A family's outputs as (vectors, float64 sums), the sums of a batch
    (lanes, count), of one instance (count,)."""
    if name == "vg":
        return [out[1]], out[0].unsqueeze(-1)
    if name.startswith("tail"):
        return list(out[:4]), out[4]
    if name.startswith("multi_phi_dphi"):
        return [], torch.cat(out, dim=-1)
    return [], out


def phase_dist_batch_kernels(dev):
    """The batched shard-local forms of the four kernel families, in one
    process (the header of this section)."""
    from tpu_lbfgs_torch.bench import trial_bounds
    from tpu_lbfgs_torch.kernels import fused_ops as ops
    from tpu_lbfgs_torch.kernels import line_search_ops as ls

    worst = {}      # largest |kernel - plain| per (problem, family)
    for problem, (lanes, n) in itertools.product(ops.BODY_IDS,
                                                 DB_KERNEL_SHAPES):
        x, d, g, S, Y, alpha, alphas = _db_inputs(lanes, n, dev, SEED + n)
        d_local = x.shape[-1] // DB_SHARDS
        for r in range(DB_SHARDS):
            start = r * d_local
            xl, dl, gl, Sl, Yl = (_block(t, r, d_local)
                                  for t in (x, d, g, S, Y))
            e4 = _db_edges(x, d, r, d_local)
            calls = _db_families(problem, xl, dl, gl, Sl, Yl, alpha, alphas,
                                 n, start, e4)
            # The same lanes with every lane but 0 replaced.
            swap = [t.clone() for t in (xl, dl, gl, Sl, Yl)]
            for t in swap:
                t[1:] = t[1:].flip(0) * 0.5
            alt = {k: a.clone() for k, a in alphas.items()}
            for a in alt.values():
                a[1:] = a[1:].flip(0)
            alt_alpha = alpha.clone()
            alt_alpha[1:] = alt_alpha[1:].flip(0)
            calls_alt = _db_families(problem, *swap, alt_alpha, alt, n,
                                     start, e4.clone())
            f_scale = _f_abs_terms(problem, xl.double())[:, None]
            trial_scales = {k: _db_trial_scales(problem, xl, dl, a)
                            for k, a in alphas.items()}
            errs, lane_errs, same, lane_same, isolated = {}, {}, True, True, True
            for name, (kern, plain) in calls.items():
                out_k, out_p = kern(), plain()
                vec_k, sum_k = _db_split(name, out_k)
                vec_p, sum_p = _db_split(name, out_p)
                if name == "vg":
                    scale = f_scale
                elif name.startswith("tail"):
                    products, _, hd = _db_form(name)
                    scale = _db_tail_scales(problem, out_p, dl, gl,
                                            Sl.to(hd), Yl.to(hd),
                                            SHARD_M if products else 0)
                else:
                    k = int(name.split("K=")[1].rstrip("]"))
                    f_abs, g_abs = trial_scales[k]
                    scale = f_abs if name.startswith("multi_phi[") \
                        else torch.cat([f_abs, g_abs], dim=-1)
                same &= all(torch.equal(a, b) and a.dtype == b.dtype
                            for a, b in zip(vec_k, vec_p))
                errs[name] = _db_rel(sum_k, sum_p, scale)
                # As the one-instance shard-local rows: the vectors' largest
                # |kernel - plain|, the sums' where there is no vector.
                family = name.split("[")[0]
                abs_err = max((a.float() - b.float()).abs().max().item()
                              for a, b in zip(vec_k, vec_p)) if vec_k \
                    else (sum_k - sum_p).abs().max().item()
                worst[problem, family] = max(worst.get((problem, family), 0.0),
                                             abs_err)
                # Lane 0 with the other lanes replaced.
                vec_a, sum_a = _db_split(name, calls_alt[name][0]())
                isolated &= torch.equal(sum_a[0], sum_k[0]) and all(
                    torch.equal(a[0], b[0]) for a, b in zip(vec_a, vec_k))
                # Every lane against the one-instance shard-local kernel.
                one = _db_one_instance(problem, name, xl, dl, gl, Sl, Yl,
                                       alpha, alphas, n, start, e4)
                outs = [_db_split(name, one(j)) for j in range(lanes)]
                vec_1 = [torch.stack([o[0][i] for o in outs])
                         for i in range(len(vec_k))]
                sum_1 = torch.stack([o[1] for o in outs])
                lane_same &= all(torch.equal(a, b)
                                 for a, b in zip(vec_k, vec_1))
                lane_errs[name] = _db_rel(sum_k, sum_1, scale)
            torch.cuda.synchronize()
            say(f"[dist-batch] kernels {problem} {lanes} lanes of d={n}, "
                f"shard {r} of {DB_SHARDS} (d_local {d_local}): vectors "
                f"bit-equal to the batched plain versions {same}, to the "
                f"one-instance shard-local kernel lane by lane {lane_same}; "
                f"lane 0 bit-equal with the other lanes replaced {isolated}; "
                f"float64 sums against plain "
                + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                + f"; lane by lane against the one-instance kernel at most "
                f"{max(lane_errs.values()):.2e} of sum|terms| (tol "
                f"{TRIAL_SUM_RTOL})")
            check(same and lane_same and isolated,
                  f"[dist-batch] {problem} batched shard-local vectors differ "
                  f"({lanes} x {n}, shard {r})")
            check(max(errs.values()) <= TRIAL_SUM_RTOL
                  and max(lane_errs.values()) <= TRIAL_SUM_RTOL,
                  f"[dist-batch] {problem} batched shard-local sums differ "
                  f"({lanes} x {n}, shard {r})")

    # Times at the solve's shape: DB_LANES lanes of shard 1 of a global
    # 2^21, d_local = 2^20.
    rec = {}
    x, d, g, S, Y, alpha, alphas = _db_inputs(DB_LANES, DB_D, dev, SEED)
    d_local = DB_D // DB_SHARDS
    xl, dl, gl, Sl, Yl = (_block(t, 1, d_local) for t in (x, d, g, S, Y))
    e4 = _db_edges(x, d, 1, d_local)
    elems = DB_LANES * d_local
    lanes = DB_LANES
    for problem in ops.BODY_IDS:
        body_ops = {"quadratic": 4, "rosenbrock": 18,
                    "coupled_quadratic": 9}[problem]
        trial = {f"{family}[K={k}]": trial_bounds.trial_bound(
                     kernel, problem, elems, k,
                     8 * elems + 16 * lanes + per_k * k * lanes)
                 for family, kernel, per_k in (
                     ("multi_phi", "multi_phi_batched", 12),
                     ("multi_phi_dphi", "multi_phi_dphi", 20))
                 for k in TRIALS}
        calls = _db_families(problem, xl, dl, gl, Sl, Yl, alpha, alphas,
                             DB_D, d_local, e4)
        tail_ops = (body_ops + 22) * elems
        bounds = {
            "vg": bound_ms(8 * elems + 16 * lanes, body_ops * elems),
            "tail[float32]": bound_ms(28 * elems + 76 * lanes, tail_ops),
            f"tail[float32 m={SHARD_M}]": bound_ms(
                (28 + 8 * SHARD_M) * elems + 76 * lanes + 16 * SHARD_M * lanes,
                tail_ops + 4 * SHARD_M * elems),
            f"tail[bfloat16 m={SHARD_M}]": bound_ms(
                (24 + 4 * SHARD_M) * elems + 76 * lanes
                + 16 * SHARD_M * lanes, tail_ops + 4 * SHARD_M * elems),
            "tail[float32 compensated]": bound_ms(28 * elems + 76 * lanes,
                                                  tail_ops),
            **{name: b["old"] for name, b in trial.items()},
        }
        for name, (kern, plain) in calls.items():
            ms, plain_ms = device_ms(kern), device_ms(plain)
            bound = bounds[name]
            library = ""
            if "m=" in name:
                # t1, t2 alone by two torch.bmm on the ring as stored.
                hd = _db_form(name)[2]
                S_h, Y_h = Sl.to(hd), Yl.to(hd)
                y_col = gl.unsqueeze(-1).to(hd)
                lib_ms = device_ms(lambda: (torch.bmm(S_h, y_col),
                                            torch.bmm(Y_h, y_col)))
                library = (f", t1, t2 by two torch.bmm "
                           f"{lib_ms * 1e3:.2f} us")
            note = (f"; {trial_bound_note(trial[name], ms)}"
                    if name in trial else "")
            say(f"[dist-batch] {problem} {name} local batched, {lanes} lanes "
                f"of d_local={d_local} (of d={DB_D}): {ms * 1e3:.2f} us on "
                f"the card, plain version {plain_ms * 1e3:.2f} us{library}, "
                f"bound {bound[0] * 1e3:.2f} us by {bound[1]}{note}")
            # The kernels line: the main path's tail, multi_phi at K = 8
            # and multi_phi_dphi at K = 36, as the one-instance rows.
            family = {"vg": "vg", "tail[float32]": "tail",
                      "multi_phi[K=8]": "multi_phi",
                      "multi_phi_dphi[K=36]": "multi_phi_dphi"}.get(name)
            if family is not None:
                key = family.replace("tail", "fused_tail") \
                    if family == "tail" else family
                rec[f"{problem}_{key}_local_batched"] = {
                    "max_abs_err": worst[problem, family], "ms": ms,
                    "plain_ms": plain_ms, "bound": bound}
    return rec


def _db_jobs():
    """The solves of [dist-batch]: (label, problem, d, lockstep, config
    keywords, sharded_vmap_minimize keywords)."""
    poly = dict(line_search="backtracking", direction="compact_incremental",
                ls_eval="polynomial")
    spec = dict(direction="compact_incremental", ls_eval="direct")
    jobs = [(f"main, {lockstep}", "rosenbrock", DB_D, lockstep, poly, {})
            for lockstep in ("bounded", "while")]
    for problem in ("rosenbrock", "coupled_quadratic", "quadratic"):
        for search in ("backtracking_speculative",
                       "wolfe_interpolation_speculative"):
            jobs.append((f"{problem} {search}", problem, DB_D, "while",
                         dict(spec, line_search=search), {}))
    jobs += [
        ("t1, t2 in the tail on a bf16 ring", "rosenbrock", DB_D, "while",
         dict(poly, history_dtype="bfloat16"), dict(with_matvec=True)),
        ("unaligned d", "coupled_quadratic", DB_D + 37, "while", poly, {}),
    ]
    return jobs


def _db_cfg_kw(problem, lockstep, cfg_kw):
    # [dist]'s rule: Rosenbrock at tol = 0, the quadratics to 1e-5; a
    # trace where the lockstep allows one.
    kw = _dist_cfg_kw(problem, DB_ITERS, cfg_kw)
    kw["record_trace"] = lockstep == "while"
    return kw


def _db_x0(d, dev, dtype=torch.float32):
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.uniform(-2.0, 2.0, (DB_BATCH, d))).to(
        device=dev, dtype=dtype)


def phase_dist_batch(dev, card):
    """sharded_vmap_minimize at full width: DB_RANKS processes on the one
    card as a DB_ROWS x DB_SHARDS (b, d) mesh (gloo), DB_BATCH instances of
    DB_D, every lane against the same batch on one device on the batched
    kernels, and the single-device vmap_minimize printed beside it."""
    import tpu_lbfgs_torch as tt
    from tpu_lbfgs_torch.core.solver import solve_to_result
    from tpu_lbfgs_torch.dist.launch import solve_cases, spawn_ranks

    jobs = _db_jobs()
    cases = [dict(problem=problem, d=d, dtype="float32", seed=SEED, box=2.0,
                  batch=DB_BATCH, batch_size=DB_ROWS, lockstep=lockstep,
                  cfg=_db_cfg_kw(problem, lockstep, cfg_kw), kw=kw,
                  gather=False)
             for _, problem, d, lockstep, cfg_kw, kw in jobs]
    t0 = time.perf_counter()
    ranks = spawn_ranks(solve_cases, DB_RANKS, cases, "cuda:0",
                        backend="gloo", timeout_s=DIST_TIMEOUT_S,
                        threads=None)
    say(f"[dist-batch] {DB_RANKS} ranks on {card} as a {DB_ROWS} x "
        f"{DB_SHARDS} (b, d) mesh (gloo, one process each, all on cuda:0), "
        f"{DB_BATCH} instances, {len(jobs)} solves in "
        f"{time.perf_counter() - t0:.1f} s with start-up.  The ranks share "
        "one card and every collective goes through the host, so the times "
        "below are a correctness run's cost, not a scaling number.")
    launches = {}
    # A bounded solve is held to the same batch's read-driven one: with no
    # lane converging early (tol = 0) the two give the same iterates.
    twin = {lockstep: j for j, (label, _, _, lockstep, _, _) in enumerate(jobs)
            if label.startswith("main")}
    for j, (label, problem, d, lockstep, cfg_kw, kw) in enumerate(jobs):
        per_rank = [r[j] for r in ranks]
        r0 = per_rank[0]
        for key in ("f", "status", "iterations", "n_fev"):
            check(all(np.array_equal(r[key], r0[key]) for r in per_rank),
                  f"[dist-batch] {label}: the ranks disagree on {key}")
        if "trace" in r0:
            check(all(np.array_equal(r["trace"]["alpha"], r0["trace"]["alpha"])
                      for r in per_rank),
                  f"[dist-batch] {label}: the ranks disagree on alphas")
        d_local = -(-d // DB_SHARDS)
        check(all(r["x_local_shape"] == (DB_LANES, d_local)
                  and r["x_local_finite"] for r in per_rank)
              and np.isfinite(r0["f"]).all(),
              f"[dist-batch] {label}: each rank must hold finite "
              f"({DB_LANES}, {d_local}) lanes and finite f")
        # The same batch on one device, the whole vectors, on the batched
        # kernels: vmap_minimize's state and solve with the batched fused
        # tail, its products t1, t2 added in float64 and rounded once, as
        # the sharded solve adds its products' partials, and f from the
        # batched vg kernel for the trials.  vmap_minimize itself (its
        # history products in float32) is printed beside it.
        p = tt.get_problem(problem)
        cfg = tt.LBFGSConfig(**_db_cfg_kw(problem, lockstep, cfg_kw))
        poly = p.dir_poly if cfg.ls_eval == "polynomial" else None
        x0 = _db_x0(d, dev)
        vg = tt.fused_value_and_grad(problem)
        single = solve_to_result(
            cfg, lambda x: vg(x)[0], vg,
            tt.init_state(vg, x0, cfg.m, cfg.history_dtype), poly,
            fused_tail=tt.fused_tail_for(problem, with_matvec=True),
            bounded=lockstep == "bounded")
        vmapped = tt.vmap_minimize(p.f, x0, cfg, value_and_grad=vg,
                                   dir_poly=poly, lockstep=lockstep)
        v_f, v_status = vmapped.f.cpu().numpy(), vmapped.status.cpu().numpy()
        s_status = single.status.cpu().numpy()
        s_iters = single.iterations.cpu().numpy()
        s_f = single.f.cpu().numpy()
        f0 = np.abs(p.f(x0).double().cpu().numpy())
        floor = 1e-9 * f0
        n_cmp, f_err, parted = [], 0.0, []
        for lane in range(DB_BATCH):
            if "trace" in r0:
                fs = r0["trace"]["f"][lane].tolist()
                f_s = single.trace.f[lane].tolist()
                a_r = r0["trace"]["alpha"][lane].tolist()
                a_s = single.trace.alpha[lane].tolist()
                k_l = min(TRACE_ITERS, int(r0["iterations"][lane]),
                          int(s_iters[lane]))
                n = 0
                while (n < k_l and min(([f0[lane]] + fs)[n],
                                       ([f0[lane]] + f_s)[n]) > floor[lane]):
                    n += 1
                err = max((abs(a - b) / max(abs(b), floor[lane])
                           for a, b in zip(fs[:n], f_s[:n])), default=0.0)
                ok = n >= 1 and a_r[:n] == a_s[:n]
                ok &= err <= DIST_F_RTOL
            else:
                n = 0
                err = abs(r0["f"][lane] - s_f[lane]) / max(abs(s_f[lane]),
                                                           floor[lane])
                read_driven = ranks[0][twin["while"]]
                ok = (int(r0["iterations"][lane]) == int(s_iters[lane])
                      and r0["f"][lane] == read_driven["f"][lane]
                      and r0["status"][lane] == read_driven["status"][lane])
            ok &= int(r0["status"][lane]) == int(s_status[lane])
            n_cmp.append(n)
            f_err = max(f_err, err)
            if not ok or err > DIST_F_WITNESS or n < min(
                    TRACE_ITERS, int(s_iters[lane])):
                parted.append(lane)
            check(ok, f"[dist-batch] {label}: lane {lane} parts from the "
                      f"single-device port (status {r0['status'][lane]} / "
                      f"{s_status[lane]}, f within {err:.2e}, first {n} "
                      "alphas compared)")
        # Per rank: its row's lanes, their iterations, its kernels.
        lines = []
        for rank, r in enumerate(per_rank):
            row = rank // DB_SHARDS
            k_row = int(np.max(r["iterations"][row * DB_LANES:
                                               (row + 1) * DB_LANES]))
            got = r["launches"]
            tail = got.get(f"{problem}_fused_tail_local_batched", 0)
            vg = got.get(f"{problem}_vg_local_batched", 0)
            check(tail == k_row and vg >= 1
                  and (vg == 1 or cfg.ls_eval == "direct"),
                  f"[dist-batch] {label}: rank {rank} must launch the "
                  f"batched shard-local tail once per iteration of its row "
                  f"({k_row}) and vg once per solve, got {got}")
            check(all(name == "compact_chain"
                      or name.endswith("_local_batched") for name in got),
                  f"[dist-batch] {label}: rank {rank} ran a whole-vector or "
                  f"one-instance kernel on its lanes: {got}")
            if cfg.ls_eval == "direct":
                own = (f"{problem}_multi_phi_local_batched"
                       if cfg.line_search == "backtracking_speculative"
                       else f"{problem}_multi_phi_dphi_local_batched")
                check(got.get(own, 0) >= k_row,
                      f"[dist-batch] {label}: rank {rank}: {own} must "
                      f"launch at least once per iteration, got {got}")
            if problem == "quadratic":
                check(r["edge_exchanges"] == 0,
                      "[dist-batch] the quadratic exchanges no edges")
            else:
                check(r["edge_exchanges"] >= k_row,
                      f"[dist-batch] {label}: a chain problem exchanges "
                      "its edges")
            lines.append(f"rank {rank} (row {row}, {k_row} iterations): "
                         f"{r['wall_s'] / max(k_row, 1) * 1e3:.2f} ms, "
                         f"{r['all_reduces'] / max(k_row, 1):.2f} "
                         f"all-reduces, "
                         f"{r['edge_exchanges'] / max(k_row, 1):.2f} edge "
                         f"exchanges per iteration")
            for name, count in got.items():
                launches.setdefault(name, count)
        v_err = float(np.max(np.abs(r0["f"] - v_f) / np.maximum(
            np.abs(v_f), floor)))
        v_trace = ""
        if "trace" in r0:
            # f over the first TRACE_ITERS iterations against vmap_minimize.
            k_v = min(TRACE_ITERS, int(np.min(r0["iterations"])))
            v_fs = vmapped.trace.f[:, :k_v].double().cpu().numpy()
            off = np.abs(r0["trace"]["f"][:, :k_v] - v_fs) / np.maximum(
                np.abs(v_fs), floor[:, None])
            v_trace = (f", f over the first {k_v} iterations within "
                       f"{float(np.max(off)):.2e}")
        held = (f"alphas equal over the first {min(n_cmp)}-{max(n_cmp)} "
                f"iterations of each lane, f within {f_err:.2e} (tol "
                f"{DIST_F_RTOL})" if "trace" in r0 else
                f"iterations equal, final f within {f_err:.2e}; f and "
                f"statuses bit-equal to the same batch under lockstep while")
        say(f"[dist-batch] {label}: {problem} {DB_BATCH} x d={d} (lanes of "
            f"{DB_LANES} x d_local {d_local} a rank) {cfg.line_search}/"
            f"{cfg.ls_eval}, lockstep {lockstep}, statuses "
            f"{[tt.Status.NAMES[int(s)] for s in r0['status']]}, iterations "
            f"{r0['iterations'].tolist()}; rank 0 launches {r0['launches']}; "
            + "; ".join(lines) + " (4 ranks sharing the card over gloo: a "
            "correctness run, not a scaling number); against the same "
            f"batch on one device on the batched kernels: statuses equal, "
            f"{held}; against vmap_minimize (float32 history products): "
            f"statuses equal {np.array_equal(r0['status'], v_status)}"
            f"{v_trace}, final f within {v_err:.2e}")
        if parted:
            # Where the two float32 solves part (f beyond DIST_F_WITNESS,
            # or alphas compared over fewer iterations than ran), the
            # witness is the same batch in float64 on one device.
            wide = tt.vmap_minimize(p.f, x0.double(),
                                    cfg.replace(use_pallas=False),
                                    grad=p.grad, dir_poly=poly,
                                    lockstep=lockstep)
            w_f = wide.f.cpu().numpy()
            say(f"[dist-batch] {label}: witness, float64 on one device, "
                f"lanes {parted}: final f sharded float32 "
                f"{[float(r0['f'][i]) for i in parted]}, single-device "
                f"float32 {[float(s_f[i]) for i in parted]}, float64 "
                f"{[float(w_f[i]) for i in parted]}")
    return launches


# --- checkpoints, the giant cell, time to tolerance, the protocol ----------
# [checkpoint]: the main path's configuration at d = D in float32, two
# make_solve_segment segments of CKPT_ITERS iterations, cut between them by
# save_state / load_state and uncut; every field of the final states bit
# for bit.  Once with the tail without its products on a float32 ring, once
# on a bfloat16 ring with the products in the tail.
CKPT_ITERS = 50
# [giant]: bench.giant.main in process, GIANT_ITERS iterations and
# GIANT_REPEATS timed runs each, at d = 2^26 on a float32 ring and on a
# bfloat16 ring with the products in the tail, the bfloat16 ring driven in
# segments, and at d = 1e8 on a float32 ring (8 GB).  Each line: a finite
# f, one fused tail launch per iteration run (the warm-up run, the timed
# runs and the device-time run), and at most GIANT_FRAC_MAX of the H100's
# memory rate on the traffic model (beyond it the model counts wrong).
GIANT_ITERS = 50
GIANT_REPEATS = 2
GIANT_FRAC_MAX = 1.05
GIANT_M = 10
# Before the runs, fused_vg and the fused tail with its products at
# m = GIANT_M against their plain versions on the same inputs, at the
# runs' sizes: d = 2^26 on a bfloat16 ring, d = 1e8 on a float32 ring
# (past 2^31 bytes of ring and of each row's offset into it).
GIANT_CHECKS = ((1 << 26, "bfloat16"), (100_000_000, "float32"))
GIANT_RUNS = (
    ["--d", str(1 << 26), "--with-matvec"],
    ["--d", str(1 << 26), "--with-matvec", "--history-dtype", "bfloat16"],
    ["--d", str(1 << 26), "--with-matvec", "--history-dtype", "bfloat16",
     "--donate"],
    ["--d", "100000000", "--with-matvec"],
)
# [tol]: time_to_tolerance_refined with the float64 stage on the card, at a
# d where the float32 stage takes ~10,000 iterations (10,285 in the
# reference's run on the CPU): the checks of the reference's
# tests/test_utils.py::test_time_to_tolerance_refined_reaches_1e5.
TOL_D = 1 << 11
TOL_REFINE_MAX = 100
# [protocol]: the published box, d = 10,000, two seeds.  The reference
# records Armijo Backtracking, Armijo Interpolation and Wolfe Interpolation
# under its float32 parallel configuration as line_search_failed at
# iteration 1 for every seed (reference_protocol_results.json); a float64
# sequential cell on the quadratic converges.
PROTOCOL_D = 10_000
PROTOCOL_SEEDS = (42, 365)
PROTOCOL_FAILS = ("backtracking", "armijo_interpolation",
                  "wolfe_interpolation")


def _states_equal(a, b):
    import dataclasses

    return [f.name for f in dataclasses.fields(a)
            if not (getattr(a, f.name).dtype == getattr(b, f.name).dtype
                    and torch.equal(getattr(a, f.name), getattr(b, f.name)))]


def phase_checkpoint(dev, tmp):
    """Two segments of the main path cut by a checkpoint equal the same
    two segments uncut, bit for bit, on both rings."""
    import tpu_lbfgs_torch as tt
    from tpu_lbfgs_torch.bench.harness import _x0
    from tpu_lbfgs_torch.io import load_state, save_state

    p = tt.get_problem("rosenbrock")
    vg = tt.fused_value_and_grad("rosenbrock")
    x0 = _x0(D, SEED, torch.float32, dev)
    for label, hdtype, products in (("float32 ring", None, False),
                                    ("bfloat16 ring, products in the tail",
                                     "bfloat16", True)):
        cfg = _bench_cfg(tt, 2 * CKPT_ITERS).replace(history_dtype=hdtype)
        tail = tt.fused_tail_for("rosenbrock", with_matvec=products)

        def segment():
            return tt.make_solve_segment(cfg, p.f, value_and_grad=vg,
                                         iters=CKPT_ITERS, dir_poly=p.dir_poly,
                                         fused_tail=tail)

        seg = segment()
        uncut = seg(seg(tt.init_state(vg, x0.clone(), cfg.m, hdtype)))
        seg = segment()
        mid = seg(tt.init_state(vg, x0.clone(), cfg.m, hdtype))
        path = tmp / f"ckpt_{hdtype or 'float32'}.npz"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_state(path, mid)
        save_s = time.perf_counter() - t0
        del mid
        t0 = time.perf_counter()
        loaded = load_state(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        resumed = seg(loaded)
        with np.load(path) as z:
            schema, ring = str(z["__schema__"]), z["s_hist"].shape
            casts = json.loads(str(z["__casts__"]))
        differ = _states_equal(resumed, uncut)
        say(f"[checkpoint] {label}, d={D}: {CKPT_ITERS} + {CKPT_ITERS} "
            f"iterations cut by save_state / load_state against uncut: "
            f"fields that differ {differ}; k {resumed.k.item()}, f "
            f"{resumed.f.item():.6e}; save {save_s:.3f} s, load (to the "
            f"card) {load_s:.3f} s, file {path.stat().st_size / 1e6:.1f} MB, "
            f"schema {schema}, ring {ring}, casts {casts}")
        check(not differ, f"[checkpoint] {label}: the resumed solve differs "
              f"from the uncut one in {differ}")
        check(resumed.k.item() == 2 * CKPT_ITERS
              and bool(torch.isfinite(resumed.f)),
              f"[checkpoint] {label}: k must reach {2 * CKPT_ITERS}, f finite")
        check(schema == "tpu-lbfgs-state-v1"
              and ring == (cfg.m, D // 128, 128)
              and casts == ({"s_hist": "bfloat16", "y_hist": "bfloat16"}
                            if hdtype else {})
              and resumed.s_hist.dtype == (torch.bfloat16 if hdtype
                                           else torch.float32),
              f"[checkpoint] {label}: the file must hold the schema key, the "
              "(m, R, L) ring and the casts")
        path.unlink()


def _giant_kernel_checks(dev, card):
    """The giant runs' kernels against their plain versions on the same
    inputs, at each of GIANT_CHECKS (d, ring): fused_vg (g bit for bit, f
    within TRIAL_SUM_RTOL of sum|terms| beyond 1 ulp) and the Rosenbrock
    fused tail with its products at m = 10 (as at D, _tail_form_check).
    One ring is alive at a time.  These launches are not the path's: the
    runs reset the counts after them."""
    from tpu_lbfgs_torch.kernels import fused_ops as ops

    problem, vg_plain = "rosenbrock", ops.VG_PLAIN["rosenbrock"]
    hist = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    alpha = torch.full((), 0.125, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    tail = ops.make_fused_tail(problem, vg_plain, with_matvec=True)
    for n, h in GIANT_CHECKS:
        x = 4.0 * torch.rand(n, generator=gen, device=dev) - 2.0
        d, g = (2.0 * torch.rand(n, generator=gen, device=dev) - 1.0
                for _ in range(2))
        f_k, g_k = ops.fused_vg(problem, x)
        f_p, g_p = vg_plain(x)
        vg_over = _beyond_ulp(f_k, f_p, _f_abs_terms(problem, x.double()))
        vg_same = torch.equal(g_k, g_p)
        del f_k, g_k, f_p, g_p
        S, Y = (_ring(gen, GIANT_M, n, dev, hist[h]) for _ in range(2))
        out_k = tail(x, d, alpha, g, S, Y)
        out_p = ops.fused_tail_plain(vg_plain, x, d, alpha, g, S, Y, True)
        torch.cuda.synchronize()
        where = f"{problem} d={n} ring {h} matvec m={GIANT_M}"
        over, t_over = _tail_form_check(problem, out_k, out_p, d, g, S, Y,
                                        GIANT_M, hist[h], where)
        say(f"[giant] {problem}_vg d={n}: g bit-equal to the plain version "
            f"{vg_same}, f {vg_over:.3e} of sum|terms| beyond 1 ulp; "
            f"{problem}_fused_tail d={n} ring {h} matvec m={GIANT_M}: "
            f"x_new, g_new, s, y bit-equal to the plain version, 7 sums "
            f"{over:.3e} and t1/t2 {t_over:.3e} of sum|terms| beyond 1 ulp "
            f"(tol {TRIAL_SUM_RTOL}); peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; on {card}")
        check(vg_same and vg_over <= TRIAL_SUM_RTOL,
              f"{problem}_vg disagrees with its plain version at d={n}")
        del x, d, g, S, Y, out_k, out_p
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def phase_giant(dev, card):
    """The giant runs' kernels against their plain versions, then
    bench.giant.main in process for each of GIANT_RUNS."""
    import contextlib
    import io

    from tpu_lbfgs_torch import kernels
    from tpu_lbfgs_torch.bench.giant import main as giant
    from tpu_lbfgs_torch.core import blocks

    torch.cuda.empty_cache()
    _giant_kernel_checks(dev, card)
    torch.cuda.reset_peak_memory_stats()
    common = ["--iters", str(GIANT_ITERS), "--repeats", str(GIANT_REPEATS)]
    for argv in GIANT_RUNS:
        reset_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            giant(argv + common)
        got = kernels.launch_counts()
        each = per_step("rosenbrock_fused_tail")
        line = buf.getvalue().strip().splitlines()[-1]
        row = json.loads(line)
        roof = row["roofline"]
        # The warm-up and timed runs, and the device-time run's blocks (one
        # of them the capture's), fewer than a block short of GIANT_ITERS.
        run = blocks.stats["steps"]
        least = GIANT_ITERS * (GIANT_REPEATS + 2) - blocks.BLOCK_ITERS
        say(f"[giant] {line}")
        share = ("an unknown share (the host was not ahead)"
                 if row["host_share"] is None
                 else f"{100 * row['host_share']:.1f}%")
        say(f"[giant] d={row['d']} ring {row['history_dtype']}"
            f"{' in segments' if row['donated_segments'] else ''}: "
            f"{row['iters_per_s']:.2f} it/s, {row['ms_per_iter']:.3f} ms per "
            f"iteration, device {row['device_us_per_iter']:.1f} us per "
            f"iteration (CUDA events around {GIANT_ITERS} iterations queued "
            f"ahead: {row['host_ahead']}), the card waits on the host "
            f"{share} of an iteration; "
            f"{roof['modeled_gb_per_iter']:.3f} GB per iteration on the "
            f"model, {roof['achieved_gbps_on_model']:.1f} GB/s = "
            f"{roof['frac_of_h100_spec']:.4f} of 3350 GB/s; fused tail "
            f"launches {got['rosenbrock_fused_tail']} for {run} iterations "
            f"run; graphs captured in the warm-up run in "
            f"{row['capture_s']:.3f} s, {row['host_reads_per_solve']:.1f} "
            f"host reads per timed solve; {blocks_note()}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; on {card}")
        check(np.isfinite(row["final_f"]) and np.isfinite(row["device_f"]),
              f"[giant] {argv}: f must stay finite")
        check(each and run >= least,
              f"[giant] {argv}: the fused tail must launch once per "
              f"iteration run, {got['rosenbrock_fused_tail']} for {run}")
        check(roof["frac_of_h100_spec"] <= GIANT_FRAC_MAX,
              f"[giant] {argv}: {roof['frac_of_h100_spec']} of the card's "
              "memory rate on the model: the model counts wrong")
        torch.cuda.reset_peak_memory_stats()


def phase_tol(card):
    """Time to ||g|| <= 1e-5 in two stages, the float64 one on the card."""
    from tpu_lbfgs_torch import kernels
    from tpu_lbfgs_torch.bench.harness import (
        _warmup_iters,
        time_to_tolerance_refined,
    )
    from tpu_lbfgs_torch.core.blocks import BLOCK_ITERS

    reset_counts()
    r = time_to_tolerance_refined(d=TOL_D, refine_backend="torch")
    got = kernels.launch_counts()
    replayed = kernels.replay_counts()["rosenbrock_fused_tail"]
    say(f"[tol] time_to_tolerance_refined(d={TOL_D}, coarse_tol=1e-3, "
        f"tol=1e-5, refine_backend='torch'): {json.dumps(r)}; fused tail "
        f"launches {got['rosenbrock_fused_tail']} ({replayed} replayed) on "
        f"{card}")
    check(r["status"] == "converged" and r["g_norm"] <= 1e-5
          and r["refine_iterations"] <= TOL_REFINE_MAX,
          f"[tol] must converge to 1e-5 within {TOL_REFINE_MAX} float64 "
          "iterations")
    # The float32 stage's warm-up run (its first capture's warm-up
    # iteration eager, the rest replayed) and its timed run, which steps
    # on, frozen, to the end of the block it converges in; the float64
    # stage runs the tail's plain version.
    least = r["coarse_iterations"] + _warmup_iters()
    check(got["rosenbrock_fused_tail"] == replayed + 1
          and least <= replayed < least + BLOCK_ITERS,
          "[tol] the float32 stage must launch the fused tail once per "
          "iteration")


def phase_protocol(card):
    """The reference's iteration-1 failures from the published box, and a
    float64 cell on the card."""
    from tpu_lbfgs_torch import kernels
    from tpu_lbfgs_torch.bench.reference_protocol import (
        TABLE_I_STRATEGIES,
        markdown_table,
        run_cuda_cell,
    )

    labels = {key: label for label, key in TABLE_I_STRATEGIES}
    cells = []
    kernels.reset_launches()
    for strategy in PROTOCOL_FAILS:
        cell = run_cuda_cell("rosenbrock", PROTOCOL_D, strategy,
                             seeds=PROTOCOL_SEEDS)
        cells.append(dict(cell, d=PROTOCOL_D, strategy=labels[strategy]))
        check(cell["statuses"] == ["line_search_failed"] * len(PROTOCOL_SEEDS)
              and cell["per_seed_iterations"] == [1] * len(PROTOCOL_SEEDS),
              f"[protocol] {strategy}: the reference fails at iteration 1 "
              f"from U(-1000, 1000) in float32; got {cell['statuses']}, "
              f"{cell['per_seed_iterations']}")
    got = kernels.launch_counts()
    check(got["rosenbrock_vg"] > 0 and got["rosenbrock_fused_tail"] > 0,
          f"[protocol] the float32 cells must run the fused kernels, "
          f"launches {ran(got)}")
    cell = run_cuda_cell("quadratic", PROTOCOL_D, "backtracking",
                         seeds=PROTOCOL_SEEDS, dtype="float64")
    cells.append(dict(cell, d=PROTOCOL_D, strategy="Armijo Backtracking "
                      "(quadratic)"))
    check(cell["statuses"] == ["converged"] * len(PROTOCOL_SEEDS)
          and cell["max_final_g_norm"] <= 1e-8,
          f"[protocol] the float64 quadratic cell must converge: {cell}")
    say(f"[protocol] d={PROTOCOL_D}, seeds {PROTOCOL_SEEDS}, x0 ~ U(-1000, "
        f"1000), launches {ran(got)}, on {card}:")
    for line in markdown_table({"cells": cells}).splitlines():
        say(f"[protocol] {line}")


# [dist-own] and [checkpoint-sharded], in one job of DIST_RANKS processes on
# the one card (gloo).  [dist-own]: a caller's own objectives through
# sharded_minimize at the [dist] width in float64, partitioned by DTensor:
# chained Rosenbrock written out (not the suite's), against the suite's
# Rosenbrock by name on the plain shard-local path, and a pseudo-Huber
# objective outside the suite; both against the single-device minimize of
# the same f (autograd), f to OWN_F_RTOL at every one of OWN_ITERS
# iterations, alphas equal.  [checkpoint-sharded]: [dist]'s config on the
# kernel path, float32, saved at CKS_ITERS by save_state_sharded on the 4
# ranks, loaded onto 4, 2 (a subgroup) and 1 rank (rank 0 alone) and
# resumed to 2 * CKS_ITERS, against the uncut solve: bit for bit on 4 ranks,
# x within CKS_X_TOL and f within CKS_F_RTOL on the other meshes.
OWN_ITERS = 40
OWN_F_RTOL = 1e-10
CKS_ITERS = 20
CKS_X_TOL = 1e-5
CKS_F_RTOL = 1e-6
# [scaling]: scaling_sweep at 1, 2 and 4 ranks on the one card.
SCALE_COUNTS = (1, 2, 4)
SCALE_ITERS = 20
# [profile] and [debug-nans]: the main path for PROFILE_ITERS iterations.
PROFILE_ITERS = 20
# [examples]: each examples/torch_*.py at its defaults, side by side.
EXAMPLES_TIMEOUT_S = 300


def own_rosenbrock(x):
    """Chained Rosenbrock written out by a caller: torch operations on the
    whole (d,) vector, nothing of the suite."""
    t = x[..., 1:] - x[..., :-1] ** 2
    return torch.sum(100.0 * t * t + (1.0 - x[..., :-1]) ** 2, dim=-1)


def pseudo_huber(x):
    """An objective outside the suite: elementwise terms and a sum, which
    DTensor keeps sharded (one all-reduce of the value)."""
    r = x - 1.0
    return torch.sum(torch.sqrt(1.0 + r * r) - 1.0 + 0.01 * x * x, dim=-1)


# (label, f, the suite problem it equals, tol): the pseudo-Huber solve
# converges within OWN_ITERS, and past that its line searches are decided
# by rounding, so it stops at a tolerance.
OWN_OBJECTIVES = (("chained rosenbrock", own_rosenbrock, "rosenbrock", 0.0),
                  ("pseudo-huber", pseudo_huber, None, 1e-6))


def _own_cfg(tt, tol=0.0):
    return tt.LBFGSConfig(line_search="backtracking",
                          direction="compact_incremental", ls_eval="direct",
                          max_iters=OWN_ITERS, tol=tol, record_trace=True)


def _own_ckpt_rank(rank, size, ck_dir):
    """One rank of the [dist-own] / [checkpoint-sharded] job."""
    import torch.distributed as torch_dist
    from torch.distributed.tensor.debug import CommDebugMode

    import tpu_lbfgs_torch as tt
    from tpu_lbfgs_torch import dist
    from tpu_lbfgs_torch.dist.mesh import Mesh, local_block, pad_for_mesh
    from tpu_lbfgs_torch.dist.partitioned import partitioned_value_and_grad
    from tpu_lbfgs_torch.dist.sharded import (
        gather_result,
        solve_shard,
        solve_shard_from_state,
    )
    from tpu_lbfgs_torch.io import load_state_sharded, save_state_sharded

    dev = torch.device("cuda", 0)
    mesh = dist.make_mesh()
    out = {"own": {}}

    def trace(res):
        return {"f": res.trace.f.tolist(), "alpha": res.trace.alpha.tolist(),
                "status": int(res.status), "k": int(res.iterations)}

    x0 = _dist_x0(DIST_D, dev).double()
    for label, f, named, tol in OWN_OBJECTIVES:
        cfg = _own_cfg(tt, tol)
        x_local = local_block(pad_for_mesh(x0, size)[0], mesh)
        vg = partitioned_value_and_grad(f, mesh, DIST_D)
        vg(x_local)                             # builds the DeviceMesh
        comm = CommDebugMode()
        with comm:
            vg(x_local)
        counts = {str(k).split(".")[-1]: n
                  for k, n in comm.get_comm_counts().items()}
        torch.cuda.synchronize()
        torch_dist.barrier()
        t0 = time.perf_counter()
        res = dist.sharded_minimize(f, x0, cfg, mesh)
        float(res.f)
        wall = time.perf_counter() - t0
        rec = {"counts": counts, "ms": wall / max(int(res.iterations), 1)
               * 1e3, "own": trace(res)}
        if named is not None:
            p = tt.get_problem(named)
            rec["named"] = trace(dist.sharded_minimize(
                p.f, x0, cfg, mesh, problem=named))
        out["own"][label] = rec

    # [checkpoint-sharded]
    x0 = _dist_x0(DIST_D, dev)
    cfg = tt.LBFGSConfig(**_dist_cfg_kw("rosenbrock", CKS_ITERS, dict(
        line_search="backtracking", direction="compact_incremental",
        ls_eval="polynomial"))).replace(record_trace=False)
    x_pad, n = pad_for_mesh(x0, size)
    _, state = solve_shard("rosenbrock", local_block(x_pad, mesh), n, cfg,
                           mesh, kernels=True, return_state=True)
    torch.cuda.synchronize()
    torch_dist.barrier()
    t0 = time.perf_counter()
    save_state_sharded(ck_dir, state, mesh, n)
    save_s = time.perf_counter() - t0
    cfg40 = cfg.replace(max_iters=2 * CKS_ITERS)

    def resume(st, on, with_matvec=False):
        res, _ = solve_shard_from_state(st, n, cfg40, on, "rosenbrock",
                                        kernels=True, with_matvec=with_matvec)
        return res

    uncut = resume(state, mesh)
    torch_dist.barrier()
    t0 = time.perf_counter()
    loaded = load_state_sharded(ck_dir, mesh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    on4 = resume(loaded, mesh)
    same = torch.equal(on4.x, uncut.x) and torch.equal(on4.f, uncut.f) \
        and int(on4.iterations) == int(uncut.iterations)
    differ4 = bool(mesh.comm.any_flag(torch.tensor(not same, device=dev)))
    whole = gather_result(uncut, mesh, n).x
    pair = torch_dist.new_group([0, 1])
    on2 = None
    if rank < 2:
        mesh2 = dist.make_mesh(pair)
        res2 = resume(load_state_sharded(ck_dir, mesh2), mesh2)
        on2 = (gather_result(res2, mesh2, n).x, res2)
    ck = {"save_s": save_s, "load_s": load_s, "same4": not differ4,
          "bytes": sum(p.stat().st_size for p in pathlib.Path(ck_dir).iterdir()),
          "files": sorted(p.name for p in pathlib.Path(ck_dir).iterdir()),
          "f_uncut": float(uncut.f), "k_uncut": int(uncut.iterations)}
    if rank == 0:
        # One process runs the whole-vector kernels; the sharded solve
        # forms S y and Y y from float64 partials, the one-device solver in
        # float32 unless the tail forms them (in float64, rounded once).
        res1 = resume(load_state_sharded(ck_dir, Mesh(None)), Mesh(None),
                      with_matvec=True)
        for label, (x, res) in (("2 ranks", on2), ("1 rank", (res1.x, res1))):
            ck[label] = {"x_err": (x - whole).abs().max().item(),
                         "f": float(res.f), "k": int(res.iterations)}
    torch_dist.barrier()
    out["ckpt"] = ck
    return out


def phase_dist_own_and_ckpt(dev, card, tmp):
    """[dist-own] and [checkpoint-sharded] (the header of this section)."""
    import tpu_lbfgs_torch as tt
    from tpu_lbfgs_torch.dist.launch import spawn_ranks

    ck_dir = tmp / "sharded_ckpt"
    t0 = time.perf_counter()
    ranks = spawn_ranks(_own_ckpt_rank, DIST_RANKS, str(ck_dir),
                        backend="gloo", timeout_s=DIST_TIMEOUT_S,
                        threads=None)
    say(f"[dist-own] {DIST_RANKS} ranks on {card} (gloo, all on cuda:0), "
        f"the job with [checkpoint-sharded] in "
        f"{time.perf_counter() - t0:.1f} s with start-up")
    own = ranks[0]["own"]
    for r in ranks[1:]:
        for label in own:
            check(r["own"][label]["own"] == own[label]["own"],
                  f"[dist-own] {label}: the ranks disagree")
    x0 = _dist_x0(DIST_D, dev).double()
    for label, f, named, tol in OWN_OBJECTIVES:
        rec = own[label]
        single = tt.minimize(f, x0.clone(), _own_cfg(tt, tol))
        solves = {"sharded": rec["own"],
                  "single-device": {"f": single.trace.f.tolist(),
                                    "alpha": single.trace.alpha.tolist(),
                                    "status": int(single.status),
                                    "k": int(single.iterations)}}
        if named is not None:
            solves[f"sharded problem={named!r}"] = rec["named"]
        names = list(solves)
        worst = {}
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                fa, fb = solves[a]["f"], solves[b]["f"]
                rel = max(abs(u - v) / abs(v) for u, v in zip(fa, fb))
                worst[f"{a} / {b}"] = (
                    rel, solves[a]["alpha"] == solves[b]["alpha"]
                    and solves[a]["k"] == solves[b]["k"]
                    and solves[a]["status"] == solves[b]["status"])
        got = rec["own"]
        say(f"[dist-own] {label}, d={DIST_D} float64, {got['k']} iterations "
            f"(status {tt.Status.NAMES[got['status']]}): f {got['f'][0]:.9e}"
            f" -> {got['f'][-1]:.9e}; "
            + "; ".join(f"{k}: f max rel {v[0]:.2e}, alphas, k and status "
                        f"equal {v[1]}" for k, v in worst.items())
            + f" (tol {OWN_F_RTOL}); collectives of one evaluation "
            f"{rec['counts']}; {rec['ms']:.1f} ms per iteration: a "
            "correctness run over gloo on one card, not a scaling number")
        check((got["k"] == OWN_ITERS if tol == 0.0
               else got["status"] == tt.Status.CONVERGED)
              and np.isfinite(got["f"][-1]) and got["f"][-1] < got["f"][0],
              f"[dist-own] {label}: {OWN_ITERS} iterations or convergence, "
              "f finite and decreasing")
        check(all(v[0] <= OWN_F_RTOL and v[1] for v in worst.values()),
              f"[dist-own] {label}: the solves differ: {worst}")
    ck = ranks[0]["ckpt"]
    say(f"[checkpoint-sharded] d={DIST_D} float32, kernel path, saved at "
        f"{CKS_ITERS} on {DIST_RANKS} ranks ({ck['files']}, "
        f"{ck['bytes'] / 1e6:.1f} MB; save {ck['save_s']:.3f} s, load on 4 "
        f"ranks {ck['load_s']:.3f} s, rank 0), resumed to {2 * CKS_ITERS}: "
        f"4 ranks bit-equal to the uncut solve {ck['same4']}; "
        + "; ".join(f"{m}: max |x - uncut| {ck[m]['x_err']:.2e}, f "
                    f"{ck[m]['f']:.6e} against {ck['f_uncut']:.6e}, k "
                    f"{ck[m]['k']}" for m in ("2 ranks", "1 rank"))
        + f" (tol x {CKS_X_TOL}, f {CKS_F_RTOL})")
    check(ck["same4"] and ck["k_uncut"] == 2 * CKS_ITERS,
          "[checkpoint-sharded] the 4-rank resume must equal the uncut solve "
          "bit for bit")
    for m in ("2 ranks", "1 rank"):
        check(ck[m]["k"] == 2 * CKS_ITERS and ck[m]["x_err"] <= CKS_X_TOL
              and abs(ck[m]["f"] - ck["f_uncut"])
              <= CKS_F_RTOL * abs(ck["f_uncut"]),
              f"[checkpoint-sharded] the resume on {m} differs from the "
              "uncut solve")


def phase_scaling(card):
    """scaling_sweep at SCALE_COUNTS ranks on the one card."""
    from tpu_lbfgs_torch.bench.scaling import scaling_sweep

    t0 = time.perf_counter()
    rows = scaling_sweep("rosenbrock", d=DIST_D, iters=SCALE_ITERS,
                         device_counts=SCALE_COUNTS, repeats=2)
    for r in rows:
        say(f"[scaling] {json.dumps(r)}")
    say(f"[scaling] {len(rows)} rows in {time.perf_counter() - t0:.1f} s on "
        f"{card}; one card: not a scaling number")
    check([r["n_devices"] for r in rows] == list(SCALE_COUNTS)
          and all(np.isfinite(r["final_f"]) and r["iters_per_s"] > 0
                  for r in rows)
          and all(r["stack"].startswith("kernels") for r in rows)
          and not any(r["scaling"] for r in rows),
          "[scaling] every count must run the kernel path and no row may "
          "claim scaling on one card")
    check(len({r["final_f"] for r in rows}) == 1 or max(
        abs(r["final_f"] - rows[0]["final_f"]) for r in rows)
        <= DIST_F_RTOL * abs(rows[0]["final_f"]),
        "[scaling] the counts must solve the same problem")


def _main_path_solve(tt, dev, iters):
    p = tt.get_problem("rosenbrock")
    from tpu_lbfgs_torch.bench.harness import _x0

    x0 = _x0(D, SEED, torch.float32, dev)
    vg = tt.fused_value_and_grad("rosenbrock")
    tail = tt.fused_tail_for("rosenbrock")
    cfg = _bench_cfg(tt, iters).replace(record_trace=True)
    return lambda: tt.minimize(p.f, x0.clone(), cfg, value_and_grad=vg,
                               dir_poly=p.dir_poly, fused_tail=tail)


def phase_profile(dev, card, tmp):
    """profile_solve on the main path: a trace that names the fused tail
    kernel, with device time."""
    import tpu_lbfgs_torch as tt
    from tpu_lbfgs_torch import kernels
    from tpu_lbfgs_torch.utils.profiling import profile_solve

    trace_dir = tmp / "profile"
    kernels.reset_launches()
    out = profile_solve(_main_path_solve(tt, dev, PROFILE_ITERS),
                        trace_dir=str(trace_dir))
    text = (trace_dir / "trace.json").read_text()
    events = json.loads(text)["traceEvents"]
    tails = [e for e in events if e.get("cat") == "kernel"
             and "tail_tile_kernel" in e.get("name", "")]
    got = kernels.launch_counts()
    say(f"[profile] profile_solve, main path d={D}, {PROFILE_ITERS} "
        f"iterations: {out['wall_s']:.3f} s traced on {card}; trace "
        f"{len(text) / 1e6:.1f} MB, {len(events)} events, "
        f"{len(tails)} tail_tile_kernel launches on the card "
        f"(device {sum(e.get('dur', 0) for e in tails) / len(tails):.2f} us "
        f"each), fused tail launches {got['rosenbrock_fused_tail']}"
        if tails else "[profile] no tail kernel in the trace")
    check(len(tails) == PROFILE_ITERS
          and got["rosenbrock_fused_tail"] == 2 * PROFILE_ITERS,
          "[profile] the trace must name the fused tail kernel once per "
          "traced iteration")


def phase_debug_nans(dev):
    """set_debug_nans: an objective whose gradient turns NaN raises
    FloatingPointError; the main path with the check equals it without."""
    import tpu_lbfgs_torch as tt
    from tpu_lbfgs_torch.core.solver import set_debug_nans

    calls = [0]
    p = tt.get_problem("rosenbrock")

    def grad(x):
        calls[0] += 1
        g = p.grad(x)
        return g * float("nan") if calls[0] > 5 else g

    f = p.f
    x0 = _dist_x0(D, dev)
    cfg = tt.LBFGSConfig(max_iters=50, tol=0.0)
    set_debug_nans(True)
    try:
        try:
            tt.minimize(f, x0, cfg, grad=grad)
            raised = None
        except FloatingPointError as e:
            raised = str(e)
        plain_calls = calls[0]
        solve = _main_path_solve(tt, dev, PROFILE_ITERS)
        checked = solve()
    finally:
        set_debug_nans(False)
    quiet = solve()
    same = torch.equal(checked.x, quiet.x) and torch.equal(
        checked.trace.f, quiet.trace.f) and torch.equal(
        checked.trace.alpha, quiet.trace.alpha)
    say(f"[debug-nans] a gradient that turns NaN at its call {plain_calls}: "
        f"FloatingPointError {raised!r}; the main path, {PROFILE_ITERS} "
        f"iterations, with the check equal to without it: {same}")
    check(raised is not None and "vg" in raised,
          "[debug-nans] the NaN gradient must raise FloatingPointError "
          "naming the value and gradient")
    check(same, "[debug-nans] the check must not change the iterates")


def phase_examples(card):
    """Each examples/torch_*.py at its defaults on the card, side by side
    (times they print were taken with the others running)."""
    paths = sorted(pathlib.Path("examples").glob("torch_*.py"))
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    t0 = time.perf_counter()

    def start(p):
        return p, subprocess.Popen(
            [sys.executable, "-X", "faulthandler", "-u", str(p)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish(p, proc):
        try:
            text, _ = proc.communicate(timeout=EXAMPLES_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
        tail = "\n".join(line for line in text.splitlines()
                         if "Warning" not in line and "warn" not in line)
        say(f"[examples] {p.name}: exit {proc.returncode}\n{tail[-1500:]}")
        if proc.returncode != 0:
            failed.append(p.name)

    # The examples that start ranks of their own run one at a time, the
    # others side by side beside the first of them.
    spawning = [p for p in paths if "nproc" in p.read_text()]
    failed = []
    procs = [start(p) for p in paths if p not in spawning]
    for p in spawning:
        finish(*start(p))
    for job in procs:
        finish(*job)
    say(f"[examples] {len(paths)} examples on {card} in "
        f"{time.perf_counter() - t0:.1f} s ({len(spawning)} with ranks of "
        f"their own one at a time, beside the others)")
    check(len(paths) == 8 and not failed,
          f"[examples] failed: {failed} (of {[p.name for p in paths]})")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "check needs a CUDA device")
    import tpu_lbfgs_torch  # noqa: F401  (fails outside the repository)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    clock = [time.perf_counter()]

    def lap(phase):
        now = time.perf_counter()
        say(f"[time] {phase}: {now - clock[0]:.1f} s")
        clock[0] = now

    card = phase_card()
    phase_build()
    lap("card and build")
    rec = phase_kernels(dev)
    phase_vg_shapes(dev, card)
    rec.update(phase_tail_forms(dev))
    rec["compact_chain"] = phase_chain(dev)
    rec.update(phase_trial_kernels(dev))
    rec.update(phase_general_kernels(dev))
    phase_compensated(dev, card)
    lap("[kernel] whole-vector forms")
    launches, state, cfg = phase_main_path(dev)
    phase_no_sync(state, cfg)
    batch_launches, state, cfg = phase_batch(dev)
    phase_batch_no_sync(state, cfg)
    launches["compact_chain"] = batch_launches["compact_chain"]
    lap("[main], [batch]")
    phase_graph_if(dev)
    phase_graph(dev, card)
    lap("[graph]")
    rec.update(phase_batch_kernel_checks(dev))
    launches.update(phase_batch_kernel_slice(dev))
    lap("[batch-kernels]")
    launches.update(phase_direct(dev))
    lap("[direct]")
    search_jobs = phase_batch_search(dev, card)
    lap("[batch-search]")
    general_launches, jobs = phase_general(dev)
    jobs += search_jobs
    launches.update(general_launches)
    lap("[general]")
    for name, n in phase_cli(dev).items():
        if not launches.get(name):      # a form no earlier path ran
            launches[name] = n
    phase_routing(dev)
    lap("[cli], [route]")
    rec.update(phase_shard_kernels(dev))
    lap("[kernel] shard-local forms")
    launches.update(phase_dist(dev, card))
    lap("[dist]")
    rec.update(phase_dist_batch_kernels(dev))
    launches.update(phase_dist_batch(dev, card))
    lap("[dist-batch]")
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        phase_checkpoint(dev, pathlib.Path(tmp))
        lap("[checkpoint]")
        phase_dist_own_and_ckpt(dev, card, pathlib.Path(tmp))
        lap("[dist-own], [checkpoint-sharded]")
        phase_scaling(card)
        lap("[scaling]")
        phase_profile(dev, card, pathlib.Path(tmp))
        phase_debug_nans(dev)
        lap("[profile], [debug-nans]")
        phase_examples(card)
        lap("[examples]")
    phase_giant(dev, card)
    lap("[giant]")
    phase_tol(card)
    lap("[tol]")
    phase_protocol(card)
    lap("[protocol]")
    gpu_rate = phase_bench(card)
    phase_bench_batch(card)
    lap("[bench]")
    phase_cpu_baseline(card, gpu_rate)
    lap("[cpu-baseline]")
    phase_launch_counts(jobs)
    phase_graph_kernels_fresh()
    lap("launch counts")

    csrc, pallas = "tpu_lbfgs_torch/csrc/", "tpu_lbfgs/kernels/pallas_ops.py:"
    vg_line = {"quadratic": 443, "rosenbrock": 461, "coupled_quadratic": 489}
    sources = {}
    for body, line in vg_line.items():
        sources[f"{body}_vg"] = (csrc + "fused_vg.cu", f"{pallas}{line}")
        sources[f"{body}_fused_tail"] = (csrc + "fused_tail.cu",
                                         pallas + "653")
        sources[f"{body}_multi_phi"] = (csrc + "multi_phi.cu", pallas + "895")
        sources[f"{body}_multi_phi_dphi"] = (csrc + "multi_phi_dphi.cu",
                                             pallas + "1010")
        for family, line in (("vg", 81), ("fused_tail", 108),
                             ("multi_phi", 171), ("multi_phi_dphi", 196)):
            sources[f"{body}_{family}_local"] = (
                sources[f"{body}_{family}"][0],
                f"tpu_lbfgs/dist/pallas_sharded.py:{line}")
            # The reference's jax.vmap(..., spmd_axis_name=...) over the
            # same shard_map wrappers (tpu_lbfgs/dist/sharded.py:327).
            sources[f"{body}_{family}_local_batched"] = \
                sources[f"{body}_{family}_local"]
        # The batched forms: the same sources, the reference's jax.vmap
        # over the same Pallas kernels.
        for family in ("vg", "fused_tail"):
            sources[f"{body}_{family}_batched"] = sources[f"{body}_{family}"]
    for name in rec:
        if name.startswith("rosenbrock_fused_tail["):
            sources[name] = sources["rosenbrock_fused_tail"]
        if name.startswith("rosenbrock_fused_tail_batched["):
            sources[name] = sources["rosenbrock_fused_tail"]
    sources.update({
        "compact_chain": (csrc + "compact_chain.cu",
                          "tpu_lbfgs/kernels/chain.py:122"),
        "iteration_tail": (csrc + "iteration_tail.cu", pallas + "113"),
        "combine_direction": (csrc + "combine_direction.cu", pallas + "224"),
        "combine_direction[ring bf16]": (csrc + "combine_direction.cu",
                                         pallas + "224"),
    })
    for name in ("iteration_tail", "combine_direction"):
        sources[f"{name}_batched"] = sources[name]
    sources["iteration_tail_batched[f64]"] = sources["iteration_tail"]
    sources["combine_direction_batched[ring bf16]"] = \
        sources["combine_direction"]
    check(set(rec) == set(sources),
          f"kernel forms measured and listed differ: "
          f"{sorted(set(rec) ^ set(sources))}")
    for name in sources:
        check(launches.get(name, 0) > 0,
              f"{name} was never launched on its path")
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                "max_abs_err": rec[name]["max_abs_err"],
                "ms": rec[name]["ms"], "plain_ms": rec[name]["plain_ms"],
                "bound_ms": rec[name]["bound"][0],
                "bound_by": rec[name]["bound"][1],
                "library_ms": rec[name].get("library_ms")}
               for name, (src, rep) in sources.items()]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def graph_kernels_main():
    """``chip_smoke.py --graph-kernels``: phase_graph_kernels alone, the
    process phase_graph_kernels_fresh starts."""
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "check needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_graph_kernels(dev)


if __name__ == "__main__":
    if sys.argv[1:] == ["--graph-kernels"]:
        graph_kernels_main()
    else:
        main()
