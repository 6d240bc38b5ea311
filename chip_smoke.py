#!/usr/bin/env python3
"""Bring-up check of tpu_lbfgs_torch on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from tpu_lbfgs_torch/csrc, holds each
against its plain PyTorch version on the card, and drives four paths,
each solve with the kernels' launch counts set to 0 just before it and
read just after:

- the single instance (chained Rosenbrock, d = 2^20, float32, m = 10,
  compact_incremental direction, Armijo backtracking on the directional
  polynomial) through tpu_lbfgs_torch.minimize, over the Rosenbrock value
  and gradient and fused tail kernels;
- the batch (4096 instances of d = 1024 in bounded lockstep, the same
  solver with fidelity="fixed" and the pair skip) through
  tpu_lbfgs_torch.vmap_minimize, over the batched compact chain kernel;
- direct evaluation (the reference protocol's f32 stack: REFERENCE_PARALLEL,
  compact_incremental, ls_eval="direct", no alpha rescue) under each of the
  8 line searches at d = 2^20 from U(-10, 10), over the value and gradient
  and fused tail kernels and, for the speculative twins, the K-trial
  multi_phi and multi_phi_dphi kernels;
- the general path, a caller's own objective at d = 2^20 in float32 with
  use_pallas=True and no fused tail, over the iteration_tail kernel every
  iteration: chained Rosenbrock under each of the three directions, the
  coupled quadratic from its plain f and grad, an objective differentiated
  by autograd under the default configuration, and one solve with damping,
  compensated dots, a trace and the periodic product refresh; then the
  public combine_direction kernel entry on the states those solves leave.

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
call computes the same function, that call's time.  Without a CUDA device it exits with an error and
prints no record.
"""
import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch

D = 1 << 20                 # bench.py's size
RAGGED = D + 37             # no multiple of any block or lane width
SEED = 42                   # bench.py's seed
MAIN_ITERS = 200
TRACE_ITERS = 20
BENCH_ITERS = 1000
BATCH, BATCH_D = 4096, 1024  # bench.py's batch cell
RAGGED_BATCH = BATCH + 37
BATCH_ITERS = 200
CHAIN_M = (5, 10, 20)

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
# The general path.  iteration_tail against its plain version: the three
# vectors bit for bit, each sum within TRIAL_SUM_RTOL of sum|terms| plus
# one ulp of the working dtype (float64 partials in another order; the
# compensated float32 plain version sums float32 chunks, whose own rounding
# stays below one ulp of a sum this size).  combine_direction runs its plain
# version's operations in its order: bit for bit, tolerance 0.
TAIL_D = (D, RAGGED, 293)
COMBINE_D = (D, RAGGED)
COMBINE_ABS_TOL = 0.0
GENERAL_ITERS = 60
GENERAL_WARMUP = 5
OPTIONS_ITERS = 120
OPTIONS_REFRESH = 50
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
    _build.load()
    say(f"[build] {path.relative_to(_build._PKG.parent)}: nvcc "
        f"{compile_s:.2f} s, total {time.perf_counter() - t0:.2f} s "
        f"({'reused' if compile_s == 0 else 'compiled'})")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say(f"[build]   {line.strip()}")


def _kernel_inputs(n, dev):
    rng = np.random.default_rng(SEED)
    as_t = lambda a: torch.from_numpy(a).to(device=dev, dtype=torch.float32)
    x = as_t(rng.uniform(-2.0, 2.0, n))
    d = as_t(rng.uniform(-1.0, 1.0, n))
    g = as_t(rng.uniform(-1.0, 1.0, n))
    return x, d, g


def phase_kernels(dev):
    from tpu_lbfgs_torch.kernels import fused_ops as ops

    rec = {}
    alpha = torch.full((), 0.125, dtype=torch.float32, device=dev)
    for n in (D, RAGGED):
        x, d, g = _kernel_inputs(n, dev)
        # value and gradient
        f_k, g_k = ops.fused_vg_rosenbrock(x)
        f_p, g_p = ops.rosenbrock_vg_plain(x)
        torch.cuda.synchronize()
        vg_ulp = ulps(g_k, g_p)
        vg_abs = (g_k - g_p).abs().max().item()
        f_rel = abs(f_k.item() - f_p.item()) / f_p.item()   # all terms >= 0
        say(f"[kernel] rosenbrock_vg d={n}: g max abs err {vg_abs:.3e}, "
            f"{vg_ulp:.2f} ulp (tol {VEC_ULPS}); f rel err {f_rel:.3e} "
            f"(tol {SUM_RTOL})")
        check(vg_ulp <= VEC_ULPS and f_rel <= SUM_RTOL,
              f"rosenbrock_vg disagrees with its plain version at d={n}")
        # fused tail
        out_k = ops.fused_tail_rosenbrock(x, d, alpha, g)
        out_p = ops.fused_tail_plain(ops.rosenbrock_vg_plain, x, d, alpha, g)
        torch.cuda.synchronize()
        tail_abs, tail_ulp = 0.0, 0.0
        for i, name in ((0, "x_new"), (2, "g_new"), (3, "s"), (4, "y")):
            tail_abs = max(tail_abs, (out_k[i] - out_p[i]).abs().max().item())
            tail_ulp = max(tail_ulp, ulps(out_k[i], out_p[i]))
        xn, gn, s, y = (t.double() for t in (out_p[0], out_p[2], out_p[3],
                                             out_p[4]))
        dd, gg = d.double(), g.double()
        scale = [out_p[1].double().abs().item(),
                 (s * y).abs().sum().item(), (y * y).sum().item(),
                 (gn * gn).sum().item(), (dd * gn).abs().sum().item(),
                 (gg * gn).abs().sum().item(), (y * gn).abs().sum().item()]
        sums_k = [out_k[1]] + list(out_k[5:11])
        sums_p = [out_p[1]] + list(out_p[5:11])
        sum_err = max(abs(a.item() - b.item()) / sc
                      for a, b, sc in zip(sums_k, sums_p, scale))
        check(out_k[11] is None and out_k[12] is None, "t1/t2 must be None")
        say(f"[kernel] rosenbrock_fused_tail d={n}: vectors max abs err "
            f"{tail_abs:.3e}, {tail_ulp:.2f} ulp (tol {VEC_ULPS}); 7 sums "
            f"max err {sum_err:.3e} of sum|terms| (tol {SUM_RTOL})")
        check(tail_ulp <= VEC_ULPS and sum_err <= SUM_RTOL,
              f"rosenbrock_fused_tail disagrees with its plain version at "
              f"d={n}")
        if n == D:
            rec["rosenbrock_vg"] = {"max_abs_err": vg_abs}
            rec["rosenbrock_fused_tail"] = {"max_abs_err": tail_abs}
            rec["rosenbrock_vg"]["ms"] = device_ms(
                lambda: ops.fused_vg_rosenbrock(x))
            rec["rosenbrock_vg"]["plain_ms"] = device_ms(
                lambda: ops.rosenbrock_vg_plain(x))
            rec["rosenbrock_fused_tail"]["ms"] = device_ms(
                lambda: ops.fused_tail_rosenbrock(x, d, alpha, g))
            rec["rosenbrock_fused_tail"]["plain_ms"] = device_ms(
                lambda: ops.fused_tail_plain(ops.rosenbrock_vg_plain, x, d,
                                             alpha, g))
            # Per element: x in and g out, about 18 operations; the tail
            # x, d, g in and x_new, g_new, s, y out, about 40.
            rec["rosenbrock_vg"]["bound"] = bound_ms(8 * n + 4, 18 * n)
            rec["rosenbrock_fused_tail"]["bound"] = bound_ms(
                28 * n + 4 + 28, 40 * n)
            for name, r in rec.items():
                say(f"[kernel] {name} d={n}: {r['ms'] * 1e3:.2f} us on the "
                    f"card, plain version {r['plain_ms'] * 1e3:.2f} us, "
                    f"bound {r['bound'][0] * 1e3:.2f} us by {r['bound'][1]}")
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
        if m == 10 and B == BATCH:
            ms = device_ms(lambda: chain.compact_chain_batched(
                *args, m=m, skip_thr=1e-10))
            plain_ms = device_ms(lambda: chain.chain_batched_plain(
                *args, m=m, skip_thr=1e-10))
            say(f"[kernel] compact_chain m={m} B={B} {dt}: {ms * 1e3:.2f} us "
                f"on the card, plain version {plain_ms * 1e3:.2f} us")
            if dt == torch.float32:     # the batch solve's dtype
                rec["ms"], rec["plain_ms"] = ms, plain_ms
                # Per instance: SY, YY, four (m,) vectors, n_pairs and
                # g_norm in; v, u, gamma, g.d and the flag out; two
                # triangular solves, the YY product and the dots, about
                # 6 m^2 + 10 m operations.
                rec["bound"] = bound_ms(
                    B * (4 * (2 * m * m + 6 * m + 4) + 1),
                    B * (6 * m * m + 10 * m))
    return rec


def _trial_abs_terms(x, d, alphas):
    """Per trial, sum |f terms| and sum |g_i d_i| in float64 at the float32
    trial points: the scale of each sum's rounding error."""
    from tpu_lbfgs_torch.kernels.fused_ops import rosenbrock_grad_plain

    f_abs, g_abs = [], []
    for a in alphas.unbind(0):
        u = (x + a * d).double()
        t = u[1:] - u[:-1] * u[:-1]
        f_abs.append((100.0 * t * t + (1.0 - u[:-1]) ** 2).abs().sum())
        g_abs.append((rosenbrock_grad_plain(u) * d.double()).abs().sum())
    return torch.stack(f_abs), torch.stack(g_abs)


def _beyond_ulp(a, b, scale):
    """Largest |a - b| beyond one ulp of b in its dtype, in units of scale
    (NaN where either side is NaN)."""
    b_abs = b.abs()
    ulp = torch.nextafter(b_abs, torch.full_like(b_abs, float("inf"))) - b_abs
    over = ((a.double() - b.double()).abs() - ulp.double()).clamp(min=0.0)
    return (over / scale).max().item()


def phase_trial_kernels(dev):
    from tpu_lbfgs_torch.kernels import fused_ops
    from tpu_lbfgs_torch.kernels import line_search_ops as ops

    names = ("rosenbrock_multi_phi", "rosenbrock_multi_phi_dphi")
    rec = {name: {"max_abs_err": 0.0} for name in names}
    rng = np.random.default_rng(SEED)
    for n, k in itertools.product(TRIAL_D, TRIALS):
        x, d, _ = _kernel_inputs(n, dev)
        alphas = torch.from_numpy(2.0 ** rng.integers(-6, 3, k)
                                  * rng.uniform(0.5, 1.0, k)).to(
            device=dev, dtype=torch.float32)
        phi_k = ops.multi_phi_rosenbrock(x, d, alphas)
        phi_p = ops.multi_phi_plain(fused_ops.rosenbrock_f_plain, x, d, alphas)
        f_k, g_k = ops.multi_phi_dphi_rosenbrock(x, d, alphas)
        f_p, g_p = ops.multi_phi_dphi_plain(fused_ops.rosenbrock_vg_plain, x,
                                            d, alphas)
        torch.cuda.synchronize()
        f_abs, g_abs = _trial_abs_terms(x, d, alphas)
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
            names[0]: (lambda: ops.multi_phi_rosenbrock(x, d, alphas),
                       lambda: ops.multi_phi_plain(
                           fused_ops.rosenbrock_f_plain, x, d, alphas)),
            names[1]: (lambda: ops.multi_phi_dphi_rosenbrock(x, d, alphas),
                       lambda: ops.multi_phi_dphi_plain(
                           fused_ops.rosenbrock_vg_plain, x, d, alphas)),
        }
        for name, (kernel, plain) in times.items():
            ms, plain_ms = device_ms(kernel), device_ms(plain)
            say(f"[kernel] {name} d={n} K={k}: {ms * 1e3:.2f} us on the "
                f"card, plain version {plain_ms * 1e3:.2f} us")
            # The record keeps the K the direct path gives each kernel most:
            # 8 for multi_phi, the 36-node tree for multi_phi_dphi.
            if k == (8 if name == names[0] else 36):
                rec[name]["ms"], rec[name]["plain_ms"] = ms, plain_ms
                # x, d and K alphas in, K (or 2 K) sums out; per element
                # and trial about 13 operations for phi (two trial points,
                # the term, its float64 add), 28 with phi' as well.
                outs = 1 if name == names[0] else 2
                rec[name]["bound"] = bound_ms(
                    8 * n + 4 * k + 4 * outs * k,
                    (13 if name == names[0] else 28) * n * k)
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

    for n, m, dt in itertools.product(COMBINE_D, CHAIN_M,
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

    kernels.reset_launches()
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
        f"launches {launches}")
    check(r.status.item() == tt.Status.MAX_ITERS and k == MAIN_ITERS,
          "the solve must run its 200 iterations to max_iters")
    check(r.x.shape == (D,) and bool(torch.isfinite(r.x).all())
          and np.isfinite(f) and f < f0, "f must be finite and decrease")
    check(launches["rosenbrock_fused_tail"] == k,
          "the fused tail kernel must launch once per iteration")
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
    from tpu_lbfgs_torch.bench.harness import bench_gpu

    r = bench_gpu(problem="rosenbrock", d=D, iters=BENCH_ITERS,
                  cfg=_bench_cfg(tt, BENCH_ITERS), repeats=3)
    check(np.isfinite(r.final_f) and r.iterations == BENCH_ITERS,
          "bench_gpu must finish its iterations with a finite f")
    say(f"[bench] {r.name}: {r.iters_per_s:.2f} iterations/s "
        f"({BENCH_ITERS} iterations, best of 3 runs {r.wall_s:.4f} s, "
        f"runs {[round(w, 4) for w in r.details['repeat_walls_s']]}) on "
        f"{card}")


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

    kernels.reset_launches()
    t0 = time.perf_counter()
    r = tt.vmap_minimize(p.f, x0, cfg, grad=p.grad, dir_poly=p.dir_poly,
                         lockstep="bounded")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()

    counts = torch.bincount(r.status.long(), minlength=4).tolist()
    status = {tt.Status.NAMES[i]: n for i, n in enumerate(counts) if n}
    ok = r.status != tt.Status.LINE_SEARCH_FAILED
    mean0, mean1 = f0.mean().item(), r.f.mean().item()
    say(f"[batch] vmap_minimize B={BATCH} d={BATCH_D} float32 bounded, "
        f"{BATCH_ITERS} iterations in {wall:.3f} s: mean f {mean0:.6e} -> "
        f"{mean1:.6e}, max |g| {r.g_norm.max().item():.4e}, status {status}, "
        f"guards {r.guards.sum(0).tolist()}, launches {launches}")
    check(bool((r.iterations == BATCH_ITERS).all()),
          "every lane must run its 200 iterations")
    check(launches["compact_chain"] == BATCH_ITERS,
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
    return launches, state, cfg


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


def _direct_cfg(tt, strategy, iters):
    # bench/reference_protocol.py::run_tpu_cell's float32 stack, no rescue.
    return tt.REFERENCE_PARALLEL.replace(
        line_search=strategy, direction="compact_incremental",
        ls_eval="direct", use_pallas=True, alpha_rescue_floor=None,
        max_iters=iters, tol=0.0)


def _direct_solver(tt, use_kernels=True):
    return dict(
        value_and_grad=tt.fused_value_and_grad("rosenbrock"),
        fused_tail=tt.fused_tail_for("rosenbrock"),
        phi_batch=tt.multi_phi_for("rosenbrock", use_pallas=use_kernels),
        phi_dphi_batch=tt.multi_phi_dphi_for("rosenbrock",
                                             use_pallas=use_kernels))


def phase_direct(dev):
    import tpu_lbfgs_torch as tt
    from tpu_lbfgs_torch import kernels
    from tpu_lbfgs_torch.kernels import line_search_ops
    from tpu_lbfgs_torch.linesearch import strategies

    p = tt.get_problem("rosenbrock")
    rng = np.random.default_rng(SEED)
    x0 = torch.from_numpy(rng.uniform(-DIRECT_BOX, DIRECT_BOX, D)).to(
        device=dev, dtype=torch.float32)
    f0 = p.f(x0).item()
    solver = _direct_solver(tt)
    trial_kernels = tuple(line_search_ops.launches)
    launches = dict.fromkeys(trial_kernels, 0)
    for strategy in tt.config.LINE_SEARCH_METHODS:
        cfg = _direct_cfg(tt, strategy, DIRECT_ITERS)
        torch.cuda.synchronize()
        kernels.reset_launches()
        strategies.reset_host_reads()
        t0 = time.perf_counter()
        r = tt.minimize(p.f, x0, cfg, **solver)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = kernels.launch_counts()
        reads = strategies.host_reads["line_search"]
        k, n_fev, f = r.iterations.item(), r.n_fev.item(), r.f.item()
        # init_state charges one evaluation, each iteration its tail's one.
        trials = n_fev - 1 - k
        say(f"[direct] {strategy}: {k} iterations in {wall:.3f} s, "
            f"{wall / k * 1e3:.3f} ms/iteration, {trials / k:.2f} trials/"
            f"iteration, {reads / k:.2f} line-search host reads/iteration "
            f"(+1 for the loop condition); f {f0:.6e} -> {f:.6e}, |g| "
            f"{r.g_norm.item():.4e}, status "
            f"{tt.Status.NAMES[r.status.item()]}, guards "
            f"{r.guards.tolist()}, launches {got}")
        check(r.status.item() == tt.Status.MAX_ITERS and k == DIRECT_ITERS,
              f"{strategy}: the solve must run its {DIRECT_ITERS} iterations")
        check(r.x.shape == (D,) and bool(torch.isfinite(r.x).all())
              and np.isfinite(f) and f < f0,
              f"{strategy}: f must be finite and decrease")
        check(got["rosenbrock_fused_tail"] == k and got["rosenbrock_vg"] >= 1,
              f"{strategy}: the tail kernel must launch once per iteration "
              "and the vg kernel at least once")
        # A twin reads one condition per pass over (x, d): per K-wide round,
        # and per scalar zoom turn of wolfe_interpolation_speculative's
        # phase B (one vg launch each, past init_state's).  So its rounds
        # are its reads less those turns, and its K-trial kernel launches
        # once per round.
        batched = sum(got[name] for name in trial_kernels)
        if strategy.endswith("_speculative"):
            own = ("rosenbrock_multi_phi"
                   if strategy == "backtracking_speculative"
                   else "rosenbrock_multi_phi_dphi")
            rounds = reads - (got["rosenbrock_vg"] - 1)
            check(rounds > 0 and got[own] == batched == rounds,
                  f"{strategy}: {own} must launch once per round ({rounds} "
                  f"rounds, launches {got})")
        else:
            check(batched == 0, f"{strategy} must not launch a K-trial kernel")
        for name in trial_kernels:
            launches[name] += got[name]

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


def _launches_per_iteration(step, state, iters=5):
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
    kernels.reset_launches()
    strategies.reset_host_reads()
    t0 = time.perf_counter()
    r = tt.minimize(f, x0, cfg, **solver)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = kernels.launch_counts()
    reads = strategies.host_reads["line_search"]
    k, fk = r.iterations.item(), r.f.item()
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
        f"{r.guards.tolist()}, launches {got}")
    check(k > 0 and r.x.shape == x0.shape and bool(torch.isfinite(r.x).all())
          and np.isfinite(fk) and fk < f0,
          f"{label}: f must be finite and decrease")
    check(got["iteration_tail"] == k and got["rosenbrock_fused_tail"] == 0,
          f"{label}: iteration_tail must launch once per iteration")
    if expect_status is not None:
        check(r.status.item() == expect_status,
              f"{label}: status {status}")
    return r, got


def phase_launch_counts(jobs):
    """Device launches per iteration of each general-path solve, after
    every timed phase: a profiler session can leave its tracing hooks on
    the launches that follow."""
    import tpu_lbfgs_torch as tt

    for label, x0, vg, m, step in jobs:
        state = tt.init_state(vg, x0, m)
        for _ in range(3):
            state = step(state)
        per_it = _launches_per_iteration(step, state)
        say(f"[general] {label}: "
            + ("device launches/iteration not measured (the profiler saw "
               "no device activity)" if per_it is None
               else f"{per_it:.0f} device launches/iteration"))


def phase_general(dev):
    import tpu_lbfgs_torch as tt
    from tpu_lbfgs_torch import kernels
    from tpu_lbfgs_torch.bench.harness import _x0
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
        check(got["rosenbrock_vg"] == r.iterations.item() + 1,
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


def phase_bench_batch(card):
    from tpu_lbfgs_torch.bench.harness import bench_batch

    r = bench_batch(problem="rosenbrock", batch=BATCH, d=BATCH_D,
                    iters=BATCH_ITERS, repeats=3)
    check(np.isfinite(r.final_f) and r.iterations == BATCH_ITERS,
          "bench_batch must finish its iterations with a finite f")
    say(f"[bench] {r.name}: {r.iters_per_s:.2f} instance-iterations/s "
        f"({BATCH_ITERS} iterations of {BATCH} lanes, best of 3 runs "
        f"{r.wall_s:.4f} s, runs "
        f"{[round(w, 4) for w in r.details['repeat_walls_s']]}, status "
        f"counts {r.details['status_counts']}) on {card}")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "check needs a CUDA device")
    import tpu_lbfgs_torch  # noqa: F401  (fails outside the repository)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = phase_card()
    phase_build()
    rec = phase_kernels(dev)
    rec["compact_chain"] = phase_chain(dev)
    rec.update(phase_trial_kernels(dev))
    rec.update(phase_general_kernels(dev))
    launches, state, cfg = phase_main_path(dev)
    phase_no_sync(state, cfg)
    batch_launches, state, cfg = phase_batch(dev)
    phase_batch_no_sync(state, cfg)
    launches["compact_chain"] = batch_launches["compact_chain"]
    launches.update(phase_direct(dev))
    general_launches, jobs = phase_general(dev)
    launches.update(general_launches)
    phase_bench(card)
    phase_bench_batch(card)
    phase_launch_counts(jobs)

    sources = {
        "rosenbrock_vg": ("tpu_lbfgs_torch/csrc/rosenbrock_vg.cu",
                          "tpu_lbfgs/kernels/pallas_ops.py:461"),
        "rosenbrock_fused_tail": (
            "tpu_lbfgs_torch/csrc/rosenbrock_fused_tail.cu",
            "tpu_lbfgs/kernels/pallas_ops.py:653"),
        "compact_chain": ("tpu_lbfgs_torch/csrc/compact_chain.cu",
                          "tpu_lbfgs/kernels/chain.py:122"),
        "rosenbrock_multi_phi": (
            "tpu_lbfgs_torch/csrc/rosenbrock_multi_phi.cu",
            "tpu_lbfgs/kernels/pallas_ops.py:895"),
        "rosenbrock_multi_phi_dphi": (
            "tpu_lbfgs_torch/csrc/rosenbrock_multi_phi_dphi.cu",
            "tpu_lbfgs/kernels/pallas_ops.py:1010"),
        "iteration_tail": ("tpu_lbfgs_torch/csrc/iteration_tail.cu",
                           "tpu_lbfgs/kernels/pallas_ops.py:113"),
        "combine_direction": ("tpu_lbfgs_torch/csrc/combine_direction.cu",
                              "tpu_lbfgs/kernels/pallas_ops.py:224"),
    }
    for name in sources:
        check(launches[name] > 0, f"{name} was never launched on its path")
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


if __name__ == "__main__":
    main()
