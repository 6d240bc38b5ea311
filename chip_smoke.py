#!/usr/bin/env python3
"""Bring-up check of tpu_lbfgs_torch on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from tpu_lbfgs_torch/csrc, holds each
against its plain PyTorch version on the card, drives bench.py's solve
(chained Rosenbrock, d = 2^20, float32, m = 10, compact_incremental
direction, Armijo backtracking on the directional polynomial) through
tpu_lbfgs_torch.minimize, checks that the solve went through the kernels
and that one iteration never waits on the device, and times the solve.
Every check raises on failure, so the exit code is 0 only when all pass.
The last line of output is a JSON record of the device; the line before
it records each kernel.  Without a CUDA device it exits with an error and
prints no record.
"""
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
            for name, r in rec.items():
                say(f"[kernel] {name} d={n}: {r['ms'] * 1e3:.2f} us on the "
                    f"card, plain version {r['plain_ms'] * 1e3:.2f} us")
    return rec


def _bench_cfg(tt, iters):
    return tt.LBFGSConfig(line_search="backtracking",
                          direction="compact_incremental", m=10,
                          use_pallas=True, ls_eval="polynomial",
                          max_iters=iters, tol=0.0)


def phase_main_path(dev):
    import tpu_lbfgs_torch as tt
    from tpu_lbfgs_torch.bench.harness import _x0
    from tpu_lbfgs_torch.kernels import fused_ops

    p = tt.get_problem("rosenbrock")
    x0 = _x0(D, SEED, torch.float32, dev)
    f0 = p.f(x0).item()
    vg = tt.fused_value_and_grad("rosenbrock")
    tail = tt.fused_tail_for("rosenbrock")
    cfg = _bench_cfg(tt, MAIN_ITERS)
    torch.cuda.synchronize()

    fused_ops.reset_launches()
    t0 = time.perf_counter()
    r = tt.minimize(p.f, x0, cfg, value_and_grad=vg, dir_poly=p.dir_poly,
                    fused_tail=tail)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fused_ops.launches)

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
    launches, state, cfg = phase_main_path(dev)
    phase_no_sync(state, cfg)
    phase_bench(card)

    sources = {
        "rosenbrock_vg": ("tpu_lbfgs_torch/csrc/rosenbrock_vg.cu",
                          "tpu_lbfgs/kernels/pallas_ops.py:461"),
        "rosenbrock_fused_tail": (
            "tpu_lbfgs_torch/csrc/rosenbrock_fused_tail.cu",
            "tpu_lbfgs/kernels/pallas_ops.py:653"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                "max_abs_err": rec[name]["max_abs_err"],
                "ms": rec[name]["ms"], "plain_ms": rec[name]["plain_ms"]}
               for name, (src, rep) in sources.items()]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
