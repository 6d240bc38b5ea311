"""A first look at the block runner's CUDA graphs on the card: bench.py's
solve at d = 2^20 (400 iterations) and the batch cell (4096 x 1024, 200
iterations, bounded) replayed against the same blocks eager, in turns; a
capture under torch.cuda.set_sync_debug_mode("error"); a fixed-trip
speculative Wolfe search under solve_bounded and an autograd gradient in a
capture, each against eager; the error an objective that reads the host
raises; device kernels of a block of 20 and of 1 from torch.profiler,
replayed and eager, and replays under the sync mode.  One line per step,
OK or FAIL with its traceback.  Needs the card; run from the repository's
root:

    python3 torch_records/graph_rehearsal.py
"""
import contextlib
import os
import sys
import time
import traceback

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import tpu_lbfgs_torch as tt  # noqa: E402
from tpu_lbfgs_torch import kernels  # noqa: E402
from tpu_lbfgs_torch.bench.harness import _x0  # noqa: E402
from tpu_lbfgs_torch.core import blocks  # noqa: E402
from tpu_lbfgs_torch.kernels import _build  # noqa: E402

dev = torch.device("cuda", 0)
FIELDS = ("x", "f", "g_norm", "k", "status", "guards", "n_fev", "n_gev")


def step(label, fn):
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
        print(f"OK {label} {time.perf_counter() - t0:.3f}s {out}", flush=True)
    except Exception:
        print(f"FAIL {label}", flush=True)
        traceback.print_exc()
        sys.stdout.flush()


def same(a, b):
    return {n: torch.equal(getattr(a, n), getattr(b, n)) for n in FIELDS
            if hasattr(a, n)}


print(_build.build()[1], flush=True)
p = tt.get_problem("rosenbrock")
vg = tt.fused_value_and_grad("rosenbrock")
tail = tt.fused_tail_for("rosenbrock")
x0 = _x0(1 << 20, 42, torch.float32, dev)
cfg = tt.LBFGSConfig(line_search="backtracking",
                     direction="compact_incremental", m=10, use_pallas=True,
                     ls_eval="polynomial", max_iters=400, tol=0.0)


def main_path():
    res = {}
    for mode in ("eager", "graph", "graph", "eager"):
        ctx = blocks.eager_loops() if mode == "eager" else \
            contextlib.nullcontext()
        kernels.reset_launches()
        blocks.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctx:
            r = tt.minimize(p.f, x0, cfg, value_and_grad=vg,
                            dir_poly=p.dir_poly, fused_tail=tail)
        torch.cuda.synchronize()
        w = time.perf_counter() - t0
        res.setdefault(mode, []).append((r, w, dict(blocks.stats),
                                         kernels.launch_counts()[
                                             "rosenbrock_fused_tail"],
                                         kernels.replay_counts()[
                                             "rosenbrock_fused_tail"]))
    e, g = res["eager"][0][0], res["graph"][0][0]
    return (same(e, g), [(w, s, n, rr) for _, w, s, n, rr in
                         res["eager"] + res["graph"]])


step("main path 400 eager vs graph", main_path)


def batch():
    bx = torch.from_numpy(np.random.default_rng(42).uniform(
        -2, 2, (4096, 1024))).to(dev, torch.float32)
    bcfg = tt.LBFGSConfig(line_search="backtracking",
                          direction="compact_incremental", m=10,
                          ls_eval="polynomial", fidelity="fixed",
                          pair_skip_threshold=1e-10, max_iters=200, tol=0.0)
    out = []
    for mode in ("eager", "graph", "graph", "eager"):
        ctx = blocks.eager_loops() if mode == "eager" else \
            contextlib.nullcontext()
        blocks.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctx:
            r = tt.vmap_minimize(p.f, bx, bcfg, grad=p.grad,
                                 dir_poly=p.dir_poly, lockstep="bounded")
        torch.cuda.synchronize()
        out.append((mode, r, time.perf_counter() - t0, dict(blocks.stats)))
    return same(out[0][1], out[1][1]), [(m, w, s) for m, _, w, s in out]


step("batch 200 bounded eager vs graph", batch)


def sync_debug_capture():
    bx = torch.from_numpy(np.random.default_rng(1).uniform(
        -2, 2, (512, 1024))).to(dev, torch.float32)
    bcfg = tt.LBFGSConfig(line_search="backtracking", ls_eval="direct",
                          direction="compact_incremental", max_iters=5,
                          tol=0.0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r = tt.vmap_minimize(p.f, bx, bcfg, grad=p.grad, lockstep="bounded")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return r.f.mean().item(), dict(blocks.stats)


step("capture under sync debug error", sync_debug_capture)


def spec_single_bounded():
    from tpu_lbfgs_torch.problems.suite import multi_phi_dphi_for
    c = tt.REFERENCE_PARALLEL.replace(
        line_search="backtracking_wolfe_speculative",
        direction="compact_incremental", ls_eval="direct",
        alpha_rescue_floor=None, max_iters=10, tol=0.0)
    x1 = torch.from_numpy(np.random.default_rng(42).uniform(
        -10, 10, 1 << 20)).to(dev, torch.float32)
    rr = []
    for mode in ("graph", "eager"):
        ctx = blocks.eager_loops() if mode == "eager" else \
            contextlib.nullcontext()
        with ctx:
            rr.append(tt.solve_bounded(c, p.f, vg, tt.init_state(vg, x1, 10),
                                       None, tail, None,
                                       multi_phi_dphi_for("rosenbrock")))
    return same(*rr), dict(blocks.stats)


step("single-instance fixed-trip spec wolfe bounded", spec_single_bounded)


def autograd_capture():
    def beale(x):
        a, b = x[..., ::2], x[..., 1::2]
        return torch.sum((1.5 - a + a * b) ** 2 + (2.25 - a + a * b**2) ** 2,
                         dim=-1)
    bx = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (64, 256))).to(dev, torch.float32)
    c = tt.LBFGSConfig(max_iters=30, tol=1e-5)
    rr = []
    for mode in ("graph", "eager"):
        ctx = blocks.eager_loops() if mode == "eager" else \
            contextlib.nullcontext()
        with ctx:
            rr.append(tt.vmap_minimize(beale, bx, c, lockstep="while"))
    return {n: torch.equal(getattr(rr[0], n), getattr(rr[1], n))
            for n in ("x", "f", "iterations", "status")}, dict(blocks.stats)


step("autograd in capture (batch while)", autograd_capture)


def host_read_objective():
    def f(x):
        if x.sum().item() > 1e30:
            return x.sum()
        return torch.sum(x * x, dim=-1)

    bx = torch.ones(8, 16, device=dev)
    return tt.vmap_minimize(f, bx, tt.LBFGSConfig(max_iters=3),
                            lockstep="bounded").f


step("host-reading objective (must fail naming it)", host_read_objective)


def profile_counts():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tpu_lbfgs_torch.core.solver import _stepper
    st = tt.init_state(vg, x0, 10)
    c = cfg.replace(max_iters=1 << 30)
    out = {}
    for mode in ("graph", "eager"):
        ctx = blocks.eager_loops() if mode == "eager" else \
            contextlib.nullcontext()
        with ctx:
            drv = blocks.BlockRunner(c, _stepper(c, p.f, vg, p.dir_poly,
                                                 tail), st, True)
        drv.start(None)
        drv.run(20)
        drv.run(1)
        torch.cuda.synchronize()
        counts = []
        for n in (20, 1):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                drv.run(n)
                torch.cuda.synchronize()
            counts.append(sum(e.count for e in prof.key_averages()
                              if e.device_type == DeviceType.CUDA))
        out[mode] = counts
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                drv.run(20)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out


step("profiler counts and sync-free replay", profile_counts)
