"""What capturing a solve's blocks as CUDA graphs costs against running the
same blocks eagerly (``tpu_lbfgs_torch.eager_loops``), each solve making
its own runner and capturing afresh, as a call of ``minimize`` /
``vmap_minimize`` does:

- short solves on bench.py's path (rosenbrock, the fused vg and tail,
  compact_incremental, polynomial backtracking, tol 0) at d = 2^12 and
  2^20 for ``SHORT_ITERS`` iterations, and the batch cell (4096 x 1024,
  bounded) for ``BATCH_SHORT_ITERS``; in turns (eager, graphs, graphs,
  eager);
- every line search in direct mode on the batch cell under
  ``vmap_minimize(lockstep="bounded")``, whose fixed-trip searches make the
  largest graphs, for ``SEARCH_ITERS`` iterations: eager, then graphs.

Each line is one JSON object: walls in seconds, capture seconds, the
iterations the blocks stepped and whether the two runs agree bit for bit.
Every solve here captures, whatever its budget: the script sets
``blocks.CAPTURE_MIN_ITERS``, the rule these numbers chose, to 0.

``--gated`` measures the searches that loop on the gated driver instead
(each search loop one CUDA graph WHILE node whose body is the loop's one
turn, ``kernels.graph_if``), the numbers behind
``blocks.GATED_BLOCK_ITERS``, ``blocks.GATED_CAPTURE_MIN_ITERS`` and the
capture of a batch's fixed trip (``solve_bounded``): each of the 8
searches in direct mode (the reference protocol's float32 stack of
chip_smoke's [direct]) on one instance at d = 2^20 for ``GATED_ITERS``
iterations, from blocks of ``GATED_BLOCKS`` iterations, and on the batch
cell (4096 x 1024) for ``GATED_BATCH_ITERS`` under both lockstep forms
from blocks of ``GATED_BATCH_BLOCKS``: capture seconds (each captured
solve's, the warm-up's share apart), WHILE nodes and other graph nodes
per captured iteration, ms per iteration replayed (a kept runner's second
solve) against the same solve read-driven eagerly (``eager_loops()``: the
per-iteration loop) or, under bounded lockstep, on its eager fixed-trip
blocks, in turns (eager, graphs, graphs, eager), one replay's host and
device milliseconds, and the iterations after which the capture has paid
for itself (capture seconds over the ms an iteration saved).  Needs the
card; run from the repository's root:

    python3 torch_records/graph_costs.py [--gated]
"""
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import tpu_lbfgs_torch as tt  # noqa: E402
from tpu_lbfgs_torch.bench.harness import _x0  # noqa: E402
from tpu_lbfgs_torch.core import blocks  # noqa: E402
from tpu_lbfgs_torch.kernels import _build  # noqa: E402

GATED_ITERS = 100
GATED_BATCH_ITERS = 40
GATED_BLOCKS = (1, 5, 20)
GATED_BATCH_BLOCKS = (1, 20)
SHORT_ITERS = (20, 40, 100)
BATCH_SHORT_ITERS = (20, 40)
SEARCH_ITERS = 40
FIELDS = ("x", "f", "g_norm", "iterations", "status", "guards", "n_fev",
          "n_gev")
dev = torch.device("cuda", 0)


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def same(a, b):
    return all(torch.equal(getattr(a, n).nan_to_num(), getattr(b, n)
                           .nan_to_num()) for n in FIELDS)


def mode(name):
    return blocks.eager_loops() if name == "eager" \
        else contextlib.nullcontext()


def timed(name, run):
    blocks.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mode(name):
        out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(blocks.stats)


def turns(label, run, modes=("eager", "graphs", "graphs", "eager")):
    with blocks.eager_loops():
        run()                  # the kernels' load, the libraries' handles
    outs, walls, stats = {}, {m: [] for m in modes}, {}
    for m in modes:
        out, wall, st = timed(m, run)
        outs.setdefault(m, out)
        walls[m].append(wall)
        stats[m] = st
    print(json.dumps({
        "what": label, "walls_s": walls,
        "capture_s": stats["graphs"]["capture_s"],
        "steps": stats["graphs"]["steps"],
        "replays": stats["graphs"]["replays"],
        "bit_equal": same(outs["eager"], outs["graphs"]),
        "card": card()}), flush=True)


def main():
    print(json.dumps({"build": _build.build()[1]}), flush=True)
    blocks.CAPTURE_MIN_ITERS = 0
    p = tt.get_problem("rosenbrock")
    vg = tt.fused_value_and_grad("rosenbrock")
    tail = tt.fused_tail_for("rosenbrock")
    for d in (1 << 12, 1 << 20):
        x0 = _x0(d, 42, torch.float32, dev)
        for n in SHORT_ITERS:
            cfg = tt.LBFGSConfig(
                line_search="backtracking", direction="compact_incremental",
                m=10, use_pallas=True, ls_eval="polynomial", max_iters=n,
                tol=0.0)
            turns(f"minimize d={d} {n} iterations",
                  lambda: tt.minimize(p.f, x0, cfg, value_and_grad=vg,
                                      dir_poly=p.dir_poly, fused_tail=tail))

    bx = torch.from_numpy(np.random.default_rng(42).uniform(
        -2.0, 2.0, (4096, 1024))).to(dev, torch.float32)
    bcfg = tt.LBFGSConfig(line_search="backtracking",
                          direction="compact_incremental", m=10,
                          ls_eval="polynomial", fidelity="fixed",
                          pair_skip_threshold=1e-10, tol=0.0)
    for n in BATCH_SHORT_ITERS:
        c = bcfg.replace(max_iters=n)
        turns(f"vmap_minimize bounded B=4096 d=1024 {n} iterations",
              lambda: tt.vmap_minimize(p.f, bx, c, grad=p.grad,
                                       dir_poly=p.dir_poly,
                                       lockstep="bounded"))

    for strategy in tt.config.LINE_SEARCH_METHODS:
        c = bcfg.replace(line_search=strategy, ls_eval="direct",
                         max_iters=SEARCH_ITERS)
        turns(f"vmap_minimize bounded direct {strategy} B=4096 d=1024 "
              f"{SEARCH_ITERS} iterations",
              lambda: tt.vmap_minimize(p.f, bx, c, grad=p.grad,
                                       lockstep="bounded"),
              modes=("eager", "graphs"))


def direct_cfg(strategy, iters):
    # chip_smoke.py's [direct] stack: bench/reference_protocol.py's float32
    # protocol, no rescue.
    return tt.REFERENCE_PARALLEL.replace(
        line_search=strategy, direction="compact_incremental",
        ls_eval="direct", use_pallas=True, alpha_rescue_floor=None,
        max_iters=iters, tol=0.0)


def replay_ms(kept, reps=20):
    """One replay of a kept runner's block graph: host ms to return from
    ``replay()`` and device ms between events around ``reps`` replays."""
    graph = kept.runner._graphs[("iterate", kept.runner.block)][0]
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        graph.replay()
    host = (time.perf_counter() - t0) / reps * 1e3
    end.record()
    end.synchronize()
    return host, start.elapsed_time(end) / reps


def gated_turns(label, solve, iters, modes, block=1, eager_label="eager"):
    """Each mode in turns: "eager" under eager_loops(), "graphs" captured
    with a kept runner (its first solve captures, the second replays).
    One JSON line."""
    from tpu_lbfgs_torch.linesearch import strategies

    blocks.GATED_BLOCK_ITERS = block
    with blocks.eager_loops():
        solve(None)
    walls, outs, info = {m: [] for m in set(modes)}, {}, {}
    captures = {"first_solve_s": [], "capture_s": [], "warmup_s": []}
    for m in modes:
        if m == "eager":
            out, wall, _ = timed("eager", lambda: solve(None))
            outs.setdefault(m, out)
        else:
            kept = blocks.Kept()
            _, first, st = timed("graphs", lambda: solve(kept))
            strategies.reset_host_reads()
            out, wall, st2 = timed("graphs", lambda: solve(kept))
            st2 = blocks.read_stats()
            # The result lives in the kept buffers, which replay_ms steps
            # on: keep a copy.
            outs.setdefault(m, out._replace(**{
                n: getattr(out, n).clone() for n in FIELDS}))
            n = kept.runner.block
            for name, v in (("first_solve_s", first),
                            ("capture_s", st["capture_s"]),
                            ("warmup_s", st["warmup_s"])):
                captures[name].append(v)
            info[m] = {"graph_iterations": n,
                       "while_nodes_per_iteration": st["while_nodes"] / n,
                       "graph_nodes_per_iteration": st["graph_nodes"] / n,
                       "gated_turns_per_iteration":
                           st2["gated_turns"] / iters,
                       "search_host_reads": strategies.host_reads[
                           "line_search"],
                       "loop_host_reads": st2["host_reads"],
                       "replay_host_ms, replay_device_ms":
                           replay_ms(kept)}
        walls[m].append(wall / iters * 1e3)
    saved = (np.mean(walls["eager"]) - np.mean(walls["graphs"])) / 1e3
    info["graphs"].update(captures)
    info["graphs"]["break_even_iterations"] = [
        c / saved if saved > 0 else None for c in captures["capture_s"]]
    print(json.dumps({
        "what": label, "block": block,
        "ms_per_iteration": walls, "eager_is": eager_label,
        "graphs": info,
        "bit_equal": {m: same(outs["eager"], outs[m]) for m in outs
                      if m != "eager"},
        "card": card()}), flush=True)


def gated_main():
    print(json.dumps({"build": _build.build()[1]}), flush=True)
    blocks.CAPTURE_MIN_ITERS = blocks.GATED_CAPTURE_MIN_ITERS = 0
    p = tt.get_problem("rosenbrock")
    vg = tt.fused_value_and_grad("rosenbrock")
    kw = dict(fused_tail=tt.fused_tail_for("rosenbrock"),
              phi_batch=tt.multi_phi_for("rosenbrock"),
              phi_dphi_batch=tt.multi_phi_dphi_for("rosenbrock"))
    x0 = torch.from_numpy(np.random.default_rng(42).uniform(
        -10.0, 10.0, 1 << 20)).to(dev, torch.float32)
    bx = torch.from_numpy(np.random.default_rng(42).uniform(
        -2.0, 2.0, (4096, 1024))).to(dev, torch.float32)
    bvg = tt.make_value_and_grad(p.f, p.grad)
    for strategy in tt.config.LINE_SEARCH_METHODS:
        cfg = direct_cfg(strategy, GATED_ITERS)

        def one(kept, cfg=cfg):
            state = tt.init_state(vg, x0, cfg.m)
            return tt.finalize_result(cfg, tt.solve_from_state(
                cfg, p.f, vg, state, None, kept=kept, **kw))

        label = f"one instance d=2^20 direct {strategy}"
        for block in GATED_BLOCKS:
            gated_turns(label, one, GATED_ITERS,
                        ("eager", "graphs", "graphs", "eager"), block)
        bcfg = tt.LBFGSConfig(
            line_search=strategy, direction="compact_incremental", m=10,
            ls_eval="direct", fidelity="fixed", pair_skip_threshold=1e-10,
            tol=0.0, max_iters=GATED_BATCH_ITERS)
        for lockstep in ("while", "bounded"):
            fn = tt.solve_bounded if lockstep == "bounded" \
                else tt.solve_from_state

            def batch(kept, fn=fn, bcfg=bcfg):
                state = tt.init_state(bvg, bx, bcfg.m)
                return tt.finalize_result(bcfg, fn(bcfg, p.f, bvg, state,
                                                   kept=kept))

            for block in GATED_BATCH_BLOCKS:
                gated_turns(
                    f"batch B=4096 d=1024 {lockstep} direct {strategy}",
                    batch, GATED_BATCH_ITERS,
                    ("eager", "graphs", "graphs", "eager"), block,
                    "eager fixed-trip blocks" if lockstep == "bounded"
                    else "eager read-driven")


if __name__ == "__main__":
    if "--gated" in sys.argv[1:]:
        gated_main()
    else:
        main()
