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
Every solve here captures, whatever its budget and search: the script
sets ``blocks.CAPTURE_MIN_ITERS`` to 0 and ``solver._captured`` to say
yes, the two rules these numbers chose.  Needs the card; run from the
repository's root:

    python3 torch_records/graph_costs.py
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
from tpu_lbfgs_torch.core import blocks, solver  # noqa: E402
from tpu_lbfgs_torch.kernels import _build  # noqa: E402

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
    solver._captured = lambda *a, **k: True
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


if __name__ == "__main__":
    main()
