"""How steady torch.profiler's device record counts are, session by
session: the counts behind chip_smoke.py's ``phase_graph_kernels``.

bench.py's solve at chip_smoke's main-path width (d = 2^20, rosenbrock,
the fused vg and tail, polynomial backtracking) as one ``BlockRunner``
eager and one captured; each profiled over a block of ``BLOCK_ITERS``
iterations and over one, ``SESSIONS`` sessions each, for ``RUNNERS``
pairs of fresh runners, each session "plain" (the block alone in the
session) and "edged" (the session waits ``EDGE_S`` on the host before
the block and after it, and launches ``SENTINELS`` spin kernels on each
side of it, left out of its records, as chip_smoke's
``phase_graph_kernels`` does), all interleaved.  One JSON line per (variant, mode, block length): every
session's count of device records, and for each session that differs
from the commonest one, the records by name that it has more and fewer
of.  Needs the card; run from the repository's root:

    python3 torch_records/profiler_counts.py
"""
import collections
import json
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.getcwd())
import tpu_lbfgs_torch as tt  # noqa: E402
from tpu_lbfgs_torch.bench.harness import _x0  # noqa: E402
from tpu_lbfgs_torch.core import blocks  # noqa: E402
from tpu_lbfgs_torch.core.solver import _stepper  # noqa: E402
from tpu_lbfgs_torch.kernels import _build  # noqa: E402

D = 1 << 20
RUNNERS = 3
SESSIONS = 6
EDGE_S = 0.02
SENTINELS = 8
SENTINEL_CYCLES = 100_000
dev = torch.device("cuda", 0)


def session(drv, length, edge):
    """The device records of one profiled block, by name."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(edge)
        for _ in range(SENTINELS if edge else 0):
            torch.cuda._sleep(SENTINEL_CYCLES)
        drv.run(length)
        for _ in range(SENTINELS if edge else 0):
            torch.cuda._sleep(SENTINEL_CYCLES)
        torch.cuda.synchronize()
        time.sleep(edge)
    return collections.Counter({e.key: e.count for e in prof.key_averages()
                                if e.device_type == DeviceType.CUDA
                                and "spin_kernel" not in e.key})


def main():
    torch.cuda.set_device(dev)
    _build.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    p = tt.get_problem("rosenbrock")
    vg = tt.fused_value_and_grad("rosenbrock")
    cfg = tt.LBFGSConfig(line_search="backtracking",
                         direction="compact_incremental", m=10,
                         use_pallas=True, ls_eval="polynomial",
                         max_iters=1 << 30, tol=0.0)
    x = _x0(D, 42, torch.float32, dev)
    step = _stepper(cfg, p.f, vg, p.dir_poly, tt.fused_tail_for("rosenbrock"))
    n = blocks.BLOCK_ITERS
    seen = collections.defaultdict(list)
    for _ in range(RUNNERS):
        drvs = {}
        for mode in ("eager", "graphs"):
            if mode == "eager":
                with blocks.eager_loops():
                    drv = blocks.BlockRunner(cfg, step, tt.init_state(
                        vg, x, cfg.m), True)
            else:
                drv = blocks.BlockRunner(cfg, step, tt.init_state(
                    vg, x, cfg.m), True)
            drv.start(None)
            drv.run(n)
            drv.run(1)
            drvs[mode] = drv
        for _ in range(SESSIONS):
            for mode, drv in drvs.items():
                for length in (n, 1):
                    for variant, edge in (("plain", 0.0), ("edged", EDGE_S)):
                        seen[(variant, mode, length)].append(
                            session(drv, length, edge))
    for (variant, mode, length), got in seen.items():
        common = collections.Counter(dict(collections.Counter(
            tuple(sorted(c.items())) for c in got).most_common(1)[0][0]))
        print(json.dumps({
            "variant": variant, "mode": mode, "block": length,
            "records": [sum(c.values()) for c in got],
            "differ": {i: {"more": dict(c - common), "fewer": dict(common - c)}
                       for i, c in enumerate(got) if c != common},
            "card": card}), flush=True)


if __name__ == "__main__":
    main()
