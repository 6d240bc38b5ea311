"""Hard-problem tools and the rules re-derived for the card: Powell
damping, the history-dtype and in-tail-products rules measured on the H100
(ROADMAP "Rules re-derived for the card"), and the speculative line search
chosen from a probe.  The port of
``examples/08_hard_problems_and_auto_rules.py``, whose rules key on the
TPU's VMEM residency; the port's are its own.

Run:  python examples/torch_08_hard_problems_and_auto_rules.py [--d N]
      [--device cpu]
"""
import argparse

import numpy as np
import torch

import tpu_lbfgs_torch as tt
from tpu_lbfgs_torch.linesearch.strategies import resolve_speculative_auto
from tpu_lbfgs_torch.types import resolve_device


def double_well(x):
    return torch.sum(-0.5 * x * x + 0.05 * x ** 4, dim=-1)


def double_well_grad(x):
    return -x + 0.2 * x ** 3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=4096)
    ap.add_argument("--device", default=None, choices=["cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- 1. Powell damping on a non-convex double well -------------------
    # Near the hilltop at x = 0 the curvature is negative: the plain solver
    # rejects those pairs (Guard.PAIR_REJECT), damping blends them in
    # (Guard.DAMPED).
    x0 = torch.from_numpy(np.random.default_rng(0).uniform(-0.5, 0.5, 512)
                          ).to(dev)
    base = tt.LBFGSConfig(line_search="backtracking", m=5, max_iters=80,
                          tol=1e-8)
    plain = tt.minimize(double_well, x0, base, grad=double_well_grad)
    damped = tt.minimize(double_well, x0, base.replace(damping=0.2),
                         grad=double_well_grad)
    g_p, g_d = plain.guards.tolist(), damped.guards.tolist()
    print(f"plain : {tt.Status.NAMES[int(plain.status)]:10s} "
          f"iters={int(plain.iterations):3d} rejected pairs="
          f"{g_p[tt.Guard.PAIR_REJECT]}")
    print(f"damped: {tt.Status.NAMES[int(damped.status)]:10s} "
          f"iters={int(damped.iterations):3d} damped pairs="
          f"{g_d[tt.Guard.DAMPED]} (rejected: {g_d[tt.Guard.PAIR_REJECT]})")

    # --- 2. the rules measured on the card --------------------------------
    # history_dtype="auto" is the iterate's dtype on the card; the tail
    # computes the history products t1 = S y, t2 = Y y itself for an f32 or
    # bf16 ring of one instance from d = 2^16 (PERF.md section 6).
    for batch, d in ((1, 4096), (4096, 1024), (1, 1 << 16), (1, 1 << 26)):
        ring = tt.resolve_history_dtype("auto", 10, d, torch.float32,
                                        batch=batch)
        in_tail = tt.auto_with_matvec(10, d, ring, batch=batch)
        print(f"batch={batch:5d} d={d:9d}: ring "
              f"{ring or 'float32 (the iterate dtype)'}, products in the "
              f"tail: {in_tail}")

    # --- 3. the speculative twin chosen from a short probe ---------------
    p = tt.get_problem("rosenbrock")
    cfg = tt.LBFGSConfig(line_search="wolfe_interpolation", c2=0.9,
                         max_iters=50, tol=0.0)
    x0r = torch.from_numpy(np.random.default_rng(1).uniform(
        -2, 2, args.d)).to(dev, torch.float32)
    probe = tt.minimize(p.f, x0r, cfg, grad=p.grad)
    resolved = resolve_speculative_auto(cfg, probe)
    trials = int(probe.n_fev) / max(int(probe.iterations), 1) - 1
    print(f"probe observed {trials:.1f} line-search trials/iter -> "
          f"line_search={resolved.line_search!r}")


if __name__ == "__main__":
    main()
