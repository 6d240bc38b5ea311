"""The main path on the card: ``compact_incremental`` direction, the
polynomial line search, and the CUDA kernels of the problem (the fused
value and gradient, the fused iteration tail).  The port of
``examples/03_fast_stack.py``; its TPU rate is the reference's, this
prints the card's.

Run:  python examples/torch_03_fast_stack.py [--d N] [--iters N] [--device cpu]
(on the CPU the kernels' plain versions run: no device rate)
"""
import argparse
import time

import torch

import tpu_lbfgs_torch as tt
from tpu_lbfgs_torch.types import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--device", default=None, choices=["cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    problem = "rosenbrock"
    p = tt.get_problem(problem)
    cfg = tt.LBFGSConfig(
        line_search="backtracking",
        direction="compact_incremental",  # Byrd-Nocedal-Schnabel, products kept
        ls_eval="polynomial",             # closed-form phi(alpha)
        use_pallas=True,
        max_iters=args.iters,
        tol=0.0,                          # a fixed-iteration run
    )
    vg = tt.fused_value_and_grad(problem)                   # one pass: f, g
    tail = tt.fused_tail_for(problem, with_matvec=False)    # the fused tail

    def solve():
        x0 = torch.full((args.d,), -1.2, dtype=torch.float32, device=dev)
        res = tt.minimize(p.f, x0, cfg, value_and_grad=vg,
                          dir_poly=p.dir_poly, fused_tail=tail)
        float(res.f)                      # waits for the device
        return res

    solve()                               # builds the kernels, warms up
    t0 = time.perf_counter()
    res = solve()
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "the CPU (plain versions, no device rate)"
    print(f"{int(res.iterations)} iterations in {dt:.3f}s = "
          f"{int(res.iterations) / dt:.0f} it/s on {where}")
    assert torch.isfinite(res.x).all()


if __name__ == "__main__":
    main()
