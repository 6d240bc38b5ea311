"""Minimal solve on the PyTorch / CUDA port (``tpu_lbfgs_torch``): the
reference's ``LBFGS(f, grad, x0, "backtracking", ...)`` call, the port of
``examples/01_basic_solve.py``.

Run:  python examples/torch_01_basic_solve.py [--d N] [--device cpu]
(on the current CUDA device unless --device cpu)
"""
import argparse

import torch

import tpu_lbfgs_torch as tt
from tpu_lbfgs_torch.types import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=10_000)
    ap.add_argument("--device", default=None, choices=["cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # A problem from the built-in suite (rosenbrock | quadratic |
    # coupled_quadratic | sphere), or your own f (torch_02_custom_problem).
    p = tt.get_problem("rosenbrock")
    cfg = tt.LBFGSConfig(line_search="backtracking", max_iters=2000,
                         tol=1e-5, m=10)
    x0 = torch.full((args.d,), -1.2, dtype=torch.float32, device=dev)
    res = tt.minimize(p.f, x0, cfg, grad=p.grad)

    print(f"device     : {dev}")
    print(f"status     : {tt.Status.NAMES[int(res.status)]}")
    print(f"iterations : {int(res.iterations)}")
    print(f"f(x*)      : {float(res.f):.3e}")
    print(f"||g||      : {float(res.g_norm):.3e}")
    print(f"evals      : {int(res.n_fev)} f, {int(res.n_gev)} grad")
    assert torch.isfinite(res.x).all()


if __name__ == "__main__":
    main()
