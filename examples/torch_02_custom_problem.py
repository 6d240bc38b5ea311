"""Bring your own objective to the port: autograd supplies the exact
gradient, or register a Problem for the command line and the harnesses.
The port of ``examples/02_custom_problem.py``.

Run:  python examples/torch_02_custom_problem.py [--d N] [--device cpu]
"""
import argparse

import torch

import tpu_lbfgs_torch as tt
from tpu_lbfgs_torch.types import resolve_device


def beale_like(x):
    # A smooth non-convex test function over pairs of coordinates.
    a, b = x[..., ::2], x[..., 1::2]
    return torch.sum((1.5 - a + a * b) ** 2 + (2.25 - a + a * b ** 2) ** 2,
                     dim=-1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--device", default=None, choices=["cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- option 1: just pass f; autograd supplies the exact gradient -------
    cfg = tt.LBFGSConfig(line_search="wolfe_interpolation", c2=0.9,
                         max_iters=500, tol=1e-6, fidelity="fixed")
    x0 = torch.zeros(args.d, dtype=torch.float64, device=dev)
    res = tt.minimize(beale_like, x0, cfg)
    print(f"autograd solve on {dev}: {tt.Status.NAMES[int(res.status)]}, "
          f"f = {float(res.f):.3e}, iters = {int(res.iterations)}")
    assert torch.isfinite(res.x).all()

    # --- option 2: register it for the command line and the harnesses ----
    def grad(x):
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(beale_like(xr).sum(), xr)
        return g

    if "beale_like" not in tt.problem_names():
        tt.register_problem(tt.Problem(name="beale_like", f=beale_like,
                                       grad=grad))
    p = tt.get_problem("beale_like")
    print("registered:", p.name, "->", sorted(tt.problem_names()))


if __name__ == "__main__":
    main()
