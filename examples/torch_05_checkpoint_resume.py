"""Checkpoint and resume on the port: the whole solver state to a file
mid-run (the reference's ``.npz``, readable by both packages) and on from
it.  The port of ``examples/05_checkpoint_resume.py``.

Run:  python examples/torch_05_checkpoint_resume.py [--d N] [--device cpu]
"""
import argparse
import tempfile

import torch

import tpu_lbfgs_torch as tt
from tpu_lbfgs_torch.io import load_state, save_state
from tpu_lbfgs_torch.types import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=4096)
    ap.add_argument("--device", default=None, choices=["cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    p = tt.get_problem("rosenbrock")
    vg = tt.make_value_and_grad(p.f, p.grad)
    cfg1 = tt.LBFGSConfig(line_search="backtracking", max_iters=50,
                          tol=1e-10)
    x0 = torch.full((args.d,), -1.2, dtype=torch.float32, device=dev)
    # A segment leaves its status RUNNING at its cap, so a later, larger
    # budget resumes it.
    seg = tt.make_solve_segment(cfg1, p.f, value_and_grad=vg, iters=50)
    state = seg(tt.init_state(vg, x0, cfg1.m))
    print(f"phase 1: k = {int(state.k)}, f = {float(state.f):.4g}")

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/ckpt.npz"
        save_state(path, state)       # copied to the host before it returns
        restored = load_state(path, device=args.device)

    # The ring, the iteration counter and the status carry over exactly.
    cfg2 = cfg1.replace(max_iters=2000, tol=1e-5)
    final = tt.solve_from_state(cfg2, p.f, vg, restored)
    print(f"phase 2: k = {int(final.k)}, f = {float(final.f):.4g}, "
          f"status = {tt.Status.NAMES[int(final.status)]}")
    assert int(final.k) > 50 and torch.isfinite(final.x).all()


if __name__ == "__main__":
    main()
