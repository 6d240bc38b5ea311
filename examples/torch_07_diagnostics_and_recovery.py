"""Diagnostics and recovery on the port: guard counters, the traced
replay, the speculative Wolfe search on its K-trial kernel, and the
per-rank sharded checkpoint restored onto another mesh.  The port of
``examples/07_diagnostics_and_recovery.py``.

Run:  python examples/torch_07_diagnostics_and_recovery.py [--d N]
      [--nproc 4] [--device cpu]
"""
import argparse
import tempfile
from pathlib import Path

import numpy as np
import torch

import tpu_lbfgs_torch as tt
from tpu_lbfgs_torch import dist
from tpu_lbfgs_torch.dist.launch import spawn_ranks
from tpu_lbfgs_torch.dist.mesh import Mesh, local_block, pad_for_mesh
from tpu_lbfgs_torch.dist.sharded import solve_shard, solve_shard_from_state
from tpu_lbfgs_torch.io import load_state_sharded, save_state_sharded
from tpu_lbfgs_torch.types import resolve_device


def double_well(x):
    return torch.sum(-0.5 * x * x + 0.05 * x ** 4, dim=-1)


def double_well_grad(x):
    return -x + 0.2 * x ** 3


def _save_on_ranks(rank, size, d, path, device):
    """Every rank: 10 iterations of the sharded solve, then its file."""
    dev = resolve_device(device)
    mesh = dist.make_mesh()
    cfg = tt.LBFGSConfig(max_iters=10, tol=0.0, direction="compact")
    x0 = torch.from_numpy(np.random.default_rng(2).uniform(-2, 2, d)).to(dev)
    x_pad, n = pad_for_mesh(x0, mesh.size)
    res, state = solve_shard("rosenbrock", local_block(x_pad, mesh), n, cfg,
                             mesh, kernels=False, return_state=True)
    save_state_sharded(path, state, mesh, d)
    # The uncut solve, on to 20 iterations, for the comparison below.
    res, _ = solve_shard_from_state(state, n, cfg.replace(max_iters=20),
                                    mesh, "rosenbrock")
    return dist.gather_result(res, mesh, d).x.cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=4096)
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", default=None, choices=["cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- 1. guard counters on a degenerate problem -----------------------
    # Concave near the origin: negative-curvature (s, y) pairs are
    # rejected, and res.guards counts it.
    x0 = torch.from_numpy(np.random.default_rng(0).uniform(-0.5, 0.5, 64)
                          ).to(dev)
    cfg = tt.LBFGSConfig(max_iters=100, tol=1e-8, m=5)
    res = tt.minimize(double_well, x0, cfg, grad=double_well_grad)
    counts = dict(zip(tt.Guard.NAMES, res.guards.tolist()))
    print(f"status={tt.Status.NAMES[int(res.status)]}  "
          f"iterations={int(res.iterations)}")
    print("guard activations:", {k: v for k, v in counts.items() if v})

    # --- 2. traced replay: where each safeguard fired -------------------
    res_t = tt.minimize(double_well, x0, cfg.replace(record_trace=True),
                        grad=double_well_grad)
    tg = res_t.trace.guards[:, tt.Guard.PAIR_REJECT].cpu().numpy()
    fired = np.nonzero(np.diff(tg, prepend=0) > 0)[0]
    print(f"pair rejections fired at iterations: "
          f"{fired[fired < int(res_t.iterations)].tolist()}")

    # --- 3. the speculative Wolfe search: K trials in one kernel ---------
    p = tt.get_problem("rosenbrock")
    xr = torch.from_numpy(np.random.default_rng(1).uniform(
        -2, 2, args.d)).to(dev, torch.float32)
    wolfe = tt.LBFGSConfig(line_search="wolfe_interpolation", c2=0.9,
                           max_iters=200, tol=1e-4)
    r_seq = tt.minimize(p.f, xr, wolfe, grad=p.grad)
    r_spec = tt.minimize(
        p.f, xr, wolfe.replace(line_search="wolfe_interpolation_speculative"),
        grad=p.grad, phi_dphi_batch=tt.multi_phi_dphi_for("rosenbrock"))
    print(f"wolfe sequential:  {int(r_seq.iterations)} iters, "
          f"f={float(r_seq.f):.3e}")
    print(f"wolfe speculative: {int(r_spec.iterations)} iters, "
          f"f={float(r_spec.f):.3e}")

    # --- 4. the sharded checkpoint: per-rank files, restored elsewhere ---
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = "nccl" if 0 < args.nproc <= cards else "gloo"
    d = 1000
    with tempfile.TemporaryDirectory() as td:
        ck = Path(td) / "ck"
        uncut = spawn_ranks(_save_on_ranks, args.nproc, d, str(ck),
                            args.device, backend=backend, timeout_s=600.0,
                            threads=None)[0]
        files = sorted(f.name for f in ck.iterdir())
        # This process alone is a mesh of one shard: the whole state.
        state = load_state_sharded(ck, device=args.device)
        cfg_s = tt.LBFGSConfig(max_iters=20, tol=0.0, direction="compact")
        res, _ = solve_shard_from_state(state, d, cfg_s, Mesh(None),
                                        "rosenbrock")
        gap = float(np.abs(res.x.cpu().numpy() - uncut).max())
        print(f"sharded checkpoint: {args.nproc} ranks wrote {files}; "
              f"resumed on one process to 20 iterations, max |x - uncut| = "
              f"{gap:.2e}")
        assert gap <= 1e-9


if __name__ == "__main__":
    main()
