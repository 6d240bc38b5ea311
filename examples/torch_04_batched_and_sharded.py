"""Scaling out on the port: a batch of independent instances in lockstep,
one instance sharded over processes, both at once on a 2-D (b, d) mesh,
and a caller's own objective on the sharded path.  The port of
``examples/04_batched_and_sharded.py``.

The sharded parts run one process per shard (explicit SPMD): this script
starts its ``--nproc`` ranks itself (``dist.launch.spawn_ranks``); under
``torchrun`` the same ``_shard_demo`` body is what every rank runs.  With a
card per rank the group is nccl; ranks that share a card (and the CPU) use
gloo, whose collectives go through the host.

Run:  python examples/torch_04_batched_and_sharded.py [--d N] [--batch B]
      [--nproc 4] [--device cpu]
"""
import argparse

import numpy as np
import torch

import tpu_lbfgs_torch as tt
from tpu_lbfgs_torch import dist
from tpu_lbfgs_torch.dist.launch import spawn_ranks
from tpu_lbfgs_torch.types import resolve_device


def chained_rosenbrock(x):
    """A caller's own objective, written out: the partitioner sees only
    torch operations on a whole (d,) or (B, d) tensor."""
    t = x[..., 1:] - x[..., :-1] ** 2
    return torch.sum(100.0 * t * t + (1.0 - x[..., :-1]) ** 2, dim=-1)


def _shard_demo(rank, size, d, device):
    """What every rank runs: the same arguments on every rank."""
    dev = resolve_device(device)
    p = tt.get_problem("rosenbrock")
    cfg = tt.LBFGSConfig(line_search="backtracking",
                         direction="compact_incremental",
                         ls_eval="polynomial", max_iters=60, tol=1e-3)
    out = {}
    # --- 2. one instance sharded over the ranks -------------------------
    mesh = dist.make_mesh()
    x0 = torch.full((d,), -1.2, dtype=torch.float32, device=dev)
    res = dist.sharded_minimize(p.f, x0, cfg.replace(use_pallas=True), mesh,
                                dir_poly=p.dir_poly, problem="rosenbrock")
    out["sharded"] = (tt.Status.NAMES[int(res.status)], int(res.iterations),
                      float(res.g_norm))
    # --- 3. the same with the caller's own f, partitioned by DTensor ----
    own = dist.sharded_minimize(chained_rosenbrock, x0.double(),
                                cfg.replace(ls_eval="direct",
                                            max_iters=10), mesh)
    out["own"] = (int(own.iterations), float(own.f))
    # --- 4. both axes: a 2-D (b, d) mesh, the shard-local kernels -------
    if size % 2 == 0:
        mesh2 = dist.make_mesh_2d(batch_size=2)
        x0s = torch.from_numpy(np.random.default_rng(1).uniform(
            -2, 2, (4, d // 4))).to(dev, torch.float32)
        res = dist.sharded_vmap_minimize(
            p.f, x0s, cfg.replace(use_pallas=True), mesh2,
            dir_poly=p.dir_poly, problem="rosenbrock", lockstep="while")
        whole = dist.gather_result(res, mesh2, d // 4)
        out["mesh2"] = (int((whole.status == tt.Status.CONVERGED).sum()),
                        whole.iterations.tolist())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=1 << 16)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", default=None, choices=["cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- 1. a batch of independent instances, all lanes at once ---------
    # The coupled quadratic converges in ~12 iterations from any start
    # (Rosenbrock from random starts needs thousands per lane).
    pq = tt.get_problem("coupled_quadratic")
    cfg = tt.LBFGSConfig(line_search="backtracking",
                         direction="compact_incremental", max_iters=500,
                         tol=1e-4)
    x0s = torch.from_numpy(np.random.default_rng(0).uniform(
        -2, 2, (args.batch, 1000))).to(dev, torch.float32)
    res = tt.vmap_minimize(pq.f, x0s, cfg, grad=pq.grad)
    conv = int((res.status == tt.Status.CONVERGED).sum())
    print(f"batch: {conv}/{args.batch} converged, median iters = "
          f"{int(res.iterations.median())}")
    assert conv == args.batch

    # --- 2-4 on --nproc ranks --------------------------------------------
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = "nccl" if 0 < args.nproc <= cards else "gloo"
    out = spawn_ranks(_shard_demo, args.nproc, args.d, args.device,
                      backend=backend, timeout_s=600.0, threads=None)[0]
    status, iters, g_norm = out["sharded"]
    print(f"sharded over {args.nproc} ranks ({backend}): {status} in "
          f"{iters} iters, ||g|| = {g_norm:.2e}")
    print(f"own objective over {args.nproc} ranks: {out['own'][0]} iters, "
          f"f = {out['own'][1]:.6e}")
    if "mesh2" in out:
        print(f"2-D mesh (2, {args.nproc // 2}): {out['mesh2'][0]}/4 "
              f"converged, iterations {out['mesh2'][1]}")


if __name__ == "__main__":
    main()
