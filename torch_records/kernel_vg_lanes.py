"""Queue 3 F11: which lanes of the batch cell fail their line search, by
the route of f.

bench.py's batch cell (``bench_batch``: U(-2, 2) of shape (B, d) from seed
42, float32, m = 10, compact_incremental, polynomial backtracking,
fidelity "fixed", pair skip 1e-10, bounded lockstep) for a number of
iterations through one package's ``vmap_minimize``, with f and its
gradient from one route:

- ``problem``: the problem's f and gradient (f and the directional
  polynomial's c0 are the same float32 sum);
- ``vg``: the fused value and gradient (the reference's Pallas kernel,
  interpreted on the CPU, or its jnp route with ``--jnp``; the port's
  plain version of its kernel, which sums f in float64);
- ``vg-c0`` (the port only): the fused value and gradient, with the
  polynomial's c0 taken from its own f.

One JSON line on stdout: the failed lanes and the iteration each stopped
at.  ``--chunk N`` solves N lanes at a time, each chunk its own
``vmap_minimize`` (the lanes do not interact): the reference's
interpreted Pallas kernel under ``jax.vmap`` takes more than 90 minutes
for the whole cell in one call on an 8-core CPU.  CPU only; it imports
both packages, so it is not part of the port.

    PYTHONPATH=. python torch_records/kernel_vg_lanes.py --package torch --route vg
    PYTHONPATH=. python torch_records/kernel_vg_lanes.py --package jax --route vg --chunk 256
"""
import argparse
import json
import time

import numpy as np

BATCH = dict(line_search="backtracking", direction="compact_incremental",
             m=10, ls_eval="polynomial", fidelity="fixed",
             pair_skip_threshold=1e-10, tol=0.0)


def _jax(x0, route, iters, jnp_route):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import tpu_lbfgs as tl
    from tpu_lbfgs.batch import vmap_minimize

    p = tl.get_problem("rosenbrock")
    if route == "problem":
        kw = dict(grad=p.grad)
    elif route == "vg":
        kw = dict(value_and_grad=tl.fused_value_and_grad(
            "rosenbrock", use_pallas=not jnp_route))
    else:
        raise SystemExit(f"--route {route} is the port's only")
    r = vmap_minimize(p.f, jnp.asarray(x0),
                      tl.LBFGSConfig(max_iters=iters, **BATCH),
                      dir_poly=p.dir_poly, lockstep="bounded", **kw)
    return (np.asarray(r.status) == tl.Status.LINE_SEARCH_FAILED,
            np.asarray(r.iterations))


def _torch(x0, route, iters):
    import torch

    import tpu_lbfgs_torch as tt
    from tpu_lbfgs_torch.kernels import fused_ops

    p = tt.get_problem("rosenbrock")
    dir_poly = p.dir_poly
    if route == "problem":
        kw = dict(grad=p.grad)
    else:
        kw = dict(value_and_grad=tt.fused_value_and_grad(
            "rosenbrock", use_pallas=False))
    if route == "vg-c0":
        def dir_poly(x, d):
            c0 = fused_ops.VG_PLAIN["rosenbrock"](x)[0]
            return torch.cat([c0.unsqueeze(-1), p.dir_poly(x, d)[..., 1:]],
                             -1)
    r = tt.vmap_minimize(p.f, torch.from_numpy(x0),
                         tt.LBFGSConfig(max_iters=iters, **BATCH),
                         dir_poly=dir_poly, lockstep="bounded", **kw)
    return ((r.status == tt.Status.LINE_SEARCH_FAILED).numpy(),
            r.iterations.numpy())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--route", choices=("problem", "vg", "vg-c0"),
                    required=True)
    ap.add_argument("--jnp", action="store_true",
                    help="the reference's jnp vg instead of its kernel")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--chunk", type=int, default=None)
    a = ap.parse_args(argv)
    x0 = np.random.default_rng(42).uniform(
        -2.0, 2.0, (a.batch, a.d)).astype(np.float32)
    t0 = time.perf_counter()
    chunk = a.chunk or a.batch
    parts = [_jax(x0[i:i + chunk], a.route, a.iters, a.jnp)
             if a.package == "jax"
             else _torch(x0[i:i + chunk], a.route, a.iters)
             for i in range(0, a.batch, chunk)]
    failed = np.concatenate([f for f, _ in parts])
    iters = np.concatenate([k for _, k in parts])
    lanes = np.flatnonzero(failed).tolist()
    print(json.dumps({
        "package": a.package, "route": a.route + (" jnp" if a.jnp else ""),
        "batch": a.batch, "d": a.d, "iters": a.iters, "chunk": chunk,
        "failed": len(lanes), "lanes": lanes,
        "stopped_at": [int(iters[i]) for i in lanes],
        "wall_s": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
