"""Queue 3 F8: the float32 protocol cell from one start in both packages.

Runs ``tpu_lbfgs.bench.reference_protocol.run_tpu_cell`` (the JAX
package's jnp stack, ``use_pallas=False``) and the port's
``run_cuda_cell(device="cpu")`` on Rosenbrock at d from the same array,
the port's ``problems.suite.reference_x0(d, seed)``, and from arrays one
float32 ulp away (every seventh coordinate from ``ulp_offset - 1`` moved
up, as ``tests/test_torch_protocol.py::_same_x0`` does).  One JSON line
per run on stdout.  CPU only; it imports both packages, so it is not part
of the port.

    PYTHONPATH=. python torch_records/same_start.py --package jax --seed 365 --ulp 0
    PYTHONPATH=. python torch_records/same_start.py --package torch --seed 365 --ulp 1
"""
import argparse
import json
import os
import time

import numpy as np


def _x0(d, seed, ulp, low=-1000.0, high=1000.0):
    from tpu_lbfgs_torch.problems.suite import reference_x0

    a = reference_x0(d, seed, low, high, device="cpu").numpy().copy()
    if ulp:
        # float32 ulps: the cells cast the float64 draw to float32.
        b = a.astype(np.float32)
        b[ulp - 1::7] = np.nextafter(b[ulp - 1::7], np.float32(np.inf))
        a = b.astype(np.float64)
    return a


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--ulp", type=int, default=0)
    ap.add_argument("--d", type=int, default=20000)
    ap.add_argument("--strategy", default="backtracking_wolfe")
    ap.add_argument("--no-rescue", action="store_true")
    a = ap.parse_args(argv)
    x0 = _x0(a.d, a.seed, a.ulp)
    t0 = time.perf_counter()
    if a.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import tpu_lbfgs.bench.reference_protocol as rp

        rp._x0_np = lambda d, seed, low=-1000.0, high=1000.0: x0
        cell = rp.run_tpu_cell("rosenbrock", a.d, a.strategy,
                               seeds=(a.seed,), use_pallas=False,
                               no_rescue=a.no_rescue)
    else:
        import torch

        torch.set_num_threads(1)
        import tpu_lbfgs_torch.bench.reference_protocol as rp

        rp.reference_x0 = lambda d, seed, dtype=torch.float64, device=None: \
            torch.from_numpy(x0).to(dtype)
        cell = rp.run_cuda_cell("rosenbrock", a.d, a.strategy,
                                seeds=(a.seed,), no_rescue=a.no_rescue,
                                device="cpu")
    print(json.dumps({"package": a.package, "seed": a.seed, "ulp": a.ulp,
                      "d": a.d, "strategy": a.strategy,
                      "no_rescue": a.no_rescue,
                      "status": cell["statuses"][0],
                      "iterations": cell["per_seed_iterations"][0],
                      "final_f": cell["mean_final_f"],
                      "g_norm": cell["max_final_g_norm"],
                      "s": round(time.perf_counter() - t0, 1),
                      "pid": os.getpid()}), flush=True)


if __name__ == "__main__":
    main()
