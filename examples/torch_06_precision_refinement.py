"""Two-stage precision refinement on the card: float32 on the main path to
||g|| <= 1e-3, then float64 (the card has it) from that iterate to 1e-5.
The port of ``examples/06_precision_refinement.py``, whose second stage ran
the C++ oracle on the host (``refine_backend="native"``, which belongs to
``tpu_lbfgs``); here ``refine_backend="torch"``.

The reference's north star is this at d = 2^20 (~94,000 float32
iterations on the card); the default here is a small d that converges in
seconds.

Run:  python examples/torch_06_precision_refinement.py [--d N] [--device cpu]
"""
import argparse
import warnings

from tpu_lbfgs_torch.bench.harness import time_to_tolerance_refined


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--device", default=None, choices=["cpu"])
    args = ap.parse_args(argv)

    with warnings.catch_warnings():
        # Stage 2 says once that the float32 kernels give way to their
        # plain versions in float64.
        warnings.simplefilter("ignore")
        r = time_to_tolerance_refined(problem="rosenbrock", d=args.d,
                                      coarse_tol=1e-3, tol=1e-5,
                                      refine_backend="torch",
                                      device=args.device)
    print(f"stage 1 (float32): {r['coarse_iterations']} iterations, "
          f"{r['coarse_wall_s']:.2f}s")
    print(f"stage 2 (float64): {r['refine_iterations']} iterations, "
          f"{r['refine_wall_s']:.2f}s")
    print(f"total: ||g|| = {r['g_norm']:.2e} (target 1e-5), f = "
          f"{r['f']:.2e}, status = {r['status']}, wall = {r['wall_s']:.2f}s "
          f"on {r.get('device', args.device)}")
    assert r["g_norm"] <= 1e-5


if __name__ == "__main__":
    main()
