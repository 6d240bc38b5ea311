"""The port's NumPy oracle (tpu_lbfgs_torch.oracle) against the JAX
package's (tpu_lbfgs.oracle) on the CPU: the same decision rules operation
for operation, so every OracleResult field equal bit for bit; and the
port's float64 solve on the CPU following the port's oracle, with the
window and tolerances of tests/test_solver.py's parity test."""
import dataclasses

import numpy as np
import pytest
import torch

import tpu_lbfgs as tl
import tpu_lbfgs_torch as tt
from tpu_lbfgs.oracle import lbfgs_oracle as jax_oracle
from tpu_lbfgs_torch import oracle
from tpu_lbfgs_torch.oracle import OracleResult, lbfgs_oracle
import np_problems

torch.set_num_threads(1)

STRATEGIES = [
    "backtracking",
    "backtracking_wolfe",
    "backtracking_wolfe_bisect",
    "armijo_interpolation",
    "wolfe_interpolation",
]


def _same(a, b) -> bool:
    """Equal bit for bit: arrays and floats (NaN equal to NaN), lists of
    them, dicts, and the rest by ==."""
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(u, v) for u, v in zip(a, b))
    if isinstance(a, (np.ndarray, float)):
        return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True) \
            and np.asarray(a).dtype == np.asarray(b).dtype
    return a == b


def test_oracle_surface_matches_the_reference():
    import tpu_lbfgs.oracle as ref

    assert [f.name for f in dataclasses.fields(OracleResult)] == \
        [f.name for f in dataclasses.fields(ref.OracleResult)]
    assert oracle.LINE_SEARCHES.keys() == ref.LINE_SEARCHES.keys()
    for name in ("cubic_interpolate", "cubic_interpolate_fixed",
                 "quadratic_interpolate", "quadratic_interpolate_fixed",
                 "safe_cubic_interpolate"):
        assert callable(getattr(oracle, name)), name


@pytest.mark.parametrize("fidelity", ["reference", "fixed"])
@pytest.mark.parametrize("problem", list(np_problems.PROBLEMS))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_oracle_matches_jax_oracle_bit_for_bit(strategy, problem, fidelity):
    """Every OracleResult field, the recorded trajectories and the guard
    counts included, from one start under one configuration; the alpha
    rescue is on for the two searches that have it."""
    f_np, g_np = np_problems.PROBLEMS[problem]
    x0 = np.random.default_rng(7).uniform(-1.5, 1.5, 24)
    kw = dict(line_search=strategy, max_iters=40, tol=1e-12, c2=0.9,
              fidelity=fidelity, alpha_rescue_floor=1e-4)
    got = lbfgs_oracle(f_np, g_np, x0, tt.LBFGSConfig(**kw))
    ref = jax_oracle(f_np, g_np, x0, tl.LBFGSConfig(**kw))
    assert got.iterations >= 1, got.status
    for field in dataclasses.fields(OracleResult):
        assert _same(getattr(got, field.name), getattr(ref, field.name)), \
            field.name


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("problem", ["rosenbrock", "coupled_quadratic"])
def test_minimize_follows_the_oracle(strategy, problem):
    """tests/test_solver.py::test_trajectory_parity_vs_oracle with the
    port on both sides: its float64 solve on the CPU follows its oracle's
    f and alpha over a 30-iteration window, within the same rtol."""
    p = tt.get_problem(problem)
    f_np, g_np = np_problems.PROBLEMS[problem]
    x0 = np.random.default_rng(7).uniform(-1.5, 1.5, 24)
    window = 30
    cfg = tt.LBFGSConfig(line_search=strategy, max_iters=window, tol=1e-12,
                         c2=0.9, record_trace=True)
    res = tt.minimize(p.f, torch.from_numpy(x0), cfg, grad=p.grad)
    orc = lbfgs_oracle(f_np, g_np, x0, cfg)
    n = min(int(res.iterations), orc.iterations, window)
    assert n >= 3, f"too few comparable iterations: {n}"
    # trace.f[k] is f after step k; oracle.fs[k] is f before step k.
    np.testing.assert_allclose(
        res.trace.f[: n - 1].numpy(), np.asarray(orc.fs[1:n]),
        rtol=1e-6, atol=1e-9,
        err_msg=f"{strategy}/{problem} f trajectory diverged")
    np.testing.assert_allclose(
        res.trace.alpha[: n - 1].numpy(), np.asarray(orc.alphas[: n - 1]),
        rtol=1e-6, atol=1e-12,
        err_msg=f"{strategy}/{problem} alpha sequence diverged")
