"""The port's binding of the C++ oracle (tpu_lbfgs_torch.native) on the
CPU: bit for bit the JAX package's binding of the same source (both build
it with one command on one host), within tests/test_native.py's bounds of
the port's NumPy oracle, its built-in problems against tests/np_problems,
concurrent builds, and the CPU baseline against the reference's."""
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpu_lbfgs as tl
import tpu_lbfgs.bench.harness as jax_harness
import tpu_lbfgs_torch as tt
from tpu_lbfgs.native import native_lbfgs as jax_native
from tpu_lbfgs_torch.bench import harness
from tpu_lbfgs_torch.native import PROBLEM_IDS, native_lbfgs
from tpu_lbfgs_torch.native import binding
from tpu_lbfgs_torch.oracle import lbfgs_oracle
import np_problems

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
STRATEGIES = [
    "backtracking",
    "backtracking_wolfe",
    "backtracking_wolfe_bisect",
    "armijo_interpolation",
    "wolfe_interpolation",
]
KEYS = ("x", "f", "g_norm", "iterations", "status", "n_fev", "n_gev",
        "trace_f", "trace_gnorm", "trace_alpha")


def _assert_same(got, ref, keys=KEYS):
    assert got.keys() == ref.keys()
    for key in keys:
        if isinstance(ref[key], np.ndarray):
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        else:
            assert got[key] == ref[key], key


@pytest.mark.parametrize("problem", list(PROBLEM_IDS))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_native_matches_jax_native_bit_for_bit(strategy, problem):
    x0 = np.random.default_rng(11).uniform(-1.5, 1.5, 20)
    kw = dict(line_search=strategy, max_iters=40, tol=1e-12, c2=0.9)
    got = native_lbfgs(problem, x0, tt.LBFGSConfig(**kw), record_trace=True)
    ref = jax_native(problem, x0, tl.LBFGSConfig(**kw), record_trace=True)
    assert got["iterations"] >= 1
    _assert_same(got, ref)


def test_native_custom_callback():
    """problem="custom" with numpy callbacks: converges, and equals the
    JAX package's binding on the same callbacks."""
    def f(x):
        return float(np.sum((x - 1.0) ** 2))

    def grad(x):
        return 2.0 * (x - 1.0)

    kw = dict(max_iters=100, tol=1e-8)
    got = native_lbfgs("custom", np.full(16, 3.0), tt.LBFGSConfig(**kw),
                       record_trace=True, f=f, grad=grad)
    ref = jax_native("custom", np.full(16, 3.0), tl.LBFGSConfig(**kw),
                     record_trace=True, f=f, grad=grad)
    assert got["status"] == "converged"
    np.testing.assert_allclose(got["x"], 1.0, atol=1e-8)
    _assert_same(got, ref)
    with pytest.raises(ValueError, match="callbacks"):
        native_lbfgs("custom", np.zeros(4), tt.LBFGSConfig(), f=f)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_native_matches_the_port_oracle(strategy):
    """tests/test_native.py::test_native_matches_numpy_oracle against the
    port's NumPy oracle: f and alpha over the common iterations."""
    cfg = tt.LBFGSConfig(line_search=strategy, max_iters=40, tol=1e-12,
                         c2=0.9)
    f_np, g_np = np_problems.PROBLEMS["rosenbrock"]
    x0 = np.random.default_rng(11).uniform(-1.5, 1.5, 20)
    nat = native_lbfgs("rosenbrock", x0, cfg, record_trace=True)
    orc = lbfgs_oracle(f_np, g_np, x0, cfg)
    n = min(nat["iterations"], orc.iterations) - 1
    assert n >= 3
    np.testing.assert_allclose(nat["trace_f"][:n], np.asarray(orc.fs[:n]),
                               rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(nat["trace_alpha"][:n],
                               np.asarray(orc.alphas[:n]),
                               rtol=1e-7, atol=1e-12)


def test_native_problem_eval_matches_np_problems():
    lib = binding.load()
    dp = ctypes.POINTER(ctypes.c_double)
    x = np.ascontiguousarray(np.random.default_rng(13).uniform(-2, 2, 64))
    for name, (f_np, g_np) in np_problems.PROBLEMS.items():
        pid = PROBLEM_IDS[name]
        fval = lib.tl_problem_f(pid, x.ctypes.data_as(dp), 64)
        assert np.isclose(fval, f_np(x), rtol=1e-12), name
        g = np.empty(64)
        lib.tl_problem_grad(pid, x.ctypes.data_as(dp), g.ctypes.data_as(dp),
                            64)
        np.testing.assert_allclose(g, g_np(x), rtol=1e-12, err_msg=name)


def test_x0_is_taken_on_the_host_only():
    """A CPU tensor solves as its numpy array does; a tensor on another
    device raises TypeError (the caller copies it to the host); an unknown
    problem or line search raises ValueError."""
    cfg = tt.LBFGSConfig(max_iters=5, tol=0.0)
    x0 = np.random.default_rng(3).uniform(-2, 2, 32)
    _assert_same(native_lbfgs("rosenbrock", torch.from_numpy(x0).float(), cfg),
                 native_lbfgs("rosenbrock", x0.astype(np.float32), cfg),
                 KEYS[:7])
    with pytest.raises(TypeError, match="host"):
        native_lbfgs("rosenbrock", torch.empty(32, device="meta"), cfg)
    with pytest.raises(ValueError, match="vector"):
        native_lbfgs("rosenbrock", np.zeros((2, 3)), cfg)
    with pytest.raises(ValueError, match="no problem"):
        native_lbfgs("sphere", x0, cfg)
    with pytest.raises(ValueError, match="no line search"):
        native_lbfgs("rosenbrock", x0,
                     cfg.replace(line_search="backtracking_speculative"))


def test_two_processes_building_at_once_leave_one_library(tmp_path):
    """Two processes compile the oracle into one build directory at the
    same time: one whole library is left, and no temporary file."""
    code = ("import sys\nfrom pathlib import Path\n"
            "from tpu_lbfgs_torch.native import binding\n"
            "binding.BUILD_ROOT = Path(sys.argv[1])\n"
            "print(binding.build(force=True))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    files = sorted(p.name for p in tmp_path.rglob("*") if p.is_file())
    assert files == [binding.LIB_NAME]
    lib = ctypes.CDLL(paths.pop())
    lib.tl_problem_f.restype = ctypes.c_double
    lib.tl_problem_f.argtypes = [ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_double), ctypes.c_int]
    x = np.full(8, 2.0)
    assert lib.tl_problem_f(0, x.ctypes.data_as(
        ctypes.POINTER(ctypes.c_double)), 8) == 8.0


def test_bench_cpu_native_matches_the_reference():
    """bench_cpu_native at d = 256 from the same x0 (_x0 in float64) as
    the reference's: every field but the times equal."""
    got = harness.bench_cpu_native(d=256, repeats=2)
    ref = jax_harness.bench_cpu_native(d=256, repeats=2)
    assert got.name == ref.name
    assert (got.iterations, got.final_f, got.final_g_norm) == \
        (ref.iterations, ref.final_f, ref.final_g_norm)
    for key in ("n_fev", "n_gev"):
        assert got.details[key] == ref.details[key], key
    assert len(got.details["repeat_walls_s"]) == 2
    assert got.iters_per_s > 0 and got.details["device"]
