"""Package-level contracts of tpu_lbfgs_torch: no JAX, the reference's
configuration surface, the options outside the port raising, exact state
interop, and launch counters that only a GPU run moves."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lbfgs as tl
import tpu_lbfgs_torch as tt
from tpu_lbfgs_torch import interop
from tpu_lbfgs_torch.kernels import fused_ops

# The tensors here are small: one intra-op thread is faster, and leaves
# the cores to the other test workers.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
BENCH = dict(line_search="backtracking", direction="compact_incremental",
             m=10, use_pallas=True, ls_eval="polynomial")


def test_import_leaves_jax_out():
    """Every module of the port imports without pulling in jax: the GPU
    machine has none."""
    code = (
        "import pkgutil, sys, importlib, tpu_lbfgs_torch\n"
        "for m in pkgutil.walk_packages(tpu_lbfgs_torch.__path__,"
        " 'tpu_lbfgs_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules"
        " if k == 'jax' or k.startswith(('jax.', 'tpu_lbfgs.')))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_config_mirrors_reference():
    ref = {f.name: f.default for f in dataclasses.fields(tl.LBFGSConfig)}
    port = {f.name: f.default for f in dataclasses.fields(tt.LBFGSConfig)}
    assert port == ref


@pytest.mark.parametrize("kw", [dict(m=0), dict(line_search="nope"),
                                dict(damping=1.5), dict(refresh_interval=0),
                                dict(history_dtype="float16")])
def test_config_validation_mirrors_reference(kw):
    with pytest.raises(ValueError):
        tl.LBFGSConfig(**kw)
    with pytest.raises(ValueError):
        tt.LBFGSConfig(**kw)


def test_status_and_guard_codes_mirror_reference():
    assert tt.Status.NAMES == tl.Status.NAMES
    assert tt.Guard.NAMES == tl.Guard.NAMES and tt.Guard.N == tl.Guard.N
    for name in tl.Guard.NAMES:
        assert getattr(tt.Guard, name.upper()) == getattr(tl.Guard,
                                                          name.upper())
    assert [f.name for f in dataclasses.fields(tt.LBFGSState)] == list(
        tl.types.LBFGSState._fields)
    assert tt.SolveResult._fields == tl.SolveResult._fields


@pytest.mark.parametrize("kw", [
    dict(line_search="wolfe_interpolation"),
    dict(line_search="backtracking_speculative"),
    dict(ls_eval="direct"),
    dict(direction="two_loop"),
    dict(direction="compact"),
    dict(damping=0.2),
    dict(accurate_dots=True),
    dict(record_trace=True),
    dict(refresh_interval=50),
    dict(history_dtype="bfloat16"),
    dict(history_dtype="float32"),     # on float64 iterates
])
def test_out_of_slice_options_raise(kw):
    cfg = tt.LBFGSConfig(**{**BENCH, **kw, "max_iters": 3})
    p = tt.get_problem("rosenbrock")
    x0 = torch.full((64,), -1.2, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.minimize(p.f, x0, cfg, grad=p.grad, dir_poly=p.dir_poly,
                    fused_tail=tt.fused_tail_for("rosenbrock"))


@pytest.mark.parametrize("call", [
    lambda: tt.fused_tail_for("rosenbrock", with_matvec=True),
    lambda: tt.fused_tail_for("rosenbrock", accurate_dots=True),
    lambda: tt.fused_tail_for("quadratic"),
    lambda: tt.fused_value_and_grad("coupled_quadratic"),
])
def test_unported_kernel_variants_raise(call):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call()


def test_use_pallas_without_fused_tail_raises():
    p = tt.get_problem("rosenbrock")
    cfg = tt.LBFGSConfig(**BENCH, max_iters=2)
    with pytest.raises(NotImplementedError, match="iteration_tail"):
        tt.minimize(p.f, torch.zeros(8, dtype=torch.float64), cfg,
                    grad=p.grad, dir_poly=p.dir_poly)


@pytest.mark.parametrize("d", [300, 1024])
def test_interop_round_trip_is_exact(d):
    """JAX state -> port -> JAX arrays is the identity, ring layout
    included; 300 is not a multiple of the 128 lanes, so its ring is
    (m, 1, d)."""
    p = tl.get_problem("rosenbrock")
    cfg = tl.LBFGSConfig(**{**BENCH, "use_pallas": False})
    s = tl.init_state(p.value_and_grad,
                      jnp.asarray(np.random.default_rng(0).uniform(-2, 2, d)),
                      cfg.m)
    step = jax.jit(lambda t: tl.iterate(cfg, p.f, p.value_and_grad, t,
                                        p.dir_poly))
    for _ in range(12):        # fill and wrap the ring
        s = step(s)
    arrays = {k: np.asarray(v) for k, v in s._asdict().items()}
    st = interop.state_from_numpy(arrays)
    assert st.s_hist.shape == (cfg.m, d) and st.s_hist.is_contiguous()
    back = interop.state_to_numpy(st)
    assert back.keys() == arrays.keys()
    for k, a in arrays.items():
        assert back[k].dtype == a.dtype and back[k].shape == a.shape, k
        np.testing.assert_array_equal(back[k], a, err_msg=k)
    again = interop.state_from_numpy(back)
    for f in dataclasses.fields(tt.LBFGSState):
        assert torch.equal(getattr(again, f.name), getattr(st, f.name))


def test_interop_copies():
    """The port updates its ring in place; a carried-over state must not
    write into the arrays it came from."""
    arrays = interop.state_to_numpy(tt.init_state(
        tt.fused_value_and_grad("rosenbrock"),
        torch.linspace(-1, 1, 256, dtype=torch.float64), 3))
    st = interop.state_from_numpy(arrays)
    st.s_hist.fill_(7.0)
    assert not arrays["s_hist"].any()


def test_cpu_run_launches_no_kernel():
    """On the CPU the wrappers take the plain versions: a whole solve
    leaves every launch counter at zero."""
    fused_ops.reset_launches()
    p = tt.get_problem("rosenbrock")
    r = tt.minimize(p.f, torch.full((256,), -1.2), tt.LBFGSConfig(
        **BENCH, max_iters=5, tol=0.0),
        value_and_grad=tt.fused_value_and_grad("rosenbrock"),
        dir_poly=p.dir_poly, fused_tail=tt.fused_tail_for("rosenbrock"))
    assert r.iterations.item() == 5
    assert fused_ops.launches == {"rosenbrock_vg": 0,
                                  "rosenbrock_fused_tail": 0}


def test_wrappers_refuse_other_devices():
    x = torch.zeros(16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_ops.fused_vg_rosenbrock(x)
    with pytest.raises(ValueError, match="CUDA"):
        fused_ops.fused_tail_rosenbrock(x, x, torch.zeros((), device="meta"),
                                        x)


def test_minimize_needs_a_gradient():
    p = tt.get_problem("rosenbrock")
    with pytest.raises(ValueError, match="gradient"):
        tt.minimize(p.f, torch.zeros(4), tt.LBFGSConfig(**BENCH),
                    dir_poly=p.dir_poly)


def test_solve_bounded_matches_solve_from_state():
    p = tt.get_problem("rosenbrock")
    cfg = tt.LBFGSConfig(**BENCH, max_iters=15, tol=0.0)
    vg = tt.fused_value_and_grad("rosenbrock")
    tail = tt.fused_tail_for("rosenbrock")
    x0 = torch.full((128,), -1.2, dtype=torch.float64)
    a = tt.solve_from_state(cfg, p.f, vg, tt.init_state(vg, x0, cfg.m),
                            p.dir_poly, tail)
    b = tt.solve_bounded(cfg, p.f, vg, tt.init_state(vg, x0, cfg.m),
                         p.dir_poly, tail)
    assert torch.equal(a.x, b.x) and a.status.item() == b.status.item()
    assert a.k.item() == b.k.item() == 15


def test_bench_gpu_refuses_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py runs bench_gpu")
    from tpu_lbfgs_torch.bench.harness import bench_gpu

    with pytest.raises(RuntimeError, match="CUDA"):
        bench_gpu(d=64, iters=2)
