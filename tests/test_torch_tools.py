"""The port's front-end tools on the CPU: ``bench.scaling`` (strong scaling
over gloo ranks), ``utils.profiling`` (``trace`` / ``profile_solve``), and
the command line's ``--debug-nans`` (against the JAX package's command
line) and ``--shard --nproc``.
"""
import json

import numpy as np
import pytest
import torch

import tpu_lbfgs_torch as tt
from tpu_lbfgs_torch import cli as torch_cli
from tpu_lbfgs_torch.bench.scaling import bench_sharded, scaling_sweep
from tpu_lbfgs_torch.core.solver import set_debug_nans
from tpu_lbfgs_torch.utils.profiling import profile_solve, trace

torch.set_num_threads(1)

#: The reference's row (tpu_lbfgs/bench/scaling.py:133-134) and its sweep's
#: additions (:161-162).
REFERENCE_ROW = {"n_devices", "iters_per_s", "wall_s", "final_f", "stack"}
REFERENCE_SWEEP = REFERENCE_ROW | {"speedup", "efficiency"}


def test_bench_sharded_rows_on_1_and_2_ranks():
    """One rank in this process, two spawned over gloo: the reference's
    fields plus the backend, the same problem solved (equal final f in
    float64 to 1e-12), the plain path's stack labels; on the CPU no row
    is a device number and the sweep says so."""
    cfg = tt.LBFGSConfig(line_search="backtracking",
                         direction="compact_incremental",
                         ls_eval="polynomial")
    rows = scaling_sweep("rosenbrock", d=256, iters=5, cfg=cfg,
                         device_counts=[1, 2], dtype="float64",
                         device="cpu", repeats=1)
    assert [r["n_devices"] for r in rows] == [1, 2]
    for r in rows:
        assert REFERENCE_SWEEP <= set(r)
        assert r["iters_per_s"] > 0 and r["scaling"] is False
        assert r["device"] == "cpu" and r["cards"] == 0
    assert [r["stack"] for r in rows] == ["plain-unsharded", "plain-shard"]
    assert [r["backend"] for r in rows] == ["none", "gloo"]
    assert rows[0]["speedup"] == 1.0 and rows[0]["efficiency"] == 1.0
    np.testing.assert_allclose(rows[1]["final_f"], rows[0]["final_f"],
                               rtol=1e-12)
    # use_pallas for a problem without kernels warns and runs plain, as the
    # reference does.
    with pytest.warns(RuntimeWarning, match="no shard-local kernels"):
        r = bench_sharded("sphere", 64, 2, cfg, 1, "float32", repeats=1,
                          use_pallas=True, device="cpu")
    assert REFERENCE_ROW <= set(r) and r["stack"] == "plain-unsharded"


def test_scaling_command_line(capsys):
    from tpu_lbfgs_torch.bench import scaling

    assert scaling.main(["--d", "128", "--iters", "2", "--counts", "1",
                         "--repeats", "1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    row = json.loads(lines[0])
    assert row["n_devices"] == 1 and row["stack"] == "plain-unsharded"
    assert lines[-1] == "# on the CPU: not a device number"


def _solve():
    p = tt.get_problem("rosenbrock")
    x0 = torch.from_numpy(np.random.default_rng(0).uniform(-2, 2, 256))
    return tt.minimize(p.f, x0, tt.LBFGSConfig(max_iters=5, tol=0.0),
                       grad=p.grad)


def test_profile_solve_writes_a_trace(tmp_path):
    """A warm-up outside the trace, the timed solve inside it, the fence a
    read of f; the trace is Chrome's JSON with the solver's operations."""
    out = profile_solve(_solve, trace_dir=str(tmp_path / "prof"),
                        device="cpu")
    assert out["wall_s"] > 0 and int(out["result"].iterations) == 5
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())[
        "traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    plain = profile_solve(_solve, warmup=False)
    assert plain["trace_dir"] is None and plain["wall_s"] > 0


def test_trace_needs_a_card_unless_the_cpu_is_asked_for(tmp_path):
    """Without ``device="cpu"`` the trace is of the card's activity and
    raises where there is none; an exception of the block propagates."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py traces there")
    with pytest.raises(RuntimeError, match="CUDA"):
        with trace(str(tmp_path / "t")):
            pass
    with pytest.raises(ZeroDivisionError):
        with trace(str(tmp_path / "t"), device="cpu"):
            1 / 0


NAN_ARGS = ["--problem", "rosenbrock", "--dim", "16", "--dtype", "float32",
            "--x0-range", "1e20", "--max-iters", "3", "--debug-nans"]
CLEAN_ARGS = ["--problem", "rosenbrock", "--dim", "64", "--dtype", "float64",
              "--max-iters", "30", "--json", "--debug-nans"]


@pytest.fixture
def jax_debug_nans_reset():
    import jax

    yield
    jax.config.update("jax_debug_nans", False)


def test_debug_nans_raises_as_the_jax_cli(jax_debug_nans_reset):
    """From x0 ~ U(-1e20, 1e20) in float32 the gradient holds inf - inf:
    both command lines raise FloatingPointError; without the flag both
    solve on (to a failed line search)."""
    from tpu_lbfgs import cli as jax_cli

    with pytest.raises(FloatingPointError):
        jax_cli.main(["--device", "cpu"] + NAN_ARGS)
    with pytest.raises(FloatingPointError, match="non-finite"):
        torch_cli.main(["--device", "cpu"] + NAN_ARGS)
    # The flag does not outlive the call.
    assert torch_cli.main(["--device", "cpu"] + NAN_ARGS[:-1]) == 0


def test_debug_nans_agrees_with_the_jax_cli_on_a_clean_solve(
        capsys, jax_debug_nans_reset):
    """A clean float64 solve with the flag: the same record as the JAX
    command line's, and the same as without the flag."""
    from tpu_lbfgs import cli as jax_cli

    def record(main, args):
        capsys.readouterr()
        assert main(["--device", "cpu"] + args) == 0
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        return rec["results"][0]

    ours = record(torch_cli.main, CLEAN_ARGS)
    theirs = record(jax_cli.main, CLEAN_ARGS)
    for key in ("status", "iterations", "n_fev", "n_gev", "guards"):
        assert ours[key] == theirs[key], key
    np.testing.assert_allclose(ours["f"], theirs["f"], rtol=1e-10)
    quiet = record(torch_cli.main, CLEAN_ARGS[:-1])
    assert quiet["f"] == ours["f"] and quiet["iterations"] == 30


@pytest.mark.parametrize("extra", [["--batch", "4", "--poly-ls"],
                                   ["--shard"]])
def test_debug_nans_on_the_batch_and_shard_paths(extra):
    """The check runs on every path: the batch and (one process) the
    sharded solve raise on the NaN start, and solve a clean one."""
    with pytest.raises(FloatingPointError):
        torch_cli.main(["--device", "cpu"] + NAN_ARGS + extra)
    assert torch_cli.main(["--device", "cpu"] + CLEAN_ARGS + extra) == 0


def test_debug_nans_checks_every_evaluation():
    """A gradient that turns NaN mid-solve: the solver's guard would keep
    the NaN out of the state (a failed step), the evaluation check raises;
    the state check names the first non-finite field."""
    from tpu_lbfgs_torch.core.solver import check_finite

    p = tt.get_problem("rosenbrock")
    calls = [0]

    def grad(x):
        calls[0] += 1
        return p.grad(x) * (float("nan") if calls[0] > 5 else 1.0)

    x0 = torch.from_numpy(np.random.default_rng(0).uniform(-2, 2, 64))
    cfg = tt.LBFGSConfig(max_iters=20, tol=0.0)
    res = tt.minimize(p.f, x0, cfg, grad=grad)
    assert tt.Status.NAMES[int(res.status)] == "line_search_failed"
    calls[0] = 0
    set_debug_nans(True)
    try:
        with pytest.raises(FloatingPointError, match="vg"):
            tt.minimize(p.f, x0, cfg, grad=grad)
        state = tt.init_state(p.value_and_grad, x0, 5)
        with pytest.raises(FloatingPointError, match="non-finite g_norm"):
            check_finite(state.replace(g_norm=state.g_norm * float("inf")))
    finally:
        set_debug_nans(False)


def test_shard_nproc_spawns_its_own_ranks(capfd):
    """``--shard --nproc 2`` starts two gloo ranks itself; rank 0 prints
    the record, equal to the one-process solve's."""
    args = ["--device", "cpu", "--problem", "rosenbrock", "--dim", "101",
            "--dtype", "float64", "--max-iters", "20", "--poly-ls",
            "--direction", "compact_incremental", "--json"]
    assert torch_cli.main(args + ["--shard", "--nproc", "2"]) == 0
    lines = [line for line in capfd.readouterr().out.splitlines()
             if line.startswith("{")]
    assert len(lines) == 1
    sharded = json.loads(lines[0])["results"][0]
    assert torch_cli.main(args) == 0
    single = json.loads(capfd.readouterr().out.strip().splitlines()[-1])[
        "results"][0]
    for key in ("status", "iterations", "n_fev", "n_gev"):
        assert sharded[key] == single[key], key
    np.testing.assert_allclose(sharded["f"], single["f"], rtol=1e-10)
