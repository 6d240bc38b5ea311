"""The port's command line against the JAX package's, on the CPU.

``tpu_lbfgs_torch.cli.main(argv)`` and ``tpu_lbfgs.cli.main(argv)`` run in
process on the same argument lists (those of tests/test_cli.py that the
port supports, and the ``--pallas`` sets the port's command line exists
for) with ``--device cpu --json``.  Both draw x0 with numpy's
``default_rng(seed)``, so they start from the same point.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tpu_lbfgs.cli as jax_cli
import tpu_lbfgs_torch.cli as torch_cli

# The tensors here are small: one intra-op thread is faster, and leaves
# the cores to the other test workers.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _run(cli, argv, capsys):
    capsys.readouterr()
    assert cli.main(list(argv) + ["--device", "cpu", "--json"]) == 0
    out = capsys.readouterr().out
    return json.loads(out.strip().splitlines()[-1])


# Argument sets on which the two packages agree step for step in float64:
# status, iterations, n_fev and n_gev equal, guards equal; f and g_norm
# within 1e-5 relative (the sums' order differs in the last bits and the
# trajectory amplifies that slowly: observed below 3e-8 on Rosenbrock, 8e-6
# on the g_norm of a quadratic that has fallen by 13 orders of magnitude)
# plus 1e-12, the rounding residue of a quadratic solved to its minimum.
F64_SETS = {
    # tests/test_cli.py::test_single_solve_json
    "single_solve": "--problem coupled_quadratic --dim 64 --max-iters 200 "
                    "--tol 1e-8",
    # test_poly_ls_and_direction_flags, cut to 12 iterations: an
    # interpolated alpha moves with the last bits of f, so the full solve's
    # iteration count is not comparable (test_poly_ls_and_direction_flags
    # below runs it to convergence)
    "poly_ls_direction": "--problem rosenbrock --dim 32 --max-iters 12 "
                         "--tol 1e-5 --poly-ls --direction "
                         "compact_incremental --line-search "
                         "wolfe_interpolation",
    # test_multi_seed_protocol
    "multi_seed": "--problem quadratic --dim 16 --max-iters 20 --tol 1e-10 "
                  "--seeds 42 365",
    # the --pallas path: every factory of problems.suite
    "pallas_poly_coupled": "--problem coupled_quadratic --dim 293 --pallas "
                           "--poly-ls --direction compact_incremental "
                           "--tol 1e-8",
    "pallas_poly_quadratic": "--problem quadratic --dim 293 --pallas "
                             "--poly-ls --direction compact_incremental",
    "pallas_sphere": "--problem sphere --dim 293 --pallas --tol 1e-8",
    "pallas_speculative": "--problem coupled_quadratic --dim 293 --pallas "
                          "--line-search backtracking_speculative "
                          "--tol 1e-8",
    "pallas_wolfe_speculative": "--problem quadratic --dim 293 --pallas "
                                "--line-search "
                                "wolfe_interpolation_speculative --tol 1e-8",
    "pallas_bt_wolfe_speculative": "--problem coupled_quadratic --dim 293 "
                                   "--pallas --line-search "
                                   "backtracking_wolfe_speculative "
                                   "--tol 1e-8 -m 5",
    "damping_trace_two_loop": "--problem rosenbrock --dim 64 --max-iters 40 "
                              "--damping 0.2 --trace --direction two_loop "
                              "--line-search backtracking_wolfe",
    "bf16_history": "--problem rosenbrock --dim 256 --max-iters 40 "
                    "--history-dtype bfloat16 --poly-ls --pallas "
                    "--direction compact_incremental",
    "auto_history": "--problem rosenbrock --dim 256 --max-iters 30 "
                    "--history-dtype auto --poly-ls --pallas",
    "auto_speculative": "--problem rosenbrock --dim 64 --max-iters 40 "
                        "--auto-speculative --line-search "
                        "wolfe_interpolation --x0-range 0.5",
    # --batch in direct mode through vmap_minimize, both lockstep modes
    "batch_direct_wolfe": "--batch 4 --problem rosenbrock --dim 32 "
                          "--max-iters 20 --line-search wolfe_interpolation",
    "batch_direct_bt_wolfe_speculative": "--batch 4 --problem "
                                         "coupled_quadratic --dim 32 "
                                         "--max-iters 30 --tol 1e-8 "
                                         "--line-search "
                                         "backtracking_wolfe_speculative "
                                         "--lockstep bounded",
    "batch_direct_backtracking": "--batch 4 --problem rosenbrock --dim 32 "
                                 "--max-iters 20 --lockstep bounded",
    # --batch --pallas: cfg.use_pallas over the batch, both lockstep modes
    # (on the CPU iteration_tail runs its plain version, the counterpart of
    # the reference's jnp route for float64; on the card, its kernel)
    "batch_pallas_poly": "--batch 4 --problem rosenbrock --dim 256 --pallas "
                         "--poly-ls --direction compact_incremental "
                         "--max-iters 30 --lockstep bounded",
    "batch_pallas_direct": "--batch 4 --problem coupled_quadratic --dim 128 "
                           "--pallas --max-iters 30 --tol 1e-8",
    # --shard with --batch: the batch branch runs and --shard is ignored
    # there, in both command lines
    "shard_batch_poly": "--shard --batch 4 --poly-ls --problem rosenbrock "
                        "--dim 64 --max-iters 30 --lockstep bounded",
    # --backend native: the C++ oracle on the host in both command lines
    # (one source built with one command), whatever --dtype says
    "native_rosenbrock": "--backend native --problem rosenbrock --dim 1000",
    "native_coupled_bisect": "--backend native --problem coupled_quadratic "
                             "--dim 64 --line-search "
                             "backtracking_wolfe_bisect --tol 1e-8 "
                             "--seeds 42 365",
}


@pytest.mark.parametrize("name", list(F64_SETS))
def test_cli_matches_jax_f64(name, capsys):
    argv = ["--dtype", "float64"] + F64_SETS[name].split()
    ref = _run(jax_cli, argv, capsys)
    out = _run(torch_cli, argv, capsys)
    assert len(out["results"]) == len(ref["results"]) >= 1
    # --backend's first value and --nproc (which starts the ranks of
    # --shard) are the port's own.
    own = ("backend", "nproc")
    assert {k: v for k, v in out["config"].items() if k not in own} == \
        {k: v for k, v in ref["config"].items() if k not in own}
    for a, b in zip(out["results"], ref["results"]):
        assert a.keys() == b.keys()
        # A --batch record has counts and means over its lanes instead.
        batch = "batch" in b
        for key in (("seed", "batch", "converged", "mean_iterations") if batch
                    else ("seed", "status", "iterations", "n_fev", "n_gev")):
            assert a[key] == b[key], key
        # A --backend native record counts no guards.
        assert a.get("guards") == b.get("guards")
        for key in (("mean_f", "max_g_norm") if batch else ("f", "g_norm")):
            assert abs(a[key] - b[key]) <= 1e-5 * abs(b[key]) + 1e-12, key
        assert a["wall_s"] > 0


# float32 with the fused kernels' factories at d = 4096: the packages sum
# in float32 (reference) and float64 (port), so a solve is compared over a
# fixed number of iterations: counts equal, f within 2e-3 (the bound of
# tests/test_torch_solver.py::test_minimize_matches_jax_end_to_end; g_norm
# and the pair-reject counter are not comparable there, see that test).
F32_SETS = {
    "rosenbrock_poly": ("--problem rosenbrock --dim 4096 --pallas --poly-ls "
                        "--direction compact_incremental --max-iters 50 "
                        "--tol 0", 2e-3),
    "rosenbrock_direct": ("--problem rosenbrock --dim 4096 --pallas "
                          "--max-iters 30 --tol 0", 2e-3),
    "coupled_poly": ("--problem coupled_quadratic --dim 4096 --pallas "
                     "--poly-ls", 2e-3),
    "coupled_plain": ("--problem coupled_quadratic --dim 4096", 2e-3),
}


@pytest.mark.parametrize("name", list(F32_SETS))
def test_cli_matches_jax_f32(name, capsys):
    args, rtol = F32_SETS[name]
    argv = ["--dtype", "float32"] + args.split()
    a = _run(torch_cli, argv, capsys)["results"][0]
    b = _run(jax_cli, argv, capsys)["results"][0]
    for key in ("status", "iterations", "n_fev", "n_gev"):
        assert a[key] == b[key], key
    assert abs(a["f"] - b["f"]) <= rtol * abs(b["f"])


def test_poly_ls_and_direction_flags(capsys):
    """tests/test_cli.py's argument list, to convergence in both."""
    argv = ("--dtype float64 --problem rosenbrock --dim 32 --max-iters 2000 "
            "--tol 1e-5 --poly-ls --direction compact_incremental "
            "--line-search wolfe_interpolation").split()
    for cli in (torch_cli, jax_cli):
        rec = _run(cli, argv, capsys)["results"][0]
        assert rec["status"] == "converged" and rec["g_norm"] < 1e-5


@pytest.mark.parametrize("lockstep", ["while", "bounded"])
def test_batch_poly_ls(lockstep, capsys):
    """tests/test_cli.py::test_batch_poly_ls in both lockstep modes: the
    batch record's fields agree (means to 1e-5 relative plus 1e-12, as
    above)."""
    argv = ["--dtype", "float64", "--batch", "4", "--dim", "64", "--problem",
            "coupled_quadratic", "--poly-ls", "--max-iters", "30", "--tol",
            "1e-6", "--lockstep", lockstep]
    a = _run(torch_cli, argv, capsys)["results"][0]
    b = _run(jax_cli, argv, capsys)["results"][0]
    assert a.keys() == b.keys()
    assert a["batch"] == b["batch"] == 4 and a["converged"] == b["converged"]
    assert a["mean_iterations"] == b["mean_iterations"]
    for key in ("mean_f", "max_g_norm"):
        assert abs(a[key] - b[key]) <= 1e-5 * abs(b[key]) + 1e-12, key


def test_verbose_reference_log(capsys):
    """The per-iteration log from the trace, line for line the
    reference's (6 significant digits of f and |grad|, 4 of alpha)."""
    argv = ["--device", "cpu", "--dtype", "float64", "--problem", "quadratic",
            "--dim", "16", "--max-iters", "20", "--tol", "1e-10",
            "--verbose"]
    logs = []
    for cli in (torch_cli, jax_cli):
        capsys.readouterr()
        assert cli.main(argv) == 0
        out = capsys.readouterr().out
        logs.append([ln for ln in out.splitlines()
                     if ln.startswith("Iteration")])
        assert "seed 42: status=converged" in out
    assert logs[0] and logs[0][0].startswith("Iteration 0, f = ")
    assert "|grad| = " in logs[0][0]
    assert logs[0][:1] == logs[1][:1] and len(logs[0]) == len(logs[1])


def test_multi_seed_summary_and_damped_guards(capsys):
    capsys.readouterr()
    assert torch_cli.main(
        "--device cpu --dtype float64 --problem rosenbrock --dim 64 "
        "--max-iters 30 --damping 0.2 --seeds 42 365".split()) == 0
    out = capsys.readouterr().out
    assert "mean wall over 2 seeds" in out
    assert "guards={'damped': " in out


@pytest.mark.parametrize("argv,message", [
    # --backend native: the reference's two checks of what the C++ oracle
    # has, before anything runs
    (["--backend", "native", "--problem", "sphere"],
     "--backend native supports problems ['coupled_quadratic', 'quadratic', "
     "'rosenbrock'], not 'sphere'"),
    (["--backend", "native", "--line-search", "backtracking_speculative"],
     "--backend native supports line searches ['armijo_interpolation', "
     "'backtracking', 'backtracking_wolfe', 'backtracking_wolfe_bisect', "
     "'wolfe_interpolation'], not 'backtracking_speculative'"),
    (["--nproc", "2"], "give --shard too"),
    (["--line-search", "nope"], "invalid choice"),
])
def test_unported_flags_exit_through_the_parser(argv, message, capsys):
    with pytest.raises(SystemExit) as exc:
        torch_cli.main(["--device", "cpu", "--dim", "16"] + argv)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def test_native_backend_runs_on_the_host(capsys):
    """--backend native without --device: each seed is the C++ oracle's
    solve on the host of default_rng(seed).uniform(-r, r, dim), as a
    direct native_lbfgs call gives it, whether or not a card is present."""
    import numpy as np

    from tpu_lbfgs_torch import LBFGSConfig
    from tpu_lbfgs_torch.native import native_lbfgs

    capsys.readouterr()
    assert torch_cli.main("--backend native --problem rosenbrock --dim 300 "
                          "--line-search wolfe_interpolation --seeds 7 "
                          "--json".split()) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    r = native_lbfgs("rosenbrock",
                     np.random.default_rng(7).uniform(-2.0, 2.0, 300),
                     LBFGSConfig(line_search="wolfe_interpolation"))
    got = rec["results"][0]
    for key in ("status", "iterations", "f", "g_norm", "n_fev", "n_gev"):
        assert got[key] == r[key], key


def test_parser_surface_matches_the_reference():
    """Every flag of the reference's parser, with the same defaults and
    choices, apart from --backend's first value; and --nproc, which starts
    the ranks of --shard where the reference's single controller needs
    none."""
    ours = {a.dest: a for a in torch_cli.build_parser()._actions}
    theirs = {a.dest: a for a in jax_cli.build_parser()._actions}
    assert ours.keys() == theirs.keys() | {"nproc"}
    for dest, act in theirs.items():
        assert ours[dest].option_strings == act.option_strings, dest
        if dest == "backend":
            assert ours[dest].choices == ["torch", "native"]
            continue
        assert ours[dest].default == act.default, dest
        assert ours[dest].choices == act.choices, dest


def test_default_device_needs_a_card():
    """Without --device cpu the command line solves on the current CUDA
    device and, without one, raises; ``python -m tpu_lbfgs_torch`` is the
    same entry point."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py runs the "
                    "command line there")
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_cli.main(["--dim", "16", "--max-iters", "2"])
    env = dict(os.environ, PYTHONPATH=str(REPO))
    base = [sys.executable, "-m", "tpu_lbfgs_torch", "--dim", "64",
            "--max-iters", "3", "--json"]
    bad = subprocess.run(base, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert bad.returncode != 0 and "CUDA" in bad.stderr
    good = subprocess.run(base + ["--device", "cpu"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert good.returncode == 0, good.stderr[-2000:]
    rec = json.loads(good.stdout.strip().splitlines()[-1])
    assert rec["results"][0]["iterations"] == 3


def test_profile_writes_a_trace(tmp_path, capsys):
    out_dir = tmp_path / "prof"
    assert torch_cli.main(
        ["--device", "cpu", "--dim", "64", "--max-iters", "3", "--json",
         "--profile", str(out_dir)]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["results"][0]["iterations"] == 3
    trace = out_dir / "trace.json"
    assert trace.is_file() and "traceEvents" in trace.read_text()[:2000]
