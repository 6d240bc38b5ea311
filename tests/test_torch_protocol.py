"""The port's reference protocol (tpu_lbfgs_torch.bench.reference_protocol)
on the CPU at small d, against the JAX package's run_tpu_cell and
run_cpu_cell from the same starting arrays (tests/test_reference_protocol.py
is the model)."""
import numpy as np
import pytest
import torch

import tpu_lbfgs.bench.reference_protocol as jax_rp
from tpu_lbfgs.config import LINE_SEARCH_METHODS
from tpu_lbfgs_torch.bench import reference_protocol as rp
from tpu_lbfgs_torch.problems.suite import reference_x0

torch.set_num_threads(1)


def _same_x0(monkeypatch, ulp_offset=0):
    """JAX's cells start from the port's reference_x0 array (numpy's draw),
    with every seventh coordinate from ulp_offset - 1 moved by one ulp
    when ulp_offset > 0."""
    def x0(d, seed, low=-1000.0, high=1000.0):
        a = reference_x0(d, seed, low, high, device="cpu").numpy().copy()
        if ulp_offset:
            a[ulp_offset - 1::7] = np.nextafter(a[ulp_offset - 1::7], np.inf)
        return a
    monkeypatch.setattr(jax_rp, "_x0_np", x0)


def test_table_i_strategies_match_the_reference():
    assert rp.TABLE_I_STRATEGIES == jax_rp.TABLE_I_STRATEGIES
    assert rp.DIMS == jax_rp.DIMS
    for _, key in rp.TABLE_I_STRATEGIES:
        assert key in LINE_SEARCH_METHODS


def test_reference_x0_draws_with_numpy_on_the_device_asked_for():
    x = reference_x0(1000, 42, device="cpu")
    assert x.dtype == torch.float64 and x.shape == (1000,)
    np.testing.assert_array_equal(
        x.numpy(), np.random.default_rng(42).uniform(-1000, 1000, 1000))
    assert float(x.abs().max()) <= 1000.0
    x32 = reference_x0(10, 7, low=-2.0, high=2.0, dtype=torch.float32,
                       device="cpu")
    assert torch.equal(x32, reference_x0(10, 7, -2.0, 2.0, device="cpu")
                       .float())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            reference_x0(10, 7)


@pytest.mark.parametrize("no_rescue", [False, True])
def test_far_start_quadratic_converges_f32(no_rescue):
    cell = rp.run_cuda_cell("quadratic", 256, "backtracking", seeds=(42, 365),
                            no_rescue=no_rescue, device="cpu")
    assert cell["backend"] == ("cuda-f32-norescue" if no_rescue
                               else "cuda-f32-parcfg")
    assert cell["seeds_run"] == 2 and cell["statuses"] == ["converged"] * 2
    assert cell["max_final_g_norm"] <= 1e-1
    assert cell["mean_iterations"] <= 50
    assert cell["device"] == "cpu" and "warmup_s" in cell


def test_budget_limits_seeds():
    # A zero budget still runs the first seed (the projection needs one
    # measured wall) and no more.
    cell = rp.run_cuda_cell("quadratic", 256, "backtracking",
                            seeds=(42, 365, 12345), budget_s=0.0,
                            device="cpu")
    assert cell["seeds_run"] == 1 and cell["seeds_total"] == 3


@pytest.mark.parametrize("strategy", ["backtracking_wolfe",
                                      "wolfe_interpolation"])
def test_f64_rosenbrock_wolfe_cell_matches_jax(strategy, monkeypatch):
    """The sequential configuration in float64 from U(-1000, 1000) at d =
    16, the same array in both packages: the same status, and the
    iteration count inside the range of JAX's runs from that array and
    from three arrays one ulp away (float64 Rosenbrock trajectories part
    after ~100 iterations, in JAX against itself too; seen: JAX 153-156
    and 159-174, the port 155 and 170)."""
    counts, statuses = [], set()
    for k in range(4):
        _same_x0(monkeypatch, k)
        ref = jax_rp.run_tpu_cell("rosenbrock", 16, strategy, seeds=(42,),
                                  dtype="float64", use_pallas=False)
        counts.append(ref["per_seed_iterations"][0])
        statuses.add(ref["statuses"][0])
    got = rp.run_cuda_cell("rosenbrock", 16, strategy, seeds=(42,),
                           dtype="float64", device="cpu")
    assert got["backend"] == "cuda-f64"
    assert len(statuses) == 1 and got["statuses"] == [statuses.pop()]
    assert min(counts) <= got["per_seed_iterations"][0] <= max(counts), \
        (got["per_seed_iterations"], counts)


@pytest.mark.parametrize("strategy,no_rescue", [
    ("armijo_interpolation", False), ("wolfe_interpolation", False),
    ("armijo_interpolation", True), ("wolfe_interpolation", True),
    ("backtracking", False)])
def test_f32_failures_at_iteration_1_from_the_published_box(
        strategy, no_rescue, monkeypatch):
    """From U(-1000, 1000) in float32 the interpolating searches fail at
    iteration 1 under either float32 configuration, and plain Armijo with
    the alpha-floor rescue overflows, in both packages: reproduced, not
    repaired."""
    _same_x0(monkeypatch)
    ref = jax_rp.run_tpu_cell("rosenbrock", 512, strategy, seeds=(42, 365),
                              use_pallas=False, no_rescue=no_rescue)
    got = rp.run_cuda_cell("rosenbrock", 512, strategy, seeds=(42, 365),
                           no_rescue=no_rescue, device="cpu")
    assert ref["statuses"] == got["statuses"] == ["line_search_failed"] * 2
    assert ref["per_seed_iterations"] == got["per_seed_iterations"] == [1, 1]


def test_run_protocol_quick_grid_and_report(tmp_path):
    out = tmp_path / "ref.json"
    report = rp.run_protocol(problem="quadratic", dims=(256, 512),
                             seeds=(42, 365, 12345), out=str(out),
                             quick=True, isolate=False, device="cpu")
    # quick: the first d, the first 2 seeds, 4 strategies x 3 backends
    # (the two float32 ones and the C++ oracle's).
    assert len(report["cells"]) == 12
    assert {c["d"] for c in report["cells"]} == {256}
    assert {c["backend"] for c in report["cells"]} == {
        "cuda-f32-parcfg", "cuda-f32-norescue", "cpu-native-f64"}
    assert all(c["seeds_total"] == 2 for c in report["cells"])
    assert report["device"] == "cpu" and report["concurrent_cells"] == 1
    # Every strategy's float32 and CPU cells iterate on the quadratic.
    rows = report["per_iteration_speedups"]
    assert len(rows) == 4 and all(r["cuda_per_iter_speedup"] > 0
                                  and "f32_over_f64_per_iter" not in r
                                  for r in rows)
    assert out.exists()
    md = rp.markdown_table(report)
    assert md.count("\n") == 13         # header + rule + 12 rows
    assert "Armijo Backtracking" in md and "cuda-f32-norescue" in md
    assert "cpu-native-f64" in md


def test_run_protocol_with_f64_cells_and_ratios():
    report = rp.run_protocol(problem="quadratic", dims=(128,), seeds=(42,),
                             out=None, quick=True, isolate=False,
                             cuda_f64=True, device="cpu")
    assert len(report["cells"]) == 16
    f64 = [c for c in report["cells"] if c["backend"] == "cuda-f64"]
    assert len(f64) == 4 and all(c["statuses"] == ["converged"] for c in f64)
    assert all(c["max_final_g_norm"] <= 1e-8 for c in f64)
    assert len(report["per_iteration_speedups"]) == 4
    assert all(r["f32_over_f64_per_iter"] > 0
               and r["cuda_per_iter_speedup"] > 0
               for r in report["per_iteration_speedups"])


@pytest.mark.parametrize("_, strategy", rp.TABLE_I_STRATEGIES)
def test_cpu_cell_matches_jax(_, strategy, monkeypatch):
    """The C++ oracle's cell from the same U(-1000, 1000) arrays in both
    packages: statuses, iterations and f equal (both load the oracle
    built from one source with one command)."""
    _same_x0(monkeypatch)
    ref = jax_rp.run_cpu_cell("rosenbrock", 16, strategy, seeds=(42, 365))
    got = rp.run_cpu_cell("rosenbrock", 16, strategy, seeds=(42, 365))
    assert got["backend"] == ref["backend"] == "cpu-native-f64"
    for key in ("seeds_run", "seeds_total", "statuses", "per_seed_iterations",
                "mean_iterations", "mean_final_f", "max_final_g_norm"):
        assert got[key] == ref[key], key
    assert got["device"]
    scaled = rp.run_cpu_cell("quadratic", 16, strategy, seeds=(42,),
                             x0_range=(-10.0, 10.0))
    assert scaled["backend"] == "cpu-native-f64-scaled"
    assert scaled["statuses"] == ["converged"]


def test_cpu_cell_budget(monkeypatch):
    """A probe that does not converge and projects one seed past the
    budget skips the cell, as the reference's does; a cell that runs stops
    adding seeds at the budget (the first always runs)."""
    _same_x0(monkeypatch)
    kw = dict(seeds=(42, 365, 12345), budget_s=0.0)
    got = rp.run_cpu_cell("rosenbrock", 256, "backtracking", **kw)
    ref = jax_rp.run_cpu_cell("rosenbrock", 256, "backtracking", **kw)
    assert got.keys() == ref.keys()
    assert got["skipped"] == ref["skipped"] == "budget"
    assert got["seeds_run"] == 0 and got["projected_wall_s_per_seed"] > 0
    got = rp.run_cpu_cell("quadratic", 256, "backtracking", **kw)
    assert got["seeds_run"] == 1 and got["seeds_total"] == 3


def test_run_protocol_cpu_cells_need_no_card(monkeypatch):
    """run_protocol(cuda=False): only the C++ oracle's cells, no device,
    and the reference report's keys (less its TPU float64 probe, which is
    not ported); with cuda=True and no card it still raises."""
    _same_x0(monkeypatch)
    kw = dict(problem="quadratic", dims=(64,), seeds=(42, 365), out=None,
              isolate=False)
    got = rp.run_protocol(cuda=False, **kw)
    ref = jax_rp.run_protocol(tpu=False, **kw)
    assert set(ref) - {"f64_probe"} <= set(got)
    assert ref["protocol"]["cpu_config"] in got["protocol"]["cpu_config"]
    assert got["device"] is None and got["cpu"]
    assert [c["backend"] for c in got["cells"]] == ["cpu-native-f64"] * 4
    for a, b in zip(got["cells"], ref["cells"]):
        assert (a["strategy"], a["statuses"], a["per_seed_iterations"],
                a["mean_final_f"]) == (b["strategy"], b["statuses"],
                                       b["per_seed_iterations"],
                                       b["mean_final_f"])
    assert got["per_iteration_speedups"] == ref["per_iteration_speedups"] \
        == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            rp.run_protocol(cpu=False, **kw)


def test_markdown_table_renders_error_and_skip_rows():
    report = {"cells": [
        {"d": 10, "strategy": "S", "backend": "cuda-f64", "error": "boom"},
        {"d": 10, "strategy": "S", "backend": "cuda-f32-parcfg",
         "skipped": "budget"},
    ]}
    md = rp.markdown_table(report)
    assert "boom" in md and "skipped (budget)" in md


def test_an_in_process_cell_failure_is_recorded():
    cell = rp._one_cell("quadratic", 64, "backtracking", "cuda-f16", (42,),
                        60.0, 60, isolate=False, device="cpu")
    assert cell == {"backend": "cuda-f16",
                    "error": "ValueError: unknown backend 'cuda-f16'; "
                             f"expected one of {rp.BACKENDS}"}


def test_a_cell_runs_in_its_own_interpreter():
    cell = rp._cell_subprocess("quadratic", 64, "backtracking",
                               "cuda-f32-norescue", (42,), 60.0, 120,
                               device="cpu")
    assert cell["statuses"] == ["converged"] and cell["device"] == "cpu"
    assert cell["backend"] == "cuda-f32-norescue"


def test_a_cpu_cell_runs_in_its_own_interpreter():
    cell = rp._cell_subprocess("quadratic", 64, "backtracking", "cpu", (42,),
                               60.0, 120)
    assert cell["backend"] == "cpu-native-f64"
    assert cell["statuses"] == ["converged"] and cell["device"]


def test_cell_ran_and_cell_rate():
    good = {"iters_per_s": 100.0, "statuses": ["converged", "max_iters"]}
    mixed = {"iters_per_s": 5.0,
             "statuses": ["line_search_failed", "max_iters"],
             "per_seed_wall_s": [0.004, 10.0],
             "per_seed_iterations": [1, 1000]}
    dead = {"iters_per_s": 3.0,
            "statuses": ["line_search_failed", "line_search_failed"],
            "per_seed_wall_s": [0.004, 0.004],
            "per_seed_iterations": [1, 1]}
    skipped = {"skipped": "budget"}
    assert rp._cell_ran(good) and not rp._cell_ran(mixed)
    assert not rp._cell_ran(skipped)
    assert not rp._cell_ran({"iters_per_s": 1.0, "statuses": []})
    assert rp._cell_rate(good) == (100.0, 2)
    rate, used = rp._cell_rate(mixed)
    assert used == 1 and abs(rate - 100.0) < 1e-9
    assert rp._cell_rate(dead) == (None, 0)
    assert rp._cell_rate(skipped) == (None, 0)
    for c in (good, mixed, dead, skipped):
        assert rp._cell_ran(c) == jax_rp._cell_ran(c)
        assert rp._cell_rate(c) == jax_rp._cell_rate(c)
