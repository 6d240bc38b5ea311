"""The port's experiment tools against the JAX package's, on the CPU: the
traffic model, time to tolerance (one stage and refined), the giant cell's
line and the sweep's refusals."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lbfgs as tl
import tpu_lbfgs.bench.harness as jax_harness
import tpu_lbfgs_torch as tt
from tpu_lbfgs.bench.giant import main as jax_giant
from tpu_lbfgs.utils.roofline import traffic_model as jax_traffic_model
from tpu_lbfgs_torch.bench import harness
from tpu_lbfgs_torch.bench.__main__ import main as bench_main
from tpu_lbfgs_torch.bench import giant as giant_module
from tpu_lbfgs_torch.bench.giant import main as giant
from tpu_lbfgs_torch.utils.roofline import (
    HBM_BW_GBPS,
    traffic_model,
)

torch.set_num_threads(1)

SEARCHES = ("backtracking", "backtracking_speculative", "backtracking_wolfe",
            "wolfe_interpolation")


@pytest.mark.parametrize("history_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("fused_tail", [None, True, False])
@pytest.mark.parametrize("ls_eval", ["polynomial", "direct"])
@pytest.mark.parametrize("direction", ["two_loop", "compact",
                                       "compact_incremental"])
def test_traffic_model_counts_the_reference_passes(direction, ls_eval,
                                                   fused_tail, history_dtype):
    """Every phase's passes equal the reference's with its residency rule
    off, at any size (the port's history always streams)."""
    for search in SEARCHES:
        kw = dict(direction=direction, ls_eval=ls_eval, m=10,
                  line_search=search, use_pallas=True,
                  history_dtype=history_dtype)
        for d, batch in ((1 << 20, 1), (1024, 4096)):
            ref = jax_traffic_model(tl.LBFGSConfig(**kw), d,
                                    fused_tail=fused_tail,
                                    hist_resident=False, batch=batch)
            got = traffic_model(tt.LBFGSConfig(**kw), d,
                                fused_tail=fused_tail, batch=batch)
            for name in ("passes_direction", "passes_line_search",
                         "passes_tail", "passes_vg", "passes_total",
                         "bytes_per_iter"):
                assert getattr(got, name) == getattr(ref, name), \
                    (search, d, name)


def test_traffic_model_products_in_the_tail_and_peaks():
    cfg = tt.LBFGSConfig(direction="compact_incremental", ls_eval="polynomial",
                         m=10, use_pallas=True)
    tm = traffic_model(cfg, 1 << 26)
    fused = traffic_model(cfg, 1 << 26, with_matvec=True)
    assert fused.passes_direction == tm.passes_direction - 1.0
    assert fused.passes_total == 55.0 and tm.passes_total == 56.0
    # Without a fused tail there is nothing to put the products into.
    assert traffic_model(cfg, 1 << 26, fused_tail=False, with_matvec=True) \
        .passes_total == traffic_model(cfg, 1 << 26, fused_tail=False) \
        .passes_total
    assert tm.bytes_per_iter == tm.passes_total * (1 << 26) * 4
    assert HBM_BW_GBPS == {"h100": 3350.0}
    peak = tm.peak_iters_per_s()
    assert peak == 3350e9 / tm.bytes_per_iter
    assert tm.roofline_fraction(peak * 0.5) == 0.5
    many = traffic_model(cfg, 1024, batch=4096)
    assert many.bytes_per_iter == 4096 * traffic_model(cfg, 1024) \
        .bytes_per_iter
    assert many.peak_instance_iters_per_s() == many.peak_iters_per_s() * 4096
    # No residency rule: "auto" history is the iterate's dtype, at any size.
    assert traffic_model(cfg, 1).passes_total \
        == traffic_model(cfg, 1 << 26).passes_total
    auto = traffic_model(cfg.replace(history_dtype="auto"), 1 << 24)
    assert auto.passes_total == traffic_model(cfg, 1 << 24).passes_total
    bf16 = traffic_model(cfg.replace(history_dtype="bfloat16"), 1 << 24)
    assert bf16.passes_total == 33.0
    assert traffic_model(cfg, 1 << 20, hist_resident=True).passes_total == \
        jax_traffic_model(tl.LBFGSConfig(**{
            k: getattr(cfg, k) for k in ("direction", "ls_eval", "m",
                                         "use_pallas")}), 1 << 20,
            hist_resident=True).passes_total


def _jax_ttt(monkeypatch, ulp_offset, **kw):
    """JAX's time_to_tolerance from the harness x0, with every seventh
    coordinate from ulp_offset - 1 moved by one ulp when ulp_offset > 0."""
    draw = jax_harness._x0

    def x0(d, seed, dtype):
        a = np.random.default_rng(seed).uniform(-2.0, 2.0, d)
        if ulp_offset:
            a[ulp_offset - 1::7] = np.nextafter(a[ulp_offset - 1::7], np.inf)
        return jnp.asarray(a, dtype)

    monkeypatch.setattr(jax_harness, "_x0", x0)
    try:
        return jax_harness.time_to_tolerance(dtype=jnp.float64, **kw)
    finally:
        monkeypatch.setattr(jax_harness, "_x0", draw)


@pytest.mark.parametrize("problem", ["quadratic", "coupled_quadratic"])
def test_time_to_tolerance_f64_matches_jax(problem, monkeypatch):
    kw = dict(problem=problem, d=96, tol=1e-8, max_iters=5000)
    ref = _jax_ttt(monkeypatch, 0, **kw)
    got = harness.time_to_tolerance(dtype=torch.float64, device="cpu", **kw)
    assert got["status"] == ref["status"] == tt.Status.CONVERGED
    assert got["iterations"] == ref["iterations"]
    assert got["g_norm"] <= 1e-8 and got["device"] == "cpu"
    assert set(ref) <= set(got) and got["wall_s"] > 0


def test_time_to_tolerance_f64_rosenbrock_within_jax_spread(monkeypatch):
    """Chained Rosenbrock from U(-2, 2) takes ~370 iterations at d = 64;
    float64 trajectories part after ~100 (ROADMAP Queue 3, recorded
    differences), so the count is held to the range of JAX's own runs from
    the same x0 and from three starts one ulp away (seen: 364-368, the
    port 366): same status, count inside the range."""
    kw = dict(problem="rosenbrock", d=64, tol=1e-8, max_iters=5000)
    refs = [_jax_ttt(monkeypatch, k, **kw) for k in range(4)]
    got = harness.time_to_tolerance(dtype=torch.float64, device="cpu", **kw)
    assert got["status"] == refs[0]["status"] == tt.Status.CONVERGED
    counts = [r["iterations"] for r in refs]
    assert min(counts) <= got["iterations"] <= max(counts), \
        (got["iterations"], counts)


def test_time_to_tolerance_refined_reaches_1e5():
    """The two-stage north-star path on the CPU: float32 on the main path
    to 1e-3, then float64 from its iterate to 1e-5 in a handful of
    iterations, as JAX's does at the same d."""
    kw = dict(d=128, max_iters=30_000, refine_iters=2_000)
    ref = jax_harness.time_to_tolerance_refined(refine_backend="jax", **kw)
    with pytest.warns(UserWarning, match="float32 programs"):
        got = harness.time_to_tolerance_refined(device="cpu", **kw)
    for r in (ref, got):
        assert r["status"] == "converged", r
        assert r["g_norm"] <= 1e-5
        assert r["refine_iterations"] <= 100, r
    assert got["refine_backend"] == "torch" and got["device"] == "cpu"
    assert set(ref) <= set(got)
    assert got["wall_s"] == got["coarse_wall_s"] + got["refine_wall_s"]


def test_refined_native_backend_raises():
    """refine_backend="native" (the float64 stage by the C++ oracle on the
    host, from the float32 iterate) converges to 1e-5 at d = 128 as the
    reference's does, with its keys; only another backend name raises."""
    kw = dict(d=128, max_iters=30_000, refine_iters=2_000,
              refine_backend="native")
    ref = jax_harness.time_to_tolerance_refined(**kw)
    got = harness.time_to_tolerance_refined(device="cpu", **kw)
    for r in (ref, got):
        assert r["status"] == "converged", r
        assert r["g_norm"] <= 1e-5
        assert r["refine_iterations"] <= 100, r
    assert got["refine_backend"] == "native" and got["device"] == "cpu"
    assert set(ref) <= set(got)
    assert got["wall_s"] == got["coarse_wall_s"] + got["refine_wall_s"]
    with pytest.raises(ValueError, match="refine_backend"):
        harness.time_to_tolerance_refined(d=64, refine_backend="jax",
                                          device="cpu")


GIANT_KEYS = {"d", "m", "iters", "problem", "history_dtype", "with_matvec",
              "direction", "use_pallas", "donated_segments", "device",
              "ms_per_iter", "iters_per_s", "wall_s", "final_f", "warmup_s",
              "repeat_walls_s", "capture_s", "host_reads_per_solve",
              "roofline"}
ROOF_KEYS = {"modeled_passes_per_iter", "modeled_gb_per_iter",
             "achieved_gbps_on_model", "frac_of_h100_spec"}


@pytest.mark.parametrize("argv", [
    [],
    ["--donate", "--history-dtype", "bfloat16"],
    ["--with-matvec"],
    ["--no-pallas", "--direction", "compact"],
])
def test_giant_line(argv, capsys):
    """One JSON line with the documented keys on either path; its pass
    count is the model's for the line's configuration, which is JAX's
    count with the history streaming (at d = 4096 JAX's own line counts
    the ring as resident in VMEM, which the port's model does not)."""
    common = ["--d", "4096", "--iters", "5", "--repeats", "2"]
    giant(common + argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert set(row) == GIANT_KEYS and set(row["roofline"]) == ROOF_KEYS
    assert row["device"] == "cpu" and np.isfinite(row["final_f"])
    assert len(row["repeat_walls_s"]) == 2
    assert row["donated_segments"] is ("--donate" in argv)
    assert row["iters_per_s"] == row["iters"] / row["wall_s"]
    roof = row["roofline"]
    assert roof["achieved_gbps_on_model"] == pytest.approx(
        roof["modeled_gb_per_iter"] * row["iters_per_s"], rel=1e-12)
    assert roof["frac_of_h100_spec"] == roof["achieved_gbps_on_model"] / 3350

    jax_giant([a for a in common + argv if a != "--with-matvec"])
    jrow = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(row) - set(jrow) == {"device", "final_f", "warmup_s",
                                    "problem", "capture_s",
                                    "host_reads_per_solve"} | (
        {"repeat_walls_s"} if "--donate" not in argv else set())
    jcfg = tl.LBFGSConfig(
        line_search="backtracking", direction=jrow["direction"], m=10,
        use_pallas=jrow["use_pallas"], ls_eval="polynomial",
        history_dtype="bfloat16" if "bfloat16" in argv else None)
    ref = jax_traffic_model(jcfg, 4096, hist_resident=False)
    assert roof["modeled_passes_per_iter"] == ref.passes_total - (
        1.0 if "--with-matvec" in argv else 0.0)


@pytest.mark.parametrize("host_ahead", [True, False])
def test_giant_host_share_needs_the_host_ahead(host_ahead):
    """host_share from a stubbed timing: 1 - device time / wall while the
    host kept ahead of the card; None when it did not (the events timed
    the host, and the share would read negative: -0.039 at d = 2^22 in
    torch_records/torch_giant_results.jsonl)."""
    timing = {"device_us_per_iter": 3930.0 * (1.039 if not host_ahead
                                              else 0.25),
              "host_ahead": host_ahead}
    share = giant_module.host_share(timing, 3.93)
    if host_ahead:
        assert share == pytest.approx(0.75, rel=1e-12)
    else:
        assert share is None


def test_giant_profile_needs_the_card(capsys):
    """--profile times the card's kernels: on the CPU it is refused, and
    no line is printed."""
    with pytest.raises(SystemExit):
        giant(["--d", "64", "--iters", "2", "--profile", "--device", "cpu"])
    captured = capsys.readouterr()
    assert captured.out == "" and "needs the card" in captured.err


def test_sweep_protocol_with_cpu_cells_only(tmp_path, capsys):
    """--reference-protocol --no-cuda: the C++ oracle's cells alone, each
    in its own interpreter, with no card; four at a time (--jobs), so the
    report keeps no rate."""
    out = tmp_path / "protocol.json"
    assert bench_main(["--reference-protocol", "--no-cuda", "--quick",
                       "--problem", "quadratic", "--dims", "64",
                       "--cpu-budget", "60", "--jobs", "4",
                       "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["device"] is None and report["concurrent_cells"] == 4
    cells = report["cells"]
    assert [c["backend"] for c in cells] == ["cpu-native-f64"] * 4
    assert all(c["statuses"] == ["converged"] * 2 and "iters_per_s" not in c
               for c in cells)
    assert "cpu-native-f64" in capsys.readouterr().out


def test_sweep_refuses_scaling_and_runs_on_the_card_only():
    """--scaling (bench.scaling.scaling_sweep) and the sweep
    run on the card only; without one they raise (tests/test_torch_tools.py
    runs the scaling sweep on gloo CPU ranks)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip runs measure the sweep")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_main(["--scaling"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_main(["--quick", "--iters", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        harness.time_to_tolerance(d=16)
