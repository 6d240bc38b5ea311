"""The run's entry: what it refuses, what it loads, and the shape of its
last line."""
import json
import subprocess
import sys

import torch

from cellbench import check, spec, trace
from cellbench import run as entry
from cellbench.tests.helpers import cpu_run


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "cellbench.run", "--workload",
         "genrose-d2e20.main", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=spec.ROOT,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    if torch.cuda.is_available():
        return
    assert proc.returncode == 2, proc.stderr
    assert proc.stdout == ""


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    for name in ("tpu_lbfgs_torch.core", "jax_like", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert entry.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpu_lbfgs.core", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert entry.forbidden_modules() == ["jax", "tpu_lbfgs.core"]


def test_a_run_loads_no_jax():
    code = ("import sys; from cellbench.tests.helpers import cpu_run;"
            "from cellbench import control, run, trace;"
            "cpu_run('genrose-d2e20.main', seconds=0.1);"
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=spec.ROOT).stdout
    assert out.strip().splitlines()[-1] == "[]"


def _line(run, traced, monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(entry, "power_limit_w", lambda: 700.0)
    correct, shown = check.verdict(run.numbers, run.cell.limits)
    return json.loads(json.dumps(entry.result_line(run, traced, correct,
                                                   shown, 123)))


def test_last_line_shape(monkeypatch):
    run = cpu_run("genrose-d2e20.main", seconds=0.1)
    line = _line(run, False, monkeypatch)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "check"]
    assert line["correct"] is True and line["attempted"] == run.solves
    assert set(line["metrics"]) == {"iters_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 1
    assert line["device"]["memory_peak_bytes"] == 123
    assert all(set(v) == {"value", "limit"} for v in line["check"].values())

    run.slice = trace.Slice([("tail_tile_kernel", 0.0, 1e-5)], 1e-3, 1e-5)
    run.slice_steps = 1
    monkeypatch.setattr("cellbench.roofline._peaks", lambda r: {
        "hbm_bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12})
    line = _line(run, True, monkeypatch)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "check"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"kernels_per_iter.solve", "solve_ms_p95.solve"} <= set(line["metrics"])
    assert "iters_per_s" not in line["metrics"]
