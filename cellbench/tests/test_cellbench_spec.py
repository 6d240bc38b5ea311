"""The benchmark's description: every cell finds its files by name, a cell
or a metric is added by adding files, and ``BENCHMARK.json`` keeps to the
form the benchmark's contract gives it."""
import json
import re
import shutil

import pytest

from cellbench import spec

SPEC = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DATA = ("configs", "traffic", "limits", "metrics")


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_finds_its_files(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == next(
        w for w in SPEC["workloads"] if w["name"] == name)["config"]
    assert {"iters", "drive", "search", "box", "pool"} <= set(cell.traffic)
    assert cell.limits
    assert cell.end_to_end and cell.per_layer
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))


def test_benchmark_form():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["cellbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in SPEC[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= cells
    for c in SPEC["configs"]:
        assert c["file"].startswith("cellbench/") and len(c["source"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])


def test_a_cell_and_a_metric_are_added_as_files(tmp_path):
    """A new configuration, mix, cell and metric need new files and
    entries only: the files already there stay byte for byte."""
    for sub in DATA:
        shutil.copytree(spec.HERE / sub, tmp_path / "cellbench" / sub)
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "cellbench").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(SPEC))
    base = json.loads((spec.ROOT / bench["configs"][0]["file"]).read_text())
    (tmp_path / "cellbench/configs/genrose-d2e18-f32.json").write_text(
        json.dumps(dict(base, name="genrose-d2e18-f32", d=1 << 18)))
    (tmp_path / "cellbench/traffic/short.json").write_text(json.dumps(
        dict(json.loads((spec.HERE / "traffic/main.json").read_text()),
             iters=50)))
    (tmp_path / "cellbench/limits/genrose-d2e18.short.json").write_text(
        json.dumps({"short": 0}))
    (tmp_path / "cellbench/metrics/solves.py").write_text(
        "def read(run):\n    return run.solves\n")
    bench["configs"].append(dict(bench["configs"][0], name="genrose-d2e18-f32",
                                 file="cellbench/configs/genrose-d2e18-f32.json"))
    bench["workloads"].append({"name": "genrose-d2e18.short",
                               "config": "genrose-d2e18-f32",
                               "traffic": "short", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "solves", "unit": "solves",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "iters_per_s",
                               "workloads": ["genrose-d2e18.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("genrose-d2e18.short", root=tmp_path)
    assert cell.config["d"] == 1 << 18 and cell.traffic["iters"] == 50
    assert "solves" in {m["name"] for m in cell.per_layer}
    assert spec.reader("solves", root=tmp_path)(
        type("R", (), {"solves": 3})()) == 3
    old = spec.load_cell(SPEC["workloads"][0]["name"], root=tmp_path)
    assert "solves" not in {m["name"] for m in old.per_layer}
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data


def test_a_cell_kind_reads_by_its_stem(tmp_path):
    """``<stem>.<kind>`` without a file of its own is read by
    ``metrics/<stem>.py``; a file of its own comes first."""
    (tmp_path / "cellbench" / "metrics").mkdir(parents=True)
    (tmp_path / "cellbench/metrics/solves.py").write_text(
        "def read(run):\n    return run.solves\n")
    run = type("R", (), {"solves": 3})()
    assert spec.reader("solves.search", root=tmp_path)(run) == 3
    (tmp_path / "cellbench/metrics/solves.batch.py").write_text(
        "def read(run):\n    return 2 * run.solves\n")
    assert spec.reader("solves.batch", root=tmp_path)(run) == 6
