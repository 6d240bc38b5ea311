"""What one cell is, read from ``BENCHMARK.json`` and the data files it
names: the configuration, the traffic mix, the limits of its comparison,
the metrics it reports and the reader of each per-layer metric.

Everything is found by name.  A cell ``<config>.<mix>`` of ``workloads``
names a configuration, whose ``file`` holds its sizes and solver settings;
its traffic mix is ``traffic/<mix>.json``; the limits of its comparison
are ``limits/<cell>.json``; a per-layer metric ``<metric>`` is read by
``metrics/<metric>.py``, or by ``metrics/<stem>.py`` where the metric is
one cell kind's ``<stem>.<kind>``, a module with ``read(run) -> float |
None``; an end-to-end metric is read the same way.
So a cell or a metric is added by adding files and entries, and no file
that is already here changes.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    def settings(self) -> dict:
        """The solver's settings as the configuration and the mix state
        them (the mix's override the configuration's)."""
        return {**self.config["solver"], "m": self.config["m"],
                **self.traffic["search"]}


def _load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str, e2e_names: set) -> bool:
    """A metric with ``workloads`` applies to those cells; one without
    applies to every cell that reports the end-to-end metric it moves (a
    per-layer one) or to every cell (an end-to-end one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` (``root`` a checkout);
    raises ``KeyError`` for a name the benchmark does not list."""
    spec = _load_json(root / "BENCHMARK.json")
    here = root / HERE.name
    work = {w["name"]: w for w in spec["workloads"]}[name]
    conf = {c["name"]: c for c in spec["configs"]}[work["config"]]
    config = _load_json(root / conf["file"])
    traffic = _load_json(here / "traffic" / f"{work['traffic']}.json")
    limits = _load_json(here / "limits" / f"{name}.json")
    e2e = [m for m in spec["end_to_end"] if _applies(m, name, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _applies(m, name, names)]
    return Cell(name, work["chips"], config, traffic, limits, e2e, layer)


def reader(metric: str, root: Path = ROOT):
    """``read(run)`` of the per-layer metric ``metric``, from
    ``metrics/<metric>.py``, or where there is none from the reader of its
    stem, the name before the first dot (``metrics/kernels_per_iter.py``
    reads ``kernels_per_iter.solve`` and ``kernels_per_iter.batch``)."""
    path = root / HERE.name / "metrics" / f"{metric}.py"
    if not path.exists():
        path = path.with_name(metric.split(".")[0] + ".py")
    mod_name = "cellbench.metrics." + metric.replace(".", "__").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
