"""Run one cell of the benchmark once and print its result line.

    python3 -m cellbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with a CUDA card.  ``--trace 0``
reports the cell's end-to-end metrics; ``--trace 1`` its per-layer ones,
from counters over the window and from a profiled slice after it.  Every
run compares what its solves returned with the plain reference
(``check.py``) and prints each number compared beside its limit, last on
standard error and under the result's last key, ``check``.  The last line
of standard output is the result, one JSON object.

Exit codes: 0 with a result (``correct`` may be false); 2 without one when
the machine has no CUDA card, or fewer than the cell asks for; 3 without
one when a module of the JAX package was loaded.
"""
import time

T_START = time.perf_counter()   # set-up is counted from the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

#: Top-level modules the process may not hold once the window has closed:
#: the JAX package and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_lbfgs")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is in ``FORBIDDEN``, the
    whole name compared (``tpu_lbfgs_torch`` is not ``tpu_lbfgs``)."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def power_limit_w():
    """The card's power limit in watts, as ``nvidia-smi`` reads it (None
    where it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(run, traced: bool, correct: bool, shown: dict,
                memory_peak: int) -> dict:
    """The result's JSON object; ``check`` comes last."""
    import torch

    from . import spec

    metrics = {}
    for m in run.cell.per_layer if traced else run.cell.end_to_end:
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu",
              "kind": torch.cuda.get_device_name(run.device),
              "count": 1, "memory_peak_bytes": memory_peak,
              "power_limit_w": power_limit_w()}
    line = {"correct": correct, "attempted": run.solves,
            "failed": run.failed, "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = run.slice.busy_s
        device["window_s"] = run.slice.window_s
        line["breakdown"] = {"device_ops": run.slice.top_ops(),
                             "idle_gaps": run.slice.top_gaps()}
    line["check"] = shown
    return line


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from . import check, spec, stats
    from .cell import Run

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"cellbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = Run(cell, args.seed, args.seconds, device, T_START)
    run.setup()
    run.window()
    if args.trace:
        run.traced_slice()
    memory_peak = run.memory()
    bad = forbidden_modules()
    if bad:
        print(f"cellbench: the process holds {bad}", file=sys.stderr)
        return 3
    run.compare()
    correct, shown = check.verdict(run.numbers, cell.limits)
    bad = forbidden_modules()
    if bad:
        print(f"cellbench: the process holds {bad}", file=sys.stderr)
        return 3
    line = result_line(run, bool(args.trace), correct, shown, memory_peak)
    walls = sorted(w * 1e3 for w in run.walls[:run.window_solves])
    print(f"cellbench: {len(walls)} solves in the window, ms: "
          f"p50 {stats.percentile(walls, 50)!r} p95 "
          f"{stats.percentile(walls, 95)!r} p99 {stats.percentile(walls, 99)!r}"
          f" max {walls[-1]!r}; set-up {run.setup_s!r} s ({run.setup_parts}"
          f" from the start), capture {run.capture_s!r} s", file=sys.stderr)
    rest = {n: v for n, v in run.numbers.items() if n not in shown}
    if rest:
        print(f"cellbench: read, not compared: {rest!r}", file=sys.stderr)
    for name, v in shown.items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
