"""The benchmark sweep on the card: python -m tpu_lbfgs_torch.bench
[--quick | --reference-protocol] [--out FILE]
(``tpu_lbfgs.bench.__main__``).

The reference's 8 fixed-iteration configurations (directions, line
searches, history dtypes, m) through ``harness.bench_gpu``, then its batch
row through ``harness.bench_batch``, written to one JSON report with each
row's it/s and every timed run's wall (``repeat_walls_s``: the host's speed
differs between calls, so the best alone hides the spread).  ``--quick``
runs the reference's 3 quick configurations.  ``--reference-protocol``
runs ``reference_protocol.run_protocol`` instead.  A configuration that
fails or overruns ``--per-config-timeout`` is recorded in its row and the
sweep goes on.

``--scaling`` runs ``scaling.scaling_sweep`` (strong scaling over 1, 2,
4, ... ranks, up to the cards present) and writes
``torch_scaling_results.json``; where ranks share a card the record says
it is no scaling number.  Not ported: the reference's cpu-native row (the
C++ oracle belongs to ``tpu_lbfgs``; the sweep prints a line saying so).
"""
from __future__ import annotations

import argparse
import json
import signal
import sys
import time


class _Timeout(Exception):
    pass


def _alarm(_s, _f):
    raise _Timeout()


def _configs(quick: bool):
    from ..config import LBFGSConfig

    base = LBFGSConfig(line_search="backtracking", m=10)
    configs = [
        ("two_loop/direct", base.replace(direction="two_loop")),
        ("compact/direct", base.replace(direction="compact")),
        ("compact/poly+pallas", base.replace(
            direction="compact", ls_eval="polynomial", use_pallas=True)),
        ("incr/poly+pallas", base.replace(
            direction="compact_incremental", ls_eval="polynomial",
            use_pallas=True)),
        ("incr/poly+pallas/bf16", base.replace(
            direction="compact_incremental", ls_eval="polynomial",
            use_pallas=True, history_dtype="bfloat16")),
        ("incr/poly+pallas/m=20", base.replace(
            direction="compact_incremental", ls_eval="polynomial",
            use_pallas=True, m=20)),
        ("wolfe/poly", base.replace(
            direction="compact_incremental", ls_eval="polynomial",
            line_search="wolfe_interpolation", c2=0.9, use_pallas=True)),
        ("spec-ls/direct+pallas/bf16", base.replace(
            direction="compact_incremental",
            line_search="backtracking_speculative",
            use_pallas=True, history_dtype="bfloat16")),
    ]
    return [configs[1], configs[4], configs[7]] if quick else configs


def _timed_row(name, timeout_s, fn):
    """fn() -> row fields, under an alarm; a failure is recorded in the
    row."""
    signal.alarm(timeout_s)
    try:
        return {"config": name, **fn()}
    except _Timeout:
        return {"config": name, "error": "timeout"}
    except Exception as e:  # noqa: BLE001 - record and continue
        return {"config": name, "error": f"{type(e).__name__}: {e}"}
    finally:
        signal.alarm(0)


def _print_row(row, rate, unit):
    if "error" in row:
        print(f"{row['config']:28s} ERROR {row['error']}", flush=True)
    else:
        print(f"{row['config']:28s} {row[rate]:12,.1f} {unit}, runs "
              f"{row['repeat_walls_s']}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpu_lbfgs_torch.bench")
    ap.add_argument("--out", default=None,
                    help="report file (default torch_bench_results.json, or "
                         "torch_reference_protocol_results.json)")
    ap.add_argument("--d", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--per-config-timeout", type=int, default=300)
    ap.add_argument("--quick", action="store_true",
                    help="3 key configurations only (with "
                         "--reference-protocol: the first d, 2 seeds)")
    ap.add_argument("--reference-protocol", action="store_true",
                    help="run the reference's published experiment instead: "
                         "5 seeds x 4 strategies x d in {1e4, 2e4, 1e5, "
                         "2^20}, x0 ~ U(-1000, 1000), to convergence")
    ap.add_argument("--problem", default="rosenbrock")
    ap.add_argument("--cuda-budget", type=float, default=600.0,
                    help="per-cell seed-loop wall budget (s)")
    ap.add_argument("--cell-timeout", type=int, default=900,
                    help="hard limit per cell (s)")
    ap.add_argument("--cuda-f64", action="store_true",
                    help="include the float64 sequential-configuration cells")
    ap.add_argument("--dims", type=int, nargs="+", default=None,
                    help="protocol dimensions (default the reference's 4)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="protocol cells run at a time, each its own process "
                         "on the one card; above 1 the cells' walls include "
                         "the sharing and the report keeps no rate")
    ap.add_argument("--scaling", action="store_true",
                    help="strong scaling of the sharded solve over 1, 2, "
                         "4, ... ranks, a card each (bench.scaling)")
    args = ap.parse_args(argv)

    if args.scaling:
        from ..types import resolve_device
        from .scaling import SHARED_NOTE, scaling_sweep

        resolve_device(None)                # the card, or RuntimeError
        rows = scaling_sweep(d=args.d, iters=min(args.iters, 50))
        for r in rows:
            print(f"n={r['n_devices']:3d}  {r['iters_per_s']:9.1f} it/s  "
                  f"speedup {r['speedup']:.2f}  eff {r['efficiency']:.2f}  "
                  f"{r['stack']}, {r['backend']}")
        record = {"device": rows[0].get("device_name"), "d": args.d,
                  "rows": rows}
        if not rows[-1]["scaling"]:
            record["evidence"] = SHARED_NOTE
        out = args.out or "torch_scaling_results.json"
        with open(out, "w") as fh:
            json.dump(record, fh, indent=1)
        print(f"wrote {out}")
        return 0

    if args.reference_protocol:
        from .reference_protocol import DIMS, run_protocol

        run_protocol(problem=args.problem, dims=tuple(args.dims or DIMS),
                     cuda_budget_s=args.cuda_budget,
                     cell_timeout_s=args.cell_timeout,
                     out=args.out or "torch_reference_protocol_results.json",
                     quick=args.quick, cuda_f64=args.cuda_f64,
                     jobs=args.jobs)
        return 0

    from .harness import _cuda_device, _device_name, bench_batch, bench_gpu

    card = _device_name(_cuda_device("tpu_lbfgs_torch.bench"))
    signal.signal(signal.SIGALRM, _alarm)
    rows = []
    for name, cfg in _configs(args.quick):
        def one(cfg=cfg):
            t0 = time.time()
            r = bench_gpu(d=args.d, iters=args.iters, cfg=cfg, repeats=2)
            return {"iters_per_s": r.iters_per_s, "wall_s": r.wall_s,
                    "repeat_walls_s": r.details["repeat_walls_s"],
                    "final_f": r.final_f,
                    "setup_s": time.time() - t0 - sum(
                        r.details["repeat_walls_s"])}
        rows.append(_timed_row(name, args.per_config_timeout, one))
        _print_row(rows[-1], "iters_per_s", "it/s")

    def batch():
        rb = bench_batch(batch=4096, d=1024, iters=200)
        return {"instance_iters_per_s": rb.iters_per_s, "wall_s": rb.wall_s,
                "repeat_walls_s": rb.details["repeat_walls_s"]}
    rows.append(_timed_row("batch-4096xd1024", args.per_config_timeout, batch))
    _print_row(rows[-1], "instance_iters_per_s", "inst-it/s")
    print(f"{'cpu-native-baseline':28s} not ported: the C++ oracle belongs "
          "to tpu_lbfgs", flush=True)

    out = args.out or "torch_bench_results.json"
    with open(out, "w") as fh:
        json.dump({"d": args.d, "iters": args.iters,
                   "device": card,
                   "rows": rows}, fh, indent=1)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
