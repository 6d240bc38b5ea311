"""The control of a cell's comparison: the plain reference put in the
program's place, computed in bfloat16, the precision below the float32
that the configurations state.  It has to come out as not correct.

    python3 -m cellbench.control --workload <cell> --seeds 11 12 13

prints, for each seed, the numbers that ``check`` compares, read from the
control's solves of the starts a run with that seed samples, beside the
cell's limits, and every number it read.  The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import math
import random
import sys

import torch

from . import check, spec
from .cell import NUMBERS, draw_pool
from .reference import lbfgs as reference

LOWER = torch.bfloat16


def numbers(cell, seed: int, device) -> dict:
    """The numbers ``check`` compares, of the control's solves of the
    starts that a run of ``cell`` with ``seed`` samples."""
    conf, traffic = cell.config, cell.traffic
    settings, budget = cell.settings(), traffic["iters"]
    dtype = getattr(torch, conf["dtype"])
    shape = ((conf["batch"],) if conf["batch"] else ()) + (conf["d"],)
    pool = draw_pool(seed, traffic["pool"] + 1, shape, traffic["box"], dtype,
                     device)
    sample = random.Random(seed).sample(range(traffic["check_from"]),
                                        traffic["check_solves"])
    starts = [pool[i % (len(pool) - 1)].clone() for i in sorted(sample)]
    del pool
    per = {n: [] for n in NUMBERS}
    short, gaps = 0, []
    turns = []
    for x0 in starts:
        res = reference.solve(x0, settings, budget, LOWER)
        got = check.end_state(res, settings, budget)
        for name in per:
            per[name].append(got[name])
        short += int(got["short"].sum())
        if conf["batch"]:
            ref = reference.solve(x0, settings, budget, torch.float64)
            gaps.append(check.f_gap_median(res["f"], ref["f"]))
            continue
        n = traffic["start_iters"]
        low = reference.solve(x0, settings, n, LOWER)
        ref = reference.solve(x0, settings, n, dtype)
        gaps.append(check.x_gap(low["x"], ref["x"]))
        # One more step from the control's final state, as a run takes it;
        # where its search failed before the budget, its last step taken.
        steps = int(res["k"]) - int(res["failed"])
        prev, cur = (res, reference.solve(x0, settings, budget + 1, LOWER)) \
            if steps == budget else (
                reference.solve(x0, settings, steps - 1, LOWER),
                reference.solve(x0, settings, steps, LOWER))
        if int(cur["k"]) == int(prev["k"]) + 1 \
                and int(cur["n_pairs"]) == int(prev["n_pairs"]) + 1:
            d = cur["s_rows"][-1].double() / cur["alpha"].double()
            turns.append(check.direction_gap(d, prev, settings))
    out = {n: check.largest(v) for n, v in per.items()}
    out["short"] = float(short)
    out["f_gap_median" if conf["batch"] else "start_gap"] = \
        max(gaps) if gaps else math.nan
    if not conf["batch"]:
        out["direction_gap"] = max(turns) if turns else math.nan
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    for seed in args.seeds:
        got = numbers(cell, seed, device)
        correct, shown = check.verdict(got, cell.limits)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": correct, "check": shown,
                          "read": got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
