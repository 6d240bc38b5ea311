"""The giant-instance cell: one (d, configuration) per call, printed as one
JSON line (``tpu_lbfgs.bench.giant``).

    python -m tpu_lbfgs_torch.bench.giant --d 67108864 --with-matvec
    python -m tpu_lbfgs_torch.bench.giant --d 100000000 --donate --profile

At d = 2^26 an iteration's device work (~14 GB of traffic on the model at
m = 10) outweighs the host's ~290 launches, so this is the first cell
where the card's memory, not the Python loop, should set the rate.  The
line carries:

- ``iters_per_s``, ``wall_s`` (best of ``--repeats`` timed runs of
  ``--iters`` iterations, each replaying blocks of iterations captured as
  CUDA graphs in the warm-up run and reading the loop's flags once per
  block, as every solve does), ``ms_per_iter``, ``repeat_walls_s``,
  ``final_f``, and the block runner's ``capture_s`` (the warm-up's
  captures) and ``host_reads_per_solve`` (``bench.harness.
  _blocks_details``);
- ``device_us_per_iter``: CUDA events around ``--iters`` more iterations
  as replayed blocks of the same solve that read nothing back, queued
  behind a sleep kernel, so that the events time the card's work and not
  the host's (when the host cannot keep ahead of the card, they time the
  host; ``host_ahead`` says which); ``host_share``: 1 - device / wall time
  per iteration, the share of an iteration in which the card waits for
  what is left of the host, the block's replay and its read (null when the
  host did not keep ahead: the events then timed the host);
- ``roofline``: the model's passes and GB per iteration
  (``utils.roofline.traffic_model``, with the port's products in the
  tail under ``--with-matvec``), the rate the timed runs reached on it and
  its share of one H100's 3350 GB/s.  A share above 1.0 means the model
  counts wrong, and is printed as it is;
- under ``--profile``, ``profile``: where the device time of an iteration
  goes, from one more replayed block under ``torch.profiler`` (each
  kernel's device us and launches per iteration, largest first, and their
  sums).

The plain path is ``bench.harness.bench_gpu``'s protocol
(``fixed_iterations``, on the device asked for); ``--donate``
drives the solve as ``make_solve_segment`` segments of ``--iters``
iterations from one state (a warm-up segment, then ``--repeats`` timed
ones), which has no buffer donation to ask for in the port: the ring is
updated in place either way.  One state is alive at a time.  The run is on
the card unless ``--device cpu`` asks for the CPU (the tests).
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..config import LBFGSConfig
from ..core import blocks
from ..core.solver import _stepper, init_state, make_solve_segment
from ..problems.suite import get_problem
from ..types import resolve_device
from ..utils.roofline import HBM_BW_GBPS, traffic_model
from .harness import (
    _device_name,
    _since,
    _timed,
    _x0,
    fixed_iterations,
    solve_callables,
)

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpu_lbfgs_torch.bench.giant")
    ap.add_argument("--d", type=int, default=1 << 26)
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--problem", default="rosenbrock")
    ap.add_argument("--history-dtype", default=None,
                    help="e.g. bfloat16; default the iterate's, float32")
    ap.add_argument("--with-matvec", action="store_true",
                    help="compute the history products inside the fused "
                         "tail kernel instead of as two matrix-vector "
                         "products")
    ap.add_argument("--direction", default="compact_incremental")
    ap.add_argument("--no-pallas", action="store_true")
    ap.add_argument("--donate", action="store_true",
                    help="drive the solve as make_solve_segment segments "
                         "from one state instead of one solve per run")
    ap.add_argument("--profile", action="store_true",
                    help="add the device time per iteration of each "
                         "kernel, from torch.profiler (the card only)")
    ap.add_argument("--device", default=None,
                    help="cpu for a run on the CPU; default the current "
                         "CUDA device")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.profile and device.type != "cuda":
        ap.error("--profile times the card's kernels: it needs the card")
    cfg = LBFGSConfig(
        line_search="backtracking", direction=args.direction, m=args.m,
        use_pallas=not args.no_pallas, ls_eval="polynomial",
        history_dtype=args.history_dtype)

    if args.donate:
        r = _bench_donated(args, cfg, device)
    else:
        br = fixed_iterations(args.problem, args.d, args.iters, cfg,
                              torch.float32, (42,), args.repeats,
                              args.with_matvec, device)
        r = {"iters_per_s": br.iters_per_s, "wall_s": br.wall_s,
             "final_f": br.final_f, "warmup_s": br.details["warmup_s"],
             "repeat_walls_s": br.details["repeat_walls_s"],
             "capture_s": br.details["capture_s"],
             "host_reads_per_solve": br.details["host_reads_per_solve"]}
        if device.type == "cuda":
            torch.cuda.empty_cache()
            r.update(_device_time(args, cfg, device, _x0_giant(args, device)))

    ms_per_iter = 1e3 / r["iters_per_s"]
    if "device_us_per_iter" in r:
        r["host_share"] = host_share(r, ms_per_iter)
    tm = traffic_model(cfg, args.d, with_matvec=args.with_matvec)
    achieved_gbps = tm.bytes_per_iter * r["iters_per_s"] / 1e9
    roof = {
        "modeled_passes_per_iter": tm.passes_total,
        "modeled_gb_per_iter": tm.bytes_per_iter / 1e9,
        "achieved_gbps_on_model": achieved_gbps,
        "frac_of_h100_spec": achieved_gbps / HBM_BW_GBPS["h100"],
    }
    print(json.dumps({
        "d": args.d, "m": args.m, "iters": args.iters,
        "problem": args.problem,
        "history_dtype": args.history_dtype or "float32",
        "with_matvec": args.with_matvec,
        "direction": args.direction,
        "use_pallas": not args.no_pallas,
        "donated_segments": args.donate,
        "device": _device_name(device),
        "ms_per_iter": ms_per_iter,
        **r,
        "roofline": roof,
    }), flush=True)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return 0


def host_share(timing: dict, ms_per_iter: float):
    """The share of an iteration's wall the card spent waiting on the host,
    1 - device time / wall, from ``_device_time``'s timing; None when the
    host never got ahead of the card, since the events then timed the
    host's launches and not the card's work."""
    if not timing["host_ahead"]:
        return None
    return 1.0 - timing["device_us_per_iter"] / (ms_per_iter * 1e3)


def _x0_giant(args, device) -> torch.Tensor:
    """The harness's start, U(-2, 2) from seed 42 in float64, rounded to
    float32 (``bench.harness._x0``)."""
    return _x0(args.d, 42, torch.float32, device)


def _callables(args, cfg):
    p = get_problem(args.problem)
    vg, dir_poly, tail, _, _ = solve_callables(
        args.problem, args.d, cfg, torch.float32,
        with_matvec=args.with_matvec)
    return p, vg, dir_poly, tail


def _device_time(args, cfg, device, x0=None, state=None) -> dict:
    """Device us per iteration: about ``--iters`` iterations of the solve,
    as blocks of ``blocks.BLOCK_ITERS`` replayed by a block runner of the
    while form (``solve_from_state``'s), which read nothing back, between
    two CUDA events, queued behind a sleep kernel of ~0.1 s; the runner
    captures its graph in one block before.  ``host_ahead``: whether the
    card was still behind the host when the last block was queued (the
    events then time the card's work)."""
    p, vg, dir_poly, tail = _callables(args, cfg)
    if state is None:
        state = init_state(vg, x0, cfg.m, cfg.history_dtype)
    run_cfg = cfg.replace(max_iters=1 << 30, tol=0.0)
    drv = blocks.BlockRunner(run_cfg, _stepper(run_cfg, p.f, vg, dir_poly,
                                                tail), state, masked=True)
    drv.start(None)
    n = blocks.BLOCK_ITERS
    n_blocks = max(1, args.iters // n)
    drv.run(n)
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(n_blocks):
        drv.run(n)
    end.record()
    host_ahead = not end.query()
    end.synchronize()
    out = {"device_us_per_iter":
           start.elapsed_time(end) * 1e3 / (n_blocks * n),
           "host_ahead": host_ahead}
    if args.profile:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            drv.run(n)
            torch.cuda.synchronize(device)
        out["profile"] = _by_kernel(prof, n)
    out["device_f"] = float(drv.s.f)
    return out


def _by_kernel(prof, iters: int) -> dict:
    """Each kernel's device us and launches per iteration of a profiled
    run of ``iters`` iterations, largest first, and their sums."""
    from torch.autograd import DeviceType

    kernels = sorted(
        ((e.key, e.self_device_time_total / iters,
          e.count / iters) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total),
        key=lambda r: -r[1])
    return {"iters": iters,
            "device_us_per_iter": sum(us for _, us, _ in kernels),
            "kernels_per_iter": sum(n for _, _, n in kernels),
            "by_kernel": [{"name": name[:120], "us_per_iter": us,
                           "launches_per_iter": n}
                          for name, us, n in kernels]}


def _bench_donated(args, cfg, device):
    """The solve as segments from one state: the path for a state that
    cannot be held twice.  A warm-up segment, then ``--repeats`` timed
    ones, each fenced by a synchronize; on the card, one more run of
    ``--iters`` iterations for ``_device_time``."""
    p, vg, dir_poly, tail = _callables(args, cfg)
    cfg = cfg.replace(max_iters=args.iters * (args.repeats + 1), tol=0.0)
    seg = make_solve_segment(cfg, p.f, value_and_grad=vg, iters=args.iters,
                             dir_poly=dir_poly, fused_tail=tail, donate=True)
    before = dict(blocks.stats)
    state, warmup_s = _timed(
        lambda x0: seg(init_state(vg, x0, cfg.m, cfg.history_dtype)),
        _x0_giant(args, device), device)
    capture_s = _since(before)["capture_s"]
    walls = []
    before = dict(blocks.stats)
    for _ in range(args.repeats):
        state, wall = _timed(seg, state, device)
        walls.append(wall)
    best = min(walls)
    out = {"iters_per_s": args.iters / best, "wall_s": best,
           "final_f": float(state.f), "warmup_s": warmup_s,
           "repeat_walls_s": walls, "capture_s": capture_s,
           "host_reads_per_solve":
           _since(before)["host_reads"] / args.repeats}
    if device.type == "cuda":
        out.update(_device_time(args, cfg, device, state=state))
    return out


if __name__ == "__main__":
    sys.exit(main())
