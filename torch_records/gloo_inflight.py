"""Which layer of PyTorch's CPU collectives corrupts the heap: four gloo
ranks as two pairs, each rank all-gathering small float64 blocks (2 x
129-131, the shapes of the own-objective job's bounded batch cases) over
its pair, ``--rounds`` rounds of ``--inflight`` all-gathers, through one
of these routes:

- ``native``: PyTorch's native functional collective
  (``_functional_collectives.all_gather_tensor``, what DTensor calls), all
  ``--inflight`` asked for before any is read;
- ``native-waited``: the same, each waited before the next is asked for
  (what DTensor's own redistributions do);
- ``c10d``: ``torch.distributed.all_gather_into_tensor``, one at a time
  (what ``dist/partitioned.py::_c10d_api_collectives`` registers);
- ``gloo``: ``ProcessGroupGloo._allgather_base`` on a pair group built by
  hand with ``--threads`` worker threads, all ``--inflight`` in flight
  before any is waited for (``--drop-inputs``: the inputs let go of at
  once).

    python torch_records/gloo_inflight.py --route native --spawns 4 \\
        [--rounds 3000] [--inflight 8] [--threads 2] [--drop-inputs]

Each spawn prints one JSON line (``ok``, or the dead rank's signal from
``dist.launch.spawn_ranks``, and the lines of glibc's heap checks from the
ranks' output); a last line sums them.  Run from the checkout whose
``tpu_lbfgs_torch`` starts the ranks.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import time

COLS = 131


def _pair_group(rank: int, threads: int):
    import torch.distributed as dist
    from torch._C._distributed_c10d import PrefixStore, ProcessGroupGloo

    opts = ProcessGroupGloo._Options()
    opts._devices = [ProcessGroupGloo.create_default_device()]
    opts._threads = threads
    opts._timeout = datetime.timedelta(seconds=60)
    store = PrefixStore(f"pair{rank // 2}",
                        dist.distributed_c10d._get_default_store())
    return ProcessGroupGloo(store, rank % 2, 2, opts)


def gather_rank(rank: int, size: int, route: str, rounds: int,
                inflight: int, threads: int, drop_inputs: bool) -> float:
    """One rank: ``rounds`` rounds of ``inflight`` all-gathers over its
    pair by ``route``; returns its seconds."""
    import warnings

    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    warnings.simplefilter("ignore")
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    group = pairs[rank // 2]
    hand_built = _pair_group(rank, threads) if route == "gloo" else None
    x = torch.arange(2 * COLS, dtype=torch.float64).reshape(2, COLS) + rank
    t0 = time.time()
    for _ in range(rounds):
        blocks = [x[:, :COLS - k % 3].contiguous() for k in range(inflight)]
        if route == "native":
            outs = [funcol.all_gather_tensor(b, 0, group) for b in blocks]
        elif route == "native-waited":
            outs = [funcol.all_gather_tensor(b, 0, group).wait()
                    for b in blocks]
        else:
            outs = [b.new_empty((2 * b.shape[0], b.shape[1]))
                    for b in blocks]
            if route == "c10d":
                for o, b in zip(outs, blocks):
                    dist.all_gather_into_tensor(o, b, group=group)
            else:
                works = [hand_built._allgather_base(o, b)
                         for o, b in zip(outs, blocks)]
                if drop_inputs:
                    del blocks
                for w in works:
                    w.wait()
        float(sum(o.sum() for o in outs))
    del hand_built
    return time.time() - t0


def one_spawn(args) -> dict:
    sys.path.insert(0, os.getcwd())
    from tpu_lbfgs_torch.dist.launch import spawn_ranks

    t0 = time.time()
    try:
        spawn_ranks(gather_rank, 4, args.route, args.rounds, args.inflight,
                    args.threads, args.drop_inputs, backend="gloo",
                    timeout_s=120.0, threads=1)
        return dict(ok=True, seconds=round(time.time() - t0, 1))
    except RuntimeError as e:
        return dict(ok=False, error=str(e).splitlines()[0],
                    seconds=round(time.time() - t0, 1))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--route", required=True,
                    choices=("native", "native-waited", "c10d", "gloo"))
    ap.add_argument("--spawns", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=3000)
    ap.add_argument("--inflight", type=int, default=8)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--drop-inputs", action="store_true")
    ap.add_argument("--one-spawn", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one_spawn:
        print(json.dumps(one_spawn(args)), flush=True)
        return {}
    rows = []
    for _ in range(args.spawns):
        # Each spawn in a process of its own: an aborting rank takes only
        # its own job down.
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one-spawn",
             *(argv if argv is not None else sys.argv[1:])],
            capture_output=True, text=True)
        lines = done.stdout.strip().splitlines()
        row = json.loads(lines[-1]) if lines else dict(ok=False, error="")
        row["heap_messages"] = [line for line in done.stderr.splitlines()
                                if "malloc" in line or "chunk" in line
                                or "corrupted" in line]
        print(json.dumps(row), flush=True)
        rows.append(row)
    summary = dict(route=args.route, inflight=args.inflight,
                   threads=args.threads, drop_inputs=args.drop_inputs,
                   rounds=args.rounds, spawns=args.spawns,
                   dead=sum(not r["ok"] for r in rows))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
