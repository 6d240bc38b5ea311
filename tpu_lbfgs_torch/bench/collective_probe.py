"""What one collective of the sharded solve costs on this machine: the
packed all-reduce and the edge exchange of ``dist.comm.ShardComm``, timed
among N ranks that share the current CUDA device over gloo (or run on the
CPU).

    python3 -m tpu_lbfgs_torch.bench.collective_probe [RANKS] [cpu]

Each rank times 200 all-reduces of a 27-element float64 vector (the fused
tail's 7 + 2 m sums at m = 10) and 200 edge exchanges of two vectors, after
20 of each unmeasured, with the host's clock fenced by
``torch.cuda.synchronize()``, and the parent prints rank 0's microseconds
per call with the card's name and power limit.  Several ranks on one card
say what the backend and the host cost, not what a link between cards
does.
"""
from __future__ import annotations

import subprocess
import sys
import time

import torch

from ..dist.launch import spawn_ranks

WARMUP, CALLS = 20, 200


def _rank(rank: int, size: int, device: str):
    from ..dist.mesh import make_mesh

    comm = make_mesh().comm
    dev = torch.device(device)
    sums = torch.full((27,), float(rank + 1), dtype=torch.float64, device=dev)
    x = torch.arange(1024, dtype=torch.float32, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = {}
    for name, call in (("all_reduce", lambda: comm.all_reduce_sum(sums)),
                       ("edge_pair", lambda: comm.edge_pair(x, x))):
        for _ in range(WARMUP):
            call()
        sync()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            call()
        sync()
        out[name] = (time.perf_counter() - t0) / CALLS * 1e6
    return out


def main(argv) -> int:
    ranks = int(argv[0]) if argv else 4
    on_cpu = "cpu" in argv[1:]
    if not on_cpu and not torch.cuda.is_available():
        print("collective_probe needs a CUDA device (or the argument cpu)",
              file=sys.stderr)
        return 1
    where = "the CPU"
    if not on_cpu:
        torch.zeros(1, device="cuda")
        where = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    outs = spawn_ranks(_rank, ranks, "cpu" if on_cpu else "cuda:0",
                       backend="gloo", threads=None)
    print(f"collective_probe: {ranks} ranks over gloo on {where}: all-reduce "
          f"of 27 float64 {outs[0]['all_reduce']:.1f} us, edge exchange of "
          f"two vectors {outs[0]['edge_pair']:.1f} us per call (rank 0; "
          f"{CALLS} calls after {WARMUP})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
