"""The collectives of the sharded solve: what ``lax.psum``, ``lax.ppermute``
and ``lax.axis_index`` give the reference's ``shard_map`` bodies, over one
``torch.distributed`` process group.

The sharded solve is explicit SPMD: one process per shard, each holding its
block of x, g and the (m, d_local) ring, with every scalar and the small
ring metadata replicated.  A reduction over d is a local partial followed by
one ``all_reduce_sum``; every rank receives the same bits, so the solver's
branches (all taken on replicated scalars) agree across ranks.

Sums cross the group in float64: a partial is the float64 sum of the
shard's terms, unrounded, the all-reduce adds the partials in float64, and
the caller rounds the total once to the working dtype.  That is the port's
rule for every sum (terms in the working dtype, added in float64, rounded
once), kept across shards.

The edge exchange is an all-reduce too: each rank writes its boundary
values into its own row of a zero ``(size, k)`` buffer and the sum fills in
the other rows (adding zeros is exact).  Point-to-point send / recv of CUDA
tensors is missing from the gloo backend, and an all-reduce is what every
backend has; with one card per rank under NCCL the same code runs
unchanged, since the backend is that of the group the caller hands in.

A solve without a comm (``comm=None`` everywhere in the solver) is not
sharded and runs none of this.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import Tensor


class ShardComm:
    """Rank, size and the two collectives of one d-axis group.  ``group`` is
    a ``torch.distributed`` process group, None for the default one.
    ``order``: the group's ranks in mesh order (default: the group's own);
    ``rank`` is this process's place in it, which the edge exchange and the
    gathers follow.

    ``all_reduces`` and ``edge_exchanges`` count the calls since the last
    ``reset_counts()``, so a run can state its communication per
    iteration."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None,
                 order: Optional[Sequence[int]] = None):
        if not dist.is_initialized():
            raise RuntimeError(
                "ShardComm needs an initialized torch.distributed process "
                "group (dist.multihost.initialize, or torchrun)")
        self.group = group
        self.size = dist.get_world_size(group)
        self.order = list(order) if order is not None \
            else list(range(self.size))
        self.rank = self.order.index(dist.get_rank(group))
        self.all_reduces = 0
        self.edge_exchanges = 0

    def reset_counts(self) -> None:
        self.all_reduces = 0
        self.edge_exchanges = 0

    def all_reduce_sum(self, t: Tensor) -> Tensor:
        """The sum of ``t`` over the group, in place and returned; one
        packed tensor per call, float64 for sums."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        self.all_reduces += 1
        return t

    def reduce_parts(self, parts: Sequence[Tensor], dtype) -> list[Tensor]:
        """One all-reduce for several float64 partials of any shapes: they
        are packed into one vector, summed over the group and handed back in
        their shapes, each rounded once to ``dtype``."""
        flat = torch.cat([p.reshape(-1).double() for p in parts])
        self.all_reduce_sum(flat)
        out = flat.to(dtype).split([p.numel() for p in parts])
        return [o.reshape(p.shape) for o, p in zip(out, parts)]

    def any_flag(self, flag: Tensor) -> Tensor:
        """Whether a bool flag (any shape) holds on any rank."""
        return self.all_reduce_sum(flag.double()) > 0

    def edge_pair(self, *vs: Tensor):
        """For each local block v: (the previous shard's last element, the
        next shard's first), on v's device, all blocks in one exchange.  A
        (d_local,) vector gives 0-d tensors; (B, d_local) rows give each
        lane's own, (B,) tensors, so a batch exchanges 2 k B values in the
        same one collective.  The values wrap around at the two ends of the
        global vector; the kernels' and chunks' index masks discard them
        there."""
        v0 = vs[0]
        k = len(vs)
        buf = torch.zeros((self.size, 2 * k) + tuple(v0.shape[:-1]),
                          dtype=v0.dtype, device=v0.device)
        buf[self.rank] = torch.stack([v[..., 0] for v in vs]
                                     + [v[..., -1] for v in vs])
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        self.edge_exchanges += 1
        firsts = buf[(self.rank + 1) % self.size, :k]
        lasts = buf[(self.rank - 1) % self.size, k:]
        return [(lasts[i], firsts[i]) for i in range(k)]

    def all_gather_vec(self, v: Tensor) -> Tensor:
        """The global vector from every rank's equal-length local block, on
        every rank (an all-reduce of a zero buffer, as ``edge_pair``): for
        results and tests, not for the iteration."""
        buf = torch.zeros((self.size,) + tuple(v.shape), dtype=v.dtype,
                          device=v.device)
        buf[self.rank] = v
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return buf.reshape((-1,) + tuple(v.shape[1:]))
