"""The d-axis mesh of the sharded solve (``tpu_lbfgs.dist.mesh``).

The reference's mesh is a grid of devices under one controller.  The port
is one process per shard, so its mesh is the description of this process's
place in the d-axis group: the group's size, this rank, and the rank's
``[start, stop)`` in the zero-padded global vector.  x, g and the ring are
split in equal contiguous blocks; every scalar and the (m,) / (m, m) ring
metadata are replicated (the reference's ``state_shardings``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import Tensor

from .comm import ShardComm


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the d axis.  ``comm`` is None for a mesh of
    one shard, which communicates nothing."""

    comm: Optional[ShardComm]
    size: int = 1
    rank: int = 0

    def bounds(self, d_pad: int) -> tuple[int, int]:
        """This rank's ``[start, stop)`` in a padded vector of ``d_pad``
        elements (a multiple of ``size``)."""
        d_local = d_pad // self.size
        return self.rank * d_local, (self.rank + 1) * d_local


def make_mesh(group=None) -> Mesh:
    """The 1-D mesh over ``group`` (a ``torch.distributed`` process group,
    None for the default one).  Where ``torch.distributed`` is not
    initialized the mesh has one shard: a single process is the whole
    vector."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(None)
    comm = ShardComm(group)
    if comm.size == 1:
        return Mesh(None)
    return Mesh(comm, comm.size, comm.rank)


def shard_alignment(n_shards: int) -> int:
    """The multiple the global d is padded to.  The reference pads to
    128 * 8 * n_shards so that every shard is whole (8, 128) tiles; the
    CUDA kernels mask by index and take any length, so the port pads to a
    multiple of the shard count only."""
    return n_shards


def pad_for_mesh(x0: Tensor, n_shards: int) -> tuple[Tensor, int]:
    """(x0 zero-padded to a multiple of the shard count, the unpadded d):
    the reference's ``_pad_for_mesh``.  The shard-local objectives own
    their terms by global index and give the padded coordinates zero
    gradient, so they never move, every reduction sees zeros there, and the
    padded solve equals the unpadded one step for step."""
    d = x0.shape[-1]
    pad = (-d) % shard_alignment(n_shards)
    if not pad:
        return x0, d
    return torch.nn.functional.pad(x0, (0, pad)), d


def local_block(x_global: Tensor, mesh: Mesh) -> Tensor:
    """This rank's block of a (padded) global vector, contiguous and its
    own storage."""
    start, stop = mesh.bounds(x_global.shape[-1])
    return x_global[..., start:stop].clone(
        memory_format=torch.contiguous_format)
