"""The meshes of the sharded solve (``tpu_lbfgs.dist.mesh``).

The reference's mesh is a grid of devices under one controller.  The port
is one process per mesh point, so its mesh is the description of this
process's place: its d-axis group (the group's size, this rank in it, and
the rank's ``[start, stop)`` in the zero-padded global vector) and, on a
2-D ``(b, d)`` mesh (``make_mesh_2d``), its row on the instance axis.  x,
g and the ring are split in equal contiguous blocks on d; every scalar and
the (m,) / (m, m) ring metadata are replicated over the d group (the
reference's ``state_shardings``); a batch's lanes are split in equal
contiguous runs over b.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import Tensor

from .comm import ShardComm


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the mesh: ``size`` ranks on the d axis, this
    one ``rank`` among them, over ``comm``, None for a d axis of one shard,
    which communicates nothing; on a 2-D mesh ``batch_size`` rows on the
    instance axis, this one ``batch_rank``, and ``grid`` the comm of the
    whole mesh, which only assembles results (``sharded.gather_result``).
    A 1-D mesh is one row, its ``grid`` its ``comm``."""

    comm: Optional[ShardComm]
    size: int = 1
    rank: int = 0
    batch_size: int = 1
    batch_rank: int = 0
    grid: Optional[ShardComm] = None

    def __post_init__(self):
        if self.grid is None and self.batch_size == 1:
            object.__setattr__(self, "grid", self.comm)

    def bounds(self, d_pad: int) -> tuple[int, int]:
        """This rank's ``[start, stop)`` in a padded vector of ``d_pad``
        elements (a multiple of ``size``)."""
        d_local = d_pad // self.size
        return self.rank * d_local, (self.rank + 1) * d_local


def make_mesh(group=None, order=None) -> Mesh:
    """The 1-D mesh over ``group`` (a ``torch.distributed`` process group,
    None for the default one), its ranks in ``order`` (the group's ranks in
    mesh order; default the group's own, ``multihost.global_mesh`` gives
    another).  Where ``torch.distributed`` is not initialized the mesh has
    one shard: a single process is the whole vector."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(None)
    comm = ShardComm(group, order)
    if comm.size == 1:
        return Mesh(None)
    return Mesh(comm, comm.size, comm.rank)


def make_mesh_2d(batch_size: int, group=None, order=None) -> Mesh:
    """The 2-D ``(b, d)`` mesh over ``group`` (None for the default one):
    ``batch_size`` rows on the instance axis, the rest of the ranks on the
    vector axis, laid out row-major as the reference's
    ``reshape(batch_size, n // batch_size)``: the rank at place r of
    ``order`` (default the group's own order) sits at (r // n_d, r % n_d).
    Every rank creates every row's d group, in the same order, as
    ``torch.distributed.new_group`` requires; a row of one rank has no d
    comm.  Raises ``ValueError`` when the ranks do not divide into
    ``batch_size`` rows.  Where ``torch.distributed`` is not initialized
    the mesh is the one process, and only ``batch_size=1`` divides it."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        n = 1
    else:
        n = dist.get_world_size(group)
    if batch_size < 1 or n % batch_size != 0:
        raise ValueError(f"{n} devices not divisible by batch axis "
                         f"{batch_size}")
    n_d = n // batch_size
    if n == 1:
        return Mesh(None)
    grid = ShardComm(group, order)
    row, col = divmod(grid.rank, n_d)
    comm = None
    if n_d > 1:
        def global_rank(r):
            return r if group is None else dist.get_global_rank(group, r)

        for r in range(batch_size):
            members = [global_rank(q)
                       for q in grid.order[r * n_d:(r + 1) * n_d]]
            row_group = dist.new_group(members)
            if r == row:
                # A new group orders its ranks by global rank; the row's
                # mesh order is the members' order.
                ranks = sorted(members)
                comm = ShardComm(row_group, [ranks.index(g) for g in members])
    return Mesh(comm, n_d, col, batch_size, row, grid)


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


def local_lanes(x_batch: Tensor, mesh: Mesh) -> Tensor:
    """This rank's row's lanes of a (B, ...) batch: the ``batch_rank``-th of
    ``batch_size`` equal contiguous runs (B a multiple of ``batch_size``)."""
    b_local = x_batch.shape[0] // mesh.batch_size
    return x_batch[mesh.batch_rank * b_local:(mesh.batch_rank + 1) * b_local]
