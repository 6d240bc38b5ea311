"""Process bootstrap of the sharded solve (``tpu_lbfgs.dist.multihost``):
``torch.distributed`` takes the place of ``jax.distributed``.

Every process runs the same program on its shard (SPMD); ``initialize``
joins it to the group, from explicit arguments or from the environment a
launcher such as ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE``).  The reference's detection of a TPU pod from its
environment has no counterpart here.
"""
from __future__ import annotations

import datetime
import os
import sys
from typing import Optional

import torch
import torch.distributed as dist

#: Seconds after which a rank blocked in a collective gives up (a peer that
#: died must end the run, not hang it).
DEFAULT_TIMEOUT_S = 300.0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join this process to the group; calling it again is a no-op.

    With explicit arguments (``coordinator_address`` as "host:port", or
    as a ``torch.distributed`` init URL such as "file:///path", which
    ``dist.launch.spawn_ranks`` gives the ranks of one host) any failure
    is real (wrong address, port clash, a count that never fills) and
    propagates.  With none, the launcher's environment is used; on a
    plain single process, where it is not set, nothing is initialized and
    ``dist.make_mesh()`` is a mesh of one shard.

    ``backend``: "nccl" (one CUDA device per process) or "gloo" (CPU
    tensors, or several processes sharing one card); by default nccl where
    a CUDA device and nccl are present, else gloo."""
    if dist.is_initialized():
        return
    explicit = coordinator_address is not None or num_processes is not None
    if not explicit and "RANK" not in os.environ:
        return
    if backend is None:
        nccl = torch.cuda.is_available() and dist.is_nccl_available()
        backend = "nccl" if nccl else "gloo"
    kwargs = dict(backend=backend,
                  timeout=datetime.timedelta(seconds=timeout_s))
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError(
                "initialize: give coordinator_address, num_processes and "
                "process_id together, or none of them")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        kwargs.update(init_method=url,
                      world_size=num_processes, rank=process_id)
    # torch.distributed.nn.functional binds the default group as its
    # functions' default argument when it is imported, and DTensor's first
    # use imports it (through torch._dynamo): imported after the group
    # exists, it would keep the group alive past shutdown(), and its
    # backend's threads running into interpreter exit.  Imported first, it
    # binds None.
    import torch.distributed.nn.functional as _  # noqa: F401

    dist.init_process_group(**kwargs)


def shutdown() -> None:
    """Leave the group in step with the other ranks (a barrier, then the
    group is destroyed): a process that exits with the group still up can
    abort in the backend's threads.  What the port holds of the groups
    (``partitioned.release``: the DeviceMeshes of a caller's own
    objective) is let go first, so that destroying them ends them.  A
    no-op without a group."""
    if dist.is_initialized():
        dist.barrier()
        partitioned = sys.modules.get(__package__ + ".partitioned")
        if partitioned is not None:
            partitioned.release()
        dist.destroy_process_group()


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _host_order(group, host: Optional[str]) -> list:
    """The group's ranks in mesh order: the hosts in the order of their
    lowest rank, each host's ranks together in rank order.  ``host`` names
    this process's host (default ``socket.gethostname()``); every rank
    learns every rank's by one ``all_gather_object``."""
    import socket

    hosts = [None] * dist.get_world_size(group)
    dist.all_gather_object(hosts, host or socket.gethostname(), group=group)
    first = {}
    for h in hosts:
        first.setdefault(h, len(first))
    return sorted(range(len(hosts)), key=lambda r: (first[hosts[r]], r))


def global_mesh(group=None, host: Optional[str] = None):
    """The 1-D mesh over every process of the job (``group``, None for the
    default one) with the ranks of one host adjacent, so that a rank's two
    neighbours on the vector axis, whose edges it exchanges, are on its
    own host where they can be: the explicit-SPMD counterpart of the
    reference's ICI-aware device order
    (``tpu_lbfgs/dist/multihost.py:132``).  ``host`` overrides this
    process's host name.  A single process is a mesh of one shard."""
    from .mesh import Mesh, make_mesh

    if not dist.is_initialized():
        return Mesh(None)
    return make_mesh(group, _host_order(group, host))


def global_mesh_2d(batch_size: int, group=None, host: Optional[str] = None):
    """The 2-D ``(b, d)`` mesh over every process of the job, ranks of one
    host adjacent in row-major order, so that a row's d group stays on one
    host where it fits (``tpu_lbfgs/dist/multihost.py:149``).  Raises the
    reference's ``ValueError`` when the processes do not divide into
    ``batch_size`` rows."""
    from .mesh import make_mesh_2d

    if not dist.is_initialized():
        return make_mesh_2d(batch_size)
    n = dist.get_world_size(group)
    if batch_size < 1 or n % batch_size != 0:
        raise ValueError(f"{n} devices not divisible by batch axis "
                         f"{batch_size}")
    return make_mesh_2d(batch_size, group, _host_order(group, host))
