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

    With explicit arguments (``coordinator_address`` as "host:port") any
    failure is real (wrong address, port clash, a count that never fills)
    and propagates.  With none, the launcher's environment is used; on a
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
        kwargs.update(init_method=f"tcp://{coordinator_address}",
                      world_size=num_processes, rank=process_id)
    dist.init_process_group(**kwargs)


def shutdown() -> None:
    """Leave the group in step with the other ranks (a barrier, then the
    group is destroyed): a process that exits with the group still up can
    abort in the backend's threads.  A no-op without a group."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1
