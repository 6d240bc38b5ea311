"""The sharded solves: one process per shard of the vector axis, and on a
2-D mesh per (instance row, shard), over ``torch.distributed``
(``tpu_lbfgs.dist``)."""
from .comm import ShardComm
from .mesh import Mesh, make_mesh, make_mesh_2d, pad_for_mesh, shard_alignment
from .multihost import (
    global_mesh,
    global_mesh_2d,
    initialize,
    is_coordinator,
    process_count,
    shutdown,
)
from .pallas_sharded import (
    SHARDED_PALLAS_PROBLEMS,
    shardmap_fused_tail,
    shardmap_fused_vg,
    shardmap_multi_phi,
    shardmap_multi_phi_dphi,
)
from .sharded import (
    gather_result,
    shard_objective,
    sharded_minimize,
    sharded_vmap_minimize,
    solve_shard,
    solve_shard_from_state,
)
from .shardmap_vg import (
    shardmap_dir_poly,
    shardmap_value,
    shardmap_value_and_grad,
)

__all__ = [
    "Mesh", "ShardComm", "SHARDED_PALLAS_PROBLEMS", "gather_result",
    "global_mesh", "global_mesh_2d", "initialize", "is_coordinator",
    "make_mesh", "make_mesh_2d", "pad_for_mesh", "process_count",
    "shard_alignment", "shard_objective", "sharded_minimize",
    "sharded_vmap_minimize", "shutdown", "solve_shard",
    "solve_shard_from_state",
    "shardmap_dir_poly", "shardmap_fused_tail", "shardmap_fused_vg",
    "shardmap_multi_phi", "shardmap_multi_phi_dphi", "shardmap_value",
    "shardmap_value_and_grad",
]
