"""Checkpoint and resume of solver state."""
from .checkpoint import (
    load_state,
    load_state_sharded,
    save_state,
    save_state_sharded,
)

__all__ = ["load_state", "load_state_sharded", "save_state",
           "save_state_sharded"]
