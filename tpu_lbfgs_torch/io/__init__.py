"""Checkpoint and resume of solver state."""
from .checkpoint import load_state, save_state

__all__ = ["load_state", "save_state"]
