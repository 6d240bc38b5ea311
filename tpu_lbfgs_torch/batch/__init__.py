"""Batched solves: many independent instances in lockstep on one device."""
from .vmapped import vmap_minimize

__all__ = ["vmap_minimize"]
