"""Hand-written CUDA kernels with their plain PyTorch versions, and the
small-matrix head of the compact direction.

Each wrapper counts its kernel's launches in its module's ``launches``;
``launch_counts()`` reads and ``reset_launches()`` zeroes every count of
the package at once.  A launch recorded into a CUDA graph counts nothing
until the graph runs, and each replay as the kernels it runs (``counts``):
``launch_counts()`` is what the device ran, eager or replayed,
``replay_counts()`` the replayed part."""
from . import chain, counts, fused_ops, line_search_ops
from .fused_ops import (
    FUSED_VG,
    combine_direction,
    iteration_tail,
    make_fused_tail,
)
from .line_search_ops import make_multi_phi, make_multi_phi_dphi

_COUNTED = (fused_ops, chain, line_search_ops)


def launch_counts() -> dict[str, int]:
    """Kernel runs on the device per wrapper, eager launches and graph
    replays together, for every kernel of the package."""
    return {name: n for module in _COUNTED
            for name, n in module.launches.items()}


def replay_counts() -> dict[str, int]:
    """Kernel runs by CUDA graph replays per wrapper: the part of
    ``launch_counts()`` that graphs ran."""
    return {name: counts.replayed[name] for name in launch_counts()}


def reset_launches() -> None:
    for module in _COUNTED:
        module.reset_launches()
    counts.reset()
