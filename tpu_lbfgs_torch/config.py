"""Solver configuration: the same fields, defaults and validation as
``tpu_lbfgs.config.LBFGSConfig``, so one configuration means the same solve
in both packages.

The port runs every option of the reference, for one instance and for a
batch: the three directions, every line search, trials evaluated directly
(``ls_eval="direct"``) or on the closed-form directional polynomial,
damping, compensated dots, traces, the periodic refresh of the incremental
products, and a history ring stored in another dtype than the iterate's
(bfloat16, or float32 under float64).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

C1_DEFAULT = 1e-4
C2_SEQUENTIAL = 0.9
C2_PARALLEL = 0.7
INITIAL_STEP_SIZE = 1.0
BACKTRACKING_SHRINK = 0.5
BACKTRACKING_TOL = 1e-8
WOLFE_INTERP_MIN = 1e-10
WOLFE_INTERP_MAX = 10.0

LINE_SEARCH_METHODS = (
    "backtracking",
    "backtracking_speculative",
    "backtracking_wolfe",
    "backtracking_wolfe_speculative",
    "backtracking_wolfe_bisect",
    "armijo_interpolation",
    "wolfe_interpolation",
    "wolfe_interpolation_speculative",
)

DIRECTION_METHODS = ("two_loop", "compact", "compact_incremental")

FIDELITY_MODES = ("reference", "fixed")


@dataclasses.dataclass(frozen=True)
class LBFGSConfig:
    """Static solver configuration; see ``tpu_lbfgs.config.LBFGSConfig`` for
    the meaning and provenance of every field."""

    m: int = 10
    max_iters: int = 1000
    tol: float = 1e-5

    line_search: str = "backtracking"
    c1: float = C1_DEFAULT
    c2: float = C2_SEQUENTIAL
    initial_step: float = INITIAL_STEP_SIZE
    shrink: float = BACKTRACKING_SHRINK
    grow: float = 1.1
    backtracking_tol: float = BACKTRACKING_TOL
    interp_min: float = WOLFE_INTERP_MIN
    interp_max: float = WOLFE_INTERP_MAX
    ls_max_iters: int = 20
    ls_safety_cap: int = 256
    bisect_tol: float = 1e-10
    safe_cubic: bool = True
    fidelity: str = "reference"
    alpha_rescue_floor: Optional[float] = None
    alpha_rescue_value: float = 0.5

    direction: str = "two_loop"
    refresh_interval: Optional[int] = None
    pair_skip_threshold: Optional[float] = None
    curvature_threshold: float = 0.0
    damping: Optional[float] = None
    step_fail_tol: float = 1e-10
    spec_width: int = 8

    ls_eval: str = "direct"

    # The port's fused kernels come from the callables the caller passes
    # (fused_value_and_grad, fused_tail_for).  Without a fused tail, True
    # selects the iteration_tail CUDA kernel (kernels.fused_ops) on the
    # card; on the CPU it runs that kernel's plain version.
    use_pallas: bool = False
    # None | "bfloat16" | "float32" | "auto": the dtype of the (m, d) ring;
    # None is the iterate's, "auto" is core.solver.resolve_history_dtype.
    history_dtype: Optional[str] = None
    accurate_dots: bool = False
    record_trace: bool = False

    def __post_init__(self):
        if self.line_search not in LINE_SEARCH_METHODS:
            raise ValueError(
                f"unknown line_search {self.line_search!r}; "
                f"expected one of {LINE_SEARCH_METHODS}"
            )
        if self.direction not in DIRECTION_METHODS:
            raise ValueError(
                f"unknown direction {self.direction!r}; "
                f"expected one of {DIRECTION_METHODS}"
            )
        if self.fidelity not in FIDELITY_MODES:
            raise ValueError(
                f"unknown fidelity {self.fidelity!r}; expected one of {FIDELITY_MODES}"
            )
        if self.ls_eval not in ("direct", "polynomial"):
            raise ValueError(
                f"unknown ls_eval {self.ls_eval!r}; expected 'direct' or "
                "'polynomial'")
        if self.m <= 0:
            raise ValueError("history depth m must be positive")
        if self.refresh_interval is not None and self.refresh_interval < 1:
            raise ValueError(
                f"refresh_interval must be >= 1 or None (got "
                f"{self.refresh_interval!r})")
        if self.damping is not None and not (0.0 < self.damping < 1.0):
            raise ValueError(
                f"damping must be in (0, 1) or None (got {self.damping!r})")
        if self.history_dtype not in (None, "bfloat16", "float32", "auto"):
            raise ValueError(
                f"unknown history_dtype {self.history_dtype!r}; expected "
                "None, 'bfloat16', 'float32', or 'auto'")

    def replace(self, **kw) -> "LBFGSConfig":
        return dataclasses.replace(self, **kw)


# The reference's sequential driver (main.cpp:24-58).
REFERENCE_SEQUENTIAL = LBFGSConfig(
    m=10, max_iters=15000, tol=1e-8, line_search="backtracking", c2=C2_SEQUENTIAL,
)

# The reference's GPU drivers (e.g. L-BFGS-Backtracking.cu:429-457): loose
# tol, the per-pair curvature skip (L-BFGS.cu:222-223), C2 = 0.7 and the
# alpha floor rescue.
REFERENCE_PARALLEL = LBFGSConfig(
    m=10, max_iters=50000, tol=1e-1, line_search="backtracking", c2=C2_PARALLEL,
    alpha_rescue_floor=1e-4, pair_skip_threshold=1e-10,
)
