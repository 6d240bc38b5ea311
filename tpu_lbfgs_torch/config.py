"""Solver configuration: the same fields, defaults and validation as
``tpu_lbfgs.config.LBFGSConfig``, so one configuration means the same solve
in both packages.

The port runs one slice of the reference so far: Armijo backtracking on the
closed-form directional polynomial, the incremental compact direction, f32
or f64 history.  ``check_supported`` turns every other option into a
``NotImplementedError`` at solve time, naming the ROADMAP item that brings
it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

C1_DEFAULT = 1e-4
C2_SEQUENTIAL = 0.9
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

    # The port's kernels come from the callables the caller passes
    # (fused_value_and_grad, fused_tail_for).  Without a fused tail, True
    # would select the unfused iteration_tail kernel, which is not ported
    # yet, so iterate raises.
    use_pallas: bool = False
    # None | "float32" | "auto" run; "auto" resolves to the input dtype
    # (the reference's rule is a TPU VMEM-residency rule).  "bfloat16" is
    # not ported yet.
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


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to tpu_lbfgs_torch yet (ROADMAP.md {item})")


def check_supported(cfg: LBFGSConfig) -> None:
    """Raise NotImplementedError for an option outside the ported slice."""
    if cfg.line_search != "backtracking":
        raise _unported(f"line_search={cfg.line_search!r}", "Queue 1 item 7")
    if cfg.ls_eval != "polynomial":
        raise _unported(f"ls_eval={cfg.ls_eval!r}", "Queue 1 item 7")
    if cfg.direction != "compact_incremental":
        raise _unported(f"direction={cfg.direction!r}", "Queue 1 item 8")
    if cfg.damping is not None:
        raise _unported("damping", "Queue 1 item 8")
    if cfg.accurate_dots:
        raise _unported("accurate_dots", "Queue 1 item 8")
    if cfg.record_trace:
        raise _unported("record_trace", "Queue 1 item 8")
    if cfg.refresh_interval is not None:
        raise _unported("refresh_interval", "Queue 1 item 8")
    if cfg.history_dtype == "bfloat16":
        raise _unported("bfloat16 history", "Queue 1 item 8")
