"""Line-search strategies."""
from .strategies import (
    SPECULATIVE_TRIALS_THRESHOLD,
    SPECULATIVE_TWINS,
    armijo_interpolation,
    backtracking,
    backtracking_speculative,
    backtracking_wolfe,
    backtracking_wolfe_bisect,
    backtracking_wolfe_speculative,
    get_line_search,
    resolve_speculative_auto,
    wolfe_interpolation,
    wolfe_interpolation_speculative,
)
