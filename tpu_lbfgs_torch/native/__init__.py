from .binding import PROBLEM_IDS, build, native_lbfgs
