"""The objective suite."""
from .suite import Problem, get_problem

__all__ = ["Problem", "get_problem"]
