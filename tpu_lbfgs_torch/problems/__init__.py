"""The objective suite."""
from .fixtures import (
    FIXTURE_DIMS,
    QuadraticFixture,
    fixture_suite,
    make_spd_fixture,
)
from .suite import Problem, get_problem, problem_names, register_problem

__all__ = ["FIXTURE_DIMS", "Problem", "QuadraticFixture", "fixture_suite",
           "get_problem", "make_spd_fixture", "problem_names",
           "register_problem"]
