"""Each ``examples/torch_*.py`` run as a user runs it, on the CPU at a small
size (``--device cpu``; on the card they run at their defaults in
chip_smoke.py's ``[examples]``).  04 and 07 start 4 gloo ranks of their
own."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = sorted(p.name for p in (REPO / "examples").glob("torch_*.py"))
# Small sizes for the CPU, and a line each run must print.
ARGS = {
    "torch_01_basic_solve.py": (["--d", "1000"], "iterations :"),
    "torch_02_custom_problem.py": (["--d", "256"], "registered: beale_like"),
    "torch_03_fast_stack.py": (["--d", "4096", "--iters", "20"],
                               "20 iterations in"),
    "torch_04_batched_and_sharded.py": (
        ["--d", "1024", "--batch", "64", "--nproc", "4"],
        "2-D mesh (2, 2)"),
    "torch_05_checkpoint_resume.py": (["--d", "1024"], "phase 2: k ="),
    "torch_06_precision_refinement.py": (["--d", "64"], "status = converged"),
    "torch_07_diagnostics_and_recovery.py": (["--d", "1024", "--nproc", "4"],
                                             "sharded checkpoint: 4 ranks"),
    "torch_08_hard_problems_and_auto_rules.py": (["--d", "1024"],
                                                 "probe observed"),
}


def test_every_example_is_listed():
    assert EXAMPLES == sorted(ARGS) and len(EXAMPLES) == 8


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(name):
    args, expect = ARGS[name]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, str(REPO / "examples" / name),
                          "--device", "cpu"] + args, cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert expect in run.stdout, run.stdout[-3000:]
