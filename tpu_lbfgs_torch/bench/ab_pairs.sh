#!/usr/bin/env bash
# Compare bench.py's single-instance solve between two trees on one card:
#
#   bash tpu_lbfgs_torch/bench/ab_pairs.sh PARENT_DIR CHANGE_DIR [PAIRS]
#
# Each directory holds a checkout of the repository (for the parent, unpack
# `git archive <commit>` into a directory that .gitignore lists).  Every run
# is one process calling bench/harness.py::bench_gpu (chained Rosenbrock,
# d = 2^20, float32, 1000 iterations, best of 3) in its own tree, which builds
# that tree's kernels at first use.  The pairs alternate which side runs
# first (parent, change, change, parent, ...), all on the same card, because
# the host's speed differs between machines and drifts within a call.
# Prints the card's name and power limit, then one "AB <dir> <iterations/s>
# <the three runs' seconds>" line per run.
set -euo pipefail
parent=$1
change=$2
pairs=${3:-5}

run() {
  (cd "$1" && python3 -c "
from tpu_lbfgs_torch.bench import harness
# the main path's configuration; a tree from before main_path_cfg has it
# as bench_gpu's default
cfg = getattr(harness, 'main_path_cfg', lambda: None)()
r = harness.bench_gpu(problem='rosenbrock', d=1 << 20, iters=1000, cfg=cfg,
                      repeats=3)
print('AB $1', round(r.iters_per_s, 2),
      [round(w, 3) for w in r.details['repeat_walls_s']], flush=True)
" 2>&1 | grep '^AB')
}

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for i in $(seq 1 "$pairs"); do
  if [ $((i % 2)) -eq 1 ]; then
    run "$parent"; run "$change"
  else
    run "$change"; run "$parent"
  fi
done
