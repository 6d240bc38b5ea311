#!/bin/bash
# The card's records of the experiment harnesses, each written under $OUT
# (default torch_records, where they are kept); the card's name and power
# limit go to $OUT/card.txt:
#
#   bash torch_records/records.sh north sweep giant protocol alone
#
#   north     time to ||g|| <= 1e-5 at d = 2^20 in two stages
#             (bench.harness.time_to_tolerance_refined)
#   sweep     python -m tpu_lbfgs_torch.bench --quick
#   giant     bench/giant.py --profile, the products in the tail, 100
#             iterations, 2 timed runs: d = 2^22 and 2^24 (float32 ring),
#             d = 2^26 (float32 ring, bfloat16 ring, bfloat16 ring in
#             segments) and d = 1e8 (float32 ring)
#   protocol  the reference protocol at d = 10,000 and 20,000 with the
#             float64 cells, 600 s a cell, $JOBS cells at a time sharing
#             the card (default 6; the record then keeps no rate)
#   alone     the cells whose seeds the shared budget cut (the same four
#             at d = 10,000 and 20,000; $DIMS picks the d), one at a time,
#             600 s each, as the reference's grid ran them
set -euo pipefail
OUT=${OUT:-torch_records}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
for part in "$@"; do
  echo "=== $part $(date -u +%H:%M:%S)"
  case $part in
    north)
      python3 -c 'import json, sys
from tpu_lbfgs_torch.bench.harness import time_to_tolerance_refined as ttt
json.dump(ttt(d=1 << 20, coarse_tol=1e-3, tol=1e-5), sys.stdout, indent=1)' \
        | tee "$OUT/torch_northstar_1e5.json" ;;
    sweep)
      python3 -m tpu_lbfgs_torch.bench --quick --out "$OUT/torch_bench_results.json" ;;
    giant)
      : > "$OUT/torch_giant_results.jsonl"
      for args in "--d 4194304" "--d 16777216" "--d 67108864" \
                  "--d 67108864 --history-dtype bfloat16" \
                  "--d 67108864 --history-dtype bfloat16 --donate" \
                  "--d 100000000"; do
        # shellcheck disable=SC2086
        python3 -m tpu_lbfgs_torch.bench.giant $args --with-matvec \
          --iters 100 --repeats 2 --profile | tee -a "$OUT/torch_giant_results.jsonl"
      done ;;
    protocol)
      python3 -m tpu_lbfgs_torch.bench --reference-protocol --cuda-f64 \
        --dims 10000 20000 --cuda-budget 600 --jobs "${JOBS:-6}" \
        --out "$OUT/torch_reference_protocol_results.json" ;;
    alone)
      for d in ${DIMS:-10000 20000}; do
        : > "$OUT/torch_reference_protocol_alone_$d.jsonl"
        for cell in "backtracking cuda-f32-norescue" \
                    "backtracking_wolfe cuda-f32-parcfg" \
                    "backtracking_wolfe cuda-f32-norescue" \
                    "wolfe_interpolation cuda-f64"; do
          read -r strategy backend <<< "$cell"
          python3 -m tpu_lbfgs_torch.bench.reference_protocol --cell \
            --problem rosenbrock --d "$d" --strategy "$strategy" \
            --backend "$backend" --budget 600 \
            | tee -a "$OUT/torch_reference_protocol_alone_$d.jsonl"
        done
      done ;;
    *) echo "unknown part $part" >&2; exit 2 ;;
  esac
done
echo "=== done $(date -u +%H:%M:%S)"
