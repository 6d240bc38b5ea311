"""GPU throughput harness, and the C++ oracle's CPU baseline."""
from .harness import (
    REFERENCE_SEEDS,
    BenchResult,
    bench_batch,
    bench_cpu_native,
    bench_gpu,
    time_to_tolerance,
    time_to_tolerance_refined,
)
