"""GPU throughput harness."""
