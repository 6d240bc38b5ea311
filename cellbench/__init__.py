"""A benchmark of the PyTorch and CUDA port, tpu_lbfgs_torch (README.md)."""
