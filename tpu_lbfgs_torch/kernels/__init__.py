"""Hand-written CUDA kernels with their plain PyTorch versions, and the
small-matrix head of the compact direction."""
