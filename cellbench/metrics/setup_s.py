"""Seconds from the process's start to the first timed solve: imports,
the CUDA context, the kernels' build or load, the pool of starts and one
solve that captures the kept runner's graphs."""


def read(run):
    return run.setup_s
