"""Host seconds the program spent capturing its CUDA graphs, warm-ups
included, in set-up's solve: ``blocks.stats["capture_s"]``.  Moves
``setup_s``."""


def read(run):
    return run.capture_s
