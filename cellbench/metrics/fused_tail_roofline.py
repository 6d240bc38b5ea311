"""The fused tail's share of its roofline, in %: the bytes it must move at
the cell's shapes, every lane of a batch, over the card's memory rate,
over the mean device time of a call (``tail_tile_kernel`` and the
finishing kernels of its sums) in the profiled slice.  Bound: bytes (its
few operations an element take far less); the card's power limit stands
in the result line.

Bytes a lane, float32: it reads x, d, g and writes x_new, g_new and the
pair's two rows (7 d); where it forms the history products t1 = S y,
t2 = Y y it reads the ring's 2 m rows as well (2 m d); the step in, seven
sums and the 2 m products out."""
from cellbench.roofline import kernel_pct


def read(run):
    prog = run.program
    m, d, item = prog.settings["m"], prog.d, prog.itemsize
    rows = 7 + (2 * m if prog.tail_products else 0)
    scalars = 1 + 7 + (2 * m if prog.tail_products else 0)
    return kernel_pct(run, "tail_tile_kernel",
                      (prog.batch or 1) * item * (rows * d + scalars))
