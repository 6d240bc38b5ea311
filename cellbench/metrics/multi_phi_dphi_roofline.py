"""The K-trial value-and-slope kernel's share of its roofline, in %: the
larger of its bytes over the card's memory rate and its operations over
the card's float32 rate, over the mean device time of a call
(``multi_phi_dphi_kernel`` and the finishing kernels of its sums) in the
profiled slice.  The card's power limit stands in the result line.

Each call evaluates phi(a) = f(x + a d) and phi'(a) = grad f(x + a d).d
at K steps a of one instance.  K: the speculative strong-Wolfe search's
doubling ladder, ``spec_width`` steps a round; the speculative
backtracking-Wolfe search's tree, (R + 1)(R + 2) / 2 with R =
``spec_width`` - 1.

Bytes: x and d read once (2 d), the K steps in, 2 K sums out.
Operations, the chained Rosenbrock body's own work per trial and element,
whatever implements it: the trial point z = x + a d (2); t = z' - z^2 (2)
and u = 1 - z (1); the term 100 t^2 + u^2 (4) and its sum (1); the
gradient's element -400 z t - 2 u + 200 t_prev (6); and its product with
d summed (2): 18 a trial and element."""
from cellbench.roofline import kernel_pct

OPS_PER_TRIAL_ELEMENT = 18


def read(run):
    prog = run.program
    width = prog.settings["spec_width"]
    if prog.settings["line_search"] == "backtracking_wolfe_speculative":
        trials = width * (width + 1) // 2
    else:
        trials = width
    d, item = prog.d, prog.itemsize
    n_bytes = item * (2 * d + 3 * trials)
    n_ops = OPS_PER_TRIAL_ELEMENT * trials * d
    return kernel_pct(run, "multi_phi_dphi_kernel", n_bytes, n_ops)
