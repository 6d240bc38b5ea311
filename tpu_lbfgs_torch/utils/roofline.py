"""Per-iteration memory-traffic model and roofline accounting on the card
(``tpu_lbfgs.utils.roofline`` with the H100's memory rate).

The model counts the passes over d-sized vectors that one iteration must
make (1 pass = d elements of the iterate's dtype read or written once; a
bfloat16 history row counts half of a float32 one) and turns them into
bytes, so a benchmark can report the memory rate it reached on the model
and its share of the card's.  The counting is the reference's, pass for
pass (its module docstring):

direction "two_loop": per pair and loop, read s_i or y_i and read/write
    q or r -> 4 m history + 4 m vector passes, + 2 for gamma and negation.
direction "compact": S.Y', Y.Y', S.g, Y.g (5 m history + 1), then the
    combine gamma g + v S - gamma u Y (2 m history + 2).
direction "compact_incremental": the products S y, Y y (2 m history + 1)
    and the combine (2 m history + 2).
line search "polynomial": one (x, d) pass for the coefficients; "direct":
    (x, d) and the objective per trial, a gradient pass per Wolfe trial.
tail: fused, read x, d, g, write x_new, g_new and the two rows; otherwise
    x_new, the value and gradient, and ``iteration_tail`` (read x, d, g,
    g_new, write x_new, s, y).  The ring's row write: 4 row passes.

Where the port's streams differ from the reference's:

- ``with_matvec``: the port puts the products S y, Y y into the fused tail
  from d = 2^16 under "auto" (``problems.suite.auto_with_matvec``).  The
  tail then reads the 2 m history rows in its own stream and y is never
  read again: one vector pass fewer than the reference's count.
- The history always streams.  The reference's rule that a ring under
  ~100 MB stays in the TPU's VMEM, its reads free, is a rule of that
  memory.  The H100's 50 MB L2 is shared with every other stream of an
  iteration, and no measurement shows a ring staying in it, so the model
  has no residency rule and no ``history_streams``; ``hist_resident=True``
  still asks for the reference's count without history reads.
- "auto" history is the iterate's dtype (``core.solver.
  resolve_history_dtype``), so it weighs 1.0 at every size.

The counts are what an iteration must move.  The port's code moves more:
its masked ring write (``index_select``, ``torch.where``, ``index_copy_``)
makes 7 row passes per ring where the model counts 2, and the compact
direction's small matrices and scalars are not counted.  So a rate on the
model is a lower bound of the rate the card reached, and a share above
1.0 means the model counts wrong.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..config import LBFGSConfig

#: Peak device-memory rate, GB/s: one H100 SXM, 80 GB HBM3 (NVIDIA's data
#: sheet, at the card's full 700 W).
HBM_BW_GBPS = {"h100": 3350.0}

_ITEMSIZE = {"bfloat16": 2, "float32": 4, "float64": 8}


@dataclass
class TrafficModel:
    """Per-iteration device-memory traffic, split by phase, in passes of d
    elements of ``dtype_bytes`` each.  ``batch``: instances iterated in
    lockstep; passes are per instance and bytes scale by the count."""
    passes_direction: float
    passes_line_search: float
    passes_tail: float
    passes_vg: float
    d: int
    dtype_bytes: int
    batch: int = 1

    @property
    def passes_total(self) -> float:
        return (self.passes_direction + self.passes_line_search
                + self.passes_tail + self.passes_vg)

    @property
    def bytes_per_iter(self) -> float:
        """Device-memory bytes per lockstep iteration, all lanes."""
        return self.passes_total * self.d * self.dtype_bytes * self.batch

    def peak_iters_per_s(self, chip: str = "h100") -> float:
        """Iterations/s at the card's peak memory rate."""
        return HBM_BW_GBPS[chip] * 1e9 / self.bytes_per_iter

    def peak_instance_iters_per_s(self, chip: str = "h100") -> float:
        """Instance-iterations/s at the peak: batch x the lockstep rate."""
        return self.peak_iters_per_s(chip) * self.batch

    def roofline_fraction(self, measured_iters_per_s: float,
                          chip: str = "h100") -> float:
        """A measured lockstep iterations/s over the peak one."""
        return measured_iters_per_s / self.peak_iters_per_s(chip)


def traffic_model(cfg: LBFGSConfig, d: int, dtype_bytes: int = 4,
                  avg_ls_trials: float = 2.2,
                  obj_passes: float = 1.0,
                  fused_tail: bool = None,
                  hist_resident: bool = False,
                  batch: int = 1,
                  with_matvec: bool = False) -> TrafficModel:
    """Passes per iteration for a configuration, the reference's count.

    ``avg_ls_trials``: line-search trials per iteration (n_fev / iterations
    of a run); ``obj_passes``: passes one objective evaluation costs beyond
    reading its input; ``fused_tail``: whether the fused tail kernel runs
    (default ``cfg.use_pallas``); ``hist_resident``: history reads cost
    nothing (the reference's VMEM count; module docstring); ``batch``:
    lockstep instances; ``with_matvec``: the fused tail forms the history
    products (compact_incremental only; module docstring)."""
    m = cfg.m
    if fused_tail is None:
        fused_tail = cfg.use_pallas
    hd = cfg.history_dtype
    hw = 1.0 if hd in (None, "auto") else _ITEMSIZE[hd] / dtype_bytes
    hw_write = hw     # ring-row writes stream whatever the reads do
    if hist_resident:
        hw = 0.0

    if cfg.direction == "two_loop":
        p_dir = (4.0 * m) * hw + (4.0 * m) + 2.0
    elif cfg.direction == "compact_incremental":
        # The products against y (in the tail with with_matvec, which then
        # reads no y of its own) + the combine: read S, Y, g, write d.
        p_y = 0.0 if (with_matvec and fused_tail) else 1.0
        p_dir = (2.0 * m) * hw + p_y + (2.0 * m) * hw + 2.0
    else:  # compact: recompute S.Y', Y.Y', S.g, Y.g, then combine
        p_dir = (5.0 * m) * hw + 1.0 + (2.0 * m) * hw + 2.0

    if cfg.ls_eval == "polynomial":
        p_ls = 2.0
    else:
        per_trial = 2.0 + obj_passes
        if cfg.line_search == "backtracking_speculative":
            # The ladder of candidates shares one (x, d) stream per round.
            per_trial = (2.0 + obj_passes) / max(avg_ls_trials, 1.0)
        elif cfg.line_search in ("backtracking_wolfe",
                                 "backtracking_wolfe_bisect",
                                 "wolfe_interpolation"):
            per_trial += 1.0
        p_ls = per_trial * avg_ls_trials
        if cfg.direction == "two_loop":
            p_ls += 2.0     # g.d; the compact paths have it in O(m)

    if fused_tail:
        p_tail = 3.0 + 2.0 + 2.0 * hw_write
        p_vg = 0.0
    else:
        p_tail = 3.0 + 7.0
        p_vg = 2.0 + obj_passes
    p_ring = 4.0 * hw_write
    return TrafficModel(p_dir, p_ls, p_tail + p_ring, p_vg, d, dtype_bytes,
                        batch=batch)
