"""The yardstick's arithmetic against hand counts: the p95 sample rule, the
traffic model, the rooflines, and the device's idle share from a
synthetic trace."""
import pytest

from cellbench import roofline, stats, traffic_model, trace
from cellbench.peaks import PEAKS, peaks
from cellbench.spec import load_cell, reader

H100 = "NVIDIA H100 80GB HBM3"


def test_p95_sample_rule():
    assert stats.least_samples(95) == 200
    assert stats.least_samples(99) == 1000
    values = list(range(1, 201))
    p95 = stats.percentile(values, 95)
    assert p95 == 190
    assert sum(v > p95 for v in values) == stats.TAIL_SAMPLES
    assert stats.percentile([3.0], 95) == 3.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_traffic_model_hand_counts():
    main = load_cell("genrose-d2e20.main").settings()
    # compact_incremental: 2m + 1 + 2m + 2 = 43; polynomial: 2; fused tail
    # 3 + 2 + 2 = 7; ring write 4.
    assert traffic_model.passes_per_iteration(main, 0.0) == 56.0
    assert traffic_model.bytes_per_iteration(main, 1 << 20, 4, 1, 0.0) \
        == 56 * 4 * (1 << 20)
    batch = load_cell("genrose-b4096.lockstep").settings()
    assert traffic_model.bytes_per_iteration(batch, 1024, 4, 4096, 0.0) \
        == 56 * 4 * 1024 * 4096
    direct = load_cell("genrose-d2e20.direct-wolfe").settings()
    # 43 + 9 trials of (x, d) and the objective + 7 + 4.
    assert traffic_model.passes_per_iteration(direct, 9.0) == 43 + 27 + 11


def test_peaks_table():
    assert peaks(H100) == PEAKS[H100]
    with pytest.raises(KeyError):
        peaks("a card the table lacks")


class _Prog:
    def __init__(self, cell, tail_products):
        self.settings = cell.settings()
        self.d, self.batch = cell.config["d"], cell.config["batch"]
        self.itemsize, self.tail_products = 4, tail_products


class _Run:
    """What the readers read of a run, by hand."""

    def __init__(self, name, ops, tail_products=True):
        cell = load_cell(name)
        self.program = _Prog(cell, tail_products)
        self.slice = trace.Slice(ops, 1.0, 0.75)
        self.device = None
        self.slice_steps = 2
        self.window_steps = self.window_iterations = self.iterations = 1000
        self.window_s, self.fevs = 2.0, 11000


@pytest.fixture
def h100(monkeypatch):
    monkeypatch.setattr(roofline, "_peaks", lambda run: PEAKS[H100])


def test_fused_tail_roofline(h100):
    d = 1 << 20
    ops = [("void tail_tile_kernel<tl::Rosenbrock, float, true>", 0.0, 40e-6),
           ("void tl::finish_sums<double>", 40e-6, 50e-6),
           ("void tail_tile_kernel<tl::Rosenbrock, float, true>", 1e-3,
            1e-3 + 50e-6),
           ("elementwise_kernel", 2e-3, 3e-3)]
    run = _Run("genrose-d2e20.main", ops)
    # 7 vector passes and the ring's 20 rows, 1 + 7 + 20 scalars.
    want = 100.0 * 4 * (27 * d + 28) / 3.35e12 / 50e-6
    assert reader("fused_tail_roofline.solve")(run) == pytest.approx(want)
    run.program.tail_products = False
    want = 100.0 * 4 * (7 * d + 8) / 3.35e12 / 50e-6
    assert reader("fused_tail_roofline.solve")(run) == pytest.approx(want)
    batch = _Run("genrose-b4096.lockstep", ops, tail_products=False)
    want = 100.0 * 4096 * 4 * (7 * 1024 + 8) / 3.35e12 / 50e-6
    assert reader("fused_tail_roofline.batch")(batch) \
        == pytest.approx(want)


def test_multi_phi_dphi_roofline(h100):
    d = 1 << 20
    ops = [("void multi_phi_dphi_kernel<tl::Rosenbrock>", 0.0, 15e-6),
           ("void tl::finish_sums<double>", 15e-6, 20e-6),
           ("void multi_phi_dphi_batched_kernel<tl::Rosenbrock>", 1.0, 2.0)]
    run = _Run("genrose-d2e20.direct-wolfe", ops)
    # K = 8: bytes 2 d + 3 K floats at 3.35 TB/s (2.504 us) against 18 K d
    # operations at 67 TFLOP/s (2.254 us): bytes bound it.
    want = 100.0 * 4 * (2 * d + 24) / 3.35e12 / 20e-6
    assert reader("multi_phi_dphi_roofline")(run) == pytest.approx(want)
    run.program.settings["line_search"] = "backtracking_wolfe_speculative"
    # K = 36: the operations bound it.
    want = 100.0 * 18 * 36 * d / 67e12 / 20e-6
    assert reader("multi_phi_dphi_roofline")(run) == pytest.approx(want)
    assert reader("multi_phi_dphi_roofline")(_Run(
        "genrose-d2e20.direct-wolfe", ops[2:])) is None


def test_iteration_roofline_and_counts(h100):
    run = _Run("genrose-d2e20.main", [("k", 0.0, 1.0)] * 5)
    want = 100.0 * 1000 / 2.0 * 56 * 4 * (1 << 20) / 3.35e12
    assert reader("iter_roofline.solve")(run) == pytest.approx(want)
    assert reader("kernels_per_iter.solve")(run) == 2.5
    assert reader("device_idle_pct.solve")(run) == pytest.approx(25.0)
    assert reader("fev_per_iter")(run) == 11.0
    run.walls, run.window_solves = [0.001 * i for i in range(1, 201)], 200
    assert reader("solve_ms_p95")(run) == pytest.approx(190.0)
    run.slice = None
    assert reader("device_idle_pct.solve")(run) is None
    assert reader("kernels_per_iter.solve")(run) is None


def test_idle_share_from_a_synthetic_trace():
    device = [("spin_kernel", 0.0, 0.5),            # a sentinel: not counted
              ("a", 1.0, 1.2), ("b", 1.1, 1.3),     # overlap: busy 0.3
              ("cellbench.solve", 1.0, 1.9),        # an annotation
              ("Memcpy DtoH", 1.5, 1.6),
              ("c", 1.8, 1.9), ("late", 2.5, 2.6)]   # outside the window
    host = [("cellbench.solve", 1.0, 1.7), ("cellbench.read", 1.7, 2.0),
            ("cudaGraphLaunch", 1.25, 1.5), ("cudaEventSynchronize", 1.6, 1.8),
            ("cellbench.slice", 1.0, 2.0)]
    s = trace.reduce(device, host, (1.0, 2.0))
    assert s.window_s == pytest.approx(1.0)
    assert s.busy_s == pytest.approx(0.3 + 0.1 + 0.1)
    assert [op[0] for op in s.kernels] == ["a", "b", "c"]
    gaps = dict(s.top_gaps())
    assert gaps["cellbench.solve / cudaGraphLaunch"] == pytest.approx(0.2)
    assert gaps["cellbench.read / cudaEventSynchronize"] == pytest.approx(0.2)
    assert gaps["cellbench.read / no runtime call"] == pytest.approx(0.1)
    assert sum(gaps.values()) == pytest.approx(s.window_s - s.busy_s)
    assert s.top_ops()[0][0] in ("a", "b")


def test_calls_take_their_finishing_kernels():
    ops = [("x_kernel", 0.0, 1.0), ("finish_rows", 1.0, 1.5),
           ("finish_sums", 1.5, 2.0), ("y", 2.0, 3.0),
           ("x_kernel", 4.0, 4.5), ("y", 4.5, 5.0)]
    assert trace.Slice(ops, 5.0, 4.0).calls("x_kernel") == [2.0, 0.5]
