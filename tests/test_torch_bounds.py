"""The K-trial kernels' bound for the build the port has
(tpu_lbfgs_torch/bench/trial_bounds.py) against counts by hand, at the
shape sharded_vmap_minimize gives the batched kernels, 4 lanes of a block
of 2^20, and at one lane of 2^20, at the module's rates and clock, pinned
here: 132 SMs at 1.98 GHz; 128 issued, 16 conversions and, beside them, 64
float64 adds or multiplies per SM per clock; 3.35 TB/s; the old model's
67 TFLOP/s."""
import pytest

from tpu_lbfgs_torch.bench import trial_bounds as tb

LANES, D_LOCAL = 4, 1 << 20
ELEMS = LANES * D_LOCAL
SM_CLOCKS_PER_MS = 132 * 1.98e9 / 1e3


def test_rates_and_clock():
    assert (tb.SMS, tb.CLOCK_HZ) == (132, 1.98e9)
    assert (tb.ISSUE_PER_SM_CLOCK, tb.CVT_PER_SM_CLOCK,
            tb.F64_PER_SM_CLOCK) == (128, 16, 64)
    assert (tb.HBM_BYTES_PER_S, tb.F32_OPS_PER_S) == (3.35e12, 67e12)


def test_multi_phi_rosenbrock_k8():
    # The batched kernel (multi_phi_batched_kernel), runs of 8.
    # 4 * 2^20 elements * 8 trials = 33,554,432 terms.
    # Issue: 11.25 instructions a term (41 FMUL + 33 FADD + 8 F2F + 8 DADD
    # for one trial of a run of 8, over 8; 9 trial points, the body's 8
    # terms, their conversions and adds), 128 a clock an SM:
    #   33,554,432 * 11.25 / 128 = 2,949,120 SM-clocks = 0.011284 ms.
    # Float64 pipe: a conversion (1/16) and an add (1/64, overlapped) a
    # term: 33,554,432 / 16 = 2,097,152 SM-clocks = 0.008024 ms.
    # Bytes: x and d (8 a element), alphas, edges and the K sums of each
    # lane: 33,554,432 + 16 * 4 + 12 * 8 * 4 = 33,554,880 = 0.010016 ms.
    # Old: 13 operations a term at 67e12 = 0.006510 ms, under the bytes.
    n_bytes = 8 * ELEMS + 16 * LANES + 12 * 8 * LANES
    got = tb.trial_bound("multi_phi_batched", "rosenbrock", ELEMS, 8,
                         n_bytes)
    assert got["issue"] == pytest.approx(2_949_120 / SM_CLOCKS_PER_MS,
                                         rel=1e-12)
    assert got["f64"] == pytest.approx(2_097_152 / SM_CLOCKS_PER_MS,
                                       rel=1e-12)
    assert got["bytes"] == pytest.approx(33_554_880 / 3.35e9, rel=1e-12)
    assert got["corrected"] == (got["issue"], "issue")
    assert got["corrected"][0] == pytest.approx(0.011284, abs=5e-7)
    assert got["old"] == (got["bytes"], "bytes")


def test_multi_phi_rosenbrock_k8_one_instance():
    # The one-instance kernel (multi_phi_kernel), runs of 4, one lane of
    # 2^20: 8,388,608 terms.
    # Issue: 11.5 a term (21 FMUL + 17 FADD + 4 F2F + 4 DADD for one trial
    # of a run of 4, over 4): 8,388,608 * 11.5 / 128 = 753,664 SM-clocks
    # = 0.0028836 ms.
    # Bytes: 8 * 2^20 + 4 * 8 alphas + 4 * 8 sums = 8,388,672 = 0.0025041
    # ms, under the issue.
    n_bytes = 8 * D_LOCAL + 4 * 8 + 4 * 8
    got = tb.trial_bound("multi_phi", "rosenbrock", D_LOCAL, 8, n_bytes)
    assert got["issue"] == pytest.approx(753_664 / SM_CLOCKS_PER_MS,
                                         rel=1e-12)
    assert got["bytes"] == pytest.approx(8_388_672 / 3.35e9, rel=1e-12)
    assert got["corrected"] == (got["issue"], "issue")
    assert got["corrected"][0] == pytest.approx(0.0028836, abs=5e-8)


def test_multi_phi_dphi_quadratic_k36():
    # 4 * 2^20 * 36 = 150,994,944 terms.
    # Float64 pipe: two conversions (f's term and g_i, 2/16 of a clock)
    # and, overlapped, a multiply and two adds (3/64) a term:
    #   150,994,944 * 2 / 16 = 18,874,368 SM-clocks = 0.072216 ms.
    # Issue: 10 a term (8 FMUL + 12 FADD + 8 F2F + 4 DMUL + 8 DADD for one
    # trial of a run of 4, over 4): 150,994,944 * 10 / 128 = 11,796,480
    # SM-clocks = 0.045133 ms.
    # Old: 9 operations a term at 67e12 = 0.020283 ms, over the bytes.
    n_bytes = 8 * ELEMS + 16 * LANES + 20 * 36 * LANES
    got = tb.trial_bound("multi_phi_dphi", "quadratic", ELEMS, 36, n_bytes)
    assert got["f64"] == pytest.approx(18_874_368 / SM_CLOCKS_PER_MS,
                                       rel=1e-12)
    assert got["issue"] == pytest.approx(11_796_480 / SM_CLOCKS_PER_MS,
                                         rel=1e-12)
    assert got["corrected"] == (got["f64"], "f64")
    assert got["corrected"][0] == pytest.approx(0.072216, abs=5e-7)
    assert got["old"][1] == "operations"
    assert got["old"][0] == pytest.approx(150_994_944 * 9 / 67e9, rel=1e-12)


@pytest.mark.parametrize("kernel", tb.KERNELS)
@pytest.mark.parametrize("body", tb.BODIES)
def test_corrected_bound_is_the_largest_limit(kernel, body):
    # The corrected bound is never under the bytes or under either pipe,
    # and at this build (one issue slot an operation, float64 sums) never
    # under the old model's, which counted the same work at 67 TFLOP/s.
    n_bytes = 8 * ELEMS
    for k in (8, 36):
        got = tb.trial_bound(kernel, body, ELEMS, k, n_bytes)
        limit, name = got["corrected"]
        assert limit == max(got["bytes"], got["issue"], got["f64"])
        assert got[name] == limit
        assert limit >= got["old"][0]
