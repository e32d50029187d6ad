"""The frozen yardstick and the trace arithmetic, on synthetic spans."""

import pytest

from gpubench import trace, yardstick
from gpubench.manifest import Bench
from conftest import ROOT


def test_busy_time_is_the_union_of_spans():
    spans = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 41)]
    assert yardstick.union_ns(spans) == 15 + 10 + 1
    assert yardstick.idle_gaps(spans) == [(15, 20), (30, 40)]
    assert yardstick.idle_share(spans) == pytest.approx(1 - 26 / 41)


def test_one_span_has_no_idle_time():
    assert yardstick.idle_share([(3, 9)]) == 0.0
    with pytest.raises(ValueError):
        yardstick.idle_share([])


# the 64-bit torus's split-ring shape (N = 2048, group 2, (3, 2) levels, 4
# primes): no cell runs it yet, a configuration added as data would
SPLIT = {"N": 2048, "n_primes": 4, "split_ring": True,
         "key": {"group": 2, "engine_bgbit": 8, "decomp_levels": [3, 2]}}


@pytest.mark.parametrize("config, kernel, us", [
    ("g3", "k1", 21.28), ("g3", "k2", 15.76), (SPLIT, "k1", 45.07),
    (SPLIT, "k2s", 39.11)])
def test_the_byte_bounds_at_2048_lanes(config, kernel, us):
    cfg = Bench(ROOT).config(config) if isinstance(config, str) else config
    shapes = yardstick.step_shapes(cfg, 2048)
    assert shapes[kernel] * 1e6 == pytest.approx(us, abs=0.005)


def test_k1_counts_its_inputs_and_outputs_once():
    k1 = yardstick.k1_bound_s(3, 1, 1024)
    assert k1 == pytest.approx((3 * 2 * 2 * 1024 + 2 * 2 * 1024 * 4
                                + 2 * 3 * 1024 * 2048) / yardstick.HBM_BPS)


def test_a_fast_ntt_needs_less_time_than_the_bytes():
    """The least multiplications of a fast NTT (N/2 log2 N a polynomial and
    prime, at the int32 multiply rate, half of the 67 TFLOP/s fp32 FMA
    rate) stay under the byte bound at g3's shape, for K2's forward
    transforms and products and K1's inverse transforms."""
    imul = 67e12 / 2 / 2
    P, N, B, R = 3, 1024, 2048, 4
    butterflies = N // 2 * 10
    k2 = (B * R * P * butterflies + B * R * 2 * P * N) / imul
    k1 = 2 * B * P * butterflies / imul
    g3 = yardstick.step_shapes(Bench(ROOT).config("g3"), B)
    assert k2 < g3["k2"] and k1 < g3["k1"]


def _trace(records, launched, cfg_name="g3", calls=2):
    return trace.Trace(records=records, launched=launched,
                       host_spans=[("enqueue apply_gates", 0, 40),
                                   ("copy to host", 40, 100)],
                       calls=calls, window_ns=100,
                       cfg=Bench(ROOT).config(cfg_name), lanes=2048)


def test_a_trace_is_complete_only_when_it_kept_every_counted_launch():
    recs = [("ntt_inverse_crt_acc_kernel<3>", 0, 10),
            ("void ntt_step_fused_kernel<4>", 10, 20), ("elementwise", 20, 25)]
    full = {"k1": 1, "k2": 1, "k2s": 0, "k3": 0}
    assert _trace(recs, full).complete
    assert not _trace(recs, dict(full, k1=2)).complete
    assert not _trace([], dict(full, k1=0, k2=0)).complete


def test_the_readers_on_a_synthetic_trace():
    from gpubench.manifest import reader

    k1_ns, k2_ns = 104_173, 347_243
    recs = [("ntt_inverse_crt_acc_kernel", 0, k1_ns),
            ("ntt_step_fused_kernel", 200_000, 200_000 + k2_ns),
            ("decompose", 600_000, 610_000), ("key switch", 700_000, 705_000)]
    t = _trace(recs, {"k1": 1, "k2": 1, "k2s": 0, "k3": 0})
    assert reader("k1_roofline")(t) == pytest.approx(
        100 * yardstick.k1_bound_s(3, 2048, 1024) / (k1_ns / 1e9))
    assert reader("k2_roofline")(t) == pytest.approx(
        100 * yardstick.k2_bound_s(3, 1024, 3, 4, 1, 2048) / (k2_ns / 1e9))
    assert t.roofline_pct("k2s") is None
    assert reader("glue_us_per_step")(t) == pytest.approx(15.0)
    busy = k1_ns + k2_ns + 10_000 + 5_000
    assert reader("idle_share.batch")(t) == pytest.approx(100 * (1 - busy / 705_000))


def test_the_breakdown_names_what_the_host_did_in_each_gap():
    recs = [("a", 0, 10), ("b", 20, 30), ("a", 60, 70), ("c", 70, 200)]
    b = _trace(recs, {"k1": 0, "k2": 0, "k2s": 0, "k3": 0}).breakdown()
    assert b["device_ops"][0] == ["c", 130 / 1e9]
    assert dict(b["idle_gaps"]) == {"enqueue apply_gates": 10 / 1e9,
                                    "copy to host": 30 / 1e9}
