"""The readers of the program's own spans (gpubench/program.py), on a
synthetic trace and synthetic records put in place of the recorder's."""

import pytest

from gpubench import program, trace
from gpubench.manifest import Bench, reader
from conftest import ROOT
from zig_tfhe_tpu_torch.utils import profiling
from zig_tfhe_tpu_torch.utils.profiling import Span

IDLE = ("idle_ms_per_call.prelude", "idle_ms_per_call.steps",
        "idle_ms_per_call.finish")
READERS = IDLE + ("key_switch_ms_per_call", "host_syncs_per_call")
MS = 1_000_000          # ns


def _call(first_id, t0, steps_host=(2, 8), steps_device=(2, 8),
          root="gates.apply"):
    """One call's spans from host time ``t0`` (ms in the arguments):
    ``root`` over 10 ms on both clocks, its steps on the host over
    ``steps_host`` and on the device over ``steps_device`` (after the
    call's start), its key switch from 8.5 to 9.8 ms on both; 5 syncs."""
    h0, h1 = steps_host
    d0, d1 = steps_device
    return [Span(root, first_id, None, first_id, t0, t0 + 10 * MS,
                 10.0, 0.0, 5, {}),
            Span("blind_rotate.steps", first_id + 1, first_id, first_id,
                 t0 + int(h0 * MS), t0 + int(h1 * MS), d1 - d0, d0, None,
                 {"steps": 234}),
            Span("bootstrap.key_switch", first_id + 2, first_id, first_id,
                 t0 + int(8.5 * MS), t0 + int(9.8 * MS), 1.3, 8.5, None, {})]


# two calls: enqueue 0-10 ms and 12-22 ms, each followed by 2 ms of copy
HOST = [("enqueue apply_gates", 0, 10 * MS), ("copy to host", 10 * MS, 12 * MS),
        ("enqueue apply_gates", 12 * MS, 22 * MS),
        ("copy to host", 22 * MS, 24 * MS)]
SPANS = _call(1, 0) + _call(4, 12 * MS)


def _trace(records, call_span="gates.apply"):
    return trace.Trace(records=records, launched={}, host_spans=HOST, calls=2,
                       window_ns=24 * MS, cfg=Bench(ROOT).config("g3"),
                       lanes=2048, call_span=call_span)


@pytest.fixture
def recorded(monkeypatch):
    def put(spans):
        monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    put(SPANS)
    return put


K1 = "ntt_inverse_crt_acc_kernel<32>"      # a hand kernel's record


def _kernels(gaps, late=0.0, shift=0.0):
    """Kernel records that keep the device busy over each call's device
    window, 0-10 and 12-22 ms (call 1's ``late`` ms later), except in
    ``gaps`` (ms); idle between the calls.  The record that ends at a
    window's 8 ms, where its steps end, is K1's.  ``shift`` moves every
    record on the host clock, as the profiler's clock conversion can."""
    out = []
    for lo, hi in ((late, 10 + late), (12, 22)):
        edges = [lo] + [x for g in gaps if lo <= g[0] < hi for x in g] + [hi]
        for i in range(0, len(edges), 2):
            s, e, k1 = edges[i], edges[i + 1], lo + 8
            parts = [(s, k1, K1), (k1, e, "k")] if s < k1 < e else [
                (s, e, K1 if e == k1 else "k")]
            out += [(nm, int((a + shift) * MS), int((b + shift) * MS))
                    for a, b, nm in parts]
    return out


def test_each_idle_reader_by_hand(recorded):
    # call 1: 1.0 ms prelude (mid 1.0), 0.5 ms steps (mid 5.0), 0.25 ms
    # finish (mid 9.0); the 2 ms between the calls (mid 11) is the
    # harness's; call 2: 0.5 ms prelude (mid 13.0), 0.5 ms finish (mid 21.0)
    t = _trace(_kernels([(0.5, 1.5), (4.75, 5.25), (8.875, 9.125),
                         (12.75, 13.25), (20.75, 21.25)]))
    got = {m: reader(m)(t) for m in IDLE}
    assert got == pytest.approx({"idle_ms_per_call.prelude": 1.5 / 2,
                                 "idle_ms_per_call.steps": 0.5 / 2,
                                 "idle_ms_per_call.finish": 0.75 / 2})


def test_gaps_go_to_the_part_the_device_was_running(recorded):
    """The host runs ahead: it closes the steps at 3 ms, while the device
    runs them until 8 ms.  A gap at 6 ms is the steps', though the host
    had moved on to the finish then."""
    recorded(_call(1, 0, steps_host=(2, 3)) + _call(4, 12 * MS))
    t = _trace(_kernels([(0.5, 1.0), (6.0, 6.5), (9.0, 9.25)]))
    got = {m: reader(m)(t) for m in IDLE}
    assert got == pytest.approx({"idle_ms_per_call.prelude": 0.5 / 2,
                                 "idle_ms_per_call.steps": 0.5 / 2,
                                 "idle_ms_per_call.finish": 0.25 / 2})
    # the same gaps as the breakdown's enqueue, split otherwise
    idle = dict(t.breakdown()["idle_gaps"])
    assert idle["enqueue apply_gates"] * 1e3 == pytest.approx(0.5 + 0.5 + 0.25)


def test_a_call_the_device_reaches_late_is_placed_by_its_kernels(recorded):
    """The device reaches call 1's start event 1.5 ms after the host opened
    the call (as after the profiler starts): its end event, after its last
    kernel, places it.  From the host start its finish would fall past the
    call's end."""
    t = _trace(_kernels([(2.0, 3.0), (6.25, 6.75), (10.375, 10.625)],
                        late=1.5))
    got = {m: reader(m)(t) for m in IDLE}
    assert got == pytest.approx({"idle_ms_per_call.prelude": 1.0 / 2,
                                 "idle_ms_per_call.steps": 0.5 / 2,
                                 "idle_ms_per_call.finish": 0.25 / 2})
    (lo, hi), = program.calls(t)[0]["bootstrap.key_switch"]
    assert (lo, hi) == pytest.approx((10.0 * MS, 11.3 * MS))


def test_the_idle_parts_sum_to_the_breakdowns_enqueue_idle(recorded):
    t = _trace(_kernels([(0.5, 1.5), (3.0, 3.4), (6.0, 7.0), (9.5, 9.9),
                         (12.5, 14.3), (17.2, 17.6), (21.0, 21.9)]))
    idle = dict(t.breakdown()["idle_gaps"])
    assert set(idle) == {"enqueue apply_gates", "copy to host"}
    total = sum(reader(m)(t) for m in IDLE)
    enqueue = (1.0 + 0.4 + 1.0 + 0.4 + 1.8 + 0.4 + 0.9) / 2
    assert idle["enqueue apply_gates"] * 1e3 / t.calls == pytest.approx(enqueue)
    assert total == pytest.approx(enqueue)


def test_the_split_does_not_move_with_the_host_clock(recorded):
    """The profiler put every record 0.7 ms late on the host clock: the
    calls are placed by their hand kernels, not by the host."""
    gaps = [(0.5, 1.5), (4.75, 5.25), (8.875, 9.125), (12.75, 13.25),
            (20.75, 21.25)]
    want = {m: reader(m)(_trace(_kernels(gaps))) for m in READERS}
    got = {m: reader(m)(_trace(_kernels(gaps, shift=0.7))) for m in READERS}
    assert got == pytest.approx(want)
    assert program.calls(_trace(_kernels(gaps, shift=0.7)))[0]["call"] == (
        pytest.approx((0.7 * MS, 10.7 * MS)))


def test_nothing_where_the_hand_kernels_do_not_share_out(recorded):
    t = _trace(_kernels([]) + [(K1, 23 * MS, 24 * MS)])
    assert all(reader(m)(t) is None for m in IDLE + ("key_switch_ms_per_call",))
    assert reader("host_syncs_per_call")(t) == 5


def test_key_switch_and_host_syncs_a_call(recorded):
    # call 1's key switch (8.5-9.8 ms) holds a 0.3 ms gap; call 2's none
    t = _trace(_kernels([(9.0, 9.3)]))
    assert reader("key_switch_ms_per_call")(t) == pytest.approx((1.0 + 1.3) / 2)
    assert reader("host_syncs_per_call")(t) == 5


def test_records_outside_the_traced_stretch_are_ignored(recorded):
    before = _call(10, -40 * MS)
    after = _call(20, 30 * MS)
    recorded(before + SPANS + after)
    t = _trace(_kernels([]))
    assert reader("host_syncs_per_call")(t) == 5
    assert reader("key_switch_ms_per_call")(t) == pytest.approx(1.3)
    recorded(before + after)
    assert all(reader(m)(t) is None for m in READERS)


def test_nothing_without_records(recorded, monkeypatch):
    t = _trace(_kernels([]))
    recorded([])
    assert all(reader(m)(t) is None for m in READERS)
    # a program whose recorder predates spans: the readers do not raise
    monkeypatch.delattr(profiling, "spans")
    assert all(reader(m)(t) is None for m in READERS)


def test_nothing_where_the_recorder_dropped_spans(recorded, monkeypatch):
    t = _trace(_kernels([]))
    monkeypatch.setattr(profiling, "dropped", lambda: 1)
    assert all(reader(m)(t) is None for m in READERS)


def test_no_device_time_off_a_card(recorded):
    recorded([s._replace(device_ms=None, device_at_ms=None, syncs=None)
              for s in SPANS])
    t = _trace(_kernels([]))
    assert all(reader(m)(t) is None for m in READERS)
    assert program.spans(t) is not None


def test_the_five_entries_read_the_program():
    bench = Bench(ROOT)
    got = {x["name"]: x for x in bench.per_layer("g3.gates_b2048")}
    for m in READERS:
        assert got[m]["source"] == ("program_counter" if m.startswith("host")
                                    else "program_span")
        assert got[m]["moves"] == "bootstraps_per_s"


GAPS = [(0.5, 1.5), (4.75, 5.25), (8.875, 9.125), (12.75, 13.25), (20.75, 21.25)]


def test_the_readers_find_a_lut_call_by_its_span(recorded):
    """The same calls under the ``lut`` kind's span read as the gate
    calls do, and the gate calls' span is then no call."""
    want = {m: reader(m)(_trace(_kernels(GAPS))) for m in READERS}
    recorded(_call(1, 0, root="lut.call") + _call(4, 12 * MS, root="lut.call"))
    got = {m: reader(m)(_trace(_kernels(GAPS), "lut.call")) for m in READERS}
    assert got == pytest.approx(want)
    assert all(v is not None for v in got.values())
    assert all(reader(m)(_trace(_kernels(GAPS))) is None for m in READERS)


def test_a_span_of_the_calls_name_inside_a_call_is_no_call(recorded):
    """A program span named as the kind's call span, nested in the call's
    own (as ``gates.apply`` inside a ``lut.call``), is read as a part of
    that call: the calls and their syncs are counted once."""
    calls = _call(1, 0, root="lut.call") + _call(4, 12 * MS, root="lut.call")
    recorded(calls)
    want = {m: reader(m)(_trace(_kernels(GAPS), "lut.call")) for m in READERS}
    inner = [Span("lut.call", 100 + i, c, c, t0, t0 + 10 * MS, 10.0, 0.0,
                  None, {}) for i, (c, t0) in enumerate(((1, 0), (4, 12 * MS)))]
    recorded(calls + inner)
    got = {m: reader(m)(_trace(_kernels(GAPS), "lut.call")) for m in READERS}
    assert got == pytest.approx(want)
