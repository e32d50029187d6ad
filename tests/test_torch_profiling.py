"""The port's own spans (``utils/profiling.py``): off outside a profiler,
the gate path's spans and their ids under one, outputs unchanged, the host
clock they share with the profiler's records, and on a card the device
clock that places them and the synchronising operations they count.

The file imports no jax; its ``cuda`` tests run on a card with

    python -m pytest --noconftest -m cuda tests/test_torch_profiling.py
"""

import os
import time
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from zig_tfhe_tpu_torch import key, params, tlwe
from zig_tfhe_tpu_torch.models import gates
from zig_tfhe_tpu_torch.ops import ntt
from zig_tfhe_tpu_torch.ops.cuda import ntt_inverse as K1
from zig_tfhe_tpu_torch.utils import profiling

P = params.TEST_TINY
LANES = 16


@pytest.fixture(autouse=True)
def fresh():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def one_thread():
    # many small CPU ops: torch's intra-op pool stalls beside other workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(device):
    g = torch.Generator(device=device).manual_seed(11)
    sk = key.SecretKey.generate(g, P)
    ck = key.CloudKey.generate(g, sk, P, group=3)
    bits = torch.randint(0, 2, (2, LANES), generator=g, device=device).bool()
    a, b = (tlwe.encrypt_bool(g, x, P.tlwe_lv0.alpha, sk.key_lv0) for x in bits)
    ids = torch.arange(LANES, device=device) % len(gates.GATE_NAMES)
    return ids, a, b, ck


@pytest.fixture(scope="module")
def tiny(one_thread):
    return _inputs(torch.device("cpu"))


def _check_call(found, ck):
    by = {s.name: s for s in found}
    assert sorted(by) == ["blind_rotate.steps", "bootstrap.key_switch",
                          "gates.apply"] and len(found) == 3
    root = by["gates.apply"]
    assert root.parent is None and root.call == root.id
    for name in ("blind_rotate.steps", "bootstrap.key_switch"):
        s = by[name]
        assert s.parent == root.id and s.call == root.id
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    assert by["blind_rotate.steps"].attrs == {"steps": ck.bsk_ntt.shape[0]}
    assert by["blind_rotate.steps"].end_ns <= by["bootstrap.key_switch"].start_ns
    return by


def test_off_by_default_a_span_is_the_shared_no_op():
    assert not profiling.is_recording()
    a = profiling.span("x")
    with profiling.span("y", device=torch.device("cpu"), k=1) as b:
        pass
    assert a is b
    assert profiling.spans() == []


def test_outside_a_profiler_recording_stays_off():
    """Pins the coupling to ``torch.autograd.profiler._is_profiler_enabled``:
    on between a profiler's start and stop, off before and after."""
    prof = profile(activities=[ProfilerActivity.CPU])
    assert not profiling.is_recording()
    prof.start()
    try:
        assert profiling.is_recording()
    finally:
        prof.stop()
    assert not profiling.is_recording()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.is_recording()
        with profiling.recording(False):
            assert not profiling.is_recording()
        assert profiling.is_recording()
    assert not profiling.is_recording()


@pytest.mark.parametrize("how", ["profiler", "recording"])
def test_a_gate_call_records_its_spans(tiny, how):
    ids, a, b, ck = tiny
    if how == "profiler":
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        try:
            gates.apply_gates(ids, a, b, ck)
        finally:
            prof.stop()
    else:
        with profiling.recording():
            gates.apply_gates(ids, a, b, ck)
    by = _check_call(profiling.spans(), ck)
    # no event pair and no sync count on the CPU
    assert all(s.device_ms is None and s.device_at_ms is None
               and s.syncs is None for s in by.values())
    # a call after the stretch records nothing
    gates.apply_gates(ids, a, b, ck)
    assert len(profiling.spans()) == 3


def test_outputs_are_bit_equal_with_recording_on_and_off(tiny):
    ids, a, b, ck = tiny
    with profiling.recording(False):
        off = gates.apply_gates(ids, a, b, ck)
    with profiling.recording():
        on = gates.apply_gates(ids, a, b, ck)
    assert torch.equal(on, off)
    assert profiling.spans()


def test_two_calls_have_their_own_call_ids():
    with profiling.recording():
        for _ in range(2):
            with profiling.span("outer"):
                with profiling.span("mid"):
                    with profiling.span("inner", n=3):
                        pass
    s = profiling.spans()
    assert [x.name for x in s] == ["outer", "mid", "inner"] * 2
    assert [x.parent for x in s] == [None, s[0].id, s[1].id,
                                     None, s[3].id, s[4].id]
    assert [x.call for x in s] == [s[0].id] * 3 + [s[3].id] * 3
    assert s[2].attrs == {"n": 3}
    assert s[0].start_ns <= s[1].start_ns <= s[2].start_ns
    assert s[2].end_ns <= s[1].end_ns <= s[0].end_ns <= s[3].start_ns


def test_past_the_limit_records_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(profiling, "LIMIT", 3)
    with profiling.recording():
        with profiling.span("a"):
            with profiling.span("b"):
                with profiling.span("c"):       # the third record
                    with profiling.span("d"):   # dropped, still nested
                        pass
                with profiling.span("e"):       # dropped
                    pass
    got = profiling.spans()
    assert [x.name for x in got] == ["a", "b", "c"]
    assert got[2].parent == got[1].id and got[2].call == got[0].id
    assert profiling.dropped() == 2
    profiling.clear()
    assert profiling.dropped() == 0


def test_a_new_stretch_of_recording_forgets_the_last():
    """The store holds one stretch: a span refused (recording off) ends
    it, and the next span recorded outside any open span starts anew."""
    for name in ("first", "second"):
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.span(name):
                pass
        with profiling.span("untraced"):
            pass
        assert [x.name for x in profiling.spans()] == [name]
    with profiling.recording():
        with profiling.span("outer"):
            with profiling.recording(False):
                with profiling.span("refused inside"):
                    pass
            with profiling.span("inner"):   # the open call is kept
                pass
    assert [x.name for x in profiling.spans()] == ["outer", "inner"]


def test_the_sync_count_catches_torchs_sync_warnings(monkeypatch):
    """A call's ``syncs`` counts the warnings of torch's sync debug mode,
    set to warn inside it only; other warnings are shown again, and the
    sync warnings too where the mode was on outside."""
    mode = [0]
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode[0])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.__setitem__(0, m))

    def body():
        assert mode[0] == 1
        for _ in range(3):
            warnings.warn("called a synchronizing CUDA operation")
        warnings.warn("another warning")

    for outside, shown_n in ((0, 1), (1, 4)):
        mode[0] = outside
        with warnings.catch_warnings(record=True) as shown:
            warnings.simplefilter("always")
            count = profiling._SyncCount().__enter__()
            body()
            assert count.exit() == 3
        assert mode[0] == outside
        assert len(shown) == shown_n
        assert str(shown[-1].message) == "another warning"


def test_a_profiler_range_lies_inside_a_span_around_it():
    """The spans' clock is the profiler's: a ``record_function`` event's
    start and end fall inside the span taken around it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("around"):
            with record_function("probe"):
                time.sleep(0.002)
    (s,) = profiling.spans()
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "probe"]
    assert len(ev) == 1
    start = ev[0].start_ns()
    assert s.start_ns <= start <= start + ev[0].duration_ns() <= s.end_ns


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device side of the spans")
    return torch.device("cuda", 0)


def _kernel_records(prof):
    from gpubench.trace import kernel_records

    return kernel_records(prof)


def _k1_inputs(dev):
    plan = ntt.plan_for_params(P, 0, 3, (2, 2), bgbit=6, pseudorandom_key=True)
    v = torch.zeros((plan.n_primes, 4, 2, plan.N), dtype=torch.int32, device=dev)
    acc = torch.ones((4, 2, plan.N), dtype=torch.int32, device=dev)
    K1.ntt_inverse_to_crt_acc(v, acc, plan, 0)
    torch.cuda.synchronize()
    return plan, v, acc


@pytest.mark.cuda
def test_a_span_contains_its_synchronised_kernel(dev):
    plan, v, acc = _k1_inputs(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.span("k1", device=dev):
            K1.ntt_inverse_to_crt_acc(v, acc, plan, 0)
            torch.cuda.synchronize()
    (s,) = profiling.spans()
    (k,) = [r for r in _kernel_records(prof) if "ntt_inverse_crt_acc" in r[0]]
    assert s.start_ns <= k[1] <= k[2] <= s.end_ns
    assert 0 < s.device_ms <= (s.end_ns - s.start_ns) / 1e6


@pytest.mark.cuda
def test_the_event_pair_places_a_span_where_the_device_ran_it(dev):
    """The host runs ahead: a long kernel first, then K1 enqueued at once,
    so the host's span around K1's launch closes before K1 runs.  The
    benchmark's reader (``gpubench/program.py``) ties the span's end event
    to K1's record and places the call from the event pairs: the call
    holds the long kernel, the span the kernels of K1's wrapper alone."""
    from gpubench import program, trace, yardstick

    plan, v, acc = _k1_inputs(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.span("gates.apply", device=dev):
            torch.cuda._sleep(20_000_000)
            with profiling.span("blind_rotate.steps", device=dev):
                K1.ntt_inverse_to_crt_acc(v, acc, plan, 0)
        torch.cuda.synchronize()
    call, inner = profiling.spans()
    records = sorted(_kernel_records(prof), key=lambda r: r[1])
    sleep, mine = records[0], records[1:]       # K1's wrapper's kernels
    (k,) = [r for r in mine if "ntt_inverse_crt_acc" in r[0]]
    assert inner.end_ns < mine[0][1]
    assert call.device_at_ms == 0 and inner.device_at_ms > 1
    t = trace.Trace(records=records, launched={}, calls=1, cfg={}, lanes=0,
                    host_spans=[("call", call.start_ns, call.end_ns)],
                    window_ns=call.end_ns - call.start_ns)
    placed = program.calls(t)[0]
    (lo, hi), = placed["blind_rotate.steps"]
    margin = 20_000     # ns
    assert hi == pytest.approx(k[2], abs=1)
    assert lo - margin <= mine[0][1], (lo, mine[0])
    busy = yardstick.union_ns([(s, e) for _, s, e in mine]) / 1e6
    assert program.busy_ms_per_call(t, "blind_rotate.steps") == (
        pytest.approx(busy, abs=margin / 1e6))
    cs, ce = placed["call"]
    assert cs - margin <= sleep[1] and ce >= k[2] - margin, (cs, ce, sleep)


@pytest.mark.cuda
def test_recording_adds_no_kernel_record_on_the_card(dev):
    ids, a, b, ck = _inputs(dev)
    gates.apply_gates(ids, a, b, ck)
    torch.cuda.synchronize()
    names = {}
    for on in (False, True):
        profiling.clear()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with profiling.recording(on):
                out = gates.apply_gates(ids, a, b, ck).cpu()
        names[on] = sorted(r[0] for r in _kernel_records(prof))
    assert names[True] == names[False]
    by = _check_call(profiling.spans(), ck)
    assert by["bootstrap.key_switch"].device_ms > 0
    assert by["gates.apply"].syncs == 5
    assert out.shape == (LANES, P.n0 + 1)
    # where they are: with the sync debug mode on outside, the span shows
    # the warnings again, at the lines that made them
    torch.cuda.set_sync_debug_mode(1)
    try:
        with warnings.catch_warnings(record=True) as shown:
            warnings.simplefilter("always")
            with profiling.recording():
                gates.apply_gates(ids, a, b, ck)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sites = sorted((os.path.basename(w.filename), w.lineno) for w in shown
                   if "synchronizing" in str(w.message))
    # three gate tables in apply_gates, two index tables in sample_extract
    assert [f for f, _ in sites] == ["gates.py"] * 3 + ["trlwe.py"] * 2, sites
