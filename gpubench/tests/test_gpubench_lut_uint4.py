"""The cell ``uint4.lut_b2048`` and its two readers of the program's new
records: ``testvec_ms_per_call`` (span ``blind_rotate.testvec``) and
``plain_digit_steps_per_call`` (attribute ``plain_digit_steps`` of
``blind_rotate.steps``), on synthetic records, on the tiny root's recorded
calls, and beside the g3 and t64 cells, which read what they read
before."""

import json
import time

import numpy as np
import pytest
import torch
from conftest import ROOT
from test_gpubench_program_spans import HOST, MS, READERS, _call, _kernels

from gpubench import manifest, run, trace, traffic
from gpubench.manifest import Bench, reader
from zig_tfhe_tpu_torch.utils import profiling
from zig_tfhe_tpu_torch.utils.profiling import Span

NEW = ("testvec_ms_per_call", "plain_digit_steps_per_call")
CELL = "uint4.lut_b2048"
SEED = 2 ** 33 + 7
GAPS = [(0.5, 1.5), (4.75, 5.25), (8.875, 9.125), (12.75, 13.25),
        (20.75, 21.25)]
# what the two accepted cells read before this cell and its readers
G3_BEFORE = ["idle_share.batch", "k2_roofline", "k1_roofline",
             "glue_us_per_step", "idle_ms_per_call.prelude",
             "idle_ms_per_call.steps", "idle_ms_per_call.finish",
             "key_switch_ms_per_call", "host_syncs_per_call"]
T64_BEFORE = ["idle_share.batch", "k1_roofline", "glue_us_per_step",
              "idle_ms_per_call.prelude", "idle_ms_per_call.steps",
              "idle_ms_per_call.finish", "key_switch_ms_per_call",
              "host_syncs_per_call", "k2s_roofline", "k2s_steps_per_call"]


def _lut_call(first_id, t0, plain=410):
    """``_call``'s spans under ``lut.call``, with ``lut.apply`` around
    them, the test vectors' rotation from 0.5 to 1.5 ms on both clocks
    and ``plain`` steps' digits made outside K1."""
    spans = _call(first_id, t0, root="lut.call")
    root, steps, ks = spans
    inner = first_id + 10
    apply = Span("lut.apply", inner, root.id, root.id, t0, t0 + 10 * MS,
                 10.0, 0.0, None, {})
    tv = Span("blind_rotate.testvec", inner + 1, inner, root.id,
              t0 + MS // 2, t0 + 3 * MS // 2, 1.0, 0.5, None, {})
    attrs = {"steps": 410, "fused_steps": 410 - plain,
             "plain_digit_steps": plain}
    return [root, apply, tv, steps._replace(parent=inner, attrs=attrs),
            ks._replace(parent=inner)]


def _trace(records, cfg="uint4", call_span="lut.call"):
    return trace.Trace(records=records, launched={}, host_spans=HOST, calls=2,
                       window_ns=24 * MS, cfg=Bench(ROOT).config(cfg),
                       lanes=2048, call_span=call_span)


@pytest.fixture
def recorded(monkeypatch):
    def put(spans):
        monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    return put


def test_the_new_readers_by_hand(recorded):
    recorded(_lut_call(1, 0) + _lut_call(40, 12 * MS, plain=1))
    # call 1's rotation (0.5-1.5 ms) lies in the gap 0.5-1.5, busy 0;
    # call 2's (12.5-13.5) holds the gap 12.75-13.25, busy 0.5 ms
    t = _trace(_kernels(GAPS))
    assert reader("testvec_ms_per_call")(t) == pytest.approx((0.0 + 0.5) / 2)
    assert reader("plain_digit_steps_per_call")(t) == (410 + 1) / 2


def test_the_new_records_leave_the_other_readers_as_they_were(recorded):
    """The same calls with and without ``lut.apply`` and the test vectors'
    span read alike in every accepted program reader."""
    recorded(_call(1, 0, root="lut.call") + _call(4, 12 * MS, root="lut.call"))
    want = {m: reader(m)(_trace(_kernels(GAPS))) for m in READERS}
    recorded(_lut_call(1, 0) + _lut_call(40, 12 * MS))
    got = {m: reader(m)(_trace(_kernels(GAPS))) for m in READERS}
    assert got == pytest.approx(want)
    assert all(v is not None for v in got.values())


def test_nothing_to_read_from_a_program_without_the_records(recorded):
    """The parent's program: no ``blind_rotate.testvec`` span, no
    ``plain_digit_steps``; the readers return None and do not raise."""
    recorded(_call(1, 0, root="lut.call") + _call(4, 12 * MS, root="lut.call"))
    t = _trace(_kernels(GAPS))
    assert all(reader(m)(t) is None for m in NEW)
    recorded([])
    assert all(reader(m)(t) is None for m in NEW)
    # off a card: the attribute is read, no span is placed
    recorded([s._replace(device_ms=None, device_at_ms=None)
              for s in _lut_call(1, 0) + _lut_call(40, 12 * MS)])
    assert reader("testvec_ms_per_call")(t) is None
    assert reader("plain_digit_steps_per_call")(t) == 410


def test_the_cells_report_their_lists():
    bench = Bench(ROOT)
    names = {c: [x["name"] for x in bench.per_layer(c)]
             for c in ("g3.gates_b2048", "t64.gates_b2048", CELL)}
    assert names["t64.gates_b2048"] == T64_BEFORE
    assert names["g3.gates_b2048"] == G3_BEFORE + ["testvec_ms_per_call"]
    assert names[CELL] == G3_BEFORE + list(NEW)
    assert [x["name"] for x in bench.end_to_end(CELL)] == ["bootstraps_per_s",
                                                           "setup_s"]
    by = {x["name"]: x for x in bench.m["per_layer"]}
    assert (by["testvec_ms_per_call"]["source"],
            by["plain_digit_steps_per_call"]["source"]) == ("program_span",
                                                            "program_counter")
    assert by["plain_digit_steps_per_call"]["layer"] == by["glue_us_per_step"]["layer"]


def test_the_configuration_is_the_ports_uint4_set():
    from zig_tfhe_tpu_torch import params

    bench = Bench(ROOT)
    cfg = bench.config("uint4")
    p = params.PARAMS_BY_NAME[cfg["params"]]
    assert p is params.SECURITY_UINT4
    assert (p.torus_bits, p.n0, p.N, p.tlwe_lv0.alpha, p.tlwe_lv1.alpha,
            p.bgbit, p.L, p.basebit, p.iks_t, p.split_ring) == tuple(
        cfg[k] for k in ("torus_bits", "n0", "N", "lwe_alpha", "glwe_alpha",
                         "bg_bits", "levels", "ks_base_bits", "ks_levels",
                         "split_ring"))
    assert cfg["key"]["engine_bgbit"] == cfg["bg_bits"]
    assert cfg["control_key"]["engine_bgbit"] < cfg["bg_bits"]
    mix = traffic.draw(bench.traffic("lut_b2048"), SEED)
    assert (mix.lanes, mix.message_modulus, mix.pool) == (2048, 16, 8)
    assert len(mix.functions) == 7


def _recorded_call(root, cell):
    bench = manifest.Bench(root)
    cfg = bench.config(bench.cell(cell)["config"])
    kind = manifest.kind(bench.traffic(bench.cell(cell)["traffic"])["kind"])
    prog = kind.Program(cfg, SEED, "cpu")
    mix = traffic.draw(bench.traffic(bench.cell(cell)["traffic"]), SEED)
    pool = prog.encrypt(mix)
    profiling.clear()
    try:
        with profiling.recording():
            t0 = time.time_ns()
            prog.apply(pool, 0)
            prog.apply(pool, 1)
            t1 = time.time_ns()
        t = trace.Trace(records=[], launched={}, host_spans=[("call", t0, t1)],
                        calls=2, window_ns=t1 - t0, cfg=cfg, lanes=mix.lanes,
                        call_span=kind.CALL_SPAN)
        return t, {m: reader(m)(t) for m in NEW}, profiling.spans()
    finally:
        profiling.clear()


@pytest.mark.parametrize("cell, plain", [("tiny_uint.lut_m16", 4),
                                         ("tiny.gates_b2048", 1)])
def test_a_rehearsal_of_the_new_readers(tiny_root, cell, plain):
    """Two calls recorded on the CPU: TEST_TINY_UINT's 2-limb digits are
    made outside K1 on each of its 4 steps, TEST_TINY's one-limb group-2
    digits on step 0 alone; the test vectors' span is recorded but, off a
    card, not placed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t, got, found = _recorded_call(tiny_root, cell)
    finally:
        torch.set_num_threads(n)
    assert got == {"testvec_ms_per_call": None,
                   "plain_digit_steps_per_call": plain}
    roots = [s for s in found if s.parent is None]
    assert [s.name for s in roots] == [t.call_span] * 2
    assert sum(s.name == "blind_rotate.testvec" for s in found) == 2


@pytest.mark.cuda
def test_a_short_traced_run_of_the_cell_on_the_card(cuda_device):
    bench = manifest.Bench(ROOT)
    r = run.run_cell(bench, CELL, SEED, 2.0, True, cuda_device)
    line = run.result_line(bench, CELL, r, True, cuda_device)
    print(json.dumps({k: line[k] for k in ("correct", "metrics", "device",
                                           "check")}))
    assert line["correct"]
    assert set(line["metrics"]) == {x["name"] for x in bench.per_layer(CELL)}
    assert line["metrics"]["plain_digit_steps_per_call"]["value"] == 410
    assert np.isfinite(line["metrics"]["testvec_ms_per_call"]["value"])


def test_loading_the_32_bit_reference_loads_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); import gpubench.reference.pbs32;"
            "from gpubench import importcheck as c;"
            "print(c.refused(sys.modules, c.REFUSED_IN_REFERENCE))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"
