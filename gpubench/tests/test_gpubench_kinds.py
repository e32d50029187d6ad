"""The traffic kinds (``gpubench/kinds/``): the gate draws as they were
before the kind moved into a file of its own, the dispatch on a mix's
``kind``, and the ``lut`` kind rehearsed on the CPU at TEST_TINY_UINT
(a cell added to ``tiny_root`` as data only): correct, while its control
and its planted faults are not, and its calls' spans."""

import hashlib

import numpy as np
import pytest
import torch
from conftest import LUT_M16, ROOT

from gpubench import manifest, run, system, traffic
from gpubench.reference import gates as ref_gates
from gpubench.reference import lut as ref_lut

SEED = 2 ** 31 + 4242
CELL = "tiny_uint.lut_m16"
KIND_ATTRS = ("draw", "Program", "judge", "WRONG", "CALL_SPAN", "ENQUEUE")

# sha256 of the gate ids (int64), x and y (bool) of gates_b2048, and of the
# lv0 then lv1 secret keys (int32) of g3 (700, 1024) and t64 (742, 2048),
# as the harness drew them before the gates kind moved into kinds/gates.py
GATE_DRAWS = {
    1: "8812c83f3ae24112d6cecf49a0a649c6952f531870535b392b4bc48db95186d7",
    2: "517abc2bd4f36ab70a1dd4e3d78546e71727426d47b8bdf0fc74070f035bfea3"}
SECRET_KEYS = {
    (1, 700, 1024): "797a4d32b18595357b39e66cf2c04aa9376bc31f77210c3db16b19effdac84be",
    (1, 742, 2048): "a415b4a0a0a749048dcb230ce7901eb1c8a9bd346536534a0caa87ca83d81c9b",
    (2, 700, 1024): "95d4da61c6e0305293da2673c8ae52af1353b167db9f537b41ba255f345c1c26",
    (2, 742, 2048): "3021ec38ba257387687e9a4036bd6cc21de5152eafca5a9be326c831c9a3827a"}


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed", sorted(GATE_DRAWS))
def test_the_gate_draws_are_those_of_before_the_move(seed):
    mix = traffic.draw(manifest.Bench(ROOT).traffic("gates_b2048"), seed)
    assert (mix.lanes, mix.pool, mix.warm_calls, mix.trace_calls) == (2048, 8, 2, 6)
    assert _digest(mix.gate_ids.astype("<i8"), mix.x, mix.y) == GATE_DRAWS[seed]


@pytest.mark.parametrize("seed, n0, n1", sorted(SECRET_KEYS))
def test_the_secret_keys_are_those_of_before_the_move(seed, n0, n1):
    k0, k1 = system.secret_keys(seed, n0, n1)
    assert _digest(k0.astype("<i4"), k1.astype("<i4")) == SECRET_KEYS[seed, n0, n1]


@pytest.mark.parametrize("name", ["gates", "lut"])
def test_each_kind_is_a_file_with_what_the_harness_reads(name):
    kind = manifest.kind(name)
    assert all(hasattr(kind, a) for a in KIND_ATTRS)
    assert all(callable(getattr(kind.Program, a)) for a in ("encrypt", "apply", "free"))
    assert kind.WRONG != "noise_sd"


def test_the_harness_dispatches_on_the_kind():
    assert manifest.kind("gates").CALL_SPAN == "gates.apply"
    assert manifest.kind("gates").ENQUEUE == "enqueue apply_gates"
    assert manifest.kind("lut").CALL_SPAN == "lut.call"
    assert type(traffic.draw(LUT_M16, SEED)).__name__ == "LutMix"
    for bad in (None, "circuit", "../run", "gates/../lut"):
        with pytest.raises(ValueError, match="traffic kind"):
            traffic.draw(dict(LUT_M16, kind=bad), SEED)


def test_the_lut_draw():
    one, two = traffic.draw(LUT_M16, SEED), traffic.draw(LUT_M16, SEED)
    assert np.array_equal(one.x, two.x) and np.array_equal(one.fn_ids, two.fn_ids)
    assert not np.array_equal(one.x, traffic.draw(LUT_M16, SEED + 1).x)
    assert one.x.shape == one.fn_ids.shape == (4, 64)
    assert one.functions == ref_lut.FUNCTION_NAMES
    assert set(np.unique(one.x)) <= set(range(16))
    assert set(np.unique(one.fn_ids)) == set(range(len(ref_lut.FUNCTION_NAMES)))
    some = traffic.draw(dict(LUT_M16, functions=["carry", "msb"]), SEED)
    assert some.functions == ("carry", "msb")
    assert set(np.unique(some.fn_ids)) == {0, 1}
    with pytest.raises(ValueError, match="power of two"):
        traffic.draw(dict(LUT_M16, message_modulus=12), SEED)
    with pytest.raises(ValueError, match="functions"):
        traffic.draw(dict(LUT_M16, functions=["cube"]), SEED)


def _run(root, seed=SEED, seconds=0.3, **kw):
    bench = manifest.Bench(root)
    return bench, run.run_cell(bench, CELL, seed, seconds, False, "cpu", **kw)


def test_a_rehearsal_of_the_lut_cell(tiny_root):
    bench, r = _run(tiny_root, seconds=1.0)
    assert r["correct"] and r["failed"] == 0
    w = r["window"]
    assert r["attempted"] == w.calls * w.lanes == w.calls * LUT_M16["lanes"]
    assert list(r["check"]) == ["wrong_values", "noise_sd"]
    line = run.result_line(bench, CELL, r, False, "cpu")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "check"]
    assert list(line["metrics"]) == ["setup_s"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_lut_control_comes_out_not_correct(tiny_root, seed):
    bench = manifest.Bench(tiny_root)
    key = bench.config("tiny_uint")["control_key"]
    _, r = _run(tiny_root, seed=seed, key_form=key)
    assert not r["correct"]
    assert r["check"]["noise_sd"]["value"] > r["check"]["noise_sd"]["limit"]
    _, r = _run(tiny_root, seed=seed)
    assert r["correct"]


def _zeroed_mask(monkeypatch):
    """The blind rotation's mask zeroed: every step leaves the accumulator
    as it was."""
    from zig_tfhe_tpu_torch import bootstrap

    real = bootstrap.blind_rotate

    def broken(tlwe, testvec, ck, params):
        t = tlwe.clone()
        t[..., :params.n0] = 0
        return real(t, testvec, ck, params)

    monkeypatch.setattr(bootstrap, "blind_rotate", broken)


def _other_function(monkeypatch):
    """One lane a call given another lane's test vector, where the two
    functions differ at the lane's input (read with the seed's key)."""
    from zig_tfhe_tpu_torch import bootstrap

    real = bootstrap.bootstrap_with_testvec
    m = LUT_M16["message_modulus"]

    def broken(ct, tv, ck):
        p = ck.params
        key, _ = system.secret_keys(SEED, p.n0, p.n1)
        u = ref_gates.phases(ct.numpy(), key, p.torus_bits).view(np.uint64)
        shift = p.torus_bits - m.bit_length()
        x = ((u + np.uint64(1 << (shift - 1))) >> np.uint64(shift)) % np.uint64(m)
        tv = tv.clone()
        for j in range(tv.shape[0]):
            at = int(x[j]) * p.N // m       # the centre of x's box
            other = (tv[:, 1, at] != tv[j, 1, at]).nonzero()
            if len(other):
                tv[j] = tv[int(other[0])]
                return real(ct, tv, ck)
        raise AssertionError("no two lanes' functions differ")

    monkeypatch.setattr(bootstrap, "bootstrap_with_testvec", broken)


def _shifted_output(monkeypatch):
    """One lane's output moved by one bin of Z_m where it is produced."""
    from zig_tfhe_tpu_torch import bootstrap

    real = bootstrap.bootstrap_with_testvec
    m = LUT_M16["message_modulus"]

    def broken(ct, tv, ck):
        out = real(ct, tv, ck)
        out[0, -1] += 1 << (ck.params.torus_bits - m.bit_length())
        return out

    monkeypatch.setattr(bootstrap, "bootstrap_with_testvec", broken)


def _half_batch(monkeypatch):
    """Half of the batch left out; its lanes taken from the other half."""
    from zig_tfhe_tpu_torch import bootstrap

    real = bootstrap.bootstrap_with_testvec

    def broken(ct, tv, ck):
        h = (ct.shape[0] + 1) // 2
        out = real(ct[:h], tv[:h], ck)
        return torch.cat([out, out])[:ct.shape[0]]

    monkeypatch.setattr(bootstrap, "bootstrap_with_testvec", broken)


@pytest.mark.parametrize("fault", [_zeroed_mask, _other_function,
                                   _shifted_output, _half_batch])
def test_a_planted_fault_in_the_lut_path_comes_out_not_correct(
        tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    _, r = _run(tiny_root)
    assert not r["correct"]
    assert r["failed"] > 0


def test_a_recorded_lut_call_holds_the_programs_spans(tiny_root):
    from zig_tfhe_tpu_torch.utils import profiling

    bench = manifest.Bench(tiny_root)
    kind = manifest.kind("lut")
    prog = kind.Program(bench.config("tiny_uint"), SEED, "cpu")
    pool = prog.encrypt(traffic.draw(bench.traffic("lut_m16"), SEED))
    profiling.clear()
    try:
        with profiling.recording():
            prog.apply(pool, 0)
        found = profiling.spans()
    finally:
        profiling.clear()
    (root,) = [s for s in found if s.parent is None]
    assert root.name == kind.CALL_SPAN == "lut.call"
    inside = {s.name for s in found if s.call == root.id and s is not root}
    assert {"blind_rotate.steps", "bootstrap.key_switch"} <= inside
