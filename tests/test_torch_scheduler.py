"""The port's netlists and level scheduler against the JAX package.

Netlist text must be byte-equal; plans (the same native scheduler, built
separately by each package) array-equal; ``evaluate`` bit-equal to JAX's
on a TEST_TINY cloud key made by the JAX package (group 3) and carried into
the port, on ciphertexts JAX encrypted from numpy-seeded bits: the w = 8
Bristol multiplier, random circuits with every lane kind, and the serving
mode.  Malformed circuits raise ValueError, as in tests/test_scheduler.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import TRUTH_TABLES
from zig_tfhe_tpu import key as JK
from zig_tfhe_tpu import params as JP
from zig_tfhe_tpu import tlwe as JT
from zig_tfhe_tpu.models import netlists as JN
from zig_tfhe_tpu.models import scheduler as JS
from zig_tfhe_tpu_torch import key as TK
from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch import tlwe as TT
from zig_tfhe_tpu_torch.models import gates as TG
from zig_tfhe_tpu_torch.models import netlists as TN
from zig_tfhe_tpu_torch.models import scheduler as TS


@pytest.fixture(scope="module")
def jax_keys():
    sk = JK.SecretKey.generate(jax.random.key(17), JP.TEST_TINY)
    ck = JK.CloudKey.generate(jax.random.key(18), sk, JP.TEST_TINY, group=3)
    return sk, ck


@pytest.fixture(scope="module")
def port_key(jax_keys):
    _, ck = jax_keys
    return TK.CloudKey.from_numpy(
        {k: np.asarray(getattr(ck, k)) for k in ("testvec", "ksk1", "bsk_ntt")},
        TP.TEST_TINY, bsk_ntt_drop=ck.bsk_ntt_drop, bsk_group=ck.bsk_group,
        bsk_levels=ck.bsk_levels, bsk_bgbit=ck.bsk_bgbit, device="cpu")


def _encrypt(sk, bits, seed):
    """JAX ciphertexts of ``bits`` (any shape), as numpy int32."""
    return np.asarray(JT.encrypt_bool(jax.random.key(seed),
                                      jnp.asarray(np.asarray(bits, bool)),
                                      0.0, sk.key_lv0))


def _both_evaluate(jax_keys, port_key, jplan, tplan, cts):
    _, ck = jax_keys
    want = np.asarray(JS.evaluate(jplan, jnp.asarray(cts), ck))
    got = TS.evaluate(tplan, torch.from_numpy(cts.copy()), port_key)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    return got


def _assert_plans_equal(jplan, tplan):
    assert tplan.n_slots == jplan.n_slots
    assert tplan.n_levels == jplan.n_levels
    for a, b in zip(jplan.levels, tplan.levels):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(tplan.input_slots, jplan.input_slots)
    assert np.array_equal(tplan.output_slots, jplan.output_slots)


def _full_adder(S):
    c = S.Circuit()
    a, b, cin = c.input(), c.input(), c.input()
    x, g = c.gate("xor", a, b), c.gate("and", a, b)
    s, t = c.gate("xor", x, cin), c.gate("and", x, cin)
    c.output(s)
    c.output(c.gate("or", g, t))
    return c


def _not_copy_const_mux(S):
    c = S.Circuit()
    a, b = c.input(), c.input()
    na = c.not_(a)
    m = c.mux(na, c.copy(b), c.const(True))        # (!a) ? b : 1
    c.output(m)
    c.output(na)
    return c


_BRISTOL_FA = """\
5 8
2 1 1
2 1 0 1 3 XOR
2 1 0 1 4 AND
2 1 3 2 5 XOR
2 1 3 2 6 AND
2 1 4 6 7 OR
"""


@pytest.mark.parametrize("w", [4, 8, 64])
def test_netlist_text_byte_equal(w):
    text = TN.bristol_multiplier(w)
    assert text.encode() == JN.bristol_multiplier(w).encode()
    rng = np.random.default_rng(w)
    bits = rng.integers(0, 2, 2 * w).tolist()
    got = TN.eval_bristol_plain(text, bits)
    assert got == JN.eval_bristol_plain(text, bits)
    a = sum(v << i for i, v in enumerate(bits[:w]))
    b = sum(v << i for i, v in enumerate(bits[w:]))
    assert sum(v << i for i, v in enumerate(got)) == a * b


@pytest.mark.parametrize("which", ["full_adder", "not_copy_const_mux",
                                   "bristol_fa", "mult8", "mult64"])
def test_plan_array_equal(which):
    if which == "full_adder":
        jplan, tplan = _full_adder(JS).schedule(), _full_adder(TS).schedule()
        assert [len(l) for l in tplan.levels] == [2, 2, 1]
    elif which == "not_copy_const_mux":
        jplan = _not_copy_const_mux(JS).schedule()
        tplan = TS.schedule(_not_copy_const_mux(TS))
    else:
        text = {"bristol_fa": _BRISTOL_FA, "mult8": TN.bristol_multiplier(8),
                "mult64": TN.bristol_multiplier(64)}[which]
        jplan, tplan = JS.parse_bristol(text), TS.parse_bristol(text)
    _assert_plans_equal(jplan, tplan)
    if which == "mult64":
        boot = sum(int((l[:, 0] < 100).sum()) for l in tplan.levels)
        assert (tplan.n_gates, boot, tplan.n_levels, tplan.n_slots,
                max(len(l) for l in tplan.levels)) == (26931, 26803, 43,
                                                       5908, 2048)
    assert TS.SUPER_LEVEL_CAP == 2048


def test_evaluate_multiplier_w8_bit_equal(jax_keys, port_key):
    sk, _ = jax_keys
    text = TN.bristol_multiplier(8)
    jplan, tplan = JS.parse_bristol(text), TS.parse_bristol(text)
    a, b = 202, 142
    bits = [(a >> i) & 1 for i in range(8)] + [(b >> i) & 1 for i in range(8)]
    out = _both_evaluate(jax_keys, port_key, jplan, tplan,
                         _encrypt(sk, bits, 31))
    dec = TT.decrypt_bool(out, torch.from_numpy(np.array(sk.key_lv0)))
    assert sum(int(v) << i for i, v in enumerate(dec.tolist())) == a * b


def _random_spec(rng, n_in, n_gates):
    """A random DAG over every lane kind: (op, args) per gate, where args
    index the wires made so before (inputs first), plus 4 output wires."""
    spec = []
    for k in range(n_gates):
        n_wires = n_in + k
        kind = int(rng.integers(0, 9))
        if kind <= 4:
            spec.append((TG.GATE_NAMES[rng.integers(0, 10)],
                         rng.integers(0, n_wires, 2).tolist()))
        elif kind == 5:
            spec.append(("not", [int(rng.integers(0, n_wires))]))
        elif kind == 6:
            spec.append(("copy", [int(rng.integers(0, n_wires))]))
        elif kind == 7:
            spec.append(("const", [bool(rng.integers(0, 2))]))
        else:
            spec.append(("mux", rng.integers(0, n_wires, 3).tolist()))
    outs = rng.integers(n_in, n_in + n_gates, 4).tolist()
    return spec, outs


def _build(S, n_in, spec, outs):
    c = S.Circuit()
    wires = [c.input() for _ in range(n_in)]
    for op, args in spec:
        if op == "not":
            wires.append(c.not_(wires[args[0]]))
        elif op == "copy":
            wires.append(c.copy(wires[args[0]]))
        elif op == "const":
            wires.append(c.const(args[0]))
        elif op == "mux":
            wires.append(c.mux(*(wires[i] for i in args)))
        else:
            wires.append(c.gate(op, wires[args[0]], wires[args[1]]))
    for i in outs:
        c.output(wires[i])
    return c.schedule()


def _simulate(n_in, spec, outs, bits):
    v = [bool(b) for b in bits]
    for op, args in spec:
        if op == "not":
            v.append(not v[args[0]])
        elif op == "copy":
            v.append(v[args[0]])
        elif op == "const":
            v.append(args[0])
        elif op == "mux":
            v.append(v[args[1]] if v[args[0]] else v[args[2]])
        else:
            v.append(TRUTH_TABLES[op](v[args[0]], v[args[1]]))
    return [v[i] for i in outs]


@pytest.mark.parametrize("trial", range(2))
def test_evaluate_random_circuits_bit_equal(jax_keys, port_key, trial):
    sk, _ = jax_keys
    rng = np.random.default_rng(100 + trial)
    n_in = 4
    spec, outs = _random_spec(rng, n_in, 12)
    jplan, tplan = _build(JS, n_in, spec, outs), _build(TS, n_in, spec, outs)
    _assert_plans_equal(jplan, tplan)
    bits = rng.integers(0, 2, n_in)
    out = _both_evaluate(jax_keys, port_key, jplan, tplan,
                         _encrypt(sk, bits, trial))
    dec = TT.decrypt_bool(out, torch.from_numpy(np.array(sk.key_lv0)))
    assert dec.tolist() == _simulate(n_in, spec, outs, bits)


def test_evaluate_serving_mode_bit_equal(jax_keys, port_key):
    """The w = 4 multiplier over B = 3 clients in one pass, [8, 3, n0+1]."""
    sk, _ = jax_keys
    text = TN.bristol_multiplier(4)
    jplan, tplan = JS.parse_bristol(text), TS.parse_bristol(text)
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 16, (2, 3))
    bits = np.array([(vals[i // 4] >> (i % 4)) & 1 for i in range(8)], bool)
    out = _both_evaluate(jax_keys, port_key, jplan, tplan,
                         _encrypt(sk, bits, 9))
    assert out.shape == (8, 3, TP.TEST_TINY.n0 + 1)
    dec = TT.decrypt_bool(out, torch.from_numpy(np.array(sk.key_lv0)))
    prods = (dec.numpy().astype(np.int64) << np.arange(8)[:, None]).sum(0)
    assert np.array_equal(prods, vals[0] * vals[1])
    # one client alone through the unbatched form gives its column
    single = TS.evaluate(tplan, out.new_tensor(_encrypt(sk, bits[:, 1], 9)),
                         port_key)
    assert single.shape == (8, TP.TEST_TINY.n0 + 1)


def test_parse_errors_and_cycles_raise():
    with pytest.raises(ValueError, match="parse error"):
        TS.parse_bristol("garbage")
    with pytest.raises(ValueError, match="unsupported gate"):
        TS.parse_bristol("1 4\n2 1 1\n2 1 0 1 3 FROB\n")
    with pytest.raises(ValueError, match="cycle"):
        TS.parse_bristol("1 3\n2 0 1\n2 1 0 2 2 AND\n")
    with pytest.raises(ValueError, match="written twice"):
        TS.parse_bristol("2 3\n2 0 1\n2 1 0 1 2 AND\n2 1 1 0 2 OR\n")
    with pytest.raises(ValueError, match="out of range"):
        TS.parse_bristol("1 3\n2 0 1\n2 1 0 99999999 2 AND\n")
    with pytest.raises(ValueError, match="arity"):
        TS.parse_bristol("1 3\n2 0 1\n-5 1 0 1 2 AND\n")
    with pytest.raises(ValueError, match="unreasonable"):
        TS.parse_bristol("1 999999999999\n2 0 1\n2 1 0 1 2 AND\n")
    with pytest.raises(ValueError, match="never written"):
        TS.parse_bristol("1 4\n2 0 2\n2 1 0 1 2 AND\n")


def test_unresolved_and_aliased_slots_raise(port_key):
    plan = _full_adder(TS).schedule()
    TS._check_no_unresolved_slots(plan)
    for row, col in ((0, 1), (0, 2), (2, 4)):
        bad = TS.Plan([l.copy() for l in plan.levels], plan.n_slots,
                      plan.input_slots, plan.output_slots)
        bad.levels[min(row, len(bad.levels) - 1)][0, col] = -1
        with pytest.raises(ValueError, match="unresolved"):
            TS._check_no_unresolved_slots(bad)
    with pytest.raises(ValueError, match="unresolved"):
        TS._check_no_unresolved_slots(TS.Plan(plan.levels, plan.n_slots,
                                              plan.input_slots,
                                              np.array([0, -1], np.int32)))
    # two lanes of one level writing one slot are refused before any work
    levels = [l.copy() for l in plan.levels]
    levels[0][1, 4] = levels[0][0, 4]
    cts = torch.zeros((3, TP.TEST_TINY.n0 + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="twice"):
        TS.evaluate(TS.Plan(levels, plan.n_slots, plan.input_slots,
                            plan.output_slots), cts, port_key)
    with pytest.raises(ValueError, match="inputs must be"):
        TS.evaluate(plan, cts[:2], port_key)
