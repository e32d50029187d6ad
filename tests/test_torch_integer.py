"""The port's integer layer (models/integer.py), unsigned and the gates
bridge, against the JAX package's, bit for bit, on TEST_TINY_UINT (N = 256,
n0 = 8, group 2: every blind-rotation step runs K2's plain version, then
K1's).

A JAX-made key (with its packing key) goes to the port through
``CloudKey.from_numpy``; the classic digit multiplier runs on the same key
without its packing key.  The ciphertexts are made with numpy from a seed
and handed to both packages: 4 lanes of 2-digit operands (one equal pair).
Held bit-equal: the LUT bank (every table's bytes) and the digit-multiplier
tables, the trivial constants, ``_pbs`` (shared and per-lane tables),
``radix_add``, ``radix_sub`` (with
``emit_ge8``), ``radix_lt``, ``radix_eq``, ``radix_select``,
``radix_min``/``radix_max``, ``radix_bitwise``, ``radix_shl``/``radix_shr``
at r = 1 and 2, ``digit_mul`` on both paths, ``radix_scale_plain``,
``radix_mul_plain``, ``radix_mask_low``, ``radix_mul`` at 2 x 1 digits,
``to_bools``/``from_bools``, and ``radix_divmod`` and the encrypted-amount
shifts at 1 digit.  The codec is held across packages at the decrypt level
(the RNGs differ).  The port alone: the blind rotations each op makes at 2
digits (the counts the chip script expects), inputs left untouched, the
FheUint operators and the bridge through a scheduled circuit at the decrypt
level, the refusals, and the int64 carriers of the 64-bit torus and the
over-budget demotion of a multi-value round (bit-equal to JAX).  Tolerance: exact equality.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zig_tfhe_tpu import key as JK
from zig_tfhe_tpu import params as JP
from zig_tfhe_tpu import tlwe as JT
from zig_tfhe_tpu.models import integer as JI
from zig_tfhe_tpu_torch import key as TK
from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch import tlwe as TT
from zig_tfhe_tpu_torch.models import gates as TG
from zig_tfhe_tpu_torch.models import integer as TI
from zig_tfhe_tpu_torch.models import lut as TL
from zig_tfhe_tpu_torch.models import scheduler as TS
from zig_tfhe_tpu_torch.ops import blind_rotate

JPAR, TPAR = JP.TEST_TINY_UINT, TP.TEST_TINY_UINT
A = np.array([45, 5, 63, 0])           # 2-digit operands; lane 2 is equal
B = np.array([19, 7, 63, 1])
Y = np.array([1, 3, 0, 7])             # 1-digit amounts / divisors


def _t(a):
    return torch.from_numpy(np.array(a))


def _encrypt_radix(rng, values, D, s, noise=2**18):
    """Radix ciphertexts int32 [len(values), D, n0+1] made with numpy:
    base-8 digits at the PBS codec (m = 16), uniform masks, the body <a, s>
    + mu + integer noise of that std, mod 2^32."""
    digits = (np.asarray(values)[:, None] >> (3 * np.arange(D))) & 7
    mu = np.asarray(JT._encode_message_table(16)).astype(np.int64)[digits]
    a = rng.integers(-2**31, 2**31, digits.shape + (len(s),), dtype=np.int64)
    e = np.round(rng.normal(0, noise, digits.shape)).astype(np.int64)
    b = (a @ np.asarray(s, np.int64) + mu + e) & 0xFFFFFFFF
    ct = np.concatenate([a & 0xFFFFFFFF, b[..., None]], axis=-1)
    return ct.astype(np.uint32).view(np.int32)


def _port_key(ck, device="cpu", **arrays_over):
    arrays = {n: np.asarray(getattr(ck, n)) for n in
              ("testvec", "ksk1", "bsk_ntt", "pksk") if getattr(ck, n) is not None}
    arrays.update(arrays_over)
    arrays = {n: a for n, a in arrays.items() if a is not None}
    gadget = ck.pksk_gadget if "pksk" in arrays else None
    return TK.CloudKey.from_numpy(
        arrays, TPAR, bsk_ntt_drop=ck.bsk_ntt_drop, bsk_group=ck.bsk_group,
        bsk_levels=ck.bsk_levels, bsk_bgbit=ck.bsk_bgbit,
        pksk_gadget=gadget, device=device)



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs its test processes side by side (pytest-xdist); with
    one intra-op thread the port's many small CPU ops do not wait on pool
    threads that another process holds the cores from."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def keys():
    """A JAX TEST_TINY_UINT secret key and cloud key (packing key included),
    the same key without its packing key (the classic digit multiplier),
    and both in the port."""
    sk = JK.SecretKey.generate(jax.random.key(91), JPAR)
    ck = JK.CloudKey.generate(jax.random.key(92), sk, JPAR)
    assert ck.pksk is not None and ck.bsk_group == 2
    ck_classic = dataclasses.replace(ck, pksk=None, pksk_gadget=None)
    return (sk, {"tree": ck, "classic": ck_classic},
            {"tree": _port_key(ck), "classic": _port_key(ck, pksk=None)})


@pytest.fixture(scope="module")
def cts(keys):
    sk = keys[0]
    rng = np.random.default_rng(2024)
    s = np.asarray(sk.key_lv0)
    return {"a": _encrypt_radix(rng, A, 2, s), "b": _encrypt_radix(rng, B, 2, s),
            "y": _encrypt_radix(rng, Y, 1, s),
            "sel": _encrypt_radix(rng, (A < B).astype(int), 1, s)[:, 0]}


def _dec(ct, sk):
    """A port ciphertext of digits [..., D, n0+1] (or a bit [..., n0+1])
    decrypted by the JAX package."""
    x = np.asarray(ct)
    return JI.decrypt_radix(jnp.asarray(x if x.ndim == 3 else x[:, None]),
                            sk.key_lv0)


# name -> (op on (integer module, inputs, key), the value(s) it decrypts to);
# the same code runs on both packages
_OPS = {
    "add": (lambda I, c, k: I.radix_add(c["a"], c["b"], k), A + B),
    "sub": (lambda I, c, k: I.radix_sub(c["a"], c["b"], k),
            ((A - B) % 64, A < B)),
    "sub_ge8": (lambda I, c, k: I.radix_sub(c["a"], c["b"], k, emit_ge8=True)[::2],
                ((A - B) % 64, None)),
    "lt": (lambda I, c, k: I.radix_lt(c["a"], c["b"], k), A < B),
    "eq": (lambda I, c, k: I.radix_eq(c["a"], c["b"], k), A == B),
    "select": (lambda I, c, k: I.radix_select(c["sel"], c["a"], c["b"], k),
               np.where(A < B, A, B)),
    "min": (lambda I, c, k: I.radix_min(c["a"], c["b"], k), np.minimum(A, B)),
    "max": (lambda I, c, k: I.radix_max(c["a"], c["b"], k), np.maximum(A, B)),
    "and": (lambda I, c, k: I.radix_bitwise(c["a"], c["b"], "and", k), A & B),
    "or": (lambda I, c, k: I.radix_bitwise(c["a"], c["b"], "or", k), A | B),
    "xor": (lambda I, c, k: I.radix_bitwise(c["a"], c["b"], "xor", k), A ^ B),
    "shl1": (lambda I, c, k: I.radix_shl(c["a"], 1, k), A << 1),
    "shl2": (lambda I, c, k: I.radix_shl(c["a"], 2, k), A << 2),
    "shl4": (lambda I, c, k: I.radix_shl(c["a"], 4, k), A << 4),
    "shr1": (lambda I, c, k: I.radix_shr(c["a"], 1, k), A >> 1),
    "shr2": (lambda I, c, k: I.radix_shr(c["a"], 2, k), A >> 2),
    "shr4": (lambda I, c, k: I.radix_shr(c["a"], 4, k), A >> 4),
    "scale_plain5": (lambda I, c, k: I.radix_scale_plain(c["a"], 5, k), A * 5),
    "mul_plain10": (lambda I, c, k: I.radix_mul_plain(c["a"], 10, k), A * 10),
    "mask_low4": (lambda I, c, k: I.radix_mask_low(c["a"], 4, k), A & 15),
    "mul_2x1": (lambda I, c, k: I.radix_mul(c["a"], c["b"][:, :1], k),
                A * (B & 7)),
    "pbs": (lambda I, c, k: (I._pbs(c["a"][:, 0], "div", k),
                             I._pbs(c["a"][:, 0], ("mod", "div", "x8", "sign7"), k)),
            ((A & 7) // 8, None)),
    "to_from_bools": (lambda I, c, k: (I.to_bools(c["a"], k),
                                       I.from_bools(I.to_bools(c["a"], k), k),
                                       I.from_bools(I.to_bools(c["a"], k)[:, :4], k)),
                      (None, A, A & 15)),
    # 1 digit, 4 lanes (one divisor 0: the all-ones quotient)
    "divmod_1x1": (lambda I, c, k: I.radix_divmod(c["a"][:, :1], c["y"], k),
                   (np.where(Y > 0, (A & 7) // np.maximum(Y, 1), 7),
                    np.where(Y > 0, (A & 7) % np.maximum(Y, 1), None))),
    "shl_enc": (lambda I, c, k: I.radix_shl_enc(c["a"][:, :1], c["y"], k),
                ((A & 7) << Y) % 8),
    "shr_enc": (lambda I, c, k: I.radix_shr_enc(c["a"][:, :1], c["y"], k),
                (A & 7) >> Y),
}


def _run_both(name, keys, cts, path="tree"):
    sk, jcks, tcks = keys
    fn = _OPS[name][0]
    want = fn(JI, {n: jnp.asarray(v) for n, v in cts.items()}, jcks[path])
    got = fn(TI, {n: _t(v) for n, v in cts.items()}, tcks[path])
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for w, t in zip(want, got):
        assert t.dtype == torch.int32 and np.array_equal(t.numpy(), np.asarray(w))
    return sk, got


@pytest.mark.parametrize("name", sorted(_OPS))
def test_op_bit_equal_to_jax(keys, cts, name):
    sk, got = _run_both(name, keys, cts)
    wants = _OPS[name][1]
    if not isinstance(wants, tuple):
        wants = (wants,)
    for t, w in zip(got, wants):
        if w is None:
            continue
        w = np.asarray(w)
        live = np.array([v is not None for v in w.ravel()]) if w.dtype == object \
            else np.ones(w.shape, bool)
        dec = _dec(t, sk)
        assert np.array_equal(dec[live], w[live].astype(np.int64)), name


@pytest.mark.parametrize("path", ["tree", "classic"])
def test_digit_mul_bit_equal_to_jax(keys, cts, path):
    sk, jcks, tcks = keys
    assert (tcks[path].pksk is None) == (path == "classic")
    want = JI.digit_mul(jnp.asarray(cts["a"][:, 0]), jnp.asarray(cts["b"][:, 0]),
                        jcks[path])
    got = TI.digit_mul(_t(cts["a"][:, 0]), _t(cts["b"][:, 0]), tcks[path])
    for w, t in zip(want, got):
        assert np.array_equal(t.numpy(), np.asarray(w))
    lo, hi = (_dec(t, sk) for t in got)
    assert np.array_equal(lo + 8 * hi, (A & 7) * (B & 7))


def test_lut_bank_and_constants_bit_equal_to_jax(keys):
    jbank, tbank = JI._luts(JPAR), TI._luts(TPAR)
    assert list(tbank) == list(jbank) and len(tbank) == 58
    for n in jbank:
        assert tbank[n].poly.tobytes() == np.asarray(jbank[n].poly, np.int32).tobytes(), n
    rows, tables = TI._bank(TPAR, torch.device("cpu"))
    assert TI._bank(TPAR, torch.device("cpu"))[1] is tables   # built once
    assert np.array_equal(tables.numpy(), np.stack([tbank[n].poly for n in rows]))
    assert np.array_equal(TI._digit_mul_tvs(TPAR), JI._digit_mul_tvs(JPAR))
    assert (TI.BASE, TI.M, TI.radix_spec(32)) == (JI.BASE, JI.M, JI.radix_spec(32))
    for n in ("mod", "pp2hi", "sovf", "low2"):
        assert TI._factored(TPAR, n) == JI._factored(JPAR, n)
    like = np.zeros((3, 2, TPAR.n0 + 1), np.int32)
    for v in (0, 1, 8, 15):
        assert np.array_equal(TI._trivial_digit(v, _t(like[:, 0])).numpy(),
                              np.asarray(JI._trivial_digit(v, jnp.asarray(like[:, 0]))))
    for v, D in ((0, 1), (45, 2), (511, 3), (123456, 6)):
        assert np.array_equal(TI._trivial_radix(v, D, _t(like)).numpy(),
                              np.asarray(JI._trivial_radix(v, D, jnp.asarray(like))))


def test_codec_across_packages(keys):
    """The port's encrypt_radix decrypts under the JAX package's
    decrypt_radix and the reverse (alpha = 0 and the uint4 noise)."""
    sk = keys[0]
    vals = np.array([0, 1, 7, 8, 63, 64, 511, 4095, 2**31 + 5])
    s = _t(np.asarray(sk.key_lv0))
    g = torch.Generator().manual_seed(5)
    for alpha in (0.0, JP.SECURITY_UINT4.tlwe_lv0.alpha):
        ct = TI.encrypt_radix(g, vals, 11, alpha, s)
        assert tuple(ct.shape) == (len(vals), 11, TPAR.n0 + 1)
        assert np.array_equal(JI.decrypt_radix(jnp.asarray(ct.numpy()), sk.key_lv0), vals)
        assert np.array_equal(TI.decrypt_radix(ct, s), vals)
        jct = JI.encrypt_radix(jax.random.key(6), vals, 11, alpha, sk.key_lv0)
        assert np.array_equal(TI.decrypt_radix(_t(jct), s), vals)
    assert TI.decrypt_radix(TI.encrypt_radix(g, 45, 2, 0.0, s), s) == 45


def _ripple_adder_plan(bits):
    """A ``bits``-bit ripple-carry adder built with scheduler.Circuit:
    inputs a_0.., b_0..; outputs the bits + 1 sum bits, little-endian."""
    c = TS.Circuit()
    a_bits = [c.input() for _ in range(bits)]
    b_bits = [c.input() for _ in range(bits)]
    carry = None
    for i in range(bits):
        s1 = c.gate("xor", a_bits[i], b_bits[i])
        gg = c.gate("and", a_bits[i], b_bits[i])
        if carry is None:
            c.output(s1)
            carry = gg
        else:
            c.output(c.gate("xor", s1, carry))
            carry = c.gate("or", gg, c.gate("and", s1, carry))
    c.output(carry)
    return c.schedule()


def _bridge_add(x_digits, y_digits, plan, ck):
    """to_bools of two 1-digit operands (one rotation), the ripple adder on
    the gates, from_bools of its 4 sum bits (one rotation)."""
    bits = TI.to_bools(torch.cat([x_digits, y_digits], dim=-2), ck)
    out = TS.evaluate(plan, bits.movedim(-2, 0), ck)           # [4, B, n0+1]
    return TI.from_bools(out.movedim(0, -2), ck)


@pytest.mark.parametrize("op, digits, want", [
    ("add", 2, 2), ("lt", 2, 2), ("eq", 2, 2), ("mul", 2, 18),
    ("mul_classic", 2, 24), ("divmod", 2, 32), ("add", 1, 1), ("eq", 3, 2),
    ("bridge", 1, 7)])
def test_blind_rotations_per_op(keys, monkeypatch, op, digits, want):
    """The blind rotations each op makes (the chip script expects K2 = K1 =
    410 x this count on uint4); they do not depend on the set.  The bridge
    is to_bools, the 3-bit ripple adder's 5 levels, from_bools."""
    _, _, tcks = keys
    calls = []
    real = blind_rotate.blind_rotate_ntt

    def counted(*args, **kw):
        calls.append(args[0].shape[0])
        return real(*args, **kw)

    g = torch.Generator().manual_seed(3)
    s = _t(np.asarray(keys[0].key_lv0))
    x, y = A % 8**digits, np.maximum(B % 8**digits, 1)
    a = TI.encrypt_radix(g, x, digits, 0.0, s)
    b = TI.encrypt_radix(g, y, digits, 0.0, s)
    ck = tcks["classic" if op == "mul_classic" else "tree"]
    plan = _ripple_adder_plan(3)
    fn = {"add": TI.radix_add, "lt": TI.radix_lt, "eq": TI.radix_eq,
          "mul": TI.radix_mul, "mul_classic": TI.radix_mul,
          "divmod": TI.radix_divmod,
          "bridge": lambda a, b, ck: _bridge_add(a, b, plan, ck)}[op]
    monkeypatch.setattr(blind_rotate, "blind_rotate_ntt", counted)
    out = fn(a, b, ck)
    assert len(calls) == want, calls
    if op == "bridge":
        assert np.array_equal(TI.decrypt_radix(out, s), x + y)


def test_inputs_untouched_and_ops_repeatable(keys, cts):
    """Every op leaves its input tensors as they were, and the same inputs
    give the same outputs twice."""
    _, _, tcks = keys
    ck = tcks["tree"]
    c = {n: _t(v) for n, v in cts.items()}
    before = {n: v.clone() for n, v in c.items()}
    a, b = TI.FheUint(c["a"], ck), TI.FheUint(c["b"], ck)
    y = TI.FheUint(c["y"], ck)
    ops = [lambda: TI.radix_add(c["a"], c["b"], ck),
           lambda: TI.radix_sub(c["a"], c["b"], ck, emit_ge8=True),
           lambda: TI.radix_eq(c["a"], c["b"], ck),
           lambda: TI.radix_select(c["sel"], c["a"], c["b"], ck),
           lambda: TI.radix_shr(c["a"], 3, ck),
           lambda: TI.radix_mask_low(c["a"], 4, ck),
           lambda: TI.radix_mul(c["a"], c["b"], ck),
           lambda: TI.from_bools(TI.to_bools(c["a"], ck), ck),
           lambda: divmod(a, y), lambda: a << y, lambda: a.overflowing_sub(b),
           lambda: (a // 4, a % 4, a * 6, a ^ b, a.max(b))]
    for op in ops:
        first, second = op(), op()
        flat1 = [x.digits if isinstance(x, TI.FheUint) else x
                 for x in (first if isinstance(first, tuple) else (first,))]
        flat2 = [x.digits if isinstance(x, TI.FheUint) else x
                 for x in (second if isinstance(second, tuple) else (second,))]
        assert all(torch.equal(u, v) for u, v in zip(flat1, flat2))
        for n, v in c.items():
            assert torch.equal(v, before[n]), n


def _port_keygen():
    g = torch.Generator().manual_seed(17)
    sk = TK.SecretKey.generate(g, TPAR)
    return g, sk, TK.CloudKey.generate(g, sk, TPAR)


@pytest.fixture(scope="module")
def port_keys():
    """The port's own TEST_TINY_UINT keys (packing key by default)."""
    return _port_keygen()


def _enc(g, v, d, sk, ck):
    return TI.FheUint.encrypt(g, v, d, sk, ck, alpha=0.0)


def test_fheuint_operators(port_keys):
    g, sk, ck = port_keys
    a, b, a2 = _enc(g, 45, 2, sk, ck), _enc(g, 19, 3, sk, ck), _enc(g, 45, 2, sk, ck)
    assert (a + b).decrypt(sk) == 64               # mixed width, widened
    assert (a + 100).decrypt(sk) == 145 and (3 * a).decrypt(sk) == 135
    assert (a * b).decrypt(sk) == 855
    assert (a - _enc(g, 19, 2, sk, ck)).decrypt(sk) == 26
    assert (b - a).decrypt(sk) == (19 - 45) % 512 and (60 - a).decrypt(sk) == 15
    assert ((a == a2).decrypt(sk), (a == b).decrypt(sk), (a != b).decrypt(sk)) == (1, 0, 1)
    assert ((a < b).decrypt(sk), (b < a).decrypt(sk), (a <= a2).decrypt(sk)) == (0, 1, 1)
    assert ((a >= b).decrypt(sk), (a > 45).decrypt(sk), (a >= 45).decrypt(sk)) == (1, 0, 1)
    assert (a.min(b).decrypt(sk), a.max(b).decrypt(sk)) == (19, 45)
    assert ((b < a).select(a, b).decrypt(sk), (a < b).select(a, 7).decrypt(sk)) == (45, 7)
    assert ((a & b).decrypt(sk), (a | b).decrypt(sk), (a ^ b).decrypt(sk)) == (
        45 & 19, 45 | 19, 45 ^ 19)
    for s in (0, 1, 3, 5):
        assert ((a << s).decrypt(sk), (a >> s).decrypt(sk)) == (45 << s, 45 >> s)
    assert (a >> 12).decrypt(sk) == 0
    for v in (0, 1, 2, 3, 10):
        assert (a * v).decrypt(sk) == 45 * v
    for v in (1, 4, 32):
        q, r = divmod(a, v)
        assert (q.decrypt(sk), r.decrypt(sk)) == divmod(45, v)
    s_, c = a.overflowing_add(_enc(g, 30, 2, sk, ck))
    assert (s_.decrypt(sk), c.decrypt(sk)) == (75 - 64, 1)
    d, br = _enc(g, 30, 2, sk, ck).overflowing_sub(a)
    assert (d.decrypt(sk), br.decrypt(sk)) == ((30 - 45) % 64, 1)
    av = _enc(g, np.array([5, 12, 63]), 2, sk, ck)
    bv = _enc(g, np.array([7, 30, 1]), 2, sk, ck)
    assert list((av + bv).decrypt(sk)) == [12, 42, 64]
    assert list((av < bv).decrypt(sk)) == [1, 1, 0]
    assert list(av.min(bv).decrypt(sk)) == [5, 12, 1]


def test_fheuint_divmod_and_encrypted_shifts(port_keys):
    """Division (the all-ones quotient of an encrypted zero divisor) and the
    encrypted-amount shifts at the decrypt level, exact at alpha = 0."""
    g, sk, ck = port_keys
    a, b = _enc(g, 45, 2, sk, ck), _enc(g, 7, 1, sk, ck)
    q, r = divmod(a, b)
    assert (q.decrypt(sk), r.decrypt(sk)) == (6, 3)
    assert ((a // 19).decrypt(sk), (a % 19).decrypt(sk)) == (2, 7)
    assert (100 // b).decrypt(sk) == 14 and divmod(45, b)[0].decrypt(sk) == 6
    assert (a // _enc(g, 0, 1, sk, ck)).decrypt(sk) == 63
    ca, cb = _enc(g, np.array([45, 10, 63]), 2, sk, ck), _enc(g, np.array([6, 10, 1]), 2, sk, ck)
    assert list((ca // cb).decrypt(sk)) == [7, 1, 63]
    assert list((ca % cb).decrypt(sk)) == [3, 0, 0]
    xs, ys = _enc(g, np.array([37, 5, 63]), 2, sk, ck), _enc(g, np.array([1, 2, 6]), 1, sk, ck)
    assert list((xs << ys).decrypt(sk)) == [(37 << 1) % 64, (5 << 2) % 64, 0]
    assert list((xs >> ys).decrypt(sk)) == [18, 1, 0]


def test_bridge_through_gates_and_scheduler(port_keys):
    """FheUint -> bits -> a 3-bit ripple adder built with scheduler.Circuit
    and run by scheduler.evaluate -> bits -> digits; and a gate on the
    bits (models/gates)."""
    g, sk, ck = port_keys
    x, y = np.array([5, 7, 0, 3]), np.array([7, 7, 0, 4])
    cx, cy = _enc(g, x, 1, sk, ck), _enc(g, y, 1, sk, ck)
    bits = torch.cat([TI.to_bools(cx.digits, ck), TI.to_bools(cy.digits, ck)], dim=-2)
    assert np.array_equal(TT.decrypt_bool(bits, sk.key_lv0).numpy(),
                          np.concatenate([(x[:, None] >> np.arange(3)) & 1,
                                          (y[:, None] >> np.arange(3)) & 1], 1))
    total = _bridge_add(cx.digits, cy.digits, _ripple_adder_plan(3), ck)
    assert np.array_equal(TI.decrypt_radix(total, sk.key_lv0), x + y)
    anded = TG.gate("and", bits[:, :3], bits[:, 3:], ck)
    assert np.array_equal(TI.decrypt_radix(TI.from_bools(anded, ck), sk.key_lv0), x & y)


def test_refusals(keys, cts, monkeypatch):
    sk, jcks, tcks = keys
    ck = tcks["tree"]
    s = _t(np.asarray(sk.key_lv0))
    # width 64 (once refused): the int64 carriers equal the JAX package's
    g = torch.Generator().manual_seed(3)
    wide = TI.encrypt_radix(g, np.array([5, 63]), 2, 0.0, s, width=64)
    assert wide.dtype == torch.int64 and wide.shape == (2, 2, TPAR.n0 + 1)
    assert np.array_equal(TI.decrypt_radix(wide, s), [5, 63])
    assert np.array_equal(JI.decrypt_radix(jnp.asarray(wide.numpy()),
                                           sk.key_lv0), [5, 63])
    jwide = jnp.asarray(wide.numpy())
    assert np.array_equal(TI._trivial_digit(1, wide[:, 0]).numpy(),
                          np.asarray(JI._trivial_digit(1, jwide[:, 0])))
    assert np.array_equal(TI._trivial_radix(5, 2, wide).numpy(),
                          np.asarray(JI._trivial_radix(5, 2, jwide)))
    for name, table in TI._luts(TP.TEST_TINY64).items():
        want = JI._luts(JP.TEST_TINY64)[name].poly
        assert table.poly.dtype == want.dtype == np.int64
        assert np.array_equal(table.poly, want), name
    assert np.array_equal(TI._digit_mul_tvs(TP.TEST_TINY64),
                          JI._digit_mul_tvs(JP.TEST_TINY64))
    p64 = TP.TEST_TINY64
    sk64 = TK.SecretKey.generate(g, p64)
    ck64 = TK.CloudKey.generate(g, sk64, p64)
    bits = TT.encrypt_bool(g, torch.tensor([[1, 0, 1, 1]], dtype=torch.bool),
                           0.0, sk64.key_lv0, width=64)
    assert np.array_equal(TI.decrypt_radix(TI.from_bools(bits, ck64),
                                           sk64.key_lv0), [13])
    # an over-budget factored table (a 64-bit key's budget is finite):
    # the call is demoted to one rotation lane per table, as in JAX
    monkeypatch.setattr(TL, "mid_norm1_budget", lambda ck: 1.0)
    monkeypatch.setattr(JI.L, "mid_norm1_budget", lambda ck: 1.0)
    groups = (("pp0lo", "pp0hi"),) * 2
    got = TI._pbs_mv_groups(_t(cts["a"]).movedim(-2, 0), groups,
                            tcks["classic"])
    want = JI._pbs_mv_groups(jnp.moveaxis(jnp.asarray(cts["a"]), -2, 0),
                             groups, jcks["classic"])
    assert np.array_equal(got.numpy(), np.asarray(want))
    monkeypatch.undo()
    # the packing key's gadget contract and its row count
    x, y = _t(cts["a"][:, 0]), _t(cts["b"][:, 0])
    bad = TK.CloudKey.from_numpy(
        {n: t.numpy() for n, t in ck.named_buffers()}, TPAR,
        bsk_ntt_drop=ck.bsk_ntt_drop, bsk_group=ck.bsk_group,
        bsk_levels=ck.bsk_levels, bsk_bgbit=ck.bsk_bgbit,
        pksk_gadget=(TPAR.basebit + 1, TPAR.iks_t), device="cpu")
    with pytest.raises(ValueError, match="basebit"):
        TI.digit_mul(x, y, bad)
    with pytest.raises(ValueError, match="basebit"):
        JI.digit_mul(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
                     dataclasses.replace(jcks["tree"],
                                         pksk_gadget=(TPAR.basebit + 1, TPAR.iks_t)))
    bad2 = _port_key(jcks["tree"], pksk=np.asarray(jcks["tree"].pksk)[:TPAR.n1])
    bad2.pksk_gadget = None
    with pytest.raises(ValueError, match="rows"):
        TI.digit_mul(x, y, bad2)
    # an encrypted comparison has no Python truth value
    a = TI.FheUint(_t(cts["a"]), ck)
    with pytest.raises(TypeError, match="decrypt"):
        bool(a == a)
    with pytest.raises(TypeError, match="decrypt"):
        if a < 4:
            pass
    with pytest.raises(TypeError, match="unhashable"):
        hash(a)
    assert (a == None) is False and (a != "x") is True      # noqa: E711
    with pytest.raises(TypeError):
        a & 1.5
    with pytest.raises(ValueError, match="unsigned"):
        a + (-1)
