"""The port's signed integers (models/integer.py: FheInt,
``radix_lt_signed``, ``radix_asr``, ``radix_asr_enc``) against the JAX
package's, bit for bit, on TEST_TINY_UINT.

A JAX-made key (with its packing key) goes to the port through
``CloudKey.from_numpy``; two's-complement operands are made with numpy from
a seed (4 lanes, 2 digits: range [-32, 32); 1-digit ones for the sign
extension, the truncating division and the encrypted-amount shift) and
handed to both packages, whose FheInt handles run the same expression.
Held bit-equal: + - (both ways) and negation, the signed comparisons,
min/max and select, the arithmetic shift by plain amounts (sub-digit,
digit-aligned and past the width), the wrapping left shift, the plain
negative multiplier, ``overflowing_add``, ``abs``, the sign extension of a
narrower operand, ``div_rem`` and ``>>`` by an encrypted amount.  The port
alone, on its own keys at alpha = 0: every operator exact against Python's
two's-complement arithmetic at the decrypt level, and inputs left
untouched.  Tolerance: exact equality.
"""

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
from zig_tfhe_tpu_torch.models import integer as TI
from zig_tfhe_tpu_torch.ops import blind_rotate

JPAR, TPAR = JP.TEST_TINY_UINT, TP.TEST_TINY_UINT
SA = np.array([-21, 13, -32, 5])       # 2 digits: [-32, 32)
SB = np.array([13, -21, 2, 5])
SA1 = np.array([-3, 3, -4, 2])         # 1 digit: [-4, 4)
SB1 = np.array([2, -2, 1, 3])
Y = np.array([1, 3, 0, 7])             # unsigned 1-digit amounts


def _wrap(v, D=2):
    half = 8**D // 2
    return (np.asarray(v) + half) % (2 * half) - half


def _encrypt_radix(rng, values, D, s, noise=2**18):
    """Two's-complement radix ciphertexts int32 [len(values), D, n0+1] made
    with numpy (the PBS codec, m = 16; uniform masks; integer noise)."""
    raw = np.mod(np.asarray(values), 8**D)
    digits = (raw[:, None] >> (3 * np.arange(D))) & 7
    mu = np.asarray(JT._encode_message_table(16)).astype(np.int64)[digits]
    a = rng.integers(-2**31, 2**31, digits.shape + (len(s),), dtype=np.int64)
    e = np.round(rng.normal(0, noise, digits.shape)).astype(np.int64)
    b = (a @ np.asarray(s, np.int64) + mu + e) & 0xFFFFFFFF
    ct = np.concatenate([a & 0xFFFFFFFF, b[..., None]], axis=-1)
    return ct.astype(np.uint32).view(np.int32)



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
    sk = JK.SecretKey.generate(jax.random.key(93), JPAR)
    ck = JK.CloudKey.generate(jax.random.key(94), sk, JPAR)
    arrays = {n: np.asarray(getattr(ck, n)) for n in
              ("testvec", "ksk1", "bsk_ntt", "pksk")}
    tck = TK.CloudKey.from_numpy(
        arrays, TPAR, bsk_ntt_drop=ck.bsk_ntt_drop, bsk_group=ck.bsk_group,
        bsk_levels=ck.bsk_levels, bsk_bgbit=ck.bsk_bgbit,
        pksk_gadget=ck.pksk_gadget, device="cpu")
    rng = np.random.default_rng(77)
    s = np.asarray(sk.key_lv0)
    cts = {"x": _encrypt_radix(rng, SA, 2, s), "y": _encrypt_radix(rng, SB, 2, s),
           "x1": _encrypt_radix(rng, SA1, 1, s), "y1": _encrypt_radix(rng, SB1, 1, s),
           "u": _encrypt_radix(rng, Y, 1, s)}
    return sk, ck, tck, cts


# name -> (expression on the handles of one package, the value(s) it
# decrypts to); u is an unsigned 1-digit amount (FheUint)
_EXPRS = {
    "add": (lambda h: h["x"] + h["y"], _wrap(SA + SB)),
    "sub": (lambda h: h["x"] - h["y"], _wrap(SA - SB)),
    "rsub": (lambda h: 5 - h["x"], _wrap(5 - SA)),
    "neg": (lambda h: -h["x"], _wrap(-SA)),
    "lt": (lambda h: h["x"] < h["y"], SA < SB),
    "ge": (lambda h: h["x"] >= h["y"], SA >= SB),
    "lt_zero": (lambda h: h["x"] < 0, SA < 0),
    "min": (lambda h: h["x"].min(h["y"]), np.minimum(SA, SB)),
    "max": (lambda h: h["x"].max(h["y"]), np.maximum(SA, SB)),
    "select": (lambda h: (h["x"] < h["y"]).select(h["x"], h["y"]),
               np.where(SA < SB, SA, SB)),
    "asr1": (lambda h: h["x"] >> 1, SA >> 1),
    "asr2": (lambda h: h["x"] >> 2, SA >> 2),
    "asr3": (lambda h: h["x"] >> 3, SA >> 3),
    "asr4": (lambda h: h["x"] >> 4, SA >> 4),
    "asr7": (lambda h: h["x"] >> 7, SA >> 7),
    "shl1": (lambda h: h["x"] << 1, _wrap(SA << 1)),
    "mul_neg3": (lambda h: h["x"] * -3, _wrap(SA * -3)),
    "overflowing_add": (lambda h: h["x"].overflowing_add(h["y"]),
                        (_wrap(SA + SB), (SA + SB != _wrap(SA + SB)).astype(int))),
    "abs": (lambda h: h["x"].abs(), _wrap(np.abs(SA))),
    "sign_extend": (lambda h: h["x1"] + h["y"], _wrap(SA1 + SB)),
    "div_rem_1": (lambda h: h["x1"].div_rem(h["y1"]),
                  (np.trunc(SA1 / SB1).astype(int),
                   SA1 - np.trunc(SA1 / SB1).astype(int) * SB1)),
    "asr_enc": (lambda h: h["x"] >> h["u"], SA >> Y),
}


def _handles(I, cts, ck, tensor):
    h = {n: I.FheInt(tensor(v), ck) for n, v in cts.items() if n != "u"}
    h["u"] = I.FheUint(tensor(cts["u"]), ck)
    return h


@pytest.mark.parametrize("name", sorted(_EXPRS))
def test_fheint_bit_equal_to_jax(keys, name):
    sk, jck, tck, cts = keys
    expr, wants = _EXPRS[name]
    want = expr(_handles(JI, cts, jck, jnp.asarray))
    got = expr(_handles(TI, cts, tck, lambda a: torch.from_numpy(np.array(a))))
    if not isinstance(want, tuple):
        want, got, wants = (want,), (got,), (wants,)
    for w, t, v in zip(want, got, wants):
        assert type(t).__name__ == type(w).__name__
        assert t.digits.dtype == torch.int32
        assert np.array_equal(t.digits.numpy(), np.asarray(w.digits))
        dec = JI.FheInt(jnp.asarray(t.digits.numpy()), jck).decrypt(sk)
        assert np.array_equal(dec, np.asarray(v).astype(np.int64)), name


@pytest.fixture(scope="module")
def port_keys():
    g = torch.Generator().manual_seed(19)
    sk = TK.SecretKey.generate(g, TPAR)
    return g, sk, TK.CloudKey.generate(g, sk, TPAR)


def _senc(g, v, d, sk, ck):
    return TI.FheInt.encrypt(g, v, d, sk, ck, alpha=0.0)


def test_fheint_arith_compare_shift(port_keys):
    """Two's-complement semantics of every operator (the JAX package's
    tests/test_integer_signed.py cases), at the decrypt level."""
    g, sk, ck = port_keys
    a, b, a2 = _senc(g, -21, 2, sk, ck), _senc(g, 13, 2, sk, ck), _senc(g, -21, 2, sk, ck)
    assert ((a + b).decrypt(sk), (a - b).decrypt(sk), (b - a).decrypt(sk)) == (-8, 30, -30)
    assert ((-a).decrypt(sk), (a * b).decrypt(sk)) == (21, (-21 * 13) % 64 - 64)
    with pytest.raises(ValueError, match="range"):
        _senc(g, 40, 2, sk, ck)
    assert ((a < b).decrypt(sk), (b < a).decrypt(sk), (a == a2).decrypt(sk)) == (1, 0, 1)
    assert ((a != b).decrypt(sk), (a <= a2).decrypt(sk), (a >= b).decrypt(sk)) == (1, 1, 0)
    assert ((a < 0).decrypt(sk), (b > -1).decrypt(sk)) == (1, 1)
    assert (a.min(b).decrypt(sk), a.max(b).decrypt(sk)) == (-21, 13)
    w = _senc(g, -100, 3, sk, ck)
    assert ((w < a).decrypt(sk), (a + w).decrypt(sk), w.max(a).decrypt(sk)) == (1, -121, -21)
    for s in (0, 1, 2, 3, 4, 7):
        assert (w >> s).decrypt(sk) == -100 >> s, s
    assert (w >> 12).decrypt(sk) == -1
    p = _senc(g, 100, 3, sk, ck)
    assert ((p >> 2).decrypt(sk), (p >> 12).decrypt(sk)) == (25, 0)
    assert ((w << 1).decrypt(sk), (p << 3).decrypt(sk)) == (-200, (100 << 3) - 1024)
    c = _senc(g, 37, 3, sk, ck)
    assert (w & c).decrypt(sk) % 512 == (-100 & 37) & 511
    assert (w ^ c).decrypt(sk) % 512 == (-100 ^ 37) & 511
    s = _senc(g, -21, 2, sk, ck)
    assert ((s * 2).decrypt(sk), (s * -1).decrypt(sk), (s * 0).decrypt(sk),
            (s * 3).decrypt(sk)) == (22, 21, 0, 1)
    r, o = _senc(g, 20, 2, sk, ck).overflowing_add(_senc(g, 20, 2, sk, ck))
    assert (r.decrypt(sk), o.decrypt(sk)) == (40 - 64, 1)
    r, o = _senc(g, 20, 2, sk, ck).overflowing_add(_senc(g, 11, 2, sk, ck))
    assert (r.decrypt(sk), o.decrypt(sk)) == (31, 0)
    with pytest.raises(ValueError, match="ciphertext branch"):
        (a < b).select(1, 2)
    av, bv = _senc(g, np.array([-5, 30, -32]), 2, sk, ck), _senc(g, np.array([7, -30, 1]), 2, sk, ck)
    assert list((av + bv).decrypt(sk)) == [2, 0, -31]
    assert list((av < bv).decrypt(sk)) == [1, 0, 1]
    assert list(av.min(bv).decrypt(sk)) == [-5, -30, -32]


def test_fheint_abs_div_rem_and_encrypted_shift(port_keys):
    """abs, truncating div_rem (with the INT_MIN edge) and the arithmetic
    shift by an encrypted amount, at the decrypt level (alpha = 0)."""
    g, sk, ck = port_keys
    a, b = _senc(g, -21, 2, sk, ck), _senc(g, 13, 2, sk, ck)
    assert (a.abs().decrypt(sk), b.abs().decrypt(sk)) == (21, 13)
    q, r = a.div_rem(b)                      # -21 = 13 * (-1) - 8
    assert (q.decrypt(sk), r.decrypt(sk)) == (-1, -8)
    q, r = (-b).div_rem(-a)                  # -13 / 21 -> 0 rem -13
    assert (q.decrypt(sk), r.decrypt(sk)) == (0, -13)
    q, r = _senc(g, -32, 2, sk, ck).div_rem(_senc(g, 2, 2, sk, ck))
    assert (q.decrypt(sk), r.decrypt(sk)) == (-16, 0)
    sx = _senc(g, -100, 3, sk, ck)
    for y in (1, 4, 12):
        cy = TI.FheUint.encrypt(g, y, 2, sk, ck, alpha=0.0)
        assert (sx >> cy).decrypt(sk) == -100 >> y, y


@pytest.mark.parametrize("op, want", [
    ("add", 2), ("sub", 2), ("lt", 3), ("asr2", 2), ("asr_enc", 10),
    ("abs", 7), ("div_rem", 55)])
def test_fheint_blind_rotations_per_op(port_keys, monkeypatch, op, want):
    """The blind rotations of each FheInt op at 2 digits (a 1-digit
    unsigned amount for the encrypted shift): the chip script expects K2 =
    K1 = 410 x this count on uint4."""
    g, sk, ck = port_keys
    x, y = _senc(g, SA, 2, sk, ck), _senc(g, SB, 2, sk, ck)
    u = TI.FheUint.encrypt(g, Y, 1, sk, ck, alpha=0.0)
    fn = {"add": lambda: x + y, "sub": lambda: x - y, "lt": lambda: x < y,
          "asr2": lambda: x >> 2, "asr_enc": lambda: x >> u,
          "abs": lambda: x.abs(), "div_rem": lambda: x.div_rem(y)}[op]
    calls = []
    real = blind_rotate.blind_rotate_ntt
    monkeypatch.setattr(blind_rotate, "blind_rotate_ntt",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    fn()
    assert len(calls) == want


def test_fheint_inputs_untouched(port_keys):
    """The signed ops (their sign-digit replacements, sign extension,
    arithmetic shifts) leave their inputs as they were and repeat."""
    g, sk, ck = port_keys
    a, b = _senc(g, np.array([-21, 7]), 2, sk, ck), _senc(g, np.array([13, -7]), 2, sk, ck)
    n = _senc(g, np.array([-3, 2]), 1, sk, ck)
    before = [x.digits.clone() for x in (a, b, n)]
    for op in (lambda: a < b, lambda: a >> 4, lambda: a >> 2, lambda: n + a,
               lambda: a.abs(), lambda: a.overflowing_add(b)[0],
               lambda: TI.radix_lt_signed(a.digits, b.digits, ck),
               lambda: n.div_rem(n)[1]):
        first, second = op(), op()
        first = first.digits if isinstance(first, TI.FheInt) else first
        second = second.digits if isinstance(second, TI.FheInt) else second
        assert torch.equal(first, second)
        assert all(torch.equal(x.digits, y) for x, y in zip((a, b, n), before))
