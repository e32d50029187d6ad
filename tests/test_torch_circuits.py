"""The port's TRLWE boolean surface, gate surface and circuits against the
JAX package.

A TEST_TINY cloud key made by the JAX package (group 3) is carried into the
port; ciphertexts are JAX encryptions of numpy-seeded bits.  Every function
must return the JAX package's int32 ciphertexts bit for bit: ``trlwe.phase``,
the 10 named gate wrappers, ``mux_naive``, ``gate_pair``, ``full_adder``,
``ripple_carry_add`` and ``kogge_stone_add`` (one operand pair and a client
batch).  The port's own encryptions (torch.Generator randomness) are held at
the decrypt level.
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
from zig_tfhe_tpu import trlwe as JR
from zig_tfhe_tpu.models import circuits as JC
from zig_tfhe_tpu.models import gates as JG
from zig_tfhe_tpu_torch import key as TK
from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch import tlwe as TT
from zig_tfhe_tpu_torch import trlwe as TR
from zig_tfhe_tpu_torch.models import circuits as TC
from zig_tfhe_tpu_torch.models import gates as TG

_X = np.array([False, False, True, True])
_Y = np.array([False, True, False, True])


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def keys():
    """(JAX secret key, JAX cloud key, the cloud key in the port, the port's
    secret key)."""
    sk = JK.SecretKey.generate(jax.random.key(27), JP.TEST_TINY)
    ck = JK.CloudKey.generate(jax.random.key(28), sk, JP.TEST_TINY, group=3)
    port_ck = TK.CloudKey.from_numpy(
        {k: np.asarray(getattr(ck, k)) for k in ("testvec", "ksk1", "bsk_ntt")},
        TP.TEST_TINY, bsk_ntt_drop=ck.bsk_ntt_drop, bsk_group=ck.bsk_group,
        bsk_levels=ck.bsk_levels, bsk_bgbit=ck.bsk_bgbit, device="cpu")
    port_sk = TK.SecretKey.from_numpy(np.asarray(sk.key_lv0),
                                      np.asarray(sk.key_lv1), device="cpu")
    return sk, ck, port_ck, port_sk


def _encrypt(sk, bits, seed):
    """JAX ciphertexts of ``bits`` (any shape), as numpy int32."""
    return np.asarray(JT.encrypt_bool(jax.random.key(seed),
                                      jnp.asarray(np.asarray(bits, bool)),
                                      0.0, sk.key_lv0))


def test_trlwe_phase_bit_equal_and_bool_roundtrip(keys):
    sk, _, _, port_sk = keys
    P = JP.TEST_TINY
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (3, P.N)).astype(bool)
    ct = np.asarray(JR.encrypt_bool(jax.random.key(4), jnp.asarray(bits),
                                    P.trlwe_lv1.alpha, sk.key_lv1))
    want = np.asarray(JR.phase(jnp.asarray(ct), sk.key_lv1))
    got = TR.phase(_t(ct), port_sk.key_lv1)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(TR.decrypt_bool(_t(ct), port_sk.key_lv1).numpy(),
                          bits)
    # the port's encryption, at the 128-bit set's ring noise, decrypts in
    # both packages
    g = torch.Generator().manual_seed(5)
    alpha = TP.SECURITY_128_BIT.trlwe_lv1.alpha
    ct2 = TR.encrypt_bool(g, _t(bits), alpha, port_sk.key_lv1)
    assert ct2.shape == (3, 2, P.N) and ct2.dtype == torch.int32
    assert np.array_equal(TR.decrypt_bool(ct2, port_sk.key_lv1).numpy(), bits)
    assert np.array_equal(
        np.asarray(JR.decrypt_bool(jnp.asarray(ct2.numpy()), sk.key_lv1)),
        bits)


@pytest.mark.parametrize("name", ["nand", "or_", "and_", "xor", "xnor", "nor",
                                  "andny", "andyn", "orny", "oryn"])
def test_named_gate_wrappers_bit_equal(keys, name):
    sk, ck, port_ck, port_sk = keys
    a, b = _encrypt(sk, _X, 1), _encrypt(sk, _Y, 2)
    want = np.asarray(getattr(JG, name)(jnp.asarray(a), jnp.asarray(b), ck))
    got = getattr(TG, name)(_t(a), _t(b), port_ck)
    assert np.array_equal(got.numpy(), want)
    truth = TRUTH_TABLES[name.rstrip("_")]
    assert TT.decrypt_bool(got, port_sk.key_lv0).tolist() == [
        truth(bool(x), bool(y)) for x, y in zip(_X, _Y)]


def test_mux_naive_and_gate_pair_bit_equal(keys):
    sk, ck, port_ck, port_sk = keys
    a, b = _encrypt(sk, _X, 1), _encrypt(sk, _Y, 2)
    c = a[::-1].copy()
    want = np.asarray(JG.mux_naive(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(c), ck))
    got = TG.mux_naive(_t(a), _t(b), _t(c), port_ck)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(TT.decrypt_bool(got, port_sk.key_lv0).numpy(),
                          np.where(_X, _Y, _X[::-1]))
    want = np.asarray(JG.gate_pair(("xor", "andny"), (jnp.asarray(a),) * 2,
                                   (jnp.asarray(b), jnp.asarray(c)), ck))
    got = TG.gate_pair(("xor", "andny"), (_t(a), _t(a)), (_t(b), _t(c)),
                       port_ck)
    assert got.shape == (2, 4, TP.TEST_TINY.n0 + 1)
    assert np.array_equal(got.numpy(), want)


def test_full_adder_bit_equal(keys):
    sk, ck, port_ck, port_sk = keys
    combos = np.array([(a, b, c) for a in (0, 1) for b in (0, 1)
                       for c in (0, 1)], bool).T             # [3, 8]
    cts = [_encrypt(sk, combos[i], 81 + i) for i in range(3)]
    want = JC.full_adder(*(jnp.asarray(x) for x in cts), ck)
    got = TC.full_adder(*(_t(x) for x in cts), port_ck)
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), np.asarray(w))
    total = combos.sum(0)
    assert np.array_equal(TT.decrypt_bool(got[0], port_sk.key_lv0).numpy(),
                          total % 2 == 1)
    assert np.array_equal(TT.decrypt_bool(got[1], port_sk.key_lv0).numpy(),
                          total >= 2)


def test_ripple_carry_add_4bit_bit_equal(keys):
    sk, ck, port_ck, port_sk = keys
    a = _encrypt(sk, JC.to_bits(9, 4), 84)
    b = _encrypt(sk, JC.to_bits(8, 4), 85)
    cin = JG.constant(False, JP.TEST_TINY, batch=(1,))
    ws, wc = JC.ripple_carry_add(jnp.asarray(a), jnp.asarray(b), cin, ck)
    gs, gc = TC.ripple_carry_add(
        _t(a), _t(b), TG.constant(False, TP.TEST_TINY, (1,), device="cpu"),
        port_ck)
    assert np.array_equal(gs.numpy(), np.asarray(ws))
    assert np.array_equal(gc.numpy(), np.asarray(wc))
    assert TC.decrypt_bits(gs, port_sk) == (9 + 8) % 16
    assert bool(TT.decrypt_bool(gc, port_sk.key_lv0)[0])


def test_kogge_stone_402_plus_304_bit_equal(keys):
    sk, ck, port_ck, port_sk = keys
    a = _encrypt(sk, TC.to_bits(402, 16), 84)
    b = _encrypt(sk, TC.to_bits(304, 16), 85)
    ws, wc = JC.kogge_stone_add(jnp.asarray(a), jnp.asarray(b), ck)
    gs, gc = TC.kogge_stone_add(_t(a), _t(b), port_ck)
    assert np.array_equal(gs.numpy(), np.asarray(ws))
    assert np.array_equal(gc.numpy(), np.asarray(wc))
    assert TC.decrypt_bits(gs, port_sk) == 706


def test_kogge_stone_client_batch_bit_equal(keys):
    """8-bit Kogge-Stone over 4 clients in one pass ([W, B, n0+1])."""
    sk, ck, port_ck, port_sk = keys
    rng = np.random.default_rng(3)
    av, bv = rng.integers(0, 256, 4), rng.integers(0, 256, 4)
    a = _encrypt(sk, (av >> np.arange(8)[:, None]) & 1, 2)
    b = _encrypt(sk, (bv >> np.arange(8)[:, None]) & 1, 3)
    ws, wc = JC.kogge_stone_add(jnp.asarray(a), jnp.asarray(b), ck)
    gs, gc = TC.kogge_stone_add(_t(a), _t(b), port_ck)
    assert gs.shape == (8, 4, TP.TEST_TINY.n0 + 1) and gc.shape[:2] == (1, 4)
    assert np.array_equal(gs.numpy(), np.asarray(ws))
    assert np.array_equal(gc.numpy(), np.asarray(wc))
    dec = TT.decrypt_bool(torch.cat([gs, gc]), port_sk.key_lv0).numpy()
    assert np.array_equal((dec.astype(np.int64) << np.arange(9)[:, None])
                          .sum(0), av + bv)


def test_bit_codecs_and_port_encryption(keys):
    _, _, port_ck, port_sk = keys
    for w, v in [(8, 0b10101010), (16, 0b1010101010101010), (32, 0xDEADBEEF),
                 (64, 0xDEADBEEFCAFEBABE)]:
        bits = TC.to_bits(v, w)
        assert np.array_equal(bits, JC.to_bits(v, w))
        assert TC.from_bits(bits) == v
    assert [a.width for a in (TC.U8AsBits, TC.U16AsBits, TC.U32AsBits,
                              TC.U64AsBits)] == [8, 16, 32, 64]
    g = torch.Generator().manual_seed(80)
    ct = TC.U16AsBits.encrypt(g, 402, port_sk, TP.TEST_TINY)
    assert ct.shape == (16, TP.TEST_TINY.n0 + 1) and ct.dtype == torch.int32
    assert TC.decrypt_bits(ct, port_sk) == 402
