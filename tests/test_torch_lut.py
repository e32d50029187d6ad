"""Programmable bootstrapping of the port (models/lut.py) against the JAX
package's, bit for bit, on TEST_TINY_UINT (N = 256, n0 = 8, group 2, Bg_e
2^11 with 2-limb digits: every blind-rotation step runs K2's multi-limb
plain version, then K1's).

A JAX-made key (with its packing key) goes to the port through
``CloudKey.from_numpy``; the ciphertexts are made with numpy from a seed
and handed to both packages.  Held bit-equal: the Encoder and Generator
tables, the message codec, ``bootstrap_with_testvec`` and the strategy
pair, ``bootstrap_lut`` (one shared table and per-lane tables),
``factor_lut`` and ``bootstrap_multi_lut``, ``tree_pbs`` in both select
shapes (m = 32 interleaved, m = 64 per-family) through
``bootstrap_lut_radix`` and its chaining, ``bootstrap_lut_bivariate``, and
``mid_norm1_budget`` at every 32-bit set (and its formula at the 64-bit
sets on a stand-in key).  The port's own keygen is held at the decrypt
level: truth tables at alpha = 0.  Tolerance: exact equality.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zig_tfhe_tpu import bootstrap as JB
from zig_tfhe_tpu import key as JK
from zig_tfhe_tpu import params as JP
from zig_tfhe_tpu import tlwe as JT
from zig_tfhe_tpu.models import lut as JL
from zig_tfhe_tpu_torch import bootstrap as TB
from zig_tfhe_tpu_torch import key as TK
from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch import tlwe as TT
from zig_tfhe_tpu_torch.models import lut as TL

JPAR, TPAR = JP.TEST_TINY_UINT, TP.TEST_TINY_UINT


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def keys():
    """A JAX TEST_TINY_UINT secret key and cloud key (packing key included)
    and the same cloud key in the port."""
    sk = JK.SecretKey.generate(jax.random.key(81), JPAR)
    ck = JK.CloudKey.generate(jax.random.key(82), sk, JPAR)
    assert ck.pksk is not None and ck.bsk_group == 2 and ck.bsk_bgbit == 11
    arrays = {n: np.asarray(getattr(ck, n)) for n in
              ("testvec", "ksk1", "bsk_ntt", "pksk")}
    tck = TK.CloudKey.from_numpy(
        arrays, TPAR, bsk_ntt_drop=ck.bsk_ntt_drop, bsk_group=ck.bsk_group,
        bsk_levels=ck.bsk_levels, bsk_bgbit=ck.bsk_bgbit,
        pksk_gadget=ck.pksk_gadget, device="cpu")
    return sk, ck, tck


def _encrypt(rng, msgs, m, s, noise=0):
    """TLWE lv0 ciphertexts of the PBS codec, made with numpy: uniform
    masks, the body <a, s> + mu (+ integer noise of that std) mod 2^32."""
    msgs = np.asarray(msgs) % m
    mu = np.asarray(JT._encode_message_table(m)).astype(np.int64)[msgs]
    a = rng.integers(-2**31, 2**31, (len(msgs), len(s)), dtype=np.int64)
    e = np.round(rng.normal(0, noise, len(msgs))).astype(np.int64) if noise else 0
    b = (a @ np.asarray(s, np.int64) + mu + e) & 0xFFFFFFFF
    ct = np.concatenate([a & 0xFFFFFFFF, b[:, None]], axis=1)
    return ct.astype(np.uint32).view(np.int32)


def _both(ct):
    return jnp.asarray(ct), _t(ct)


def _dec(ct, m, sk):
    return np.asarray(JT.decrypt_message(jnp.asarray(np.asarray(ct)), m,
                                         sk.key_lv0))


@pytest.mark.parametrize("m", [2, 4, 8, 16, 32])
def test_encoder_and_generator_tables_match_jax(m):
    je, te = JL.Encoder.new(m), TL.Encoder.new(m)
    assert [te.encode(x) for x in range(2 * m)] == [je.encode(x) for x in range(2 * m)]
    vals = [0, 1, 2**31 - 1, 2**31, 2**32 - 1, 123456789]
    assert [te.decode(v) for v in vals] == [je.decode(v) for v in vals]
    assert te.encode_with_scale(3, 0.01) == je.encode_with_scale(3, 0.01)
    jg, tg = JL.Generator.new(m, JPAR), TL.Generator.new(m, TPAR)
    for f in (lambda x: x, lambda x: (3 * x + 1) % m, lambda x: x * x % m):
        assert np.array_equal(tg.generate_lookup_table(f).poly,
                              np.asarray(jg.generate_lookup_table(f).poly))
    full = lambda x: x * 0x01020304       # noqa: E731
    assert np.array_equal(tg.generate_lookup_table_full(full).poly,
                          jg.generate_lookup_table_full(full).poly)
    assert np.array_equal(
        tg.generate_lookup_table_custom(lambda x: x % 4, 4, 1 / 16).poly,
        jg.generate_lookup_table_custom(lambda x: x % 4, 4, 1 / 16).poly)
    assert [tg.mod_switch(v) for v in vals] == [jg.mod_switch(v) for v in vals]
    assert TL.div_round(7, 2) == JL.div_round(7, 2) == 4
    assert np.array_equal(TL.multi_lut_base(m, 256), JL.multi_lut_base(m, 256))
    ts_ = TL.Generator.with_scale(m, 1 / (4 * m), TPAR)
    js_ = JL.Generator.with_scale(m, 1 / (4 * m), JPAR)
    assert np.array_equal(ts_.generate_lookup_table(lambda x: x).poly,
                          js_.generate_lookup_table(lambda x: x).poly)
    # the LookupTable surface: from_poly copies, as_torch, clear, copy_from
    table = tg.generate_lookup_table(lambda x: (x + 1) % m)
    lt = TL.LookupTable.from_poly(_t(table.poly))
    assert lt.poly is not table.poly and not lt.is_empty()
    assert torch.equal(lt.as_torch("cpu"), _t(table.poly))
    other = TL.LookupTable.new(TPAR.N)
    assert other.is_empty()
    other.copy_from(lt)
    assert np.array_equal(other.get_poly(), table.poly)
    lt.clear()
    assert lt.is_empty() and not other.is_empty()


def test_message_codec_matches_jax(keys):
    sk, _, _ = keys
    for m in (2, 16, 64):
        assert np.array_equal(TT._encode_message_table(m),
                              np.asarray(JT._encode_message_table(m)))
    rng = np.random.default_rng(1)
    ct = _encrypt(rng, np.arange(40), 16, sk.key_lv0, noise=2**22)
    got = TT.decrypt_message(_t(ct), 16, _t(sk.key_lv0))
    assert np.array_equal(got.numpy(), _dec(ct, 16, sk))
    # the port's encryption decrypts to its messages (alpha = 0)
    g = torch.Generator().manual_seed(2)
    ct2 = TL.encrypt_message(g, torch.arange(20), 16, 0.0, _t(sk.key_lv0))
    assert np.array_equal(TL.decrypt_message(ct2, 16, _t(sk.key_lv0)).numpy(),
                          np.arange(20) % 16)


def test_bootstrap_with_testvec_and_strategy_match_jax(keys):
    sk, ck, tck = keys
    assert TB.STRATEGY_NAME == JB.STRATEGY_NAME == "vanilla"
    js, ts = JB.default_bootstrap(), TB.default_bootstrap()
    assert ts.name == js.name
    assert (ts.bootstrap, ts.bootstrap_without_key_switch) == (
        TB.bootstrap, TB.bootstrap_to_lv1)
    custom = TB.BootstrapStrategy(TB.bootstrap, TB.bootstrap_to_lv1)
    assert custom.name == JB.BootstrapStrategy(JB.bootstrap,
                                               JB.bootstrap_to_lv1).name
    rng = np.random.default_rng(3)
    ct = _encrypt(rng, np.arange(6), 16, sk.key_lv0)
    tv = rng.integers(-2**31, 2**31, (6, 2, TPAR.N)).astype(np.int32)
    jct, tct = _both(ct)
    want = np.asarray(JB.bootstrap_with_testvec(jct, jnp.asarray(tv), ck))
    assert np.array_equal(TB.bootstrap_with_testvec(tct, _t(tv), tck).numpy(),
                          want)
    want = np.asarray(js.bootstrap_without_key_switch(jct, ck))
    assert np.array_equal(ts.bootstrap_without_key_switch(tct, tck).numpy(),
                          want)


@pytest.mark.parametrize("m", [4, 16])
def test_bootstrap_lut_shared_table_matches_jax(keys, m):
    sk, ck, tck = keys
    rng = np.random.default_rng(m)
    msgs = np.arange(2 * m)
    ct = _encrypt(rng, msgs, m, sk.key_lv0, noise=2**20)
    f = lambda x: (7 * x + 3) % m     # noqa: E731
    jt = JL.Generator.new(m, JPAR).generate_lookup_table(f)
    tt = TL.Generator.new(m, TPAR).generate_lookup_table(f)
    jct, tct = _both(ct)
    want = np.asarray(JL.bootstrap_lut(jct, jt, ck))
    got = TL.bootstrap_lut(tct, tt, tck)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(_dec(want, m, sk), f(msgs))
    # the same table as a [2, N] tensor
    assert np.array_equal(TL.bootstrap_lut(tct, _t(tt.poly), tck).numpy(), want)


def test_bootstrap_lut_per_lane_tables_match_jax(keys):
    sk, ck, tck = keys
    m = 8
    gen = TL.Generator.new(m, TPAR)
    fs = [lambda x: x, lambda x: (x + 1) % m, lambda x: x * x % m,
          lambda x: (m - 1 - x)]
    msgs = np.arange(12) % m
    tvs = np.stack([gen.generate_lookup_table(fs[i % 4]).poly for i in range(12)])
    ct = _encrypt(np.random.default_rng(9), msgs, m, sk.key_lv0)
    jct, tct = _both(ct)
    want = np.asarray(JL.bootstrap_lut(jct, jnp.asarray(tvs), ck))
    assert np.array_equal(TL.bootstrap_lut(tct, _t(tvs), tck).numpy(), want)
    assert np.array_equal(_dec(want, m, sk),
                          [fs[i % 4](int(x)) for i, x in enumerate(msgs)])


@pytest.mark.parametrize("m, f", [
    (16, lambda x: (7 * x + 3) % 16), (16, lambda x: x // 8),
    (16, lambda x: (x * x * 5) % 16), (8, lambda x: 7 - x), (2, lambda x: 1),
    (32, lambda x: (x * 13) % 32)])
def test_factor_lut_matches_jax(m, f):
    table = TL.Generator.new(m, TPAR).generate_lookup_table(f)
    got = TL.factor_lut(table, m)
    assert got == JL.factor_lut(JL.LookupTable(table.poly.copy()), m)
    offs, coeffs, _ = got
    acc = _t(np.random.default_rng(m).integers(-2**31, 2**31, (3, 2, TPAR.N))
             .astype(np.int32))
    want = JL.apply_factored(jnp.asarray(acc.numpy()), offs, coeffs)
    assert np.array_equal(TL.apply_factored(acc, offs, coeffs).numpy(),
                          np.asarray(want))
    with pytest.raises(ValueError, match="power-of-two"):
        TL.factor_lut(table, 12)


def test_bootstrap_multi_lut_matches_jax(keys):
    sk, ck, tck = keys
    m = 16
    gen = TL.Generator.new(m, TPAR)
    fs = (lambda x: x % 8, lambda x: x // 8, lambda x: (5 * x + 2) % m)
    luts = [gen.generate_lookup_table(f) for f in fs]
    msgs = np.arange(m)
    ct = _encrypt(np.random.default_rng(5), msgs, m, sk.key_lv0, noise=2**20)
    jct, tct = _both(ct)
    want = np.asarray(JL.bootstrap_multi_lut(
        jct, [JL.LookupTable(t.poly.copy()) for t in luts], m, ck))
    got = TL.bootstrap_multi_lut(tct, luts, m, tck)
    assert tuple(got.shape) == (3, m, TPAR.n0 + 1)
    assert np.array_equal(got.numpy(), want)
    for k, f in enumerate(fs):
        assert np.array_equal(_dec(want[k], m, sk), [f(x) for x in msgs])


def test_multi_value_base_is_copied_to_the_device_once(keys):
    """The multi-value rounds share one cached T0 per (m, N, width,
    device): a later round copies no table, and no round mutates it."""
    sk, ck, tck = keys
    m = 16
    luts = [TL.Generator.new(m, TPAR).generate_lookup_table(lambda x: x % 8)]
    tct = _t(_encrypt(np.random.default_rng(6), np.arange(4), m, sk.key_lv0))
    first = TL.bootstrap_multi_lut(tct, luts, m, tck)
    misses = TL._multi_lut_base_on.cache_info().misses
    again = TL.bootstrap_multi_lut(tct, luts, m, tck)
    assert TL._multi_lut_base_on.cache_info().misses == misses
    assert torch.equal(first, again)
    base = TL._multi_lut_base_on(m, TPAR.N, 32, tct.device)
    assert np.array_equal(base.numpy(), TL.multi_lut_base(m, TPAR.N))


# m = 32: m_hi = 2, 2 * 2 * 64 <= N = 256, the interleaved select (one lane
# for both families); m = 64: m_hi = 4, the per-family select (two lanes)
@pytest.mark.parametrize("m", [32, 64])
def test_radix_tree_pbs_matches_jax_and_chains(keys, m):
    sk, ck, tck = keys
    f = lambda x: (5 * x + 1) % m    # noqa: E731
    g = lambda x: (x * x + 3) % m    # noqa: E731
    msgs = (np.arange(6) * 11) % m
    rng = np.random.default_rng(m)
    lo = _encrypt(rng, msgs % 16, 16, sk.key_lv0)
    hi = _encrypt(rng, msgs // 16, m // 16, sk.key_lv0)
    jlo, tlo = _both(lo)
    jhi, thi = _both(hi)
    want = JL.bootstrap_lut_radix(jlo, jhi, f, m, ck, ck.pksk)
    got = TL.bootstrap_lut_radix(tlo, thi, f, m, tck, tck.pksk)
    for w, t in zip(want, got):
        assert np.array_equal(t.numpy(), np.asarray(w))
    assert np.array_equal(np.asarray(JL.decrypt_radix_message(
        want, m, sk.key_lv0)), [f(int(x)) for x in msgs])
    # chaining: the outputs are radix inputs again
    want2 = JL.bootstrap_lut_radix(*want, g, m, ck, ck.pksk)
    got2 = TL.bootstrap_lut_radix(*got, g, m, tck, tck.pksk)
    for w, t in zip(want2, got2):
        assert np.array_equal(t.numpy(), np.asarray(w))
    assert np.array_equal(TL.decrypt_radix_message(got2, m, _t(sk.key_lv0)).numpy(),
                          [g(f(int(x))) for x in msgs])
    # the mid layer's test vectors
    assert np.array_equal(TL.radix_lut_testvecs(f, m, TPAR),
                          np.asarray(JL.radix_lut_testvecs(f, m, JPAR)))


def test_tree_pbs_direct_matches_jax(keys):
    """tree_pbs with fewer hypotheses than selector blocks (padded zero
    samples), per-family select with F = 3."""
    sk, ck, tck = keys
    gen = TL.Generator.new(16, TPAR)
    tvs = np.stack([np.stack([gen.generate_lookup_table(
        lambda x, a=fam, h=h: (a * x + h) % 16).poly for h in range(3)])
        for fam in range(3)])                              # [3, 3, 2, N]
    rng = np.random.default_rng(11)
    x = np.arange(5) * 3 % 16
    sel = np.arange(5) % 3
    cin = _encrypt(rng, x, 16, sk.key_lv0)
    csel = _encrypt(rng, sel, 4, sk.key_lv0)
    want = np.asarray(JL.tree_pbs(jnp.asarray(cin), jnp.asarray(csel), tvs, 4,
                                  ck, ck.pksk))
    got = TL.tree_pbs(_t(cin), _t(csel), tvs, 4, tck, tck.pksk)
    assert tuple(got.shape) == (5, 3, TPAR.n0 + 1)
    assert np.array_equal(got.numpy(), want)
    for fam in range(3):
        assert np.array_equal(_dec(want[:, fam], 16, sk), (fam * x + sel) % 16)


def test_bootstrap_lut_bivariate_matches_jax(keys):
    sk, ck, tck = keys
    f2 = lambda a, b: a * b + 1      # noqa: E731
    rng = np.random.default_rng(12)
    x, y = np.arange(6) * 5 % 16, np.arange(6) * 3 % 8
    cx = _encrypt(rng, x, 16, sk.key_lv0)
    cy = _encrypt(rng, y, 8, sk.key_lv0)
    want = np.asarray(JL.bootstrap_lut_bivariate(
        jnp.asarray(cx), jnp.asarray(cy), f2, ck, ck.pksk, y_modulus=8))
    got = TL.bootstrap_lut_bivariate(_t(cx), _t(cy), f2, tck, tck.pksk,
                                     y_modulus=8)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(_dec(want, 16, sk), (x * y + 1) % 16)


_SETS_32 = sorted(n for n, p in TP.PARAMS_BY_NAME.items() if p.torus_bits == 32)
_SETS_64 = sorted(n for n, p in TP.PARAMS_BY_NAME.items() if p.torus_bits == 64)


def _jax_params(name):
    """The JAX package's set of this name; for a set the port alone has
    (tfhers_2_2), its twin, built by the JAX package's own ``_sp`` from the
    port's fields."""
    if name in JP.PARAMS_BY_NAME:
        return JP.PARAMS_BY_NAME[name]
    t = TP.PARAMS_BY_NAME[name]
    return JP._sp(t.name, t.security_bits, t.description, t.n0,
                  t.tlwe_lv0.alpha, t.tlwe_lv1.alpha, t.nbit, t.bgbit, t.L,
                  t.basebit, t.iks_t, N=t.N, torus_bits=t.torus_bits)


@pytest.mark.parametrize("name", _SETS_32 + _SETS_64)
def test_mid_norm1_budget_matches_jax(monkeypatch, name):
    """inf at every 32-bit set; the formula (the 64-bit sets, which the
    port's keys cannot hold yet) on a stand-in key with their engine
    gadget: equal to the JAX package's."""
    monkeypatch.delenv("ZTFHE_MID", raising=False)

    def stand_in(params):
        return types.SimpleNamespace(params=params, bsk_bgbit=8,
                                     bsk_levels=(3, 2), bsk_group=2)

    want = JL.mid_norm1_budget(stand_in(_jax_params(name)))
    got = TL.mid_norm1_budget(stand_in(TP.PARAMS_BY_NAME[name]))
    assert got == want
    assert math.isinf(got) == (name in _SETS_32)


def test_port_keygen_lut_truth_tables():
    """The port's own TEST_TINY_UINT keys (packing key by default), alpha =
    0: single, multi-value, radix (both select shapes) and bivariate LUTs
    decrypt to their functions."""
    g = torch.Generator().manual_seed(17)
    sk = TK.SecretKey.generate(g, TPAR)
    ck = TK.CloudKey.generate(g, sk, TPAR)
    assert ck.pksk is not None and ck.pksk_gadget == (TPAR.basebit, TPAR.iks_t)
    assert tuple(ck.pksk.shape) == (TPAR.n1 * TPAR.iks_t, 2, TPAR.N)
    s = sk.key_lv0
    m = 16
    gen = TL.Generator.new(m, TPAR)
    msgs = torch.arange(2 * m) % m
    ct = TL.encrypt_message(g, msgs, m, 0.0, s)
    f = lambda x: (7 * x + 3) % m    # noqa: E731
    out = TL.bootstrap_lut(ct, gen.generate_lookup_table(f), ck)
    assert torch.equal(TL.decrypt_message(out, m, s), (7 * msgs + 3) % m)
    outs = TL.bootstrap_multi_lut(ct, [gen.generate_lookup_table(lambda x: x % 8),
                                       gen.generate_lookup_table(lambda x: x // 8)],
                                  m, ck)
    assert torch.equal(TL.decrypt_message(outs[0], m, s), msgs % 8)
    assert torch.equal(TL.decrypt_message(outs[1], m, s), msgs // 8)
    for M in (32, 64):
        x = torch.arange(10) * 7 % M
        cts = TL.encrypt_radix_message(g, x, M, 0.0, s)
        res = TL.bootstrap_lut_radix(*cts, lambda v: (3 * v + 1) % M, M, ck,
                                     ck.pksk)
        assert torch.equal(TL.decrypt_radix_message(res, M, s).long(),
                           (3 * x + 1) % M)
    cx = TL.encrypt_message(g, torch.arange(8), 16, 0.0, s)
    cy = TL.encrypt_message(g, torch.arange(8) % 4, 4, 0.0, s)
    out = TL.bootstrap_lut_bivariate(cx, cy, lambda a, b: a + 4 * b, ck,
                                     ck.pksk, y_modulus=4)
    assert torch.equal(TL.decrypt_message(out, 16, s).long(),
                       (torch.arange(8) + 4 * (torch.arange(8) % 4)) % 16)


def test_refusals():
    with pytest.raises(ValueError, match="32..256"):
        TL.encrypt_radix_message(torch.Generator(), [1], 512, 0.0,
                                 torch.zeros(8, dtype=torch.int32))
    # width 64 (once refused): the codec equals the JAX package's
    enc, jenc = TL.Encoder.new(16, width=64), JL.Encoder.new(16, width=64)
    for x in range(16):
        assert enc.encode(x) == jenc.encode(x) == x << 59
        assert enc.decode(enc.encode(x) + (1 << 57)) == x
    with pytest.raises(ValueError, match="power of two"):
        TL.tree_pbs(None, None, np.zeros((1, 2, 2, 256), np.int32), 3,
                    types.SimpleNamespace(params=TPAR), None)
