"""The port's 64-bit torus against the JAX package's, on TEST_TINY64 (N =
64, n0 = 8, int64 carriers; the key defaults: group 2, Bg_e 2^6 with (2, 2)
levels, drop 0, six CRT primes).  TEST_TINY64 runs the direct NTT engine
at width 64: the plain step ops, then K1's int64 finish, which has no
kernel (CPU tensors only; CUDA tensors raise).

Inputs are made with numpy from a seed and handed to both packages, and a
JAX-made key goes to the port through ``CloudKey.from_numpy``.  Held
bit-equal: the width-64 codecs (``to_carrier``, ``torus_constant_w``,
``f64_to_torus``, the message table), ``shift_right_logical`` and the
8-limb int8 recoding, the binary negacyclic product, ``small_matmul_torus``
and ``negacyclic_rotate`` on int64, ``gadget_decompose`` /
``ks_decompose`` / ``decompose_rows`` / ``modswitch`` at width 64,
the TLWE and TRLWE phases and ``sample_extract``, the gadget scales, the
key switch, and the gates (all ten, ``mux``) on a carried key.  The port's
own RNG, encryption and key generation are held at the decrypt level (and
the RNG's spread within 5% of its std).  Tolerance: exact equality
elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zig_tfhe_tpu import key as JK
from zig_tfhe_tpu import params as JP
from zig_tfhe_tpu import tlwe as JT
from zig_tfhe_tpu import trgsw as JG3
from zig_tfhe_tpu import trlwe as JR
from zig_tfhe_tpu.models import gates as JG
from zig_tfhe_tpu.ops import blind_rotate as jbr
from zig_tfhe_tpu.ops import decomposition as jdec
from zig_tfhe_tpu.ops import keyswitch as jks
from zig_tfhe_tpu.ops import poly as jpoly
from zig_tfhe_tpu.utils import torus as jtorus
from zig_tfhe_tpu_torch import key as TK
from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch import tlwe as TT
from zig_tfhe_tpu_torch import trgsw as TG3
from zig_tfhe_tpu_torch import trlwe as TR
from zig_tfhe_tpu_torch.models import gates as TG
from zig_tfhe_tpu_torch.ops import decomposition as tdec
from zig_tfhe_tpu_torch.ops import keyswitch as tks
from zig_tfhe_tpu_torch.ops import ntt as tntt
from zig_tfhe_tpu_torch.ops import poly as tpoly
from zig_tfhe_tpu_torch.utils import rng as trng
from zig_tfhe_tpu_torch.utils import torus as ttorus

JPAR, TPAR = JP.TEST_TINY64, TP.TEST_TINY64
_TRUTH = {
    "nand": lambda p, q: not (p and q), "or": lambda p, q: p or q,
    "and": lambda p, q: p and q, "xor": lambda p, q: p != q,
    "xnor": lambda p, q: p == q, "nor": lambda p, q: not (p or q),
    "andny": lambda p, q: (not p) and q, "andyn": lambda p, q: p and not q,
    "orny": lambda p, q: (not p) or q, "oryn": lambda p, q: p or not q}


def _t(a):
    return torch.from_numpy(np.array(a))


def _full64(rng, shape):
    return rng.integers(-2**63, 2**63 - 1, shape, dtype=np.int64,
                        endpoint=True)


def _wrap64(v):
    """Object-int array -> int64 bit patterns (mod 2^64)."""
    return np.array([((int(x) + 2**63) % 2**64) - 2**63
                     for x in np.ravel(v)], np.int64).reshape(np.shape(v))


def _encrypt64(rng, mu, s):
    """TLWE int64 ciphertexts [len(mu), n+1] made with numpy: uniform mask,
    body <a, s> + mu mod 2^64 (no noise)."""
    a = _full64(rng, (len(mu), len(s)))
    b = _wrap64(a.astype(object) @ np.asarray(s).astype(object)
                + np.asarray(mu).astype(object))
    return np.concatenate([a, b[:, None]], axis=1)


def _port_key(ck, params, device="cpu"):
    arrays = {n: np.asarray(getattr(ck, n)) for n in
              ("testvec", "ksk1", "bsk_ntt", "pksk") if getattr(ck, n) is not None}
    return TK.CloudKey.from_numpy(
        arrays, params, bsk_ntt_drop=ck.bsk_ntt_drop, bsk_group=ck.bsk_group,
        bsk_levels=ck.bsk_levels, bsk_bgbit=ck.bsk_bgbit,
        pksk_gadget=ck.pksk_gadget, device=device)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def keys():
    """A JAX TEST_TINY64 secret key and cloud key, and the key in the port."""
    sk = JK.SecretKey.generate(jax.random.key(61), JPAR)
    ck = JK.CloudKey.generate(jax.random.key(62), sk, JPAR)
    assert ck.ksk1.dtype == jnp.int64 and ck.bsk_group == 2
    return sk, ck, _port_key(ck, TPAR)


def test_codecs_64():
    x = np.array([0.0, 0.125, -0.125, 0.3, 1 / 3, -0.999, 0.5])
    want = np.array([jtorus.to_carrier(jtorus.torus_constant_w(v, 64), 64)
                     for v in x], np.int64)
    assert np.array_equal(ttorus.f64_to_torus(x, 64), want)
    for m in (2, 16, 64, 256):
        assert np.array_equal(TT._encode_message_table(m, 64),
                              JT._encode_message_table(m, 64))
    assert ttorus.carrier_dtype(64) == torch.int64
    assert TG._bias_table(64).tolist() == JG._bias_table(64).tolist()


def test_shift_right_logical_64():
    x = np.concatenate([_full64(np.random.default_rng(1), 256),
                        np.array([0, -1, 2**63 - 1, -2**63], np.int64)])
    for amount in range(64):
        want = np.asarray(jtorus.shift_right_logical(jnp.asarray(x), amount))
        got = ttorus.shift_right_logical(_t(x), amount).numpy()
        assert np.array_equal(want, got), amount


@pytest.mark.parametrize("n_limbs", [5, 8])
def test_i8_limbs_64(n_limbs):
    x = _full64(np.random.default_rng(2), (5, 17)) >> (8 * (8 - n_limbs))
    want = np.asarray(jtorus.i32_to_i8_limbs(jnp.asarray(x), n_limbs))
    limbs = ttorus.i32_to_i8_limbs(_t(x), n_limbs)
    assert np.array_equal(want, limbs.numpy())
    back = ttorus.i8_limbs_combine([limbs[..., k].to(torch.int32)
                                    for k in range(n_limbs)],
                                   [8 * k for k in range(n_limbs)], 64)
    assert back.dtype == torch.int64 and np.array_equal(back.numpy(), x)


def test_rng_64():
    """Decrypt-level: the 64-bit draws span both halves of the word and the
    noise has the requested std (within 5% over 40,000 samples)."""
    g = torch.Generator().manual_seed(5)
    u = trng.uniform_torus(g, (40000,), 64)
    assert u.dtype == torch.int64
    top = (u < 0).double().mean().item()
    low = (u & 1).double().mean().item()
    assert 0.48 < top < 0.52 and 0.48 < low < 0.52
    assert int((u >> 32).unique().numel()) > 39000
    e = trng.gaussian_torus(g, (40000,), 2.0 ** -20, 64)
    assert e.dtype == torch.int64
    assert abs(e.double().std().item() / 2.0 ** 44 - 1) < 0.05
    assert not trng.gaussian_torus(g, (7,), 0.0, 64).any()


def test_poly_64():
    rng = np.random.default_rng(3)
    N = TPAR.N
    a = _full64(rng, (3, N))
    s = rng.integers(0, 2, N).astype(np.int32)
    want = np.asarray(jpoly.negacyclic_polymul_binary(jnp.asarray(a),
                                                      jnp.asarray(s)))
    got = tpoly.negacyclic_polymul_binary(_t(a), _t(s))
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    ref = np.zeros(N, dtype=object)            # schoolbook, row 0, mod 2^64
    for k in range(N):
        for j in range(N):
            sgn = 1 if k + j < N else -1
            ref[(k + j) % N] += sgn * int(a[0, k]) * int(s[j])
    assert np.array_equal(got[0].numpy(), _wrap64(ref))
    small = rng.integers(-8, 8, (4, 40)).astype(np.int32)
    mat = _full64(rng, (40, 9))
    want = np.asarray(jpoly.small_matmul_torus(jnp.asarray(small),
                                               jnp.asarray(mat), 8, 64))
    assert np.array_equal(tpoly.small_matmul_torus(_t(small), _t(mat), 8,
                                                   64).numpy(), want)
    k = rng.integers(0, 2 * N + 1, 3).astype(np.int32)
    want = np.asarray(jpoly.negacyclic_rotate(jnp.asarray(a), jnp.asarray(k)))
    assert np.array_equal(tpoly.negacyclic_rotate(_t(a), _t(k)).numpy(), want)


@pytest.mark.parametrize("name,levels,bgbit", [
    ("tiny64", None, None), ("tiny64", (2, 2), 6), ("128bit_t64", (3, 2), 8),
    ("128bit_t64", (2, 2), 7)])
def test_decompose_64(name, levels, bgbit):
    jp, tp = JP.PARAMS_BY_NAME[name], TP.PARAMS_BY_NAME[name]
    x = _full64(np.random.default_rng(4), (3, 2, tp.N))
    lv = None if levels is None else levels[0]
    for center in (False, True):
        want = jdec.gadget_decompose(jnp.asarray(x), jp, -2, lv, bgbit, center)
        got = tdec.gadget_decompose(_t(x), tp, -2, lv, bgbit, center)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(),
                                                           np.asarray(want))
    want = jbr._decompose_to_rows(jnp.asarray(x), jp, levels, bgbit=bgbit)
    got = tdec.decompose_rows(_t(x), tp, levels, bgbit=bgbit)
    assert np.array_equal(got.numpy(), np.asarray(want))
    want = jbr.modswitch(jnp.asarray(x), jp)
    got = tdec.modswitch(_t(x), tp)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(),
                                                       np.asarray(want))
    for basebit, t in ((jp.basebit, jp.iks_t), (8, 3)):
        want = jdec.ks_decompose(jnp.asarray(x), basebit, t, 64)
        got = tdec.ks_decompose(_t(x), basebit, t, 64)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_tlwe_trlwe_phases_64(keys):
    sk = keys[0]
    rng = np.random.default_rng(6)
    s0 = np.asarray(sk.key_lv0)
    mu = np.asarray(JT._encode_message_table(16, 64))[rng.integers(0, 16, 12)]
    ct = _encrypt64(rng, mu + (rng.integers(-2**50, 2**50, 12)), s0)
    want = np.asarray(JT.phase(jnp.asarray(ct), sk.key_lv0))
    assert np.array_equal(TT.phase(_t(ct), _t(s0)).numpy(), want)
    assert np.array_equal(
        TT.decrypt_message(_t(ct), 16, _t(s0), 64).numpy(),
        np.asarray(JT.decrypt_message(jnp.asarray(ct), 16, sk.key_lv0, 64)))
    assert np.array_equal(TT.decrypt_bool(_t(ct), _t(s0)).numpy(),
                          np.asarray(JT.decrypt_bool(jnp.asarray(ct),
                                                     sk.key_lv0)))
    s1 = np.asarray(sk.key_lv1)
    tr = _full64(rng, (3, 2, TPAR.N))
    want = np.asarray(JR.phase(jnp.asarray(tr), sk.key_lv1))
    assert np.array_equal(TR.phase(_t(tr), _t(s1)).numpy(), want)
    for k in (0, 5):
        want = np.asarray(JR.sample_extract(jnp.asarray(tr), k))
        got = TR.sample_extract(_t(tr), k)
        assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    assert np.array_equal(TG3.gadget_scales(8, 3, 64),
                          JG3.gadget_scales(8, 3, 64))


def test_port_encryption_64(keys):
    """Decrypt-level: the port's width-64 TLWE, TRLWE and gadget-row
    encryptions (alpha 2^-30, and alpha 0 for the exact gadget rows)."""
    sk = keys[0]
    s0, s1 = _t(np.asarray(sk.key_lv0)), _t(np.asarray(sk.key_lv1))
    g = torch.Generator().manual_seed(7)
    bits = torch.arange(10) % 3 == 0
    ct = TT.encrypt_bool(g, bits, 2.0 ** -30, s0, width=64)
    assert ct.dtype == torch.int64
    assert torch.equal(TT.decrypt_bool(ct, s0), bits)
    msg = torch.arange(16)
    ct = TT.encrypt_message(g, msg, 16, 2.0 ** -30, s0, width=64)
    assert torch.equal(TT.decrypt_message(ct, 16, s0, 64).long(), msg)
    mu = _t(np.asarray(JT._encode_message_table(4, 64))[np.arange(2 * 64) % 4]
            .reshape(2, 64))
    err = TR.phase(TR.encrypt_torus(g, mu, 2.0 ** -30, s1, width=64), s1) - mu
    assert err.abs().max().item() < 2 ** 40
    p = torch.tensor([1, 0, 1], dtype=torch.int32)
    rows = TG3.encrypt_gadget_rows(g, p, 0.0, s1, TPAR, 8, 2, 2)  # [3, 4, 2, N]
    h = TG3.gadget_scales(8, 2, 64)
    ph = TR.phase(rows, s1)
    s1_poly = s1.to(torch.int64)
    for i in range(3):
        for r in range(2):
            want_b = torch.zeros(TPAR.N, dtype=torch.int64)
            want_b[0] = int(p[i]) * int(h[r])
            assert torch.equal(ph[i, 2 + r], want_b)
            assert torch.equal(ph[i, r], -int(p[i]) * int(h[r]) * s1_poly)


def test_key_switch_64(keys):
    sk, ck, tck = keys
    rng = np.random.default_rng(8)
    lv1 = _full64(rng, (5, TPAR.N + 1))
    want = np.asarray(jks.identity_key_switch(jnp.asarray(lv1), ck.ksk1, JPAR))
    got = tks.identity_key_switch(_t(lv1), tck.ksk1, TPAR)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    assert np.array_equal(tks.ks_plaintexts(_t(np.asarray(sk.key_lv1)), 8, 3,
                                            64).numpy(),
                          np.asarray(jks.ks_plaintexts(sk.key_lv1, 8, 3, 64)))


def test_tiny64_gates_bit_equal(keys):
    """All ten gates and the MUX on the carried key, bit-equal to JAX and
    decrypting to their truth tables (alpha = 0)."""
    sk, ck, tck = keys
    rng = np.random.default_rng(9)
    s0 = np.asarray(sk.key_lv0)
    B = 20
    ids = np.arange(B) % 10
    x, y, z = rng.integers(0, 2, (3, B)).astype(bool)
    a, b, c = (_encrypt64(rng, np.where(v, 1 << 61, -(1 << 61)), s0)
               for v in (x, y, z))
    want = np.asarray(JG.apply_gates(jnp.asarray(ids), jnp.asarray(a),
                                     jnp.asarray(b), ck))
    got = TG.apply_gates(_t(ids), _t(a), _t(b), tck)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    truth = [_TRUTH[TG.GATE_NAMES[i]](p, q) for i, p, q in zip(ids, x, y)]
    assert TT.decrypt_bool(got, _t(s0)).tolist() == truth
    want = np.asarray(JG.mux(jnp.asarray(a[:6]), jnp.asarray(b[:6]),
                             jnp.asarray(c[:6]), ck))
    got = TG.mux(_t(a[:6]), _t(b[:6]), _t(c[:6]), tck)
    assert np.array_equal(got.numpy(), want)
    assert TT.decrypt_bool(got, _t(s0)).tolist() == list(np.where(x, y, z)[:6])
    const = TG.constant(False, TPAR, (2,), device="cpu")
    assert const.dtype == torch.int64
    assert np.array_equal(const.numpy(), np.asarray(
        JG.constant(False, JPAR, (2,))))


def test_tiny64_port_keygen_gates():
    """Decrypt-level: the port's own TEST_TINY64 key (its packing key
    built by default, as on every 64-bit set) runs the ten gates."""
    g = torch.Generator().manual_seed(11)
    sk = TK.SecretKey.generate(g, TPAR)
    ck = TK.CloudKey.generate(g, sk, TPAR)
    assert ck.ksk1.dtype == ck.testvec.dtype == ck.pksk.dtype == torch.int64
    assert ck.pksk_gadget == (8, 3) and ck.pksk.shape == (TPAR.N * 3, 2, TPAR.N)
    assert ck.testvec[1, 0].item() == 1 << 61
    B = 20
    ids = torch.arange(B) % 10
    x, y = torch.rand((2, B), generator=g) < 0.5
    a = TT.encrypt_bool(g, x, 0.0, sk.key_lv0, width=64)
    b = TT.encrypt_bool(g, y, 0.0, sk.key_lv0, width=64)
    got = TT.decrypt_bool(TG.apply_gates(ids, a, b, ck), sk.key_lv0)
    assert got.tolist() == [_TRUTH[TG.GATE_NAMES[i]](bool(p), bool(q))
                            for i, p, q in zip(ids, x, y)]


def test_int64_finish_has_no_kernel():
    """K1's int64 variant has no kernel: its plain version runs on any
    device.  On the CPU it is the exact acc + (c << drop); on meta tensors
    (standing in for the card) it runs too and gives the int64 shape."""
    plan = tntt.plan_for_params(TPAR, 0, 2, (2, 2), bgbit=6,
                                pseudorandom_key=True)
    rng = np.random.default_rng(10)
    c = rng.integers(-2**40, 2**40, (2, 2, plan.N))
    acc = _full64(rng, (2, 2, plan.N))
    v = tntt.ntt_forward(_t(c), plan, digit_limbs=8, digit_bound=128)
    assert np.array_equal(tntt.finish_int64(v, _t(acc), plan, 3).numpy(),
                          acc + (c << 3))
    out = tntt.finish_int64([x.to("meta") for x in v], _t(acc).to("meta"),
                           plan, 0)
    assert out.device.type == "meta" and out.dtype == torch.int64
    assert tuple(out.shape) == acc.shape
