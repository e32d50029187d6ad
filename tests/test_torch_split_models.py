"""The models on the 64-bit split-ring torus (TEST_TINY_SPLIT: N = 2048,
n0 = 8, int64 carriers, the split engine at group 2 or 1) against the JAX
package's: gates, circuits, LUTs, the integer layer, the packing key and
the files.

A JAX-made TEST_TINY_SPLIT key (group 2, its packing key at the width-64
(8, 3) gadget) goes to the port through ``CloudKey.from_numpy``, and a
port-made group-1 key goes to the JAX package the other way; ciphertexts
are made with numpy from a seed and handed to both.  Held bit-equal to JAX
on these carried keys: the ten gates at groups 2 and 1, the single-shot m
= 64 LUT (``bootstrap_lut``), the m = 64 radix LUT through the tree PBS
(every mid table over this key's ||q||_1 budget, so each takes its
dedicated rotation lane: the route is checked by its rotations' lane
counts), ``radix_add``, ``radix_lt`` and a one-lane ``radix_mul`` (its
digit products over the budget, so demoted to one lane per table; both
packages make the same count of rotations), the width-64 packing key switch
and block spread (on a port-made TEST_TINY64 packing key), and the files
(a JAX key saved by the port is the JAX file, array for array and
manifest byte for byte; a port key saved by the
port runs JAX gates; 64-bit ciphertexts load both ways as uint64 on disk).
The rotations per op that ``chip_smoke.py`` holds the card to on the
SECURITY_128_BIT_T64 key (``T64_ROTATIONS``) are counted on the JAX
package at that key's budget.  Decrypt-level (exact against numpy at alpha
= 0): the Kogge-Stone adder
and a scheduler-run full adder,
``FheUint`` mul and xor, ``FheInt`` add, the gates bridge, and the port's
own keys (gates, the packing key's rows).  Tolerance: exact equality.
"""

import importlib.util
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zig_tfhe_tpu import key as JK
from zig_tfhe_tpu import params as JP
from zig_tfhe_tpu import tlwe as JT
from zig_tfhe_tpu.models import gates as JG
from zig_tfhe_tpu.models import integer as JI
from zig_tfhe_tpu.models import lut as JL
from zig_tfhe_tpu.ops import packing_keyswitch as JPK
from zig_tfhe_tpu.ops import split_ring as JSR
from zig_tfhe_tpu.utils import serialization as jser
from zig_tfhe_tpu_torch import key as TK
from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch import tlwe as TT
from zig_tfhe_tpu_torch import trlwe as TR
from zig_tfhe_tpu_torch.models import circuits as TC
from zig_tfhe_tpu_torch.models import gates as TG
from zig_tfhe_tpu_torch.models import integer as TI
from zig_tfhe_tpu_torch.models import lut as TL
from zig_tfhe_tpu_torch.models import scheduler as TS
from zig_tfhe_tpu_torch.ops import blind_rotate as TBR
from zig_tfhe_tpu_torch.ops import packing_keyswitch as TPK
from zig_tfhe_tpu_torch.utils import serialization as tser

JPAR, TPAR = JP.TEST_TINY_SPLIT, TP.TEST_TINY_SPLIT
_TRUTH = {
    "nand": lambda p, q: not (p and q), "or": lambda p, q: p or q,
    "and": lambda p, q: p and q, "xor": lambda p, q: p != q,
    "xnor": lambda p, q: p == q, "nor": lambda p, q: not (p or q),
    "andny": lambda p, q: (not p) and q, "andyn": lambda p, q: p and not q,
    "orny": lambda p, q: (not p) or q, "oryn": lambda p, q: p or not q}


def _t(a):
    return torch.from_numpy(np.array(a))


def _encrypt64(rng, mu, s):
    """TLWE int64 ciphertexts [..., n+1] of torus values mu made with numpy:
    uniform mask, body <a, s> + mu mod 2^64 (no noise)."""
    mu = np.asarray(mu)
    a = rng.integers(-2**63, 2**63 - 1, mu.shape + (len(s),), dtype=np.int64,
                     endpoint=True)
    b = a.astype(object) @ np.asarray(s).astype(object) + mu.astype(object)
    b = np.array([((int(x) + 2**63) % 2**64) - 2**63 for x in b.ravel()],
                 np.int64).reshape(mu.shape)
    return np.concatenate([a, b[..., None]], axis=-1)


def _messages(rng, msgs, m, s):
    return _encrypt64(rng, np.asarray(JT._encode_message_table(m, 64))[msgs], s)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def keys():
    """The JAX key (group 2, packing key) and its port copy; the port's
    own group-1 key (no packing key) and its JAX copy."""
    sk = JK.SecretKey.generate(jax.random.key(81), JPAR)
    ck = JK.CloudKey.generate(jax.random.key(82), sk, JPAR)
    assert ck.pksk.dtype == jnp.int64 and tuple(ck.pksk_gadget) == (8, 3)
    arrays = {n: np.asarray(getattr(ck, n))
              for n in ("testvec", "ksk1", "bsk_ntt", "pksk")}
    tck = TK.CloudKey.from_numpy(arrays, TPAR, bsk_ntt_drop=32, bsk_group=2,
                                 bsk_levels=(2, 2), bsk_bgbit=8,
                                 pksk_gadget=(8, 3), device="cpu")
    tsk = TK.SecretKey.from_numpy(np.asarray(sk.key_lv0),
                                  np.asarray(sk.key_lv1), device="cpu")
    g = torch.Generator().manual_seed(83)
    tck1 = TK.CloudKey.generate(g, tsk, TPAR, group=1, packing_key=False)
    jck1 = JK.CloudKey(testvec=jnp.asarray(tck1.testvec.numpy()),
                       ksk1=jnp.asarray(tck1.ksk1.numpy()),
                       bsk_ntt=jnp.asarray(tck1.bsk_ntt.numpy()), params=JPAR,
                       bsk_ntt_drop=32, bsk_group=1, bsk_levels=(2, 2),
                       bsk_bgbit=8)
    return sk, tsk, {2: (ck, tck), 1: (jck1, tck1)}


@pytest.mark.parametrize("group", [2, 1])
def test_gates_bit_equal(keys, group):
    sk, tsk, cks = keys
    jck, tck = cks[group]
    rng = np.random.default_rng(group)
    s0 = np.asarray(sk.key_lv0)
    B = 10
    ids = np.arange(B) % 10
    x, y = rng.integers(0, 2, (2, B)).astype(bool)
    a, b = (_encrypt64(rng, np.where(v, 1 << 61, -(1 << 61)), s0)
            for v in (x, y))
    want = np.asarray(JG.apply_gates(jnp.asarray(ids), jnp.asarray(a),
                                     jnp.asarray(b), jck))
    got = TG.apply_gates(_t(ids), _t(a), _t(b), tck)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    assert TT.decrypt_bool(got, tsk.key_lv0).tolist() == [
        _TRUTH[TG.GATE_NAMES[i]](p, q) for i, p, q in zip(ids, x, y)]


def test_kogge_stone_adder(keys):
    sk, tsk, cks = keys
    tck = cks[2][1]
    g = torch.Generator().manual_seed(5)
    a = TC.encrypt_bits(g, 202, 8, tsk, TPAR)
    b = TC.encrypt_bits(g, 49, 8, tsk, TPAR)
    assert a.dtype == torch.int64
    s, carry = TC.kogge_stone_add(a, b, tck)
    assert TC.decrypt_bits(s, tsk) == (202 + 49) % 256
    assert TC.decrypt_bits(carry, tsk) == 0
    # a full adder through the level scheduler, its arena int64, on the
    # eight input combinations at once
    fa = TS.Circuit()
    x, y, z = (fa.input() for _ in range(3))
    xo = fa.gate("xor", x, y)
    fa.output(fa.gate("xor", xo, z))
    fa.output(fa.gate("or", fa.gate("and", x, y), fa.gate("and", xo, z)))
    combos = (torch.arange(8)[None] >> torch.arange(3)[:, None]) & 1
    cts = TT.encrypt_bool(g, combos.bool(), 0.0, tsk.key_lv0, width=64)
    out = TT.decrypt_bool(TS.evaluate(fa.schedule(), cts, tck), tsk.key_lv0)
    assert torch.equal(out.long(), torch.stack([combos.sum(0) % 2,
                                                combos.sum(0) // 2]))


def test_single_shot_lut_m64(keys):
    sk, tsk, cks = keys
    jck, tck = cks[2]
    m = 64
    table = TL.Generator.new(m, TPAR).generate_lookup_table(
        lambda x: (x * x + 3) % m)
    jtable = JL.Generator.new(m, JPAR).generate_lookup_table(
        lambda x: (x * x + 3) % m)
    assert table.poly.dtype == np.int64
    assert np.array_equal(table.poly, jtable.poly)
    msgs = np.arange(0, m, 5)
    ct = _messages(np.random.default_rng(6), msgs, m, np.asarray(sk.key_lv0))
    want = np.asarray(JL.bootstrap_lut(jnp.asarray(ct), jtable, jck))
    got = TL.bootstrap_lut(_t(ct), table, tck)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(TL.decrypt_message(got, m, tsk.key_lv0, 64).numpy(),
                          (msgs * msgs + 3) % m)


def _radix_f(x):
    return (3 * x + 7) % 64


def test_radix_lut_m64_dedicated_lanes(keys, monkeypatch):
    """m = 64 through the tree PBS: every mid table's ||q||_1 (24..112)
    exceeds this key's budget (3.07, equal to JAX's), so the mid layer is
    one rotation of 8 dedicated lanes per input and no shared one, then
    one interleaved select lane per input."""
    sk, tsk, cks = keys
    jck, tck = cks[2]
    assert TL.mid_norm1_budget(tck) == JL.mid_norm1_budget(jck)
    rng = np.random.default_rng(7)
    vals = np.array([0, 17, 38, 63])
    s0 = np.asarray(sk.key_lv0)
    lo, hi = _messages(rng, vals % 16, 16, s0), _messages(rng, vals // 16, 4, s0)
    want = JL.bootstrap_lut_radix(jnp.asarray(lo), jnp.asarray(hi), _radix_f,
                                  64, jck, jck.pksk)
    lanes = []
    real = TL.blind_rotate

    def spy(ct, tv, ck, params, **kw):
        lanes.append(ct.shape[0])
        return real(ct, tv, ck, params, **kw)

    monkeypatch.setattr(TL, "blind_rotate", spy)
    got = TL.bootstrap_lut_radix(_t(lo), _t(hi), _radix_f, 64, tck, tck.pksk)
    assert lanes == [8 * 4, 4]
    for w, o in zip(want, got, strict=True):
        assert np.array_equal(o.numpy(), np.asarray(w))
    assert np.array_equal(
        TL.decrypt_radix_message(got, 64, tsk.key_lv0, 64).numpy(),
        [_radix_f(int(v)) for v in vals])


@pytest.mark.parametrize("op", ["add", "lt"])
def test_radix_ops_bit_equal(keys, op):
    sk, tsk, cks = keys
    jck, tck = cks[2]
    rng = np.random.default_rng(8)
    s0 = np.asarray(sk.key_lv0)
    A, B = np.array([45, 5, 63]), np.array([19, 7, 63])
    a = _messages(rng, (A[:, None] >> np.array([0, 3])) & 7, 16, s0)
    b = _messages(rng, (B[:, None] >> np.array([0, 3])) & 7, 16, s0)
    jfn, tfn = {"add": (JI.radix_add, TI.radix_add),
                "lt": (JI.radix_lt, TI.radix_lt)}[op]
    want = jfn(jnp.asarray(a), jnp.asarray(b), jck)
    got = tfn(_t(a), _t(b), tck)
    assert np.array_equal(got.numpy(), np.asarray(want))
    exact = A + B if op == "add" else (A < B).astype(int)
    digits = got if op == "add" else got[..., None, :]
    assert np.array_equal(TI.decrypt_radix(digits, tsk.key_lv0), exact)


def _rotation_spies(monkeypatch, stub=False):
    """Count each package's split blind rotations (both dispatch to
    ``blind_rotate_split`` at call time); with ``stub`` each returns its
    testvec unrotated, since which tables take which lanes does not read
    the rotations' output."""
    counts = {"jax": 0, "port": 0}

    def spy(name, real, lanes_like):
        def rotate(tlwe_batch, testvec, *args, **kw):
            counts[name] += 1
            if stub:
                return lanes_like(testvec, tlwe_batch.shape[0])
            return real(tlwe_batch, testvec, *args, **kw)
        return rotate

    monkeypatch.setattr(JSR, "blind_rotate_split", spy(
        "jax", JSR.blind_rotate_split,
        lambda tv, B: jnp.broadcast_to(tv, (B,) + tv.shape[-2:])))
    monkeypatch.setattr(TBR, "blind_rotate_split", spy(
        "port", TBR.blind_rotate_split,
        lambda tv, B: tv.expand(B, *tv.shape[-2:]).clone()))
    return counts


def test_radix_mul_bit_equal(keys, monkeypatch):
    """One lane of 1-digit operands through ``radix_mul``: the digit
    products' multi-value tables are over this key's budget (3.07), so
    their rounds are demoted to one lane per table; bit-equal to JAX's,
    with as many rotations (11)."""
    sk, tsk, cks = keys
    jck, tck = cks[2]
    rng = np.random.default_rng(10)
    s0 = np.asarray(sk.key_lv0)
    a, b = (_messages(rng, np.array([[v]]), 16, s0) for v in (5, 6))
    counts = _rotation_spies(monkeypatch)
    want = JI.radix_mul(jnp.asarray(a), jnp.asarray(b), jck)
    got = TI.radix_mul(_t(a), _t(b), tck)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert counts == {"jax": 11, "port": 11}
    assert np.array_equal(TI.decrypt_radix(got, tsk.key_lv0), [30])


def _t64_rotations():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.T64_ROTATIONS


@pytest.mark.parametrize("op", ["add", "lt", "mul", "radix"])
def test_t64_rotations_from_reference(keys, monkeypatch, op):
    """``chip_smoke.py``'s ``T64_ROTATIONS`` (its phase 11 holds the port
    on the card to 384 K1 launches per rotation) equals the JAX package's
    count on this key with its budget set to SECURITY_128_BIT_T64's under
    that set's key defaults (group 2, Bg_e 2^8 (3, 2): 5.31), on 2-digit
    operands as phase 11 gives them.  One lane: the JAX package's knee
    chunking (not ported) splits no rotation there."""
    sk, _, cks = keys
    jck = cks[2][0]
    t64 = types.SimpleNamespace(params=JP.SECURITY_128_BIT_T64, bsk_bgbit=8,
                                bsk_levels=(3, 2), bsk_group=2)
    budget = JL.mid_norm1_budget(t64)
    assert round(budget, 2) == 5.31
    monkeypatch.setattr(JL, "mid_norm1_budget", lambda ck: budget)
    counts = _rotation_spies(monkeypatch, stub=True)
    rng = np.random.default_rng(11)
    s0 = np.asarray(sk.key_lv0)
    if op == "radix":
        lo, hi = _messages(rng, [9], 16, s0), _messages(rng, [2], 4, s0)
        JL.bootstrap_lut_radix(jnp.asarray(lo), jnp.asarray(hi), _radix_f, 64,
                               jck, jck.pksk)
    else:
        a, b = (_messages(rng, [[v & 7, v >> 3]], 16, s0) for v in (45, 19))
        jfn = {"add": JI.radix_add, "lt": JI.radix_lt, "mul": JI.radix_mul}[op]
        jfn(jnp.asarray(a), jnp.asarray(b), jck)
    assert counts == {"jax": _t64_rotations()[op], "port": 0}


def test_integer_ops_decrypt_exact(keys):
    """FheUint mul (the tree-PBS digit multiplier, its mid tables on
    dedicated lanes) and xor, FheInt add, and the gates bridge (to_bools
    -> one AND gate per bit -> from_bools), exact at alpha = 0."""
    sk, tsk, cks = keys
    tck = cks[2][1]
    g = torch.Generator().manual_seed(9)
    A, B = np.array([45, 63, 6]), np.array([7, 5, 1])
    a = TI.FheUint.encrypt(g, A, 2, tsk, tck, alpha=0.0)
    b = TI.FheUint.encrypt(g, B, 1, tsk, tck, alpha=0.0)
    assert a.digits.dtype == torch.int64
    assert np.array_equal((a * b).decrypt(tsk), A * B)
    assert np.array_equal((a ^ b).decrypt(tsk), A ^ B)
    x = TI.FheInt.encrypt(g, np.array([-13, 31, -32]), 2, tsk, tck, alpha=0.0)
    y = TI.FheInt.encrypt(g, np.array([9, -1, 0]), 2, tsk, tck, alpha=0.0)
    assert np.array_equal((x + y).decrypt(tsk), [-4, 30, -32])
    bits_a = TI.to_bools(a.digits, tck)[..., :3, :]
    bits_b = TI.to_bools(b.digits, tck)
    anded = TG.gate("and", bits_a, bits_b, tck)
    assert np.array_equal(TI.decrypt_radix(TI.from_bools(anded, tck),
                                           tsk.key_lv0), A & B)


def test_packing_key_on_64bit_sets(keys):
    """The port builds the packing key by default on the 64-bit sets, at
    (8, 3); on TEST_TINY64's small ring its rows encrypt s1[i] * 2^(64 -
    8(j+1)) (int64, exact at alpha 0), and its key switch and block spread
    (the width-64 rotate-add doubling) equal JAX's on that key."""
    sk, tsk, cks = keys
    jck, tck = cks[2]
    for jp, tp in ((JPAR, TPAR), (JP.SECURITY_128_BIT_T64,
                                  TP.SECURITY_128_BIT_T64)):
        assert TK.default_packing_key(tp) and JK.default_packing_key(jp)
        assert TPK.default_packing_gadget(tp) == JPK.default_packing_gadget(jp)
    assert tck.pksk.shape == (TPAR.n1 * 3, 2, TPAR.N)
    p64 = TP.TEST_TINY64
    g = torch.Generator().manual_seed(10)
    s1 = (torch.rand(p64.N, generator=g) < 0.5).to(torch.int32)
    pksk = TPK.gen_packing_ksk(g, s1, p64)
    assert pksk.dtype == torch.int64 and pksk.shape == (p64.n1 * 3, 2, p64.N)
    ph = TR.phase(pksk, s1)
    want = torch.zeros_like(ph)
    want[:, 0] = (s1.long()[:, None] << torch.tensor([56, 48, 40])).reshape(-1)
    assert torch.equal(ph, want)
    rng = np.random.default_rng(11)
    lv1 = rng.integers(-2**63, 2**63 - 1, (2, 4, p64.N + 1), dtype=np.int64,
                       endpoint=True)
    want = JPK.pack_tlwes_blocks(jnp.asarray(lv1), 4, jnp.asarray(pksk.numpy()),
                                 JP.TEST_TINY64)
    got = TPK.pack_tlwes_blocks(_t(lv1), 4, pksk, p64)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(),
                                                       np.asarray(want))


def test_files_both_ways(keys, tmp_path):
    sk, tsk, cks = keys
    jck, tck = cks[2]
    jser.save_cloud_key(tmp_path / "j_ck", jck)
    loaded = tser.load_cloud_key(tmp_path / "j_ck", device="cpu")
    assert loaded.pksk.dtype == loaded.ksk1.dtype == torch.int64
    assert loaded.pksk_gadget == (8, 3)
    tser.save_cloud_key(tmp_path / "t_ck", loaded)
    with np.load(tmp_path / "j_ck.npz") as jz, np.load(tmp_path / "t_ck.npz") as tz:
        assert list(tz.files) == list(jz.files)
        for name in jz.files:
            assert tz[name].dtype == jz[name].dtype, name
            assert np.array_equal(tz[name], jz[name]), name
        m = json.loads(bytes(tz["__manifest__"]))
    assert (m["params"], m["bsk_group"], m["bsk_ntt_drop"]) == (
        "tiny_split", 2, 32)
    # the port's own group-1 key, saved by the port, runs JAX gates
    jck1, tck1 = cks[1]
    tser.save_cloud_key(tmp_path / "t_ck1", tck1)
    jck1_file = jser.load_cloud_key(tmp_path / "t_ck1")
    assert jck1_file.bsk_group == 1 and jck1_file.ksk1.dtype == jnp.int64
    rng = np.random.default_rng(12)
    s0 = np.asarray(sk.key_lv0)
    a, b = (_encrypt64(rng, np.where(v, 1 << 61, -(1 << 61)), s0)
            for v in (np.array([0, 1, 1]), np.array([1, 1, 0])))
    want = np.asarray(JG.apply_gates(jnp.arange(3), jnp.asarray(a),
                                     jnp.asarray(b), jck1_file))
    assert np.array_equal(TG.apply_gates(torch.arange(3), _t(a), _t(b),
                                         tck1).numpy(), want)
    # 64-bit ciphertexts, uint64 on disk, both ways
    tser.save_ciphertext(tmp_path / "t_ct", _t(a), TPAR)
    jct, jparams = jser.load_ciphertext(tmp_path / "t_ct.npz")
    assert jparams is JPAR and np.array_equal(np.asarray(jct), a)
    with np.load(tmp_path / "t_ct.npz") as z:
        assert z["ct"].dtype == np.uint64
    jser.save_ciphertext(tmp_path / "j_ct.npz", jnp.asarray(b), JPAR)
    back, tparams = tser.load_ciphertext(tmp_path / "j_ct.npz", device="cpu")
    assert tparams is TPAR and back.dtype == torch.int64
    assert np.array_equal(back.numpy(), b)
    with pytest.raises(TypeError, match="int64"):
        tser.save_ciphertext(tmp_path / "bad", _t(a).to(torch.int32), TPAR)
