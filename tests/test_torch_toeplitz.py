"""The port's Toeplitz engine and K3's plain version against the JAX package.

* K3's plain version, ops/cuda/extprod.py:extprod_matmul_reference, is
  bit-equal to the TPU kernel it replaces,
  zig_tfhe_tpu/ops/pallas/extprod.py:extprod_matmul_pallas, in interpret
  mode, at TEST_TINY and at the 128-bit shapes, with 4 and 3 key limbs.
* The building blocks (negacyclic_rotate for every k in [0, 2N],
  the circulant build, the ext-limb key form), the external product and
  the CMux are bit-equal to the JAX functions, one-limb and multi-limb
  (TEST_TINY_UINT) digits.
* The whole blind rotation is bit-equal to JAX's "xla" and "pallas"
  (interpret mode) engines on a JAX-made Toeplitz-only key, carried over
  by ``from_numpy`` and by the ``.npz`` format, and over three steps of the
  128-bit shapes; the gates on such a key, and on one with 3 key limbs,
  are bit-equal to JAX's.
* The port's own keygen is held at the decrypt level, and what must be
  refused is.

Inputs come from numpy seeds; the tolerance is exact equality.  The CUDA
kernel itself is held against the plain version in
tests/test_torch_cuda.py and, as C++ on the CPU, in
tests/test_torch_kernel_emulation.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_blind_rotate import _cut
from tests.test_torch_gates import _IDS, _WANT, _X, _Y
from zig_tfhe_tpu import key as JK
from zig_tfhe_tpu import params as JP
from zig_tfhe_tpu import tlwe as JT
from zig_tfhe_tpu import trgsw as JTR
from zig_tfhe_tpu.models import gates as JG
from zig_tfhe_tpu.ops import blind_rotate as JBR
from zig_tfhe_tpu.ops import poly as JPOLY
from zig_tfhe_tpu.ops.pallas.extprod import extprod_matmul_pallas
from zig_tfhe_tpu.utils import serialization as jser
from zig_tfhe_tpu_torch import key as TK
from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch import tlwe as TT
from zig_tfhe_tpu_torch import trgsw as TTR
from zig_tfhe_tpu_torch import trlwe as TTRL
from zig_tfhe_tpu_torch.models import gates as TG
from zig_tfhe_tpu_torch.ops import blind_rotate as TBR
from zig_tfhe_tpu_torch.ops import poly as TPOLY
from zig_tfhe_tpu_torch.ops.cuda import extprod as K3
from zig_tfhe_tpu_torch.ops.keyswitch import identity_key_switch
from zig_tfhe_tpu_torch.utils import serialization as tser
from zig_tfhe_tpu_torch.utils.torus import to_carrier, torus_constant_w


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(name):
    return JP.PARAMS_BY_NAME[name], TP.PARAMS_BY_NAME[name]


def _ext_key(jp, rng, lead=(), n_kl=4):
    """An ext-limb TRGSW (JAX to_ext_limbs of uniform rows): int8
    [*lead, n_kl, 2L, 2, 2N]."""
    rows = rng.integers(-2**31, 2**31, lead + (2 * jp.L, 2, jp.N)).astype(np.int32)
    return np.asarray(JTR.to_ext_limbs(jnp.asarray(rows), n_kl))


def _digits(jp, rng, B):
    half = 1 << (jp.bgbit - 1)
    return rng.integers(-half, half, (B, 2 * jp.L * jp.N)).astype(np.int8)


@pytest.mark.parametrize("name, n_kl", [("tiny", 4), ("tiny", 3),
                                        ("128bit", 4), ("128bit", 3)])
def test_kernel_plain_version_matches_pallas(name, n_kl):
    jp, tp = _pair(name)
    rng = np.random.default_rng(n_kl)
    d, ext = _digits(jp, rng, 8), _ext_key(jp, rng, n_kl=n_kl)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(extprod_matmul_pallas(jnp.asarray(d), jnp.asarray(ext), jp))
    got = K3.extprod_matmul_reference(_t(d), _t(ext), tp)
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, 2 * jp.N)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["tiny", "128bit"])
def test_negacyclic_rotate_every_k(name):
    jp, _ = _pair(name)
    N = jp.N
    rng = np.random.default_rng(N)
    p = rng.integers(-2**31, 2**31, (5, 2, N)).astype(np.int32)
    for k in (0, 1, N, 2 * N - 1, 2 * N):
        want = np.asarray(JPOLY.negacyclic_rotate(jnp.asarray(p), k))
        assert np.array_equal(TPOLY.negacyclic_rotate(_t(p), k).numpy(), want), k
        assert np.array_equal(
            TPOLY.negacyclic_rotate(_t(p), torch.tensor(k, dtype=torch.int32)).numpy(),
            want), k
    ks = np.array([0, 1, N, 2 * N - 1, 2 * N], np.int32)
    want = np.asarray(JPOLY.negacyclic_rotate(jnp.asarray(p), jnp.asarray(ks)))
    assert np.array_equal(TPOLY.negacyclic_rotate(_t(p), _t(ks)).numpy(), want)
    assert np.array_equal(TPOLY.negacyclic_rotate(_t(p), 2 * N).numpy(), p)


def test_toeplitz_build_and_extend():
    rng = np.random.default_rng(3)
    p = rng.integers(-128, 128, (2, 3, 64)).astype(np.int8)
    ext = np.asarray(JPOLY.negacyclic_extend(jnp.asarray(p)))
    assert np.array_equal(TPOLY.negacyclic_extend(_t(p)).numpy(), ext)
    want = np.asarray(JPOLY.toeplitz_from_ext(jnp.asarray(ext)))
    assert np.array_equal(TPOLY.toeplitz_from_ext(_t(ext)).numpy(), want)
    assert np.array_equal(TPOLY.toeplitz_from_ext(_t(ext)).numpy(),
                          np.asarray(JPOLY.toeplitz_gather_reference(jnp.asarray(ext))))
    assert np.array_equal(TPOLY.toeplitz(_t(p)).numpy(),
                          np.asarray(JPOLY.toeplitz(jnp.asarray(p))))


@pytest.mark.parametrize("n_kl", [4, 3, 2])
def test_to_ext_limbs(n_kl):
    rng = np.random.default_rng(n_kl)
    ct = rng.integers(-2**31, 2**31, (3, 6, 2, 64)).astype(np.int32)
    ct[0, 0, 0, :4] = [2**31 - 1, -2**31, 2**23 - 1, -2**23]   # rounding edges
    want = np.asarray(JTR.to_ext_limbs(jnp.asarray(ct), n_kl))
    got = TTR.to_ext_limbs(_t(ct), n_kl)
    assert got.dtype == torch.int8 and got.is_contiguous()
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_kl", [4, 3])
def test_trgsw_matrices(n_kl):
    jp, tp = _pair("tiny")
    ext = _ext_key(jp, np.random.default_rng(5), n_kl=n_kl)
    want = np.asarray(JBR._trgsw_matrices(jnp.asarray(ext), jp))
    got = TTR.trgsw_matrices(_t(ext), tp)
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    assert TTR.N_KLIMBS == JTR.N_KLIMBS == 4


def test_encrypt_torus_phase_is_the_gadget():
    """TRGSW rows at alpha = 0: each row's phase b - a*s is p * h_i in a[0]
    (rows 0..L-1, as a-multiples) or b[0] (rows L..2L-1)."""
    tp = TP.TEST_TINY
    g = torch.Generator().manual_seed(4)
    sk = TK.SecretKey.generate(g, tp)
    p = torch.tensor([0, 1, 1], dtype=torch.int32)
    ct = TTR.encrypt_torus(g, p, 0.0, sk.key_lv1, tp)          # [3, 2L, 2, N]
    assert tuple(ct.shape) == (3, 2 * tp.L, 2, tp.N)
    a, b = ct[..., 0, :], ct[..., 1, :]
    phase = b - TPOLY.negacyclic_polymul_binary(a, sk.key_lv1)
    h = torch.from_numpy(TTR.gadget_scales(tp.bgbit, tp.L))
    want = torch.zeros_like(phase)
    want[:, tp.L:, 0] = p[:, None] * h                  # b-rows: +p*h_i
    a_part = torch.zeros_like(a[:, :tp.L])
    a_part[..., 0] = p[:, None] * h                     # a-rows: -(p*h_i)*s
    want[:, :tp.L] = -TPOLY.negacyclic_polymul_binary(a_part, sk.key_lv1)
    assert torch.equal(phase, want)


@pytest.mark.parametrize("name, n_kl", [("tiny", 4), ("tiny_uint", 4),
                                        ("tiny_uint", 3), ("128bit", 4),
                                        ("128bit", 3)])
def test_external_product_and_cmux(name, n_kl):
    jp, tp = _pair(name)
    rng = np.random.default_rng(len(name) + n_kl)
    ext = _ext_key(jp, rng, n_kl=n_kl)
    ct0, ct1 = (rng.integers(-2**31, 2**31, (4, 2, jp.N)).astype(np.int32)
                for _ in range(2))
    want = np.asarray(JBR.external_product(jnp.asarray(ext), jnp.asarray(ct1), jp))
    assert np.array_equal(TBR.external_product(_t(ext), _t(ct1), tp).numpy(), want)
    want = np.asarray(JBR.cmux(jnp.asarray(ext), jnp.asarray(ct0),
                               jnp.asarray(ct1), jp))
    assert np.array_equal(TBR.cmux(_t(ext), _t(ct0), _t(ct1), tp).numpy(), want)


@pytest.fixture(scope="module")
def jax_toep():
    """A JAX-made TEST_TINY key with the Toeplitz BSK only, and encryptions
    of the gate inputs under it."""
    params = JP.TEST_TINY
    sk = JK.SecretKey.generate(jax.random.key(31), params)
    ck = JK.CloudKey.generate(jax.random.key(32), sk, params,
                              engines=("toeplitz",))
    assert ck.bsk_ntt is None and ck.bsk_ext_limbs is not None
    a = JT.encrypt_bool(jax.random.key(1), jnp.asarray(_X), 0.0, sk.key_lv0)
    b = JT.encrypt_bool(jax.random.key(2), jnp.asarray(_Y), 0.0, sk.key_lv0)
    return sk, ck, np.asarray(a), np.asarray(b)


def _from_jax(ck):
    arrays = {k: np.asarray(getattr(ck, k)) for k in ("testvec", "ksk1",
                                                      "bsk_ext_limbs")}
    return TK.CloudKey.from_numpy(
        arrays, TP.TEST_TINY, bsk_ntt_drop=ck.bsk_ntt_drop,
        bsk_group=ck.bsk_group, bsk_levels=ck.bsk_levels,
        bsk_bgbit=ck.bsk_bgbit, device="cpu")


def test_blind_rotate_tiny_matches_jax_engines(jax_toep, tmp_path):
    _, ck, _, _ = jax_toep
    jser.save_cloud_key(tmp_path / "ck", ck)
    loaded = tser.load_cloud_key(tmp_path / "ck", device="cpu")
    assert loaded.bsk_ntt is None and loaded.params is TP.TEST_TINY
    assert {n for n, _ in loaded.named_buffers()} == {"testvec", "ksk1",
                                                      "bsk_ext_limbs"}
    assert np.array_equal(loaded.bsk_ext_limbs.numpy(), np.asarray(ck.bsk_ext_limbs))
    ct = np.random.default_rng(9).integers(
        -2**31, 2**31, (6, JP.TEST_TINY.n0 + 1)).astype(np.int32)
    ct[0, -1] = 0          # modswitch(b) = 0: the test vector rotates by 2N
    args = (jnp.asarray(ct), ck.testvec, ck.bsk_ext_limbs, JP.TEST_TINY)
    want = np.asarray(JBR.blind_rotate_toeplitz(*args, engine="xla"))
    with pltpu.force_tpu_interpret_mode():
        assert np.array_equal(
            np.asarray(JBR.blind_rotate_toeplitz(*args, engine="pallas")), want)
    for port_ck in (_from_jax(ck), loaded):
        got = TBR.blind_rotate_toeplitz(_t(ct), port_ck.testvec,
                                        port_ck.bsk_ext_limbs, TP.TEST_TINY)
        assert np.array_equal(got.numpy(), want)
        got = TBR.blind_rotate(_t(ct), port_ck.testvec, port_ck, TP.TEST_TINY)
        assert np.array_equal(got.numpy(), want)


def test_blind_rotate_128bit_steps_match_jax():
    """Three steps (n0 cut to 3) at the 128-bit shapes: N = 1024, the
    reference gadget Bg = 2^6 with L = 3, 4 key limbs."""
    jp, tp = _cut(JP, 3), _cut(TP, 3)
    rng = np.random.default_rng(128)
    bsk = _ext_key(jp, rng, lead=(3,))                 # [3, 4, 6, 2, 2048]
    ct = rng.integers(-2**31, 2**31, (4, 4)).astype(np.int32)
    tv = rng.integers(-2**31, 2**31, (2, jp.N)).astype(np.int32)
    want = np.asarray(JBR.blind_rotate_toeplitz(
        jnp.asarray(ct), jnp.asarray(tv), jnp.asarray(bsk), jp, engine="xla"))
    got = TBR.blind_rotate_toeplitz(_t(ct), _t(tv), _t(bsk), tp)
    assert np.array_equal(got.numpy(), want)


def test_gates_on_toeplitz_key_match_jax(jax_toep):
    sk, ck, a, b = jax_toep
    port_ck = _from_jax(ck)
    want = np.asarray(JG.apply_gates(jnp.asarray(_IDS), jnp.asarray(a),
                                     jnp.asarray(b), ck))
    got = TG.apply_gates(_t(_IDS), _t(a), _t(b), port_ck)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(TT.decrypt_bool(got, _t(sk.key_lv0)).numpy(), _WANT)
    want = np.asarray(JG.gate("nor", jnp.asarray(a), jnp.asarray(b), ck))
    assert np.array_equal(TG.gate("nor", _t(a), _t(b), port_ck).numpy(), want)
    c = a[::-1].copy()
    want = np.asarray(JG.mux(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), ck))
    got = TG.mux(_t(a), _t(b), _t(c), port_ck)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(TT.decrypt_bool(got, _t(sk.key_lv0)).numpy(),
                          np.where(_X, _Y, _X[::-1]))


def test_jax_three_limb_key_matches_jax(jax_toep):
    """A JAX key made with bsk_limbs=3 loads as it is (K3 takes n_kl from
    the key's shape) and its gates are bit-equal to JAX's."""
    sk, _, a, b = jax_toep
    ck = JK.CloudKey.generate(jax.random.key(33), sk, JP.TEST_TINY,
                              engines=("toeplitz",), bsk_limbs=3)
    port_ck = _from_jax(ck)
    assert port_ck.bsk_ext_limbs.shape[1] == 3
    want = np.asarray(JG.apply_gates(jnp.asarray(_IDS), jnp.asarray(a),
                                     jnp.asarray(b), ck))
    got = TG.apply_gates(_t(_IDS), _t(a), _t(b), port_ck)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(TT.decrypt_bool(got, _t(sk.key_lv0)).numpy(), _WANT)


def _xor_toeplitz(a, b, ck):
    """XOR through the Toeplitz engine, whatever other form the key holds."""
    ca, cb, frac = TG.GATE_DEFS["xor"]
    combo = ca * a + cb * b
    combo[..., ck.params.n0] += to_carrier(torus_constant_w(frac, 32), 32)
    tr = TBR.blind_rotate_toeplitz(combo, ck.testvec, ck.bsk_ext_limbs,
                                   ck.params)
    return identity_key_switch(TTRL.sample_extract(tr, 0), ck.ksk1, ck.params)


@pytest.mark.parametrize("engines", [("toeplitz",), ("ntt", "toeplitz")])
def test_port_keygen_decrypts_truth_tables(engines):
    params = TP.TEST_TINY
    g = torch.Generator().manual_seed(13)
    sk = TK.SecretKey.generate(g, params)
    ck = TK.CloudKey.generate(g, sk, params, engines=engines)
    ext = ck.bsk_ext_limbs
    assert ext.dtype == torch.int8 and tuple(ext.shape) == (
        params.n0, 4, 2 * params.L, 2, 2 * params.N)
    assert (ck.bsk_ntt is None) == (engines == ("toeplitz",))
    if ck.bsk_ntt is None:
        assert (ck.bsk_group, ck.bsk_levels, ck.bsk_bgbit) == (1, None, None)
    a = TT.encrypt_bool(g, _t(_X), params.ksk_alpha, sk.key_lv0)
    b = TT.encrypt_bool(g, _t(_Y), params.ksk_alpha, sk.key_lv0)
    out = TG.apply_gates(_t(_IDS), a, b, ck)
    assert np.array_equal(TT.decrypt_bool(out, sk.key_lv0).numpy(), _WANT)
    out = _xor_toeplitz(a, b, ck)
    assert np.array_equal(TT.decrypt_bool(out, sk.key_lv0).numpy(), _X != _Y)


def test_port_keygen_draws_separate_masks():
    """The two key forms of one key come from separate draws (their first
    rows' masks differ)."""
    params = TP.TEST_TINY
    g = torch.Generator().manual_seed(14)
    sk = TK.SecretKey.generate(g, params)
    g1, g2 = (torch.Generator().manual_seed(15) for _ in range(2))
    both = TK.CloudKey.generate(g1, sk, params, engines=("ntt", "toeplitz"))
    toep = TK.CloudKey.generate(g2, sk, params, engines=("toeplitz",))
    assert torch.equal(both.ksk1, toep.ksk1)
    assert not torch.equal(both.bsk_ext_limbs, toep.bsk_ext_limbs)


def test_refusals(jax_toep, tmp_path):
    ck = jax_toep[1]
    with pytest.raises(ValueError, match="Toeplitz"):
        TK.CloudKey.generate(torch.Generator(), None, TP.TEST_TINY64,
                             engines=("ntt", "toeplitz"))
    g = torch.Generator().manual_seed(16)
    with pytest.raises(ValueError, match="no bootstrapping key"):
        TK.CloudKey.generate(g, TK.SecretKey.generate(g, TP.TEST_TINY),
                             TP.TEST_TINY, engines=())
    # a cloud key file with neither bootstrapping-key form
    jser.save_cloud_key(tmp_path / "nobsk", JK.CloudKey(
        testvec=ck.testvec, ksk1=ck.ksk1, params=JP.TEST_TINY))
    with pytest.raises(ValueError, match="no bootstrapping key"):
        tser.load_cloud_key(tmp_path / "nobsk", device="cpu")


def test_wrapper_on_cpu_and_its_refusals():
    tp = TP.TEST_TINY
    rng = np.random.default_rng(17)
    d, ext = _t(_digits(tp, rng, 3)), _t(_ext_key(JP.TEST_TINY, rng, n_kl=3))
    before = K3.extprod_matmul.launches
    got = K3.extprod_matmul(d, ext, tp)
    assert K3.extprod_matmul.launches == before
    assert torch.equal(got, K3.extprod_matmul_reference(d, ext, tp))
    with pytest.raises(TypeError, match="int8"):
        K3.extprod_matmul(d.int(), ext, tp)
    with pytest.raises(TypeError, match="int8"):
        K3.extprod_matmul(d, ext.short(), tp)
    with pytest.raises(ValueError, match="shapes"):
        K3.extprod_matmul(d[:, :-1], ext, tp)
    with pytest.raises(ValueError, match="shapes"):
        K3.extprod_matmul(d, ext[:, :3], tp)
    with pytest.raises(ValueError, match="shapes"):
        K3.extprod_matmul(d, torch.cat([ext, ext[:2]]), tp)
