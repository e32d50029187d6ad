"""Seeded ciphertexts and their files, the port's threefry against
``jax.random.bits``, the truncated bootstrap and ``generate_no_ksk``.

Bit-equal to the JAX package: utils/threefry.py's bits for random key data
and shapes (jax_threefry_partitionable must be on, as the port reproduces
that mode), ``expand_seeded``, seeded files both ways,
``bootstrap_without_key_switch_truncated`` on a JAX-made key, and
``CloudKey.generate_no_ksk``'s buffers and fields.  Decrypt-level: the
port's own seeded encryption.  Width 64 raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zig_tfhe_tpu import bootstrap as JB
from zig_tfhe_tpu import key as JK
from zig_tfhe_tpu import params as JP
from zig_tfhe_tpu import tlwe as JT
from zig_tfhe_tpu import trlwe as JTR
from zig_tfhe_tpu.utils import serialization as jser
from zig_tfhe_tpu_torch import bootstrap as TB
from zig_tfhe_tpu_torch import key as TK
from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch import tlwe as TT
from zig_tfhe_tpu_torch import trlwe as TTR
from zig_tfhe_tpu_torch.utils import serialization as tser
from zig_tfhe_tpu_torch.utils import threefry

JPAR, TPAR = JP.TEST_TINY, TP.TEST_TINY


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs its test processes side by side (pytest-xdist); with
    one intra-op thread the port's small CPU ops do not wait on pool
    threads that another process holds the cores from."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_jax_threefry_is_partitionable():
    """utils/threefry.py reproduces the partitionable mode; a jax whose
    default flips must fail here, not skip."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("shape", [(7,), (3, 9), (5, 70, 200)])
def test_threefry_bits_equal_jax(shape):
    """Several key data per shape; the last shape's flat index passes
    2^16."""
    rng = np.random.default_rng(sum(shape))
    for kd in [np.zeros(2, np.uint32), np.array([0, 42], np.uint32),
               *rng.integers(0, 2**32, (2, 2), dtype=np.uint32)]:
        want = np.asarray(jax.random.bits(jax.random.wrap_key_data(
            jnp.asarray(kd)), shape, jnp.uint32)).view(np.int32)
        got = threefry.random_bits32(kd, shape)
        assert got.dtype == torch.int32 and got.shape == shape
        assert np.array_equal(got.numpy(), want), kd
        assert torch.equal(threefry.random_bits32(_t(kd.astype(np.int64)),
                                                  shape), got)


@pytest.fixture(scope="module")
def jax_seeded():
    """A JAX TEST_TINY secret key and a seeded batch of 12 bits."""
    sk = JK.SecretKey.generate(jax.random.key(7), JPAR)
    bits = np.random.default_rng(5).integers(0, 2, (3, 4)).astype(bool)
    key = jax.random.key(21)
    seed, b = JT.encrypt_bool_seeded(key, jnp.asarray(bits), 0.0, sk.key_lv0)
    full = JT.encrypt_bool(key, jnp.asarray(bits), 0.0, sk.key_lv0)
    return sk, bits, seed, b, full


def test_expand_seeded_equals_jax(jax_seeded):
    sk, bits, seed, b, full = jax_seeded
    kd = np.asarray(jax.random.key_data(seed))
    got = TT.expand_seeded(kd, _t(b), JPAR.n0)
    assert np.array_equal(got.numpy(), np.asarray(JT.expand_seeded(
        seed, b, JPAR.n0)))
    assert np.array_equal(got.numpy(), np.asarray(full))
    assert torch.equal(TT.decrypt_bool(got, _t(sk.key_lv0)), _t(bits))


def test_seeded_file_jax_to_port(jax_seeded, tmp_path):
    sk, bits, seed, b, full = jax_seeded
    jser.save_seeded_ciphertext(tmp_path / "j", seed, b, JPAR)
    ct, params = tser.load_seeded_ciphertext(tmp_path / "j", device="cpu")
    assert params is TPAR and np.array_equal(ct.numpy(), np.asarray(full))
    (kd, tb), _ = tser.load_seeded_ciphertext(tmp_path / "j", expand=False,
                                              device="cpu")
    assert np.array_equal(kd, np.asarray(jax.random.key_data(seed)))
    assert np.array_equal(tb.numpy(), np.asarray(b))
    tser.save_seeded_ciphertext(tmp_path / "t", kd, tb, params)
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        assert zj.files == zt.files
        for name in zj.files:
            assert zj[name].dtype == zt[name].dtype, name
            assert np.array_equal(zj[name], zt[name]), name


def test_port_seeded_file_to_jax_and_decrypt(tmp_path):
    """The port's encrypt_bool_seeded decrypts exactly; its file loads in
    the JAX package to the port's expanded ciphertext."""
    g = torch.Generator().manual_seed(22)
    sk = TK.SecretKey.generate(g, TPAR)
    bits = torch.tensor([[True, False, True], [False, False, True]])
    seed, b = TT.encrypt_bool_seeded(g, bits, TPAR.tlwe_lv0.alpha, sk.key_lv0)
    assert seed.dtype == np.uint32 and seed.shape == (2,)
    assert b.dtype == torch.int32 and b.shape == bits.shape
    ct = TT.expand_seeded(seed, b, TPAR.n0)
    assert ct.shape == (2, 3, TPAR.n0 + 1)
    assert torch.equal(TT.decrypt_bool(ct, sk.key_lv0), bits)
    tser.save_seeded_ciphertext(tmp_path / "t", seed, b, TPAR)
    jct, params = jser.load_seeded_ciphertext(tmp_path / "t")
    assert params is JPAR and np.array_equal(np.asarray(jct), ct.numpy())


def test_seeded_width64_raises(tmp_path):
    P = TP.TEST_TINY64
    g = torch.Generator().manual_seed(23)
    sk = TK.SecretKey.generate(g, P)
    with pytest.raises(ValueError, match="do not round-trip"):
        TT.encrypt_bool_seeded(g, [True], 0.0, sk.key_lv0, width=64)
    with pytest.raises(ValueError, match="do not round-trip"):
        TT.expand_seeded(np.zeros(2, np.uint32),
                         torch.zeros(1, dtype=torch.int64), P.n0, width=64)
    with pytest.raises(ValueError, match="do not round-trip"):
        tser.save_seeded_ciphertext(tmp_path / "s", np.zeros(2, np.uint32),
                                    torch.zeros(1, dtype=torch.int32), P)


@pytest.fixture(scope="module")
def jax_key():
    sk = JK.SecretKey.generate(jax.random.key(7), JPAR)
    ck = JK.CloudKey.generate(jax.random.key(8), sk, JPAR, group=3)
    tck = TK.CloudKey.from_numpy(
        {n: np.asarray(getattr(ck, n)) for n in ("testvec", "ksk1", "bsk_ntt")},
        TPAR, bsk_ntt_drop=ck.bsk_ntt_drop, bsk_group=ck.bsk_group,
        bsk_levels=ck.bsk_levels, bsk_bgbit=ck.bsk_bgbit, device="cpu")
    return sk, ck, tck


def test_truncated_bootstrap_equals_jax(jax_key):
    sk, ck, tck = jax_key
    bits = np.array([True, False, False, True, True])
    ct = JT.encrypt_bool(jax.random.key(24), jnp.asarray(bits), 0.0,
                         sk.key_lv0)
    want = np.asarray(JB.bootstrap_without_key_switch_truncated(ct, ck))
    got = TB.bootstrap_without_key_switch_truncated(_t(ct), tck)
    assert got.shape == (5, TPAR.n0 + 1) and np.array_equal(got.numpy(), want)
    lv1 = TB.bootstrap_to_lv1(_t(ct), tck)      # the untruncated extract
    assert torch.equal(got, torch.cat([lv1[:, :TPAR.n0], lv1[:, -1:]], -1))


@pytest.mark.parametrize("k", [0, 5])
def test_sample_extract_lv0_shaped(k):
    rng = np.random.default_rng(k)
    ct = rng.integers(-2**31, 2**31, (3, 2, TPAR.N)).astype(np.int32)
    want = np.asarray(JTR.sample_extract_lv0_shaped(jnp.asarray(ct), TPAR.n0, k))
    assert np.array_equal(
        TTR.sample_extract_lv0_shaped(_t(ct), TPAR.n0, k).numpy(), want)
    with pytest.raises(ValueError, match="n0 <= N"):
        TTR.sample_extract_lv0_shaped(_t(ct), TPAR.N + 1, k)


def _fields(ck):
    return (ck.params.name, ck.bsk_ntt_drop, ck.bsk_group,
            None if ck.bsk_levels is None else tuple(ck.bsk_levels),
            ck.bsk_bgbit, ck.pksk_gadget)


_BUFFERS = ("testvec", "ksk1", "bsk_ntt", "bsk_ext_limbs", "pksk")


@pytest.mark.parametrize("knobs", [{}, {"group": None},
                                   {"engines": ("toeplitz",)},
                                   {"group": 2, "decomp_levels": (2, 1)}])
def test_generate_no_ksk_equals_jax(knobs):
    jck = JK.CloudKey.generate_no_ksk(JPAR, **knobs)
    tck = TK.CloudKey.generate_no_ksk(TPAR, device="cpu", **knobs)
    assert _fields(tck) == _fields(jck)
    for name in _BUFFERS:
        want, got = getattr(jck, name), getattr(tck, name)
        if want is None:
            assert got is None, name
            continue
        assert got.numpy().dtype == np.asarray(want).dtype, name
        assert np.array_equal(got.numpy(), np.asarray(want)), name


@pytest.mark.parametrize("knobs", [{}, {"group": None},
                                   {"engines": ("toeplitz",)}])
def test_generate_no_ksk_shapes_128bit(knobs):
    """At SECURITY_128_BIT the shapes, dtypes and fields only (the JAX
    arrays are not made: jax.eval_shape traces without computing)."""
    jck = jax.eval_shape(lambda: JK.CloudKey.generate_no_ksk(
        JP.SECURITY_128_BIT, **knobs))
    tck = TK.CloudKey.generate_no_ksk(TP.SECURITY_128_BIT, device="meta",
                                      **knobs)
    assert _fields(tck) == _fields(jck)
    for name in _BUFFERS:
        want, got = getattr(jck, name), getattr(tck, name)
        assert (got is None) == (want is None), name
        if want is not None:
            assert tuple(got.shape) == tuple(want.shape), name
            assert str(got.dtype)[6:] == str(want.dtype), name
