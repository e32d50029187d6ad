"""The port's proxy re-encryption (models/proxy_reenc.py) and its key files
against the JAX package's.

Bit-equal: the keygen and public-key encryption cores fed the JAX
package's own draws (recomputed from the same jax.random key, as the JAX
functions split and draw it), and ``reencrypt`` on JAX-made keys, one hop
and a 3-hop chain.  Decrypt-level: the port's own keygen and encryption
at TEST_TINY (exact) and one symmetric hop at SECURITY_128_BIT (accuracy
> 0.90 on 100 lanes, the reference's bar).  Files: public and
re-encryption keys cross both ways with byte-equal manifests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zig_tfhe_tpu import key as JK
from zig_tfhe_tpu import params as JP
from zig_tfhe_tpu import tlwe as JT
from zig_tfhe_tpu.models import proxy_reenc as JPR
from zig_tfhe_tpu.utils import rng as JR
from zig_tfhe_tpu.utils import serialization as jser
from zig_tfhe_tpu_torch import key as TK
from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch import tlwe as TT
from zig_tfhe_tpu_torch.models import proxy_reenc as TPR
from zig_tfhe_tpu_torch.utils import serialization as tser

JPAR, TPAR = JP.TEST_TINY, TP.TEST_TINY
ALPHA = 2.0 ** -20     # noise in the cores' draws (TEST_TINY's alphas are 0)


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


@pytest.fixture(scope="module")
def jkeys():
    """Three JAX TEST_TINY secret keys (Alice, Bob, Carol)."""
    return [JK.SecretKey.generate(k, JPAR)
            for k in jax.random.split(jax.random.key(60), 3)]


def _signs(key, shape):
    r = jax.random.randint(key, shape, 0, 4)
    return np.asarray(jnp.where(r == 0, 1, jnp.where(r == 1, -1, 0)), np.int32)


def test_sym_key_core_on_jax_draws(jkeys):
    s_from, s_to = jkeys[0].key_lv0, jkeys[1].key_lv0
    basebit, t = JPAR.basebit, JPAR.iks_t
    key = jax.random.key(66)
    want = np.asarray(JPR._sym_key_core(key, s_from, s_to, ALPHA, basebit, t))
    ka, kn = jax.random.split(key)
    n_from, n_to = s_from.shape[0], s_to.shape[0]
    masks = JR.uniform_torus(ka, (n_from, t, n_to))
    noise = JR.gaussian_torus(kn, (n_from, t), ALPHA)
    assert np.any(np.asarray(noise) != 0)
    got = TPR.sym_key_core(_t(s_from), _t(s_to), _t(masks), _t(noise),
                           basebit, t)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_asym_key_core_on_jax_draws(jkeys):
    s_from = jkeys[0].key_lv0
    bank = JPR.PublicKeyLv0.generate(jax.random.key(68), jkeys[1].key_lv0,
                                     JPAR, alpha=ALPHA).encryptions
    basebit, t = JPAR.basebit, JPAR.iks_t
    key = jax.random.key(69)
    want = np.asarray(JPR._asym_key_core(key, s_from, bank, ALPHA, basebit, t))
    ks, kn = jax.random.split(key)
    shape = (s_from.shape[0], t)
    signs = _signs(ks, shape + (bank.shape[0],))
    noise = JR.gaussian_torus(kn, shape, ALPHA)
    got = TPR.asym_key_core(_t(s_from), _t(bank), _t(signs), _t(noise),
                            basebit, t)
    assert np.array_equal(got.numpy(), want)


def test_public_key_cores_on_jax_draws(jkeys):
    """PublicKeyLv0.generate (a TLWE encryption of zeros) and
    PublicKeyLv0.encrypt_torus (the subset sum) on the JAX draws."""
    s = jkeys[1].key_lv0
    key = jax.random.key(61)
    pk = JPR.PublicKeyLv0.generate(key, s, JPAR, alpha=ALPHA)
    ka, kn = jax.random.split(key)
    size, n = 2 * JPAR.n0, JPAR.n0
    a = JR.uniform_torus(ka, (size, n))
    noise = JR.gaussian_torus(kn, (size,), ALPHA)
    body = TT.encrypt_from_draws(_t(a), _t(noise),
                                 torch.zeros(size, dtype=torch.int32), _t(s))
    assert np.array_equal(torch.cat([_t(a), body[:, None]], -1).numpy(),
                          np.asarray(pk.encryptions))
    mu = np.random.default_rng(3).integers(-2**31, 2**31, 5).astype(np.int32)
    key = jax.random.key(62)
    want = np.asarray(pk.encrypt_torus(key, jnp.asarray(mu), ALPHA))
    ks, kn = jax.random.split(key)
    signs = _signs(ks, (5, size))
    noise = JR.gaussian_torus(kn, (5,), ALPHA)
    got = TPR.pk_encrypt_from_draws(_t(pk.encryptions), _t(mu), _t(signs),
                                    _t(noise))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("hops", [1, 3])
def test_reencrypt_on_jax_keys(jkeys, hops):
    """reencrypt on JAX-made asymmetric keys: one hop Alice -> Bob, and the
    chain Alice -> Bob -> Carol -> Alice, every hop bit-equal."""
    chain = [0, 1, 2, 0][:hops + 1]
    bits = np.array([True, False, True, True, False, False])
    ct_j = JT.encrypt_bool(jax.random.key(70), jnp.asarray(bits), 0.0,
                           jkeys[0].key_lv0)
    ct_t = _t(ct_j)
    for h, (src, dst) in enumerate(zip(chain, chain[1:])):
        pk = JPR.PublicKeyLv0.generate(jax.random.key(80 + h),
                                       jkeys[dst].key_lv0, JPAR)
        rk = JPR.ProxyReencryptionKey.new_asymmetric(
            jax.random.key(90 + h), jkeys[src].key_lv0, pk, JPAR)
        trk = TPR.ProxyReencryptionKey.from_numpy(
            np.asarray(rk.key_encryptions), rk.basebit, rk.t, device="cpu")
        assert trk.base == rk.base
        ct_j = JPR.reencrypt(ct_j, rk)
        ct_t = TPR.reencrypt(ct_t, trk)
        assert np.array_equal(ct_t.numpy(), np.asarray(ct_j)), f"hop {h}"
    assert np.array_equal(np.asarray(JT.decrypt_bool(
        ct_j, jkeys[chain[-1]].key_lv0)), bits)


@pytest.fixture(scope="module")
def port_keys():
    g = torch.Generator().manual_seed(60)
    return [TK.SecretKey.generate(g, TPAR) for _ in range(3)]


def test_port_public_key_encryption_exact(port_keys):
    g = torch.Generator().manual_seed(61)
    pk = TPR.PublicKeyLv0.generate(g, port_keys[0].key_lv0, TPAR)
    assert tuple(pk.encryptions.shape) == (2 * TPAR.n0, TPAR.n0 + 1)
    bits = torch.tensor([True, False, True, True, False])
    ct = pk.encrypt_bool(g, bits, TPAR.tlwe_lv0.alpha)
    assert torch.equal(TT.decrypt_bool(ct, port_keys[0].key_lv0), bits)


@pytest.mark.parametrize("kind", ["symmetric", "asymmetric", "chain"])
def test_port_reencrypt_decrypts(port_keys, kind):
    """The port's own keys at TEST_TINY: one symmetric hop, one asymmetric
    hop, and the asymmetric chain Alice -> Bob -> Carol, each exact."""
    g = torch.Generator().manual_seed(62)
    s = [k.key_lv0 for k in port_keys]
    hops = [(0, 1), (1, 2)] if kind == "chain" else [(0, 1)]
    bits = torch.tensor([True, False, False, True, True, False])
    ct = TT.encrypt_bool(g, bits, 0.0, s[0])
    for src, dst in hops:
        if kind == "symmetric":
            rk = TPR.ProxyReencryptionKey.new_symmetric(g, s[src], s[dst], TPAR)
        else:
            pk = TPR.PublicKeyLv0.generate(g, s[dst], TPAR)
            rk = TPR.ProxyReencryptionKey.new_asymmetric(g, s[src], pk, TPAR)
        assert tuple(rk.key_encryptions.shape) == (TPAR.n0 * TPAR.iks_t,
                                                   TPAR.n0 + 1)
        ct = TPR.reencrypt(ct, rk)
        assert torch.equal(TT.decrypt_bool(ct, s[dst]), bits)


def test_port_reencrypt_statistical_128bit():
    """At real noise (proxy_reenc.zig:401-427): >= 90% of 100 lanes."""
    P = TP.SECURITY_128_BIT
    g = torch.Generator().manual_seed(76)
    alice = TK.SecretKey.generate(g, P)
    bob = TK.SecretKey.generate(g, P)
    rk = TPR.ProxyReencryptionKey.new_symmetric(g, alice.key_lv0,
                                                bob.key_lv0, P)
    assert tuple(rk.key_encryptions.shape) == (P.n0 * P.iks_t, P.n0 + 1)
    bits = torch.from_numpy(np.random.default_rng(42).integers(0, 2, 100)
                            .astype(bool))
    ct = TT.encrypt_bool(g, bits, P.tlwe_lv0.alpha, alice.key_lv0)
    dec = TT.decrypt_bool(TPR.reencrypt(ct, rk), bob.key_lv0)
    assert (dec == bits).float().mean().item() > 0.90


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_file(a, b):
    want, got = _npz(a), _npz(b)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert np.array_equal(got[name], want[name]), name
    assert bytes(got["__manifest__"]) == bytes(want["__manifest__"])


def test_key_files_jax_to_port(jkeys, tmp_path):
    """JAX-written public and re-encryption keys load into the port, and
    the port's save of them is the JAX package's file, byte for byte."""
    pk = JPR.PublicKeyLv0.generate(jax.random.key(71), jkeys[1].key_lv0, JPAR)
    rk = JPR.ProxyReencryptionKey.new_symmetric(
        jax.random.key(72), jkeys[0].key_lv0, jkeys[1].key_lv0, JPAR,
        basebit=4, t=4)
    jser.save_public_key(tmp_path / "j_pk", pk, JPAR)
    jser.save_reenc_key(tmp_path / "j_rk", rk, JPAR)
    tpk, p1 = tser.load_public_key(tmp_path / "j_pk", device="cpu")
    trk, p2 = tser.load_reenc_key(tmp_path / "j_rk", device="cpu")
    assert p1 is TPAR and p2 is TPAR and (trk.basebit, trk.t) == (4, 4)
    assert np.array_equal(tpk.encryptions.numpy(), np.asarray(pk.encryptions))
    assert np.array_equal(trk.key_encryptions.numpy(),
                          np.asarray(rk.key_encryptions))
    tser.save_public_key(tmp_path / "t_pk", tpk, p1)
    tser.save_reenc_key(tmp_path / "t_rk", trk, p2)
    _same_file(tmp_path / "j_pk.npz", tmp_path / "t_pk.npz")
    _same_file(tmp_path / "j_rk.npz", tmp_path / "t_rk.npz")


def test_key_files_port_to_jax(port_keys, tmp_path):
    """Port-written keys load into the JAX package, whose reencrypt on them
    equals the port's."""
    g = torch.Generator().manual_seed(73)
    s = [k.key_lv0 for k in port_keys]
    pk = TPR.PublicKeyLv0.generate(g, s[1], TPAR)
    rk = TPR.ProxyReencryptionKey.new_asymmetric(g, s[0], pk, TPAR)
    tser.save_public_key(tmp_path / "pk", pk, TPAR)
    tser.save_reenc_key(tmp_path / "rk", rk, TPAR)
    jpk, p1 = jser.load_public_key(tmp_path / "pk")
    jrk, p2 = jser.load_reenc_key(tmp_path / "rk")
    assert p1 is JPAR and p2 is JPAR
    assert (jrk.basebit, jrk.t) == (rk.basebit, rk.t)
    assert np.array_equal(np.asarray(jpk.encryptions), pk.encryptions.numpy())
    ct = TT.encrypt_bool(g, torch.tensor([True, False, True]), 0.0, s[0])
    assert np.array_equal(np.asarray(JPR.reencrypt(jnp.asarray(ct.numpy()), jrk)),
                          TPR.reencrypt(ct, rk).numpy())
    with pytest.raises(ValueError, match="expected a 'reenc_key'"):
        tser.load_reenc_key(tmp_path / "pk", device="cpu")
