"""The port's save side of keys and ciphertexts against the JAX package's
file format, both ways.

A key the JAX package made, saved by the port, gives the file the JAX
package writes (manifest and arrays).  Keys the port made (a group-3 NTT
key and a Toeplitz-form key, TEST_TINY) and a port ciphertext load into
zig_tfhe_tpu.utils.serialization, and JAX gates on the loaded key return
the port's bits; a JAX-saved ciphertext loads into the port.  Reloaded
parameters are the stock instances.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import TRUTH_TABLES
from zig_tfhe_tpu import key as JK
from zig_tfhe_tpu import params as JP
from zig_tfhe_tpu import tlwe as JT
from zig_tfhe_tpu.models import gates as JG
from zig_tfhe_tpu.utils import serialization as jser
from zig_tfhe_tpu_torch import key as TK
from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch import tlwe as TT
from zig_tfhe_tpu_torch.models import gates as TG
from zig_tfhe_tpu_torch.utils import serialization as tser

_IDS = np.repeat(np.arange(10), 4).astype(np.int32)
_X = np.tile([False, False, True, True], 10)
_Y = np.tile([False, True, False, True], 10)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def port_keys():
    """Port-made TEST_TINY keys: the secret key, a group-3 NTT cloud key
    and a Toeplitz-form cloud key."""
    g = torch.Generator().manual_seed(41)
    sk = TK.SecretKey.generate(g, TP.TEST_TINY)
    return (sk, TK.CloudKey.generate(g, sk, TP.TEST_TINY, group=3),
            TK.CloudKey.generate(g, sk, TP.TEST_TINY, engines=("toeplitz",)))


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_port_save_of_a_jax_key_is_the_jax_file(tmp_path):
    sk = JK.SecretKey.generate(jax.random.key(7), JP.TEST_TINY)
    ck = JK.CloudKey.generate(jax.random.key(8), sk, JP.TEST_TINY, group=3)
    jser.save_cloud_key(tmp_path / "j_ck", ck)
    jser.save_secret_key(tmp_path / "j_sk", sk, JP.TEST_TINY)
    tck = tser.load_cloud_key(tmp_path / "j_ck", device="cpu")
    tsk, tparams = tser.load_secret_key(tmp_path / "j_sk", device="cpu")
    tser.save_cloud_key(tmp_path / "t_ck", tck)
    tser.save_secret_key(tmp_path / "t_sk", tsk, tparams)
    for kind in ("ck", "sk"):
        want, got = (_npz(tmp_path / f"{p}_{kind}.npz") for p in "jt")
        assert list(got) == list(want)
        for name in want:
            assert got[name].dtype == want[name].dtype, name
            assert np.array_equal(got[name], want[name]), name
        assert bytes(got["__manifest__"]) == bytes(want["__manifest__"])
    m = json.loads(bytes(_npz(tmp_path / "t_ck.npz")["__manifest__"]))
    assert m["format"] == "zig_tfhe_tpu.v1" and m["kind"] == "cloud_key"
    assert (m["bsk_ntt_drop"], m["bsk_group"], m["bsk_levels"],
            m["bsk_bgbit"]) == (ck.bsk_ntt_drop, 3, list(ck.bsk_levels),
                                ck.bsk_bgbit)


@pytest.mark.parametrize("form", ["ntt", "toeplitz"])
def test_port_saved_keys_run_jax_gates(port_keys, tmp_path, form):
    sk, ck_ntt, ck_toep = port_keys
    ck = ck_ntt if form == "ntt" else ck_toep
    tser.save_secret_key(tmp_path / "sk", sk, TP.TEST_TINY)
    tser.save_cloud_key(tmp_path / "ck", ck)
    jsk, jparams = jser.load_secret_key(tmp_path / "sk")
    jck = jser.load_cloud_key(tmp_path / "ck")
    assert jparams is JP.TEST_TINY and jck.params is JP.TEST_TINY
    assert (jck.bsk_ntt is None) == (form == "toeplitz")
    assert (jck.bsk_ext_limbs is None) == (form == "ntt")
    for name, buf in ck.named_buffers():
        got = np.asarray(getattr(jck, name))
        assert got.dtype == buf.numpy().dtype and np.array_equal(got, buf), name
    assert (jck.bsk_ntt_drop, jck.bsk_group, jck.bsk_bgbit) == (
        ck.bsk_ntt_drop, ck.bsk_group, ck.bsk_bgbit)
    assert jck.bsk_levels == ck.bsk_levels
    a = JT.encrypt_bool(jax.random.key(1), jnp.asarray(_X), 0.0, jsk.key_lv0)
    b = JT.encrypt_bool(jax.random.key(2), jnp.asarray(_Y), 0.0, jsk.key_lv0)
    want = np.asarray(JG.apply_gates(jnp.asarray(_IDS), a, b, jck))
    got = TG.apply_gates(_t(_IDS), _t(a), _t(b), ck)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        np.asarray(JT.decrypt_bool(jnp.asarray(want), jsk.key_lv0)),
        [TRUTH_TABLES[TG.GATE_NAMES[i]](bool(x), bool(y))
         for i, x, y in zip(_IDS, _X, _Y)])
    # and back: the port reloads its own file to the same key
    again = tser.load_cloud_key(tmp_path / "ck", device="cpu")
    assert again.params is TP.TEST_TINY
    for name, buf in ck.named_buffers():
        assert torch.equal(getattr(again, name), buf), name


def test_ciphertexts_cross_load_both_ways(port_keys, tmp_path):
    sk, _, _ = port_keys
    g = torch.Generator().manual_seed(3)
    ct = TT.encrypt_bool(g, _t(_X[:6].reshape(2, 3)), TP.TEST_TINY.ksk_alpha,
                         sk.key_lv0)
    tser.save_ciphertext(tmp_path / "t_ct", ct, TP.TEST_TINY)
    jct, jparams = jser.load_ciphertext(tmp_path / "t_ct")
    assert jparams is JP.TEST_TINY
    assert jct.dtype == jnp.int32 and np.array_equal(np.asarray(jct), ct)
    assert _npz(tmp_path / "t_ct.npz")["ct"].dtype == np.uint32
    back, tparams = tser.load_ciphertext(tmp_path / "t_ct", device="cpu")
    assert tparams is TP.TEST_TINY and torch.equal(back, ct)

    jsk = JK.SecretKey.generate(jax.random.key(5), JP.TEST_TINY)
    want = JT.encrypt_bool(jax.random.key(6), jnp.asarray(_X), 0.0,
                           jsk.key_lv0)
    jser.save_ciphertext(tmp_path / "j_ct.npz", want, JP.TEST_TINY)
    got, tparams = tser.load_ciphertext(tmp_path / "j_ct.npz", device="cpu")
    assert tparams is TP.TEST_TINY
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(),
                                                       np.asarray(want))
    with pytest.raises(TypeError, match="int32"):
        tser.save_ciphertext(tmp_path / "bad", ct.long(), TP.TEST_TINY)
    with pytest.raises(ValueError, match="expected a 'cloud_key'"):
        tser.load_cloud_key(tmp_path / "j_ct.npz", device="cpu")
    tser.save_secret_key(tmp_path / "sk", sk, TP.TEST_TINY)
    with pytest.raises(ValueError, match="expected a 'ciphertext'"):
        tser.load_ciphertext(tmp_path / "sk", device="cpu")
