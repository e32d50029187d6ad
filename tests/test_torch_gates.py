"""The port's gate path as a whole, against the JAX package.

A TEST_TINY cloud key made by the JAX package (group 3, forced) is carried
into the port; all 10 gates over all 4 input pairs run through
``apply_gates`` in both packages on the same ciphertexts and must agree bit
for bit and decrypt to the truth tables.  The key also round-trips through
the JAX package's ``.npz`` format into the port's loader.  The port's own
key generation (torch.Generator randomness, so different bits) is held at
the decrypt level.  Finally the port must import and run with jax blocked.
"""

import os
import subprocess
import sys

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
from zig_tfhe_tpu.ops import keyswitch as jks
from zig_tfhe_tpu.utils import serialization as jser
from zig_tfhe_tpu_torch import key as TK
from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch import tlwe as TT
from zig_tfhe_tpu_torch.models import gates as TG
from zig_tfhe_tpu_torch.ops import keyswitch as tks
from zig_tfhe_tpu_torch.utils import serialization as tser

_IDS = np.repeat(np.arange(10), 4).astype(np.int32)
_X = np.tile([False, False, True, True], 10)
_Y = np.tile([False, True, False, True], 10)
_WANT = np.array([TRUTH_TABLES[JG.GATE_NAMES[i]](bool(x), bool(y))
                  for i, x, y in zip(_IDS, _X, _Y)])


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jax_keys():
    params = JP.TEST_TINY
    sk = JK.SecretKey.generate(jax.random.key(7), params)
    ck = JK.CloudKey.generate(jax.random.key(8), sk, params, group=3)
    return sk, ck


@pytest.fixture(scope="module")
def port_key(jax_keys):
    _, ck = jax_keys
    arrays = {k: np.asarray(getattr(ck, k)) for k in ("testvec", "ksk1",
                                                      "bsk_ntt")}
    return TK.CloudKey.from_numpy(
        arrays, TP.TEST_TINY, bsk_ntt_drop=ck.bsk_ntt_drop,
        bsk_group=ck.bsk_group, bsk_levels=ck.bsk_levels,
        bsk_bgbit=ck.bsk_bgbit)


@pytest.fixture(scope="module")
def jax_inputs(jax_keys):
    sk, _ = jax_keys
    a = JT.encrypt_bool(jax.random.key(1), jnp.asarray(_X), 0.0, sk.key_lv0)
    b = JT.encrypt_bool(jax.random.key(2), jnp.asarray(_Y), 0.0, sk.key_lv0)
    return np.asarray(a), np.asarray(b)


def test_apply_gates_bit_equal_with_jax(jax_keys, port_key, jax_inputs):
    sk, ck = jax_keys
    a, b = jax_inputs
    want = np.asarray(JG.apply_gates(jnp.asarray(_IDS), jnp.asarray(a),
                                     jnp.asarray(b), ck))
    got = TG.apply_gates(_t(_IDS), _t(a), _t(b), port_key)
    assert got.dtype == torch.int32 and got.shape == (40, TP.TEST_TINY.n0 + 1)
    assert np.array_equal(got.numpy(), want)
    dec = TT.decrypt_bool(got, _t(sk.key_lv0)).numpy()
    assert np.array_equal(dec, _WANT)


def test_gate_mux_and_free_gates_bit_equal(jax_keys, port_key, jax_inputs):
    sk, ck = jax_keys
    a, b = jax_inputs
    c = a[::-1].copy()
    want = np.asarray(JG.gate("xor", jnp.asarray(a), jnp.asarray(b), ck))
    assert np.array_equal(TG.gate("xor", _t(a), _t(b), port_key).numpy(), want)
    want = np.asarray(JG.mux(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), ck))
    got = TG.mux(_t(a), _t(b), _t(c), port_key)
    assert np.array_equal(got.numpy(), want)
    sel = TT.decrypt_bool(got, _t(sk.key_lv0)).numpy()
    assert np.array_equal(sel, np.where(_X, _Y, _X[::-1]))
    assert np.array_equal(TG.not_(_t(a)).numpy(), np.asarray(JG.not_(jnp.asarray(a))))
    assert torch.equal(TG.copy(_t(a)), _t(a))
    for v in (True, False):
        assert np.array_equal(
            TG.constant(v, TP.TEST_TINY, (3,)).numpy(),
            np.asarray(JG.constant(v, JP.TEST_TINY, (3,))))


def test_identity_key_switch_real_key_bit_equal(jax_keys, port_key):
    _, ck = jax_keys
    ct = np.random.default_rng(4).integers(
        -2**31, 2**31, (6, JP.TEST_TINY.N + 1)).astype(np.int32)
    want = np.asarray(jks.identity_key_switch(jnp.asarray(ct), ck.ksk1,
                                              JP.TEST_TINY))
    got = tks.identity_key_switch(_t(ct), port_key.ksk1, TP.TEST_TINY)
    assert np.array_equal(got.numpy(), want)


def test_npz_roundtrip_from_jax(jax_keys, port_key, jax_inputs, tmp_path):
    sk, ck = jax_keys
    jser.save_cloud_key(tmp_path / "ck", ck)
    jser.save_secret_key(tmp_path / "sk", sk, JP.TEST_TINY)
    loaded = tser.load_cloud_key(tmp_path / "ck")
    tsk, tparams = tser.load_secret_key(tmp_path / "sk")
    assert loaded.params is TP.TEST_TINY and tparams is TP.TEST_TINY
    assert (loaded.bsk_ntt_drop, loaded.bsk_group, loaded.bsk_levels,
            loaded.bsk_bgbit) == (ck.bsk_ntt_drop, ck.bsk_group,
                                  tuple(ck.bsk_levels), ck.bsk_bgbit)
    for name, buf in loaded.named_buffers():
        assert np.array_equal(buf.numpy(), np.asarray(getattr(ck, name))), name
    assert np.array_equal(tsk.key_lv0.numpy(), np.asarray(sk.key_lv0))
    a, b = jax_inputs
    got = TG.apply_gates(_t(_IDS), _t(a), _t(b), loaded)
    assert np.array_equal(
        got.numpy(), TG.apply_gates(_t(_IDS), _t(a), _t(b), port_key).numpy())
    with pytest.raises(ValueError, match="expected a 'cloud_key'"):
        tser.load_cloud_key(tmp_path / "sk")


@pytest.mark.parametrize("group", [None, 1, 3])
def test_port_keygen_decrypts_truth_tables(group):
    params = TP.TEST_TINY
    g = torch.Generator().manual_seed(11)
    sk = TK.SecretKey.generate(g, params)
    ck = TK.CloudKey.generate(g, sk, params, group=group)
    assert ck.bsk_group == (2 if group is None else group)
    assert {n for n, _ in ck.named_buffers()} == {"testvec", "ksk1", "bsk_ntt"}
    a = TT.encrypt_bool(g, _t(_X), params.ksk_alpha, sk.key_lv0)
    b = TT.encrypt_bool(g, _t(_Y), params.ksk_alpha, sk.key_lv0)
    out = TG.apply_gates(_t(_IDS), a, b, ck)
    assert np.array_equal(TT.decrypt_bool(out, sk.key_lv0).numpy(), _WANT)


def test_port_encrypt_decrypts_under_jax():
    """A port encryption under a key carried from JAX decrypts in JAX."""
    sk = JK.SecretKey.generate(jax.random.key(3), JP.TEST_TINY)
    g = torch.Generator().manual_seed(5)
    ct = TT.encrypt_bool(g, _t(_X), 0.0, _t(sk.key_lv0))
    assert np.array_equal(
        np.asarray(JT.decrypt_bool(jnp.asarray(ct.numpy()), sk.key_lv0)), _X)


_NO_JAX = r"""
import sys
sys.modules["jax"] = None       # any `import jax` now raises ImportError
import torch
import zig_tfhe_tpu_torch
from zig_tfhe_tpu_torch import params, key, tlwe
from zig_tfhe_tpu_torch.models import gates
from zig_tfhe_tpu_torch.ops.cuda import ntt_inverse
from zig_tfhe_tpu_torch.utils import serialization
assert not any(m == "zig_tfhe_tpu" or m.startswith("zig_tfhe_tpu.")
               for m in sys.modules)
g = torch.Generator().manual_seed(0)
P = params.TEST_TINY
sk = key.SecretKey.generate(g, P)
ck = key.CloudKey.generate(g, sk, P, group=3)
a = tlwe.encrypt_bool(g, [True, True], 0.0, sk.key_lv0)
b = tlwe.encrypt_bool(g, [True, False], 0.0, sk.key_lv0)
out = gates.gate("nand", a, b, ck)
assert tlwe.decrypt_bool(out, sk.key_lv0).tolist() == [False, True]
print("ok")
"""


def test_port_imports_and_runs_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=root,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": root})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
