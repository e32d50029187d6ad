"""The packing key switch (ops/packing_keyswitch.py), the cloud key's
packing key and its files, against the JAX package.

Bit-equal on numpy-seeded inputs and a JAX-made TEST_TINY_UINT packing
key: ``packing_key_switch``, ``spread_blocks`` (the 32-bit NTT round trip
on the bound-41 plan) and ``pack_tlwes_blocks``.  The port's own
``gen_packing_ksk`` is held at the decrypt level (each row's phase is its
plaintext at alpha = 0).  Files: a uint key saved by the JAX package loads
into the port with its ``pksk``; the port's saved cloud key (manifest
included) and stand-alone packing key are byte-equal to the JAX package's
and load there; a file written before ``pksk_gadget`` was recorded takes
the set's (basebit, iks_t).  Tolerance: exact equality.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zig_tfhe_tpu import key as JK
from zig_tfhe_tpu import params as JP
from zig_tfhe_tpu.ops import packing_keyswitch as JPK
from zig_tfhe_tpu.utils import serialization as jser
from zig_tfhe_tpu_torch import key as TK
from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch import trlwe as TR
from zig_tfhe_tpu_torch.ops import packing_keyswitch as TPK
from zig_tfhe_tpu_torch.utils import serialization as tser

JPAR, TPAR = JP.TEST_TINY_UINT, TP.TEST_TINY_UINT


def _t(a):
    return torch.from_numpy(np.array(a))


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def jax_keys():
    sk = JK.SecretKey.generate(jax.random.key(91), JPAR)
    ck = JK.CloudKey.generate(jax.random.key(92), sk, JPAR)
    return sk, ck


def _tlwes(rng, lead, n1):
    return rng.integers(-2**31, 2**31, (*lead, n1 + 1)).astype(np.int32)


@pytest.mark.parametrize("lead, delta", [((4,), 64), ((3, 8), 32), ((2, 2, 2), 128)])
def test_packing_key_switch_matches_jax(jax_keys, lead, delta):
    _, ck = jax_keys
    pksk = np.asarray(ck.pksk)
    basebit, t = ck.pksk_gadget
    tl = _tlwes(np.random.default_rng(delta), lead, TPAR.n1)
    want = np.asarray(JPK.packing_key_switch(jnp.asarray(tl), jnp.asarray(pksk),
                                             basebit, t, delta))
    got = TPK.packing_key_switch(_t(tl), _t(pksk), basebit, t, delta)
    assert got.dtype == torch.int32 and tuple(got.shape) == (*lead[:-1], 2, TPAR.N)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("delta", [2, 16, 128])
def test_spread_blocks_matches_jax(delta):
    rng = np.random.default_rng(delta)
    packed = rng.integers(-2**31, 2**31, (3, 2, TPAR.N)).astype(np.int32)
    want = np.asarray(JPK.spread_blocks(jnp.asarray(packed), delta, JPAR))
    assert np.array_equal(TPK.spread_blocks(_t(packed), delta, TPAR).numpy(), want)
    assert np.array_equal(TPK._window_poly(TPAR.N, delta),
                          JPK._window_poly(JPAR.N, delta))


def test_spread_blocks_refuses_wide_blocks():
    with pytest.raises(ValueError, match="block width"):
        TPK.spread_blocks(torch.zeros((2, TPAR.N), dtype=torch.int32),
                          TPAR.N, TPAR)


@pytest.mark.parametrize("m_hi, lead", [(2, (3,)), (4, (2, 2)), (8, (1,))])
def test_pack_tlwes_blocks_matches_jax(jax_keys, m_hi, lead):
    _, ck = jax_keys
    tl = _tlwes(np.random.default_rng(m_hi), (*lead, m_hi), TPAR.n1)
    want = np.asarray(JPK.pack_tlwes_blocks(jnp.asarray(tl), m_hi, ck.pksk, JPAR))
    got = TPK.pack_tlwes_blocks(_t(tl), m_hi, _t(ck.pksk), TPAR)
    assert np.array_equal(got.numpy(), want)
    assert TPK.default_packing_gadget(TPAR) == JPK.default_packing_gadget(JPAR)


def test_port_packing_key_decrypts_to_its_plaintexts():
    g = torch.Generator().manual_seed(5)
    sk = TK.SecretKey.generate(g, TPAR)
    pksk = TPK.gen_packing_ksk(g, sk.key_lv1, TPAR, alpha=0.0)
    basebit, t = TPK.default_packing_gadget(TPAR)
    assert tuple(pksk.shape) == (TPAR.n1 * t, 2, TPAR.N)
    ph = TR.phase(pksk, sk.key_lv1)                      # [n1*t, N]
    want = torch.zeros_like(ph)
    s1 = sk.key_lv1.long().repeat_interleave(t)
    scale = torch.tensor([1 << (32 - (j + 1) * basebit) for j in range(t)]).repeat(TPAR.n1)
    want[:, 0] = ((s1 * scale) & 0xFFFFFFFF).to(torch.int64).to(torch.int32)
    assert torch.equal(ph, want)


@pytest.mark.parametrize("name", sorted(n for n, p in TP.PARAMS_BY_NAME.items()
                                        if p.torus_bits == 32))
def test_default_packing_key_matches_jax(name):
    assert TK.default_packing_key(TP.PARAMS_BY_NAME[name]) == \
        JK.default_packing_key(JP.PARAMS_BY_NAME[name])


def test_jax_uint_key_loads_with_its_packing_key(jax_keys, tmp_path):
    _, ck = jax_keys
    jser.save_cloud_key(tmp_path / "j_ck", ck)
    tck = tser.load_cloud_key(tmp_path / "j_ck", device="cpu")
    assert tck.pksk is not None and tck.pksk.dtype == torch.int32
    assert np.array_equal(tck.pksk.numpy(), np.asarray(ck.pksk))
    assert tck.pksk_gadget == tuple(ck.pksk_gadget)
    # the port saves the file the JAX package writes, manifest included
    tser.save_cloud_key(tmp_path / "t_ck", tck)
    want, got = _npz(tmp_path / "j_ck.npz"), _npz(tmp_path / "t_ck.npz")
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert np.array_equal(got[name], want[name]), name
    assert bytes(got["__manifest__"]) == bytes(want["__manifest__"])
    assert json.loads(bytes(got["__manifest__"]))["pksk_gadget"] == list(ck.pksk_gadget)


def test_port_uint_key_loads_in_jax(tmp_path):
    g = torch.Generator().manual_seed(6)
    sk = TK.SecretKey.generate(g, TPAR)
    ck = TK.CloudKey.generate(g, sk, TPAR)
    tser.save_cloud_key(tmp_path / "ck", ck)
    jck = jser.load_cloud_key(tmp_path / "ck")
    assert jck.params is JPAR and jck.pksk_gadget == ck.pksk_gadget
    for name, buf in ck.named_buffers():
        got = np.asarray(getattr(jck, name))
        assert got.dtype == buf.numpy().dtype and np.array_equal(got, buf), name
    again = tser.load_cloud_key(tmp_path / "ck", device="cpu")
    assert torch.equal(again.pksk, ck.pksk) and again.pksk_gadget == ck.pksk_gadget


def test_pre_contract_file_takes_the_set_gadget(jax_keys, tmp_path):
    """A cloud-key file with pksk but no pksk_gadget (written before the
    field existed) loads with the set's (basebit, iks_t) in both packages."""
    _, ck = jax_keys
    jser.save_cloud_key(tmp_path / "ck", ck)
    arrays = _npz(tmp_path / "ck.npz")
    m = json.loads(bytes(arrays.pop("__manifest__")))
    del m["pksk_gadget"]
    np.savez(tmp_path / "old", __manifest__=np.frombuffer(
        json.dumps(m).encode(), dtype=np.uint8), **arrays)
    want = (JPAR.basebit, JPAR.iks_t)
    assert jser.load_cloud_key(tmp_path / "old.npz").pksk_gadget == want
    assert tser.load_cloud_key(tmp_path / "old.npz", device="cpu").pksk_gadget == want


@pytest.mark.parametrize("gadget", [None, (2, 6)])
def test_packing_ksk_files_both_ways(jax_keys, tmp_path, gadget):
    _, ck = jax_keys
    kw = {} if gadget is None else dict(basebit=gadget[0], t=gadget[1])
    jser.save_packing_ksk(tmp_path / "j_pk", ck.pksk, JPAR, **kw)
    pksk, params, basebit, t = tser.load_packing_ksk(tmp_path / "j_pk", device="cpu")
    assert params is TPAR and pksk.dtype == torch.int32
    assert (basebit, t) == (gadget or (TPAR.basebit, TPAR.iks_t))
    assert np.array_equal(pksk.numpy(), np.asarray(ck.pksk))
    tser.save_packing_ksk(tmp_path / "t_pk", pksk, params, **kw)
    want, got = _npz(tmp_path / "j_pk.npz"), _npz(tmp_path / "t_pk.npz")
    assert list(got) == list(want)
    assert bytes(got["__manifest__"]) == bytes(want["__manifest__"])
    assert got["pksk"].dtype == want["pksk"].dtype
    assert np.array_equal(got["pksk"], want["pksk"])
    jpk, jparams, jb, jt = jser.load_packing_ksk(tmp_path / "t_pk")
    assert jparams is JPAR and (jb, jt) == (basebit, t)
    assert np.array_equal(np.asarray(jpk), np.asarray(ck.pksk))
    jser.save_cloud_key(tmp_path / "ck", ck)
    with pytest.raises(ValueError, match="expected a 'packing_ksk'"):
        tser.load_packing_ksk(tmp_path / "ck", device="cpu")
