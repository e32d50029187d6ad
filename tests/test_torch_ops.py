"""The port's torus, decomposition, polynomial and key-switch helpers,
bit-equal with the JAX package's on inputs from one numpy seed.

Sizes are small (TEST_TINY shapes, plus the 128-bit key-switch digit
layout on a few lanes); the tolerance is exact equality throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zig_tfhe_tpu import params as JP
from zig_tfhe_tpu import trlwe as jtrlwe
from zig_tfhe_tpu.ops import blind_rotate as jbr
from zig_tfhe_tpu.ops import decomposition as jdec
from zig_tfhe_tpu.ops import keyswitch as jks
from zig_tfhe_tpu.ops import poly as jpoly
from zig_tfhe_tpu.utils import torus as jtorus
from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch import trlwe as ttrlwe
from zig_tfhe_tpu_torch.ops import decomposition as tdec
from zig_tfhe_tpu_torch.ops import keyswitch as tks
from zig_tfhe_tpu_torch.ops import poly as tpoly
from zig_tfhe_tpu_torch.utils import torus as ttorus


def _full(rng, shape):
    return rng.integers(-2**31, 2**31, shape).astype(np.int32)


def test_shift_right_logical_all_amounts():
    x = np.concatenate([_full(np.random.default_rng(1), 512),
                        np.array([0, -1, 2**31 - 1, -2**31], np.int32)])
    for amount in range(32):
        want = np.asarray(jtorus.shift_right_logical(jnp.asarray(x), amount))
        got = ttorus.shift_right_logical(torch.from_numpy(x), amount).numpy()
        assert np.array_equal(want, got), amount


@pytest.mark.parametrize("n_limbs", [1, 2, 4])
def test_i8_limbs_roundtrip(n_limbs):
    x = _full(np.random.default_rng(2), (7, 33))
    if n_limbs < 4:
        x = (x >> (8 * (4 - n_limbs))).astype(np.int32)
    want = np.asarray(jtorus.i32_to_i8_limbs(jnp.asarray(x), n_limbs))
    limbs = ttorus.i32_to_i8_limbs(torch.from_numpy(x), n_limbs)
    assert np.array_equal(want, limbs.numpy())
    back = ttorus.i8_limbs_combine([limbs[..., k].to(torch.int32)
                                    for k in range(n_limbs)],
                                   [8 * k for k in range(n_limbs)])
    diff = back.numpy().astype(np.int64) - x.astype(np.int64)
    assert np.all(diff % (1 << (8 * n_limbs)) == 0)   # exact mod 2^(8n)


def test_host_codecs():
    for d in (0.125, -0.125, 0.25, -0.25, 0.3, 0.999999):
        assert ttorus.torus_constant(d) == jtorus.torus_constant(d)
        assert ttorus.to_i32(ttorus.torus_constant(d)) == int(
            jtorus.to_i32(jtorus.torus_constant(d)))
    x = np.linspace(-3, 3, 101)
    assert np.array_equal(ttorus.f64_to_torus(x), jtorus.f64_to_torus(x))
    # width 64 (the 64-bit torus, Python-int codecs on both sides)
    for v in (1, -1, 2**63, 2**64 - 1, -(2**63), 3 * 2**62):
        assert ttorus.to_carrier(v, 64) == int(jtorus.to_carrier(v, 64))
    for d in (0.125, -0.125, 0.3, 1 / 3, 0.999999):
        assert ttorus.torus_constant_w(d, 64) == jtorus.torus_constant_w(d, 64)


@pytest.mark.parametrize("levels,bgbit,center", [
    (None, None, False), (None, None, True), (1, None, True),
    (2, 7, True), (4, 8, True)])
def test_gadget_decompose(levels, bgbit, center):
    x = _full(np.random.default_rng(3), (5, 2, 64))
    for axis in (-1, -2):
        want = jdec.gadget_decompose(jnp.asarray(x), JP.SECURITY_128_BIT, axis,
                                     levels, bgbit, center)
        got = tdec.gadget_decompose(torch.from_numpy(x), TP.SECURITY_128_BIT,
                                    axis, levels, bgbit, center)
        assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("levels,bgbit", [((2, 2), 7), ((3, 2), None), (None, 6)])
def test_decompose_to_rows_and_modswitch(levels, bgbit):
    rng = np.random.default_rng(4)
    ct = _full(rng, (3, 2, 1024))
    jp, tp = JP.SECURITY_128_BIT, TP.SECURITY_128_BIT
    want = jbr._decompose_to_rows(jnp.asarray(ct), jp, levels, bgbit)
    got = tdec.decompose_rows(torch.from_numpy(ct), tp, levels, bgbit)
    assert np.array_equal(np.asarray(want), got.numpy())
    a = _full(rng, 4096)
    assert np.array_equal(np.asarray(jbr.modswitch(jnp.asarray(a), jp)),
                          tdec.modswitch(torch.from_numpy(a), tp).numpy())


@pytest.mark.parametrize("basebit,t", [(2, 9), (2, 8), (4, 3)])
def test_ks_decompose(basebit, t):
    a = _full(np.random.default_rng(5), (6, 40))
    want = jdec.ks_decompose(jnp.asarray(a), basebit, t)
    got = tdec.ks_decompose(torch.from_numpy(a), basebit, t)
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("name", ["tiny", "128bit"])
def test_identity_key_switch(name):
    """ksk [N*t, n0+1] full-range rows: the 128-bit case is the real
    [9216, 701] digit/key layout on 3 lanes."""
    jp, tp = JP.PARAMS_BY_NAME[name], TP.PARAMS_BY_NAME[name]
    rng = np.random.default_rng(6)
    ksk = _full(rng, (jp.N * jp.iks_t, jp.n0 + 1))
    ct = _full(rng, (3, jp.N + 1))
    want = jks.identity_key_switch(jnp.asarray(ct), jnp.asarray(ksk), jp)
    got = tks.identity_key_switch(torch.from_numpy(ct), torch.from_numpy(ksk), tp)
    assert np.array_equal(np.asarray(want), got.numpy())


def test_ks_plaintexts():
    s = np.random.default_rng(7).integers(0, 2, 64).astype(np.int32)
    want = jks.ks_plaintexts(jnp.asarray(s), 2, 8)
    got = tks.ks_plaintexts(torch.from_numpy(s), 2, 8)
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("small_bound,K,M", [(2, 512, 9), (127, 40, 24),
                                             (300, 64, 64)])
def test_small_matmul_torus(small_bound, K, M):
    """Includes shapes that need the row / K / M padding of matmul_i8."""
    rng = np.random.default_rng(K + M)
    small = rng.integers(-small_bound, small_bound + 1, (3, K)).astype(np.int32)
    mat = _full(rng, (K, M))
    want = jpoly.small_matmul_torus(jnp.asarray(small), jnp.asarray(mat),
                                    small_bound)
    got = tpoly.small_matmul_torus(torch.from_numpy(small),
                                   torch.from_numpy(mat), small_bound)
    assert np.array_equal(np.asarray(want), got.numpy())


def test_negacyclic_polymul_binary_vs_naive():
    rng = np.random.default_rng(8)
    a = _full(rng, (3, 64))
    s = rng.integers(0, 2, 64).astype(np.int32)
    got = tpoly.negacyclic_polymul_binary(torch.from_numpy(a),
                                          torch.from_numpy(s)).numpy()
    want = np.asarray(jpoly.negacyclic_polymul_binary(jnp.asarray(a),
                                                      jnp.asarray(s)))
    assert np.array_equal(got, want)
    for k in range(3):
        assert np.array_equal(got[k], tpoly.negacyclic_polymul_naive(a[k], s))
        assert np.array_equal(got[k], jpoly.negacyclic_polymul_naive(a[k], s))


def test_sample_extract():
    ct = _full(np.random.default_rng(9), (4, 2, 64))
    for k in (0, 5, 63):
        want = jtrlwe.sample_extract(jnp.asarray(ct), k)
        got = ttrlwe.sample_extract(torch.from_numpy(ct), k)
        assert np.array_equal(np.asarray(want), got.numpy())
