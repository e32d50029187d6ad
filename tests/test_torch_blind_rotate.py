"""Blind rotation of the port, bit-equal with the JAX package's.

TEST_TINY runs the whole scan at multi-bit groups 1, 2 and 3 on keys made
by the JAX package's CloudKey.generate (TEST_TINY's own default is group
2 at drop 0, so group 3 is forced).  The 128-bit default shapes (N=1024,
group 3, Bg_e 2^7 (2,2), drop 5, 3 primes) run two or three scan steps,
on a copy of SECURITY_128_BIT cut to n0 = 6 or 7 lv0 coefficients, with
random in-range key residues.  Tolerance: exact equality.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zig_tfhe_tpu import key as JK
from zig_tfhe_tpu import params as JP
from zig_tfhe_tpu.ops import ntt as jntt
from zig_tfhe_tpu.ops.blind_rotate_ntt import blind_rotate_ntt as j_brn
from zig_tfhe_tpu.ops.blind_rotate_ntt import rotate_via_ntt as j_rot
from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch.ops import ntt as tntt
from zig_tfhe_tpu_torch.ops.blind_rotate_ntt import blind_rotate_ntt as t_brn
from zig_tfhe_tpu_torch.ops.blind_rotate_ntt import rotate_via_ntt as t_rot


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("group", [1, 2, 3])
def test_blind_rotate_tiny_jax_key(group):
    params = JP.TEST_TINY
    sk = JK.SecretKey.generate(jax.random.key(7), params)
    ck = JK.CloudKey.generate(jax.random.key(8 + group), sk, params, group=group)
    rng = np.random.default_rng(group)
    ct = rng.integers(-2**31, 2**31, (5, params.n0 + 1)).astype(np.int32)
    want = np.asarray(j_brn(jnp.asarray(ct), ck.testvec, ck.bsk_ntt, params,
                            ck.bsk_ntt_drop, group=ck.bsk_group,
                            levels=ck.bsk_levels, bgbit=ck.bsk_bgbit))
    got = t_brn(_t(ct), _t(ck.testvec), _t(ck.bsk_ntt), TP.TEST_TINY,
                ck.bsk_ntt_drop, group=ck.bsk_group, levels=ck.bsk_levels,
                bgbit=ck.bsk_bgbit)
    assert np.array_equal(got.numpy(), want)


def _cut(mod, n0):
    """SECURITY_128_BIT with only n0 lv0 coefficients (2-3 scan steps)."""
    p = mod.SECURITY_128_BIT
    return dataclasses.replace(p, name="128bit_steps",
                               tlwe_lv0=dataclasses.replace(p.tlwe_lv0, n=n0))


@pytest.mark.parametrize("n0", [6, 7])
def test_blind_rotate_128bit_steps(n0):
    """Group 3 at the 128-bit default engine gadget; n0 = 7 is ragged (the
    last group is padded with a = 0)."""
    jp, tp = _cut(JP, n0), _cut(TP, n0)
    drop, group, levels, bgbit = 5, 3, (2, 2), 7
    plan = jntt.plan_for_params(jp, drop, group, levels, bgbit=bgbit,
                                pseudorandom_key=True)
    assert plan.n_primes == 3 and plan.N == 1024
    rng = np.random.default_rng(n0)
    G = -(-n0 // group)
    # in-range residues: the NTT form of uniform torus rows (what keygen
    # makes), so every step's convolution stays below P/4 and the CRT lift
    # is exact; uniform residues would not be
    rows = rng.integers(-2**31, 2**31, (G, 7, 4, 2, plan.N)).astype(np.int32)
    bsk = np.moveaxis(np.asarray(jntt.to_ntt_form(jnp.asarray(rows), plan,
                                                  drop)), 0, 2)
    ct = rng.integers(-2**31, 2**31, (4, n0 + 1)).astype(np.int32)
    tv = rng.integers(-2**31, 2**31, (2, plan.N)).astype(np.int32)
    want = np.asarray(j_brn(jnp.asarray(ct), jnp.asarray(tv), jnp.asarray(bsk),
                            jp, drop, group=group, levels=levels, bgbit=bgbit))
    got = t_brn(_t(ct), _t(tv), _t(bsk), tp, drop, group=group,
                levels=levels, bgbit=bgbit)
    assert np.array_equal(got.numpy(), want)


def test_rotate_via_ntt_128bit():
    kw = dict(bgbit=7, pseudorandom_key=True)
    jplan = jntt.plan_for_params(JP.SECURITY_128_BIT, 5, 3, (2, 2), **kw)
    tplan = tntt.plan_for_params(TP.SECURITY_128_BIT, 5, 3, (2, 2), **kw)
    rng = np.random.default_rng(12)
    tv = rng.integers(-2**31, 2**31, (1, 2, 1024)).astype(np.int32)
    t = rng.integers(0, 2049, 5).astype(np.int32)
    want = np.asarray(j_rot(jnp.asarray(tv), jnp.asarray(t), jplan))
    got = t_rot(_t(tv), _t(t), tplan).numpy()
    assert np.array_equal(got, want)


def test_key_plan_mismatch_raises():
    rng = np.random.default_rng(0)
    ct = _t(rng.integers(-2**31, 2**31, (2, 9)).astype(np.int32))
    bsk = torch.zeros((3, 7, 5, 4, 2, 64), dtype=torch.int16)   # 5 primes
    with pytest.raises(ValueError, match="CRT prime planes"):
        t_brn(ct, torch.zeros(2, 64, dtype=torch.int32), bsk, TP.TEST_TINY, 0,
              group=3, levels=(2, 2), bgbit=6)


_SETS_32 = sorted(n for n, p in TP.PARAMS_BY_NAME.items() if p.torus_bits == 32)


@pytest.mark.parametrize("name", _SETS_32)
def test_blind_rotate_every_32bit_set_steps(name):
    """Every 32-bit set at its key defaults (ops/ntt.py: default_group,
    default_engine_gadget, default_drop_bits), n0 cut to 2g + 1 (two full
    steps and a ragged one), random in-range key residues: group 3 at Bg_e
    2^7 for the boolean sets, group 2 with 2-3-limb digits (Bg_e 2^10 to
    2^23, 4-5 primes, K2's multi-limb path) for the uint sets."""
    jp0, tp0 = JP.PARAMS_BY_NAME[name], TP.PARAMS_BY_NAME[name]
    group = tntt.default_group(tp0)
    bgbit, levels = tntt.default_engine_gadget(tp0, group)
    drop = tntt.default_drop_bits(tp0, group, bgbit)
    assert (group, bgbit, tuple(levels), drop) == (
        jntt.default_group(jp0), *jntt.default_engine_gadget(jp0, group)[:1],
        tuple(jntt.default_engine_gadget(jp0, group)[1]),
        jntt.default_drop_bits(jp0, group, bgbit))
    n0 = 2 * group + 1
    jp, tp = (dataclasses.replace(p, tlwe_lv0=dataclasses.replace(p.tlwe_lv0, n=n0))
              for p in (jp0, tp0))
    plan = jntt.plan_for_params(jp, drop, group, levels, bgbit=bgbit,
                                pseudorandom_key=True)
    rng = np.random.default_rng(len(name))
    rows = rng.integers(-2**31, 2**31, (3, (1 << group) - 1, sum(levels), 2,
                                        plan.N)).astype(np.int32)
    bsk = np.moveaxis(np.asarray(jntt.to_ntt_form(jnp.asarray(rows), plan,
                                                  drop)), 0, 2)
    ct = rng.integers(-2**31, 2**31, (3, n0 + 1)).astype(np.int32)
    tv = rng.integers(-2**31, 2**31, (2, plan.N)).astype(np.int32)
    kw = dict(group=group, levels=levels, bgbit=bgbit)
    want = np.asarray(j_brn(jnp.asarray(ct), jnp.asarray(tv), jnp.asarray(bsk),
                            jp, drop, **kw))
    got = t_brn(_t(ct), _t(tv), _t(np.ascontiguousarray(bsk)), tp, drop, **kw)
    assert np.array_equal(got.numpy(), want)
