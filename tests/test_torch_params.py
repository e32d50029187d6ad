"""The port's copied host configuration equals the JAX package's.

zig_tfhe_tpu_torch cannot import zig_tfhe_tpu (which imports jax), so the
parameter sets and the NTT plan construction are copies; these tests hold each
copy equal to its original, field by field and table by table.
"""

import dataclasses

import numpy as np
import pytest

from zig_tfhe_tpu import params as JP
from zig_tfhe_tpu.ops import ntt as jntt
from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch.ops import ntt as tntt

_DERIVED = ("n0", "n1", "N", "L", "bgbit", "nbit", "basebit", "iks_t",
            "ksk_alpha", "bsk_alpha", "torus_mod", "decomposition_offset",
            "ks_prec_offset", "ks_balance_offset", "split_ring", "digit_limbs",
            "ks_digit_limbs")


@pytest.mark.parametrize("name", sorted(JP.PARAMS_BY_NAME))
def test_param_set_equal(name):
    j, t = JP.PARAMS_BY_NAME[name], TP.PARAMS_BY_NAME[name]
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for prop in _DERIVED:
        assert getattr(j, prop) == getattr(t, prop), prop
    assert hash(j) == hash(t)


def test_param_tuples_and_default():
    assert [p.name for p in JP.ALL_PARAMS] == [p.name for p in TP.ALL_PARAMS]
    assert TP.DEFAULT_SECURITY.name == JP.DEFAULT_SECURITY.name == "128bit"
    assert TP.security_info(TP.SECURITY_128_BIT) == JP.security_info(
        JP.SECURITY_128_BIT)


@pytest.mark.parametrize("name", sorted(n for n, p in JP.PARAMS_BY_NAME.items()
                                        if not p.split_ring))
def test_engine_defaults_equal(name):
    j, t = JP.PARAMS_BY_NAME[name], TP.PARAMS_BY_NAME[name]
    assert jntt.default_group(j) == tntt.default_group(t)
    for group in (1, 2, 3):
        assert (jntt.default_engine_gadget(j, group)
                == tntt.default_engine_gadget(t, group))
        for bg in (None, 7, 8):
            assert (jntt.default_drop_bits(j, group, bg)
                    == tntt.default_drop_bits(t, group, bg))
    assert jntt.default_decomp_levels(j) == tntt.default_decomp_levels(t)


# (params name, drop, group, levels, engine bgbit): the plans the slice
# runs — TEST_TINY at groups 1-3 and the 128-bit default (group 3, Bg_e 2^7
# (2,2), drop 5) — plus the group-2 128-bit engine gadget
_PLANS = [("tiny", 0, 1, None, None), ("tiny", 0, 2, (2, 2), 6),
          ("tiny", 0, 3, (2, 2), 6), ("128bit", 5, 3, (2, 2), 7),
          ("128bit", 5, 2, (2, 2), 8)]


@pytest.mark.parametrize("name,drop,group,levels,bgbit", _PLANS)
def test_plan_tables_equal(name, drop, group, levels, bgbit):
    kw = dict(bgbit=bgbit, pseudorandom_key=True)
    j = jntt.plan_for_params(JP.PARAMS_BY_NAME[name], drop, group, levels, **kw)
    t = tntt.plan_for_params(TP.PARAMS_BY_NAME[name], drop, group, levels, **kw)
    assert (j.N, j.primes) == (t.N, t.primes)
    for field in ("fwd_lo", "fwd_hi", "inv_cat_lo", "inv_cat_hi", "rot",
                  "crt_e", "crt_theta"):
        for a, b in zip(getattr(j, field), getattr(t, field), strict=True):
            assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert np.array_equal(j.rot_merged, t.rot_merged)
    assert j.p_mod == t.p_mod
    assert [j.row_group(p) for p in j.primes] == [t.row_group(p)
                                                  for p in t.primes]


def test_split_ring_raises():
    with pytest.raises(NotImplementedError):
        tntt.plan_for_params(TP.TEST_TINY_SPLIT, 32, 2)
