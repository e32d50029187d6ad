"""The port's NTT engine, bit-equal with the JAX package's on equal inputs.

Every op of zig_tfhe_tpu_torch/ops/ntt.py is run beside its JAX original
on inputs drawn from one numpy seed, at the TEST_TINY group-3 plan (N=64,
4 primes) and at the 128-bit default plan (N=1024, group 3, Bg_e 2^7
(2,2), drop 5, 3 primes).  The tolerance is exact equality: the JAX path is
exact integer arithmetic, and the port keeps its formulas operation for
operation (including the float32 Barrett quotient).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zig_tfhe_tpu import params as JP
from zig_tfhe_tpu.ops import ntt as jntt
from zig_tfhe_tpu.ops.poly import negacyclic_polymul_naive
from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch.ops import ntt as tntt

# (name, drop, group, levels, bgbit)
_CASES = {"tiny": ("tiny", 0, 3, (2, 2), 6), "128bit": ("128bit", 5, 3, (2, 2), 7)}


def _plans(case):
    name, drop, group, levels, bgbit = _CASES[case]
    kw = dict(bgbit=bgbit, pseudorandom_key=True)
    return (jntt.plan_for_params(JP.PARAMS_BY_NAME[name], drop, group, levels, **kw),
            tntt.plan_for_params(TP.PARAMS_BY_NAME[name], drop, group, levels, **kw))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(jax_list, torch_list):
    assert len(jax_list) == len(torch_list)
    for x, y in zip(jax_list, torch_list):
        x, y = np.asarray(x), y.numpy()
        assert x.dtype == y.dtype and np.array_equal(x, y)


def _residues(jplan, rng, shape):
    """Centered residues of bounded polynomials (as ntt_forward makes
    them), per prime int32."""
    c = rng.integers(-2**31, 2**31, shape + (jplan.N,)).astype(np.int32)
    return [np.asarray(r) for r in jntt.ntt_forward(_j(c), jplan, 4, 128)]


def test_barrett_full_int32_range():
    rng = np.random.default_rng(3)
    for p in (12289, 40961, 59393, 61441, 62081):
        v = np.concatenate([
            rng.integers(-2**31, 2**31, 8192),
            np.array([0, 1, -1, 2**31 - 1, -2**31, p, -p, p // 2, -(p // 2),
                      p // 2 + 1, 3 * p // 2, -(3 * p // 2)]),
        ]).astype(np.int32)
        r = tntt.barrett_reduce(_t(v), p).numpy()
        assert np.array_equal(r, np.asarray(jntt.barrett_reduce(_j(v), p)))
        r64 = r.astype(np.int64)
        assert np.all((r64 - v.astype(np.int64)) % p == 0)
        assert np.all(np.abs(r64) <= 0.55 * p)


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("limbs", [1, 4])
def test_ntt_forward(case, limbs):
    jplan, tplan = _plans(case)
    rng = np.random.default_rng(10 + limbs)
    if limbs == 1:
        d = rng.integers(-64, 64, (3, 4, jplan.N)).astype(np.int32)
        bound = 64
    else:
        d = rng.integers(-2**31, 2**31, (3, 2, jplan.N)).astype(np.int32)
        bound = 128
    _eq(jntt.ntt_forward(_j(d), jplan, limbs, bound),
        tntt.ntt_forward(_t(d), tplan, limbs, bound))


@pytest.mark.parametrize("case", sorted(_CASES))
def test_to_ntt_form(case):
    jplan, tplan = _plans(case)
    drop = _CASES[case][1]
    polys = np.random.default_rng(5).integers(
        -2**31, 2**31, (2, 4, 2, jplan.N)).astype(np.int32)
    _eq([jntt.to_ntt_form(_j(polys), jplan, drop)],
        [tntt.to_ntt_form(_t(polys), tplan, drop)])


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("reduce_output", [False, True])
def test_pointwise_extprod(case, reduce_output):
    jplan, tplan = _plans(case)
    rng = np.random.default_rng(6)
    d_hat = _residues(jplan, rng, (3, 4))                        # [B, R, N]
    key = np.stack([rng.integers(-(p // 2), p // 2 + 1, (4, 2, jplan.N))
                    for p in jplan.primes]).astype(np.int16)     # [P, R, C, N]
    _eq(jntt.pointwise_extprod([_j(x) for x in d_hat], _j(key), jplan,
                               reduce_output=reduce_output),
        tntt.pointwise_extprod([_t(x) for x in d_hat], _t(key), tplan,
                               reduce_output=reduce_output))


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("g,u_wide", [(3, True), (3, False), (2, True)])
def test_rotate_combine_multi(case, g, u_wide):
    jplan, tplan = _plans(case)
    rng = np.random.default_rng(7 + g)
    B = 3
    if u_wide:   # unreduced pointwise fold outputs, |u| <= p + 768
        us = [[rng.integers(-(p + 768), p + 769, (B, 2, jplan.N)).astype(np.int32)
               for p in jplan.primes] for _ in range((1 << g) - 1)]
    else:
        us = [_residues(jplan, rng, (B, 2)) for _ in range((1 << g) - 1)]
    ts = [rng.integers(0, 2 * jplan.N + 1, B).astype(np.int32) for _ in range(g)]
    _eq(jntt.rotate_combine_multi([[_j(x) for x in u] for u in us],
                                  [_j(t) for t in ts], jplan, u_wide=u_wide),
        tntt.rotate_combine_multi([[_t(x) for x in u] for u in us],
                                  [_t(t) for t in ts], tplan, u_wide=u_wide))


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("minus_one", [True, False])
def test_rotate_diag(case, minus_one):
    jplan, tplan = _plans(case)
    rng = np.random.default_rng(8)
    res = _residues(jplan, rng, (1, 2))          # unbatched testvec shape
    t = rng.integers(0, 2 * jplan.N + 1, 4).astype(np.int32)
    _eq(jntt.rotate_diag([_j(x) for x in res], _j(t), jplan, minus_one),
        tntt.rotate_diag([_t(x) for x in res], _t(t), tplan, minus_one))


@pytest.mark.parametrize("case", sorted(_CASES))
def test_ntt_inverse_to_crt(case):
    jplan, tplan = _plans(case)
    rng = np.random.default_rng(9)
    c = rng.integers(-2**31, 2**31, (3, 2, jplan.N)).astype(np.int32)
    res = [np.asarray(r) for r in jntt.ntt_forward(_j(c), jplan, 4, 128)]
    out = tntt.ntt_inverse_to_crt([_t(x) for x in res], tplan).numpy()
    assert np.array_equal(out, np.asarray(
        jntt.ntt_inverse_to_crt([_j(x) for x in res], jplan)))
    assert np.array_equal(out, c)                # the lift is exact


@pytest.mark.parametrize("N,dbound", [(64, 32), (1024, 128)])
def test_ntt_polymul_exact_vs_naive(N, dbound):
    """forward x pointwise x inverse == the schoolbook negacyclic product
    (mirrors tests/test_ntt.py:test_ntt_polymul_exact_vs_naive)."""
    plan = tntt.make_plan(N, (N.bit_length() - 1) + dbound.bit_length() + 32)
    rng = np.random.default_rng(N + dbound)
    a = rng.integers(-dbound, dbound, (2, N)).astype(np.int32)
    b = rng.integers(-2**31, 2**31, N).astype(np.int32)
    a_hat = tntt.ntt_forward(_t(a), plan, 1, dbound)
    b_hat = tntt.to_ntt_form(_t(b), plan)
    prods = [tntt.barrett_reduce(a_hat[i] * b_hat[i].to(torch.int32), p)
             for i, p in enumerate(plan.primes)]
    c = tntt.ntt_inverse_to_crt(prods, plan).numpy()
    for k in range(a.shape[0]):
        assert np.array_equal(c[k], negacyclic_polymul_naive(a[k], b))
