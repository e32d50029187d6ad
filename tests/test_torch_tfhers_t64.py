"""tfhe-rs's default 64-bit set (params.py:SECURITY_TFHERS_2_2) and the
key form the port makes for it by default.

The set is zama-ai/tfhe-rs 0.4.0's PARAM_MESSAGE_2_CARRY_2_KS_PBS; the JAX
package has no such set.  Its published digit (2^23 x 1) is wider than one
int8 limb, so ``ops/ntt.py:default_engine_gadget`` gives it the one-limb
engine gadget 2^8 with (3, 2) levels, and its scan runs on the int32 hi
planes with the offsets' low words carried in (``decomposition.hi32_planes``;
the JAX package's ``_hi32_viable`` refuses such offsets) and on K2s.  Held
here: the ten published constants; the default key form and that K2s
takes it; every other set's default key form pinned to its values before
this set existed; every step of the scan on K2s (its plain version on the
CPU); and the carried hi-plane scan bit-equal to the generic int64 scan
and to the plain chain, on a port-made key with n0 cut to 4 (two group-2
steps) and an arbitrary int64 test vector.  Tolerance: exact equality.
"""

import dataclasses

import numpy as np
import pytest
import torch

from zig_tfhe_tpu_torch import key as TK
from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch.ops import blind_rotate_ntt as BRN
from zig_tfhe_tpu_torch.ops import decomposition as TD
from zig_tfhe_tpu_torch.ops import ntt as tntt
from zig_tfhe_tpu_torch.ops import split_ring as TSR
from zig_tfhe_tpu_torch.ops.cuda import split_step as K2S

P = TP.SECURITY_TFHERS_2_2

# (group, Bg_e bits, (la, lb), drop) of CloudKey.generate's default NTT key
# for every other set, as the port made them before tfhers_2_2 existed
_FORMS = {
    "110bit": (3, 7, (2, 2), 5), "128bit": (3, 7, (2, 2), 5),
    "128bit_t64": (2, 8, (3, 2), 32), "128bit_v2": (3, 7, (2, 2), 5),
    "80bit": (3, 7, (2, 2), 5), "draft128_t64": (2, 8, (3, 2), 32),
    "tiny": (2, 6, (2, 2), 0), "tiny64": (2, 6, (2, 2), 0),
    "tiny_split": (2, 8, (2, 2), 32), "tiny_uint": (2, 11, (2, 2), 0),
    "uint1": (2, 10, (2, 2), 3), "uint2": (2, 18, (1, 1), 0),
    "uint3": (2, 23, (1, 1), 0), "uint4": (2, 22, (1, 1), 0),
    "uint5": (2, 22, (1, 1), 0), "uint6": (2, 22, (1, 1), 0),
    "uint7": (2, 22, (1, 1), 0), "uint8": (2, 22, (1, 1), 0),
}


def _form(params):
    group = tntt.default_group(params)
    bgbit, levels = tntt.default_engine_gadget(params, group)
    return group, bgbit, levels, tntt.default_drop_bits(params, group, bgbit)


def _full64(rng, shape):
    return rng.integers(-2**63, 2**63 - 1, shape, dtype=np.int64,
                        endpoint=True)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_published_constants():
    """PARAM_MESSAGE_2_CARRY_2_KS_PBS: lwe_dimension, glwe_dimension 1 with
    polynomial_size, the two noise deviations, pbs_base_log / pbs_level,
    ks_base_log / ks_level, the native 2^64 modulus."""
    got = (P.n0, P.N, P.n1, P.tlwe_lv0.alpha, P.tlwe_lv1.alpha,
           P.trlwe_lv1.alpha, P.bgbit, P.L, P.basebit, P.iks_t,
           P.torus_bits)
    assert got == (742, 2048, 2048, 7.069849454709433e-06,
                   2.9403601535432533e-16, 2.9403601535432533e-16, 23, 1, 3,
                   5, 64)
    assert P.nbit == 11 and P.split_ring and P.security_bits == 128
    assert TP.PARAMS_BY_NAME["tfhers_2_2"] is P
    assert P not in TP.ALL_PARAMS


def test_default_key_form_takes_k2s():
    """Group 2, Bg_e 2^8 with (3, 2) levels (24 a-side bits, at least the
    published 23), drop 32, four primes on the N/2 plan, the hi-plane scan
    and K2s."""
    group, bgbit, levels, drop = _form(P)
    assert (group, bgbit, levels, drop) == (2, 8, (3, 2), 32)
    assert tntt.default_engine_gadget(P, 1) == (8, (3, 2))
    assert not TD.hi32_viable(P, drop, bgbit, levels)
    assert TD.hi32_planes(P, drop, bgbit, levels)
    assert K2S.supports(group, tntt.engine_digit_limbs(bgbit), True)
    plan = tntt.plan_for_params(P, drop, group, levels, bgbit=bgbit,
                                pseudorandom_key=True)
    assert (plan.N, plan.n_primes) == (1024, 4)
    assert 2 * sum(levels) <= K2S._MAX_ROWS


@pytest.mark.parametrize("name", sorted(_FORMS))
def test_other_sets_keep_their_key_form(name):
    assert _form(TP.PARAMS_BY_NAME[name]) == _FORMS[name]


def test_every_set_is_pinned():
    assert sorted(_FORMS) == sorted(set(TP.PARAMS_BY_NAME) - {"tfhers_2_2"})


def test_hi32_planes_takes_low_offset_bits():
    """The hi-plane scan needs the 64-bit torus, drop >= 32 and no digit
    shift below bit 32, and takes offsets with low bits (tfhers_2_2's
    engine gadget), which the JAX package's ``_hi32_viable`` refuses."""
    for name in ("128bit_t64", "tiny_split"):
        p = TP.PARAMS_BY_NAME[name]
        lv = _form(p)[2]
        assert TD.hi32_viable(p, 32, 8, lv) and TD.hi32_planes(p, 32, 8, lv)
    assert TD.hi32_planes(P, 32, 8, (3, 2))
    assert not TD.hi32_viable(P, 32, 8, (3, 2))
    assert not TD.hi32_planes(P, 31, 8, (3, 2))
    assert not TD.hi32_planes(P, 32, 11, (3, 2))    # 64 - 33 < 32
    assert not TD.hi32_planes(TP.SECURITY_128_BIT, 32, 7, (2, 2))


@pytest.fixture(scope="module")
def cut():
    """The set with n0 cut to 4 (two group-2 steps), a port-made default
    key on the CPU (no packing key) and its secret key."""
    p = dataclasses.replace(P, name="tfhers_2_2_n4",
                            tlwe_lv0=dataclasses.replace(P.tlwe_lv0, n=4))
    gen = torch.Generator().manual_seed(2024)
    sk = TK.SecretKey.generate(gen, p)
    ck = TK.CloudKey.generate(gen, sk, p, packing_key=False)
    assert (ck.bsk_group, ck.bsk_bgbit, ck.bsk_levels, ck.bsk_ntt_drop,
            ck.bsk_ntt.shape[:3]) == (2, 8, (3, 2), 32, (2, 3, 4))
    return p, ck


def _scan(p, ck, ct, tv):
    return TSR.blind_rotate_split(ct, tv, ck.bsk_ntt, p, ck.bsk_ntt_drop,
                                  group=2, levels=ck.bsk_levels,
                                  bgbit=ck.bsk_bgbit)


def test_every_step_takes_k2s(cut, monkeypatch):
    """The default key's scan calls K2s (its plain version on the CPU) once
    a step, and the plain ops where K2s declines the key; the two give the
    same accumulator."""
    p, ck = cut
    rng = np.random.default_rng(5)
    ct = torch.from_numpy(_full64(rng, (3, p.n0 + 1)))
    tv = torch.from_numpy(_full64(rng, (2, p.N)))
    calls = []
    k2s = K2S.split_step_fused
    monkeypatch.setattr(K2S, "split_step_fused",
                        lambda *a: calls.append(1) or k2s(*a))
    fused = _scan(p, ck, ct, tv)
    assert len(calls) == 2
    form = BRN.key_form      # the plain chain: the key's form routed off K2s
    monkeypatch.setattr(BRN, "key_form", lambda *a: dataclasses.replace(
        form(*a), path=BRN.Path.MULTI))
    plain = _scan(p, ck, ct, tv)
    assert len(calls) == 2
    assert torch.equal(fused, plain)


def test_carried_scan_equals_generic(cut, monkeypatch):
    """The hi-plane scan with the offsets' low words carried in equals the
    generic int64 scan on an arbitrary int64 test vector (every low word
    and carry) and on the gate test vector."""
    p, ck = cut
    rng = np.random.default_rng(6)
    ct = torch.from_numpy(_full64(rng, (3, p.n0 + 1)))
    tvs = (torch.from_numpy(_full64(rng, (2, p.N))), ck.testvec)
    hi = [_scan(p, ck, ct, tv) for tv in tvs]
    form = BRN.key_form      # the generic scan: the key's form without hi planes
    monkeypatch.setattr(BRN, "key_form", lambda *a: dataclasses.replace(
        form(*a), hi32=False, path=BRN.Path.MULTI))
    generic = [_scan(p, ck, ct, tv) for tv in tvs]
    for h, g in zip(hi, generic, strict=True):
        assert h.dtype == torch.int64 and torch.equal(h, g)
