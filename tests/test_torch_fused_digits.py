"""The next step's gadget digits written by K1 (ops/cuda/ntt_inverse.py)
and the fused step loop of ops/blind_rotate_ntt.py that reads them, on
both rings.

K1's plain version with a ``digits`` buffer writes exactly
``digit_planes(decompose_rows(out, ...), n_dl)`` of the accumulator it
returns (the int8 digits of a one-limb gadget, the 2-3 limb planes a row
of the uint gadgets: TEST_TINY_UINT's Bg_e 2^11, uint4's 2^22), and
returns the same accumulator as without one; the engine's loop on K2
(every boolean key at groups 2 and 3, every uint key at group 2)
decomposes only for step 0 and equals, bit for bit, the loop that
decomposes on every step; the ``fused_steps`` attribute of span
``blind_rotate.steps`` reads G - 1 there and 0 on the paths that bypass
the fusion (a group-1 split key), whose outputs do not change. On the
split ring's views, with a ``HalfRowGadget`` (the hi-plane gadgets of
tfhers_2_2, with low offset words, of SECURITY_128_BIT_T64 and of
TEST_TINY_SPLIT), K1's plain version and its wrapper on CPU tensors write
exactly ``rows_hi32(out, ...).to(torch.int8)``, and the split ring's
group-2 scan (K2s then K1) decomposes only for step 0, with G - 1 K1 calls
that carry the buffer, equal bit for bit to the loop that calls
``rows_hi32`` on every step. The kernel's own source is held to the plain
version in tests/test_torch_kernel_emulation.py and on the card in
tests/test_torch_cuda.py. The file imports no jax.
"""

import dataclasses

import numpy as np
import pytest
import torch

from zig_tfhe_tpu_torch import key, params
from zig_tfhe_tpu_torch.ops import ntt
from zig_tfhe_tpu_torch.ops import blind_rotate_ntt as BRN
from zig_tfhe_tpu_torch.ops import split_ring as SR
from zig_tfhe_tpu_torch.ops.decomposition import (HalfRowGadget,
                                                  decompose_rows, digit_planes,
                                                  half_row_gadget, modswitch,
                                                  row_gadget, rows_hi32)
from zig_tfhe_tpu_torch.ops.cuda import ntt_inverse as K1
from zig_tfhe_tpu_torch.ops.cuda import ntt_step as K2
from zig_tfhe_tpu_torch.ops.cuda import split_step as K2S
from zig_tfhe_tpu_torch.ops.poly import negacyclic_rotate
from zig_tfhe_tpu_torch.utils import profiling


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # many small CPU ops: torch's intra-op pool stalls beside other workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cut(P, n0):
    return dataclasses.replace(P, tlwe_lv0=dataclasses.replace(P.tlwe_lv0, n=n0))


# (params, drop, group, levels, engine bgbit): TEST_TINY (L = 2, Bg 2^6)
# at its own base, both components' offsets centred, and at Bg_e 2^7 (3,
# 2); the 128-bit g3 gadget Bg_e 2^7 (2, 2) and the g2 one, 2^6 (3, 2),
# whose a-offset is centred and b-offset not; the uint gadgets of 2 and 3
# limbs, TEST_TINY_UINT's 2^11 (2, 2) and uint4's 2^22 (1, 1) (5 primes)
_CASES = {"tiny_22": (params.TEST_TINY, 0, 3, (2, 2), 6),
          "tiny_32_bg7": (params.TEST_TINY, 0, 3, (3, 2), 7),
          "128bit_g3": (params.SECURITY_128_BIT, 5, 3, (2, 2), 7),
          "128bit_g2_32": (params.SECURITY_128_BIT, 7, 2, (3, 2), 6),
          "tiny_uint": (params.TEST_TINY_UINT, 0, 2, (2, 2), 11),
          "uint4": (params.SECURITY_UINT4, 0, 2, (1, 1), 22)}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_reference_writes_the_rows_of_its_output(case):
    P, drop, group, levels, bgbit = _CASES[case]
    plan = ntt.plan_for_params(P, drop, group, levels, bgbit=bgbit,
                               pseudorandom_key=True)
    gadget = row_gadget(P, levels, bgbit)
    B, N = 3, plan.N
    rng = np.random.default_rng(len(case))
    c, acc = (torch.from_numpy(rng.integers(-2**31, 2**31, (B, 2, N))
                               .astype(np.int32)) for _ in range(2))
    v = K1.split_limbs(torch.stack(ntt.ntt_forward(c, plan, digit_limbs=4,
                                                   digit_bound=128)))
    n_dl = ntt.engine_digit_limbs(bgbit)
    digits = torch.from_numpy(rng.integers(-128, 128,
                                           (B, sum(levels) * n_dl, N))
                              .astype(np.int8))
    before = (K1.ntt_inverse_to_crt_acc.launches,
              K1.ntt_inverse_to_crt_acc.digit_launches)
    out = K1.ntt_inverse_to_crt_acc(v, acc, plan, drop, digits=digits,
                                    gadget=gadget)
    assert (K1.ntt_inverse_to_crt_acc.launches,
            K1.ntt_inverse_to_crt_acc.digit_launches) == before
    assert torch.equal(out, K1.ntt_inverse_to_crt_acc_reference(v, acc, plan,
                                                                drop))
    assert torch.equal(out, acc + (c << drop))
    want = decompose_rows(out, P, levels, bgbit=bgbit)
    assert int(want.abs().max()) <= 1 << (bgbit - 1)
    assert torch.equal(digits, digit_planes(want, n_dl))
    # the planes give the digits back: sum_l limb_l 2^(8l)
    limbs = digits.reshape(B, sum(levels), n_dl, N).to(torch.int32)
    assert torch.equal(sum(limbs[:, :, l] << (8 * l) for l in range(n_dl)),
                       want)


def test_wrapper_refuses_digits_it_cannot_write():
    P, drop, group, levels, bgbit = _CASES["tiny_22"]
    plan = ntt.plan_for_params(P, drop, group, levels, bgbit=bgbit,
                               pseudorandom_key=True)
    v = torch.zeros((plan.n_primes, 2, 2, 2, plan.N), dtype=torch.int8)
    acc = torch.zeros((2, 2, plan.N), dtype=torch.int32)
    d = torch.zeros((2, 4, plan.N), dtype=torch.int8)
    gadget = row_gadget(P, levels, bgbit)
    with pytest.raises(ValueError, match="RowGadget"):
        K1.ntt_inverse_to_crt_acc(v, acc, plan, drop, digits=d)
    with pytest.raises(ValueError, match="contiguous int8"):
        K1.ntt_inverse_to_crt_acc(v, acc, plan, drop, digits=d[:, :3],
                                  gadget=gadget)
    with pytest.raises(ValueError, match="contiguous int8"):
        K1.ntt_inverse_to_crt_acc(v, acc, plan, drop, digits=d.int(),
                                  gadget=gadget)
    # a 2-limb gadget (TEST_TINY_UINT's 2^11) takes 2 planes a row, not
    # the one-limb plane count; a 25-bit gadget takes 4 limbs
    uint = row_gadget(params.TEST_TINY_UINT)
    assert (uint.bits, sum(uint.levels)) == (11, 4)
    with pytest.raises(ValueError, match="contiguous int8"):
        K1.ntt_inverse_to_crt_acc(v, acc, plan, drop, digits=d, gadget=uint)
    for bits in (25, 32):
        with pytest.raises(NotImplementedError, match="1-3 limbs"):
            K1.ntt_inverse_to_crt_acc(
                v, acc, plan, drop,
                digits=torch.zeros((2, 4 * 4, plan.N), dtype=torch.int8),
                gadget=uint._replace(bits=bits, levels=(1, 1)))


def _step_by_step(tlwe, tv, bsk, P, drop, group, levels, bgbit):
    """The multi-bit loop as it ran before the fusion: the set-up's
    rotation, then on every step decompose, digit planes, K2, K1."""
    n0, N, B = P.n0, P.N, tlwe.shape[0]
    plan = ntt.plan_for_params(P, drop, group, levels, bgbit=bgbit,
                               pseudorandom_key=True)
    acc = BRN.rotate_via_ntt(tv[None], 2 * N - modswitch(tlwe[:, n0], P), plan)
    G = bsk.shape[0]
    a_cols = tlwe[:, :n0].T
    if n0 < group * G:
        a_cols = torch.cat([a_cols, a_cols.new_zeros(group * G - n0, B)])
    ts = modswitch(a_cols.reshape(G, group, B), P)
    n_dl = ntt.engine_digit_limbs(bgbit)
    for s in range(G):
        d = digit_planes(decompose_rows(acc, P, levels, bgbit=bgbit), n_dl)
        v = K2.ntt_step_fused(d, bsk[s], ts[s], plan, bgbit)
        acc = K1.ntt_inverse_to_crt_acc(v, acc, plan, drop)
    return acc


def _random_key(P, drop, group, levels, bgbit, seed):
    """A key-shaped bsk_ntt in range (NTTs of uniform rows, as keygen makes
    them), and ciphertexts and a test vector."""
    plan = ntt.plan_for_params(P, drop, group, levels, bgbit=bgbit,
                               pseudorandom_key=True)
    G, S, R, N = -(-P.n0 // group), (1 << group) - 1, sum(levels), P.N
    rng = np.random.default_rng(seed)
    rows = torch.from_numpy(rng.integers(-2**31, 2**31, (G * S, R, 2, N))
                            .astype(np.int32))
    bsk = ntt.to_ntt_form(rows, plan, drop).movedim(0, 1).reshape(
        G, S, plan.n_primes, R, 2, N)
    tlwe = torch.from_numpy(rng.integers(-2**31, 2**31, (5, P.n0 + 1))
                            .astype(np.int32))
    tv = torch.from_numpy(rng.integers(-2**31, 2**31, (2, N)).astype(np.int32))
    return tlwe, tv, bsk.contiguous()


def _recorded_steps(fn):
    with profiling.recording():
        profiling.clear()
        out = fn()
    found = [s for s in profiling.spans() if s.name == "blind_rotate.steps"]
    profiling.clear()
    assert len(found) == 1
    return out, found[0].attrs


# port-made TEST_TINY keys at groups 2 and 3 (the keys tests/
# test_torch_gates.py and test_torch_ntt_step.py hold to JAX), and the
# 128-bit shapes cut to n0 = 7 / 6: g3's gadget over 3 steps (the last
# group padded), g2's (3, 2) gadget over 3 steps; uint4's 3-limb gadget
# and 5 primes cut to n0 = 5 (3 steps, the last group padded)
@pytest.mark.parametrize("case", ["tiny_g2", "tiny_g3", "128bit_g3",
                                  "128bit_g2_32", "uint4"])
def test_fused_loop_equals_step_by_step(case):
    if case.startswith("tiny"):
        P, group = params.TEST_TINY, int(case[-1])
        g = torch.Generator().manual_seed(group + 40)
        sk = key.SecretKey.generate(g, P)
        ck = key.CloudKey.generate(g, sk, P, group=group)
        drop, levels, bgbit = ck.bsk_ntt_drop, ck.bsk_levels, ck.bsk_bgbit
        bsk, tv = ck.bsk_ntt, ck.testvec
        tlwe = torch.from_numpy(np.random.default_rng(group).integers(
            -2**31, 2**31, (9, P.n0 + 1)).astype(np.int32))
    else:
        P0, drop, group, levels, bgbit = _CASES[case]
        P = _cut(P0, {"128bit_g3": 7, "128bit_g2_32": 6, "uint4": 5}[case])
        tlwe, tv, bsk = _random_key(P, drop, group, levels, bgbit, len(case))
    G = bsk.shape[0]
    assert ntt.engine_digit_limbs(bgbit) == (3 if case == "uint4" else 1)
    assert G >= 3
    got, attrs = _recorded_steps(lambda: BRN.blind_rotate_ntt(
        tlwe, tv, bsk, P, drop, group=group, levels=levels, bgbit=bgbit))
    assert attrs == {"steps": G, "fused_steps": G - 1,
                     "plain_digit_steps": 1}
    want = _step_by_step(tlwe, tv, bsk, P, drop, group, levels, bgbit)
    assert torch.equal(got, want)


def test_multi_limb_uint_key_bypasses_the_fusion(monkeypatch):
    """TEST_TINY_UINT's engine digits (Bg_e 2^11) are two limbs, which K1
    writes too: the loop decomposes for step 0 alone, every K1 but
    the last carries the planes, and the output equals the loop that
    decomposes on every step.  (The name predates K1's limb planes, when
    such a key bypassed the fusion; the key now takes it.)"""
    P = params.TEST_TINY_UINT
    g = torch.Generator().manual_seed(41)
    ck = key.CloudKey.generate(g, key.SecretKey.generate(g, P), P)
    drop, group, levels, bgbit = (ck.bsk_ntt_drop, ck.bsk_group,
                                  ck.bsk_levels, ck.bsk_bgbit)
    assert ntt.engine_digit_limbs(bgbit) == 2 and K2.supports(group, 2)
    tlwe = torch.from_numpy(np.random.default_rng(41).integers(
        -2**31, 2**31, (6, P.n0 + 1)).astype(np.int32))
    calls = _k1_digit_calls(monkeypatch)
    got, attrs = _recorded_steps(lambda: BRN.blind_rotate_ntt(
        tlwe, ck.testvec, ck.bsk_ntt, P, drop, group=group, levels=levels,
        bgbit=bgbit))
    G = ck.bsk_ntt.shape[0]
    assert G >= 3
    assert attrs == {"steps": G, "fused_steps": G - 1, "plain_digit_steps": 1}
    assert calls == [True] * (G - 1) + [False]
    want = _step_by_step(tlwe, ck.testvec, ck.bsk_ntt, P, drop, group, levels,
                         bgbit)
    assert torch.equal(got, want)


# the split ring's hi-plane gadgets at their default key forms (group 2,
# drop 32): tfhers_2_2's Bg_e 2^8 (3, 2), whose offsets have low words;
# SECURITY_128_BIT_T64's own Bg 2^8 (3, 2), whose have none (the b hi
# word differs); TEST_TINY_SPLIT's 2^8 (2, 2)
_SPLIT_CASES = {"tfhers_2_2": (params.SECURITY_TFHERS_2_2, (3, 2)),
                "128bit_t64": (params.SECURITY_128_BIT_T64, (3, 2)),
                "tiny_split": (params.TEST_TINY_SPLIT, (2, 2))}


def _split_views(P, levels, B, seed):
    """K1's operands on the split views: the residues of uniform hi planes
    c as int8 limb planes [P, 2B, 2, 2, N/2], uniform hi planes acc [2B, 2,
    N/2], and out = acc + c, what K1 returns at drop 32 - 32."""
    plan = ntt.plan_for_params(P, 32, 2, levels, bgbit=8,
                               pseudorandom_key=True)
    rng = np.random.default_rng(seed)
    c, acc = (torch.from_numpy(rng.integers(-2**31, 2**31, (B, 2, 2, plan.N))
                               .astype(np.int32)) for _ in range(2))
    v = K1.split_limbs(torch.stack(ntt.ntt_forward(c, plan, digit_limbs=4,
                                                   digit_bound=128)))
    return (plan, v.reshape(plan.n_primes, 2 * B, 2, 2, plan.N),
            acc.reshape(2 * B, 2, plan.N), acc + c)


@pytest.mark.parametrize("via", ["reference", "wrapper"])
@pytest.mark.parametrize("case", sorted(_SPLIT_CASES))
def test_reference_writes_the_half_rows_of_its_output(case, via):
    P, levels = _SPLIT_CASES[case]
    B = 3
    plan, v, acc, exact = _split_views(P, levels, B, len(case))
    gadget = half_row_gadget(P, 8, levels)
    assert isinstance(gadget, HalfRowGadget)
    assert (gadget.bits, gadget.levels) == (8, levels)
    digits = torch.from_numpy(np.random.default_rng(B).integers(
        -128, 128, (B, 2 * sum(levels), plan.N)).astype(np.int8))
    before = (K1.ntt_inverse_to_crt_acc.launches,
              K1.ntt_inverse_to_crt_acc.digit_launches)
    fn = (K1.ntt_inverse_to_crt_acc_reference if via == "reference"
          else K1.ntt_inverse_to_crt_acc)
    out = fn(v, acc, plan, 0, digits=digits, gadget=gadget)
    assert (K1.ntt_inverse_to_crt_acc.launches,
            K1.ntt_inverse_to_crt_acc.digit_launches) == before
    assert torch.equal(out, K1.ntt_inverse_to_crt_acc_reference(v, acc, plan,
                                                                0))
    assert torch.equal(out.reshape(B, 2, 2, plan.N), exact)
    want = rows_hi32(exact, P, 8, levels)
    assert int(want.abs().max()) <= 128
    assert torch.equal(digits, want.to(torch.int8))


def test_wrapper_refuses_half_rows_it_cannot_write():
    P, levels = _SPLIT_CASES["tiny_split"]
    plan, v, acc, _ = _split_views(P, levels, 2, 0)
    gadget = half_row_gadget(P, 8, levels)
    d = torch.zeros((2, 2 * sum(levels), plan.N), dtype=torch.int8)
    with pytest.raises(ValueError, match="HalfRowGadget"):
        K1.ntt_inverse_to_crt_acc(v, acc, plan, 0, digits=d)
    # the 32-bit engine's row layout [2B, R, N/2], and a wrong dtype
    for bad in (torch.zeros((4, sum(levels), plan.N), dtype=torch.int8),
                d.int(), d[:, :-1]):
        with pytest.raises(ValueError, match="contiguous int8"):
            K1.ntt_inverse_to_crt_acc(v, acc, plan, 0, digits=bad,
                                      gadget=gadget)
    # an accumulator of an odd row count holds no whole lane
    with pytest.raises(ValueError, match="contiguous int8"):
        K1.ntt_inverse_to_crt_acc(v[:, :3], acc[:3], plan, 0, digits=d[:1],
                                  gadget=gadget)
    # digits wider than one int8 limb, and a 32-bit row gadget on the views
    with pytest.raises(NotImplementedError, match="one-limb"):
        K1.ntt_inverse_to_crt_acc(v, acc, plan, 0, digits=d,
                                  gadget=gadget._replace(bits=11))
    with pytest.raises(NotImplementedError, match="one-limb"):
        K1.ntt_inverse_to_crt_acc(v, acc, plan, 0, digits=d,
                                  gadget=row_gadget(P, levels, 8))


def _split_step_by_step(tlwe, tv, bsk, P, levels):
    """The split ring's group-2 hi-plane scan as it ran before the fusion:
    the set-up's rotation and carried low words, then on every step
    ``rows_hi32``, its int8 cast, K2s and K1 without digits."""
    n0, N, B = P.n0, P.N, tlwe.shape[0]
    Nh, G = N // 2, bsk.shape[0]
    plan = ntt.plan_for_params(P, 32, 2, levels, bgbit=8,
                               pseudorandom_key=True)
    low = [off % (1 << 32) for off in row_gadget(P, levels, 8).offsets]
    acc = SR.split(negacyclic_rotate(tv[None].expand(B, 2, N),
                                     2 * N - modswitch(tlwe[:, n0], P)))
    for c in (0, 1):
        acc[:, c] += low[c]
    acc_lo = acc & 0xFFFFFFFF
    acc = (acc >> 32).to(torch.int32)
    t_cols = modswitch(tlwe[:, :n0].T, P)
    t_cols = torch.cat([t_cols, t_cols.new_zeros(2 * G - n0, B)])
    t_grps = t_cols.reshape(G, 2, B)
    for s in range(G):
        rows = rows_hi32(acc, P, 8, levels).to(torch.int8)
        v = K2S.split_step_fused(rows, bsk[s], t_grps[s], plan, 8)
        acc = K1.ntt_inverse_to_crt_acc(
            v.reshape(plan.n_primes, 2 * B, 2, 2, Nh),
            acc.reshape(2 * B, 2, Nh), plan, 0).reshape(B, 2, 2, Nh)
    acc = (acc.to(torch.int64) << 32) + acc_lo
    for c in (0, 1):
        acc[:, c] -= low[c]
    return SR.unsplit(acc)


def _split_key(P, n0, group, seed):
    P = _cut(P, n0) if n0 else P
    g = torch.Generator().manual_seed(seed)
    ck = key.CloudKey.generate(g, key.SecretKey.generate(g, P), P,
                               packing_key=False, group=group)
    tlwe = torch.randint(-2**63, 2**63 - 1, (3, P.n0 + 1), generator=g,
                         dtype=torch.int64)
    tv = torch.randint(-2**63, 2**63 - 1, (2, P.N), generator=g,
                       dtype=torch.int64)
    return P, ck, tlwe, tv


def _k1_digit_calls(monkeypatch):
    """Whether each K1 call of the scan carried a digits buffer."""
    calls = []
    k1 = BRN.ntt_inverse_to_crt_acc

    def counted(*a, digits=None, **kw):
        calls.append(digits is not None)
        return k1(*a, digits=digits, **kw)

    monkeypatch.setattr(BRN, "ntt_inverse_to_crt_acc", counted)
    return calls


# TEST_TINY_SPLIT's key (n0 = 8: 4 steps) and tfhers_2_2 cut to n0 = 5
# (3 steps, the last group padded), with an arbitrary int64 test vector
@pytest.mark.parametrize("case, n0", [("tiny_split", None), ("tfhers_2_2", 5)])
def test_split_scan_takes_the_fusion(case, n0, monkeypatch):
    P, levels = _SPLIT_CASES[case]
    P, ck, tlwe, tv = _split_key(P, n0, None, 42)
    assert (ck.bsk_group, ck.bsk_bgbit, ck.bsk_levels, ck.bsk_ntt_drop) == (
        2, 8, levels, 32)
    G = ck.bsk_ntt.shape[0]
    assert G >= 3
    calls = _k1_digit_calls(monkeypatch)
    got, attrs = _recorded_steps(lambda: SR.blind_rotate_split(
        tlwe, tv, ck.bsk_ntt, P, 32, group=2, levels=levels, bgbit=8))
    assert attrs == {"steps": G, "fused_steps": G - 1,
                     "plain_digit_steps": 1}
    assert calls == [True] * (G - 1) + [False]
    want = _split_step_by_step(tlwe, tv, ck.bsk_ntt, P, levels)
    assert torch.equal(got, want)


def test_split_ring_bypasses_the_fusion(monkeypatch):
    """A group-1 TEST_TINY_SPLIT key (no K2s) runs the plain chain and K1
    without digits on every step: ``fused_steps`` 0, and the scan equals
    the generic int64 scan, which never reaches K1."""
    P, ck, tlwe, tv = _split_key(params.TEST_TINY_SPLIT, None, 1, 43)
    calls = _k1_digit_calls(monkeypatch)
    kw = dict(group=1, levels=ck.bsk_levels, bgbit=ck.bsk_bgbit)
    got, attrs = _recorded_steps(lambda: SR.blind_rotate_split(
        tlwe, tv, ck.bsk_ntt, P, ck.bsk_ntt_drop, **kw))
    assert attrs == {"steps": P.n0, "fused_steps": 0,
                     "plain_digit_steps": P.n0}
    assert calls == [False] * P.n0
    form = BRN.key_form      # the generic scan: the key's form without hi planes
    monkeypatch.setattr(BRN, "key_form", lambda *a: dataclasses.replace(
        form(*a), hi32=False))
    assert torch.equal(got, SR.blind_rotate_split(tlwe, tv, ck.bsk_ntt, P,
                                                  ck.bsk_ntt_drop, **kw))
    assert len(calls) == P.n0
