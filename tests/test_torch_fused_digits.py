"""The next step's gadget digits written by K1 (ops/cuda/ntt_inverse.py)
and the fused step loop of ops/blind_rotate_ntt.py that reads them.

K1's plain version with a ``digits`` buffer writes exactly
``_decompose_to_rows(out, ...).to(torch.int8)`` of the accumulator it
returns, and returns the same accumulator as without one; the engine's
one-limb loop (every boolean key: groups 2 and 3) decomposes only for
step 0 and equals, bit for bit, the loop that decomposes on every step;
the ``fused_steps`` attribute of span ``blind_rotate.steps`` reads G - 1
there and 0 on the paths that bypass the fusion (a multi-limb uint key,
the split ring), whose outputs do not change.  The kernel's own source is
held to the plain version in tests/test_torch_kernel_emulation.py and on
the card in tests/test_torch_cuda.py.  The file imports no jax.
"""

import dataclasses

import numpy as np
import pytest
import torch

from zig_tfhe_tpu_torch import key, params
from zig_tfhe_tpu_torch.ops import ntt
from zig_tfhe_tpu_torch.ops import blind_rotate_ntt as BRN
from zig_tfhe_tpu_torch.ops.blind_rotate import (_decompose_to_rows, modswitch,
                                                 row_gadget)
from zig_tfhe_tpu_torch.ops.cuda import ntt_inverse as K1
from zig_tfhe_tpu_torch.ops.cuda import ntt_step as K2
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
# whose a-offset is centred and b-offset not
_CASES = {"tiny_22": (params.TEST_TINY, 0, 3, (2, 2), 6),
          "tiny_32_bg7": (params.TEST_TINY, 0, 3, (3, 2), 7),
          "128bit_g3": (params.SECURITY_128_BIT, 5, 3, (2, 2), 7),
          "128bit_g2_32": (params.SECURITY_128_BIT, 7, 2, (3, 2), 6)}


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
    digits = torch.from_numpy(rng.integers(-128, 128, (B, sum(levels), N))
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
    want = _decompose_to_rows(out, P, levels, bgbit=bgbit)
    assert int(want.abs().max()) <= 1 << (bgbit - 1)
    assert torch.equal(digits, want.to(torch.int8))


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
    with pytest.raises(NotImplementedError, match="one-limb"):
        K1.ntt_inverse_to_crt_acc(v, acc, plan, drop, digits=d,
                                  gadget=row_gadget(params.TEST_TINY_UINT))


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
        d = K2.digit_planes(_decompose_to_rows(acc, P, levels, bgbit=bgbit), n_dl)
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
# group padded), g2's (3, 2) gadget over 3 steps
@pytest.mark.parametrize("case", ["tiny_g2", "tiny_g3", "128bit_g3", "128bit_g2_32"])
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
        P = _cut(P0, 7 if group == 3 else 6)
        tlwe, tv, bsk = _random_key(P, drop, group, levels, bgbit, len(case))
    G = bsk.shape[0]
    assert ntt.engine_digit_limbs(bgbit) == 1 and G >= 3
    got, attrs = _recorded_steps(lambda: BRN.blind_rotate_ntt(
        tlwe, tv, bsk, P, drop, group=group, levels=levels, bgbit=bgbit))
    assert attrs == {"steps": G, "fused_steps": G - 1}
    want = _step_by_step(tlwe, tv, bsk, P, drop, group, levels, bgbit)
    assert torch.equal(got, want)


def test_multi_limb_uint_key_bypasses_the_fusion():
    """TEST_TINY_UINT's engine digits (Bg_e 2^11) are two limbs: the loop
    decomposes on every step, as before."""
    P = params.TEST_TINY_UINT
    g = torch.Generator().manual_seed(41)
    ck = key.CloudKey.generate(g, key.SecretKey.generate(g, P), P)
    drop, group, levels, bgbit = (ck.bsk_ntt_drop, ck.bsk_group,
                                  ck.bsk_levels, ck.bsk_bgbit)
    assert ntt.engine_digit_limbs(bgbit) == 2 and K2.supports(group, 2)
    tlwe = torch.from_numpy(np.random.default_rng(41).integers(
        -2**31, 2**31, (6, P.n0 + 1)).astype(np.int32))
    got, attrs = _recorded_steps(lambda: BRN.blind_rotate_ntt(
        tlwe, ck.testvec, ck.bsk_ntt, P, drop, group=group, levels=levels,
        bgbit=bgbit))
    assert attrs == {"steps": ck.bsk_ntt.shape[0], "fused_steps": 0}
    want = _step_by_step(tlwe, ck.testvec, ck.bsk_ntt, P, drop, group, levels,
                         bgbit)
    assert torch.equal(got, want)


def test_split_ring_bypasses_the_fusion():
    """TEST_TINY_SPLIT's hi-plane scan finishes on K1 without digits."""
    P = params.TEST_TINY_SPLIT
    g = torch.Generator().manual_seed(42)
    ck = key.CloudKey.generate(g, key.SecretKey.generate(g, P), P,
                               packing_key=False)
    tlwe = torch.randint(-2**63, 2**63 - 1, (2, P.n0 + 1), generator=g,
                         dtype=torch.int64)
    before = K1.ntt_inverse_to_crt_acc.digit_launches
    _, attrs = _recorded_steps(lambda: BRN.blind_rotate_ntt(
        tlwe, ck.testvec, ck.bsk_ntt, P, ck.bsk_ntt_drop, group=ck.bsk_group,
        levels=ck.bsk_levels, bgbit=ck.bsk_bgbit))
    assert attrs == {"steps": ck.bsk_ntt.shape[0], "fused_steps": 0}
    assert K1.ntt_inverse_to_crt_acc.digit_launches == before
