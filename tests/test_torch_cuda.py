"""Tests of the port that need an NVIDIA CUDA card (marker ``cuda``).

Each test skips without a card.  The file imports no jax, so it also runs
where jax is not installed, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The hand-written kernels are held bit-equal to their plain PyTorch versions
(K1 also to the closed-form exact result) at the paths' shapes; the gate
paths on the card (the NTT engine's and the Toeplitz engine's) are held
bit-equal to the port's CPU path, which the other tests/test_torch_*.py
files hold bit-equal to the JAX package; so are scheduled circuits (the
full adder and the w = 8 Bristol multiplier), and so are the LUT paths
of models/lut.py on a TEST_TINY_UINT key (bootstrap_lut, tree_pbs) and the
integer layer of models/integer.py (radix_add, the tree-PBS radix_mul,
radix_eq; a FheUint operator chain exact).  The 64-bit torus: K1 at the
split-ring step's views, with and without the next step's hi-plane
half-rows (the tfhers_2_2 and SECURITY_128_BIT_T64 gadgets), a
SECURITY_128_BIT_T64 gate batch (one K1 per step of the 384-step
hi-plane scan) and a SECURITY_TFHERS_2_2 one (371 steps of K2s then K1,
370 of the K1 launches writing the next half-rows, no synchronising
operation in the scan), and the int64 finish, which has no
kernel and runs its plain version on the card, bit-equal to the CPU; K2s
(the split-ring step core) bit-equal to its plain version at the t64 and
TEST_TINY_SPLIT shapes, and one K2s and one K1 launch per hi-plane step.
K2's instance compiled at g3's shape: the launches that take it, and its
f32-add Barrett equal to the conversion form on every int32.
Slice 5: the threefry mask expansion, the proxy re-encryption subset sum
and key switch, and a one-rank NCCL gate runner, each equal to the CPU
path.
"""

import dataclasses

import numpy as np
import pytest
import torch

from zig_tfhe_tpu_torch import key, params, tlwe, trgsw
from zig_tfhe_tpu_torch.models import (gates, integer, lut, netlists,
                                       proxy_reenc, scheduler)
from zig_tfhe_tpu_torch.ops import decomposition, ntt, split_ring
from zig_tfhe_tpu_torch.ops.cuda import extprod as K3
from zig_tfhe_tpu_torch.ops.cuda import ntt_inverse as K
from zig_tfhe_tpu_torch.ops.cuda import ntt_step as K2
from zig_tfhe_tpu_torch.ops.cuda import split_step as K2S

pytestmark = pytest.mark.cuda

# (params, drop, group, levels, engine bgbit)
_CASES = {"tiny": (params.TEST_TINY, 0, 3, (2, 2), 6),
          "128bit": (params.SECURITY_128_BIT, 5, 3, (2, 2), 7),
          "128bit_g2": (params.SECURITY_128_BIT, 7, 2, (3, 2), 6)}

_TRUTH = {
    "nand": lambda p, q: not (p and q), "or": lambda p, q: p or q,
    "and": lambda p, q: p and q, "xor": lambda p, q: p != q,
    "xnor": lambda p, q: p == q, "nor": lambda p, q: not (p or q),
    "andny": lambda p, q: (not p) and q, "andyn": lambda p, q: p and not q,
    "orny": lambda p, q: (not p) or q, "oryn": lambda p, q: p or not q}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _plan(case):
    P, drop, group, levels, bgbit = _CASES[case]
    return ntt.plan_for_params(P, drop, group, levels, bgbit=bgbit,
                               pseudorandom_key=True), drop


# B = 1 and 33 take the narrow column tile, 200 ends inside a row tile's
# second warpgroup, 2049 leaves a row tile with one live row pair
@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("B", [1, 8, 33, 200, 2048, 2049])
def test_kernel_matches_plain_and_exact(dev, case, B):
    plan, drop = _plan(case)
    rng = np.random.default_rng(B)
    c, acc = (torch.from_numpy(rng.integers(-2**31, 2**31, (B, 2, plan.N))
                               .astype(np.int32)).to(dev) for _ in range(2))
    v = torch.stack(ntt.ntt_forward(c, plan, digit_limbs=4, digit_bound=128))
    before = K.ntt_inverse_to_crt_acc.launches
    out = K.ntt_inverse_to_crt_acc(v, acc, plan, drop)
    torch.cuda.synchronize()
    assert K.ntt_inverse_to_crt_acc.launches == before + 1
    assert torch.equal(out, K.ntt_inverse_to_crt_acc_reference(v, acc, plan,
                                                                drop))
    assert torch.equal(out, acc + (c << drop))
    # the same residues as int8 limb planes, the form K2 hands over
    v8 = K.split_limbs(v)
    assert torch.equal(K.join_limbs(v8), v)
    assert torch.equal(K.ntt_inverse_to_crt_acc(v8, acc, plan, drop), out)


# K1's instance that also writes the next step's digits, at the 128-bit g3
# gadget (Bg_e 2^7 (2, 2)) and the g2 one (2^6 (3, 2): a-offset centred)
@pytest.mark.parametrize("case", ["128bit", "128bit_g2"])
@pytest.mark.parametrize("B", [1, 200, 2048])
def test_kernel_writes_digits_of_its_output(dev, case, B):
    from zig_tfhe_tpu_torch.ops.decomposition import row_gadget

    P, drop, _, levels, bgbit = _CASES[case]
    plan, _ = _plan(case)
    gadget = row_gadget(P, levels, bgbit)
    rng = np.random.default_rng(B + 3)
    c, acc = (torch.from_numpy(rng.integers(-2**31, 2**31, (B, 2, plan.N))
                               .astype(np.int32)).to(dev) for _ in range(2))
    v = K.split_limbs(torch.stack(ntt.ntt_forward(c, plan, digit_limbs=4,
                                                  digit_bound=128)))
    digits = torch.from_numpy(rng.integers(-128, 128, (B, sum(levels), plan.N))
                              .astype(np.int8)).to(dev)   # all rewritten
    before = (K.ntt_inverse_to_crt_acc.launches,
              K.ntt_inverse_to_crt_acc.digit_launches)
    out = K.ntt_inverse_to_crt_acc(v, acc, plan, drop, digits=digits,
                                   gadget=gadget)
    torch.cuda.synchronize()
    assert (K.ntt_inverse_to_crt_acc.launches,
            K.ntt_inverse_to_crt_acc.digit_launches) == (before[0] + 1,
                                                         before[1] + 1)
    assert torch.equal(out, K.ntt_inverse_to_crt_acc(v, acc, plan, drop))
    assert torch.equal(out, acc + (c << drop))
    want = torch.empty_like(digits).cpu()
    K.ntt_inverse_to_crt_acc_reference(v.cpu(), acc.cpu(), plan, drop, want,
                                       gadget)
    assert torch.equal(digits.cpu(), want)


def test_kernel_rejects_what_it_cannot_take(dev):
    plan, drop = _plan("tiny")
    v = torch.zeros((plan.n_primes, 4, 2, plan.N), dtype=torch.int32,
                    device=dev)
    acc = torch.zeros((4, 2, plan.N), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shapes"):
        K.ntt_inverse_to_crt_acc(v[:, :3], acc, plan, drop)
    with pytest.raises(ValueError, match="same CUDA device"):
        K.ntt_inverse_to_crt_acc(v, acc.cpu(), plan, drop)
    with pytest.raises(ValueError, match="drop"):
        K.ntt_inverse_to_crt_acc(v, acc, plan, 32)


def _lanes(B, seed):
    rng = np.random.default_rng(seed)
    ids = np.arange(B) % len(gates.GATE_NAMES)
    x, y = rng.integers(0, 2, (2, B)).astype(bool)
    want = np.array([_TRUTH[gates.GATE_NAMES[i]](bool(p), bool(q))
                     for i, p, q in zip(ids, x, y)])
    return torch.from_numpy(ids), torch.from_numpy(x), torch.from_numpy(y), want


@pytest.mark.parametrize("group", [1, 2, 3])
def test_tiny_gates_on_card_equal_cpu_path(dev, group):
    P = params.TEST_TINY
    g = torch.Generator().manual_seed(group)
    sk = key.SecretKey.generate(g, P)
    ck = key.CloudKey.generate(g, sk, P, group=group)
    ids, x, y, want = _lanes(40, group)
    a = tlwe.encrypt_bool(g, x, P.ksk_alpha, sk.key_lv0)
    b = tlwe.encrypt_bool(g, y, P.ksk_alpha, sk.key_lv0)
    cpu = gates.apply_gates(ids, a, b, ck)
    steps = ck.bsk_ntt.shape[0]
    ck = ck.to(dev)
    before = K.ntt_inverse_to_crt_acc.launches
    before2 = K2.ntt_step_fused.launches
    out = gates.apply_gates(ids.to(dev), a.to(dev), b.to(dev), ck)
    torch.cuda.synchronize()
    assert K.ntt_inverse_to_crt_acc.launches - before == steps
    assert K2.ntt_step_fused.launches - before2 == (0 if group == 1 else steps)
    assert torch.equal(out.cpu(), cpu)
    assert np.array_equal(tlwe.decrypt_bool(out.cpu(), sk.key_lv0).numpy(),
                          want)


def test_128bit_gates_on_card(dev):
    """Keygen on the card at the 128-bit defaults, 64 lanes: accuracy 1.0,
    234 kernel launches, and the first 4 lanes equal to the CPU path."""
    P = params.SECURITY_128_BIT
    g = torch.Generator(device=dev).manual_seed(0)
    sk = key.SecretKey.generate(g, P)
    ck = key.CloudKey.generate(g, sk, P)
    ids, x, y, want = _lanes(64, 1)
    a = tlwe.encrypt_bool(g, x.to(dev), P.ksk_alpha, sk.key_lv0)
    b = tlwe.encrypt_bool(g, y.to(dev), P.ksk_alpha, sk.key_lv0)
    before = K.ntt_inverse_to_crt_acc.launches
    out = gates.apply_gates(ids.to(dev), a, b, ck)
    torch.cuda.synchronize()
    assert K.ntt_inverse_to_crt_acc.launches - before == 234
    got = tlwe.decrypt_bool(out, sk.key_lv0).cpu().numpy()
    assert np.array_equal(got, want)
    ck_cpu = key.CloudKey.from_numpy(
        {n: t.cpu().numpy() for n, t in ck.named_buffers()}, P,
        bsk_ntt_drop=ck.bsk_ntt_drop, bsk_group=ck.bsk_group,
        bsk_levels=ck.bsk_levels, bsk_bgbit=ck.bsk_bgbit, device="cpu")
    cpu = gates.apply_gates(ids[:4], a[:4].cpu(), b[:4].cpu(), ck_cpu)
    assert torch.equal(out[:4].cpu(), cpu)


# the fused step's configurations: (drop, group, levels, engine bgbit)
_STEP_CASES = {"128bit_g2": (7, 2, (3, 2), 6), "128bit_g3": (5, 3, (2, 2), 7)}


def _step_inputs(dev, case, B, seed):
    """Digits, one step of in-range key residues (NTTs of uniform rows, as
    keygen makes them) and rotations, at the 128-bit shapes."""
    drop, group, levels, bgbit = _STEP_CASES[case]
    P = params.SECURITY_128_BIT
    plan = ntt.plan_for_params(P, drop, group, levels, bgbit=bgbit,
                               pseudorandom_key=True)
    R, S, N = sum(levels), (1 << group) - 1, plan.N
    rng = np.random.default_rng(seed)
    half = 1 << (bgbit - 1)
    digits = torch.from_numpy(rng.integers(-half, half, (B, R, N))
                              .astype(np.int8)).to(dev)
    rows = torch.from_numpy(rng.integers(-2**31, 2**31, (S, R, 2, N))
                            .astype(np.int32)).to(dev)
    bsk = ntt.to_ntt_form(rows, plan, drop).movedim(0, 1).contiguous()
    ts = torch.from_numpy(rng.integers(0, 2 * N + 1, (group, B))
                          .astype(np.int32)).to(dev)
    return plan, bgbit, digits, bsk, ts


# B = 1 and 33 take the narrow tile, 200 and 2049 end inside a 64-row tile
# (16 lanes a tile at R = 4, 12 at R = 5); g3 takes the instance compiled
# at its shape where its wide tiles give all 132 SMs one (B >= 81)
@pytest.mark.parametrize("case", sorted(_STEP_CASES))
@pytest.mark.parametrize("B", [1, 33, 64, 200, 2048, 2049])
def test_step_kernel_matches_plain(dev, case, B):
    plan, bgbit, digits, bsk, ts = _step_inputs(dev, case, B, B)
    fn = K2.ntt_step_fused
    before = (fn.launches, fn.shape_launches, fn.uint_shape_launches)
    out = K2.ntt_step_fused(digits, bsk, ts, plan, bgbit)
    torch.cuda.synchronize()
    shape = int(case == "128bit_g3" and B >= 200)
    assert (fn.launches, fn.shape_launches, fn.uint_shape_launches) == (
        before[0] + 1, before[1] + shape, before[2])
    assert out.dtype == torch.int8
    assert tuple(out.shape) == (plan.n_primes, B, 2, 2, plan.N)
    assert torch.equal(out, K2.ntt_step_fused_reference(digits, bsk, ts, plan,
                                                         bgbit))


def test_step_kernel_rejects_what_it_cannot_take(dev):
    plan, bgbit, digits, bsk, ts = _step_inputs(dev, "128bit_g2", 4, 0)
    with pytest.raises(ValueError, match="shapes"):
        K2.ntt_step_fused(digits[:, :4], bsk, ts, plan, bgbit)
    with pytest.raises(ValueError, match="same CUDA device"):
        K2.ntt_step_fused(digits, bsk.cpu(), ts, plan, bgbit)
    with pytest.raises(NotImplementedError, match="groups"):
        K2.ntt_step_fused(digits, bsk[:1], ts[:1], plan, bgbit)
    with pytest.raises(NotImplementedError, match="one-limb"):    # 4 limbs
        K2.ntt_step_fused(digits, bsk, ts, plan, 25)


# uint keys at their defaults: group 2, Bg_e 2^10 with (2, 2) levels and 2
# limbs (8 planes, 8 lanes a tile), 4 primes, drop 3 (uint1); Bg_e 2^22 with
# (1, 1) levels and 3 limbs (6 planes, 10 lanes a tile), 5 primes (uint4)
def _limb_step_inputs(dev, name, B, seed):
    """The limb planes of a real accumulator's digits (centred remainders
    with a carry into the top limb), one step of in-range key residues, the
    rotations and the accumulator."""
    from zig_tfhe_tpu_torch.ops.decomposition import decompose_rows

    P = params.PARAMS_BY_NAME[name]
    bgbit, levels = ntt.default_engine_gadget(P, 2)
    drop = ntt.default_drop_bits(P, 2, bgbit)
    plan = ntt.plan_for_params(P, drop, 2, levels, bgbit=bgbit,
                               pseudorandom_key=True)
    N, R = plan.N, sum(levels)
    rng = np.random.default_rng(seed)
    acc = torch.from_numpy(rng.integers(-2**31, 2**31, (B, 2, N))
                           .astype(np.int32)).to(dev)
    digits = decomposition.digit_planes(
        decompose_rows(acc, P, levels, bgbit=bgbit),
        ntt.engine_digit_limbs(bgbit))
    rows = torch.from_numpy(rng.integers(-2**31, 2**31, (3, R, 2, N))
                            .astype(np.int32)).to(dev)
    bsk = ntt.to_ntt_form(rows, plan, drop).movedim(0, 1).contiguous()
    ts = torch.from_numpy(rng.integers(0, 2 * N + 1, (2, B))
                          .astype(np.int32)).to(dev)
    return plan, bgbit, drop, digits, bsk, ts, acc


# B = 10 fills one uint4 tile, 11 spills one lane into a second, 1 and 10
# take the narrow column tile; at 200, 2048 and 2049 (a last tile of 9
# lanes) uint4 takes the instance compiled at the uint keys' shape, uint1
# (R = 4 rows of 2 limbs) the general one
@pytest.mark.parametrize("name", ["uint1", "uint4"])
@pytest.mark.parametrize("B", [1, 10, 11, 200, 2048, 2049])
def test_step_kernel_multi_limb_matches_plain(dev, name, B):
    plan, bgbit, drop, digits, bsk, ts, acc = _limb_step_inputs(dev, name, B, B)
    fn = K2.ntt_step_fused
    before = (fn.launches, fn.shape_launches, fn.uint_shape_launches)
    out = K2.ntt_step_fused(digits, bsk, ts, plan, bgbit)
    torch.cuda.synchronize()
    uint = int(name == "uint4" and B >= 200)
    assert (fn.launches, fn.shape_launches, fn.uint_shape_launches) == (
        before[0] + 1, before[1], before[2] + uint)
    assert tuple(out.shape) == (plan.n_primes, B, 2, 2, plan.N)
    assert torch.equal(out, K2.ntt_step_fused_reference(digits, bsk, ts, plan,
                                                         bgbit))
    # and K1 after it, at 4-5 primes and drop 3 / 0
    acc2 = K.ntt_inverse_to_crt_acc(out, acc, plan, drop)
    assert torch.equal(acc2, K.ntt_inverse_to_crt_acc_reference(out, acc, plan,
                                                                 drop))


@pytest.mark.parametrize("B", [1, 200, 2048])
def test_kernel_five_primes_drop0_matches_plain_and_exact(dev, B):
    """K1 at uint4's plan: 5 primes, drop 0, on residues of bounded
    polynomials."""
    P = params.PARAMS_BY_NAME["uint4"]
    plan = ntt.plan_for_params(P, 0, 2, (1, 1), bgbit=22, pseudorandom_key=True)
    assert plan.n_primes == 5
    rng = np.random.default_rng(B + 5)
    c, acc = (torch.from_numpy(rng.integers(-2**31, 2**31, (B, 2, plan.N))
                               .astype(np.int32)).to(dev) for _ in range(2))
    v = K.split_limbs(torch.stack(ntt.ntt_forward(c, plan, digit_limbs=4,
                                                  digit_bound=128)))
    out = K.ntt_inverse_to_crt_acc(v, acc, plan, 0)
    torch.cuda.synchronize()
    assert torch.equal(out, K.ntt_inverse_to_crt_acc_reference(v, acc, plan, 0))
    assert torch.equal(out, acc + c)


# K1's instance that writes the uint keys' limb planes, at uint4's shapes
# (Bg_e 2^22 (1, 1): 3 limbs, 6 planes a lane; 5 primes, drop 0)
@pytest.mark.parametrize("B", [1, 200, 2048])
def test_kernel_writes_limb_planes_of_its_output(dev, B):
    P = params.PARAMS_BY_NAME["uint4"]
    levels, bgbit = (1, 1), 22
    plan = ntt.plan_for_params(P, 0, 2, levels, bgbit=bgbit,
                               pseudorandom_key=True)
    gadget = decomposition.row_gadget(P, levels, bgbit)
    rng = np.random.default_rng(B + 22)
    c, acc = (torch.from_numpy(rng.integers(-2**31, 2**31, (B, 2, plan.N))
                               .astype(np.int32)).to(dev) for _ in range(2))
    v = K.split_limbs(torch.stack(ntt.ntt_forward(c, plan, digit_limbs=4,
                                                  digit_bound=128)))
    digits = torch.from_numpy(rng.integers(-128, 128, (B, 6, plan.N))
                              .astype(np.int8)).to(dev)   # all rewritten
    before = (K.ntt_inverse_to_crt_acc.launches,
              K.ntt_inverse_to_crt_acc.digit_launches)
    out = K.ntt_inverse_to_crt_acc(v, acc, plan, 0, digits=digits,
                                   gadget=gadget)
    torch.cuda.synchronize()
    assert (K.ntt_inverse_to_crt_acc.launches,
            K.ntt_inverse_to_crt_acc.digit_launches) == (before[0] + 1,
                                                         before[1] + 1)
    assert torch.equal(out, K.ntt_inverse_to_crt_acc(v, acc, plan, 0))
    assert torch.equal(out, acc + c)
    want = torch.empty_like(digits).cpu()
    K.ntt_inverse_to_crt_acc_reference(v.cpu(), acc.cpu(), plan, 0, want,
                                       gadget)
    assert torch.equal(digits.cpu(), want)
    assert torch.equal(want, decomposition.digit_planes(
        decomposition.decompose_rows(out, P, levels, bgbit=bgbit), 3).cpu())


def _step_by_step_scan(acc, bsk, ts, form, core, plain_step):
    """The direct ring's kernel loop as it ran on the uint keys before K1
    wrote their limb planes: the planes made on every step, K1 without a
    buffer (ops/blind_rotate_ntt.py:scan's kernel path)."""
    for s in range(ts.shape[0]):
        v = core(form.gadget.planes(acc), bsk[s], ts[s], form.plan, form.bits)
        acc = K.ntt_inverse_to_crt_acc(v, acc, form.plan, form.drop)
    return acc


def test_uint4_bootstrap_lut_takes_the_limb_planes(dev, monkeypatch):
    """A bootstrap_lut batch on a uint4 key made on the card: 410 steps of
    K2 and K1, 409 of the K1 launches writing the next limb planes, the
    output bit-equal to the loop that remakes the planes on every step,
    and every lane decoding to f(x)."""
    from zig_tfhe_tpu_torch.ops import blind_rotate_ntt

    P = params.SECURITY_UINT4
    g = torch.Generator(device=dev).manual_seed(25)
    sk = key.SecretKey.generate(g, P)
    ck = key.CloudKey.generate(g, sk, P, packing_key=False)
    steps = ck.bsk_ntt.shape[0]
    assert (steps, ck.bsk_bgbit, ck.bsk_levels) == (410, 22, (1, 1))
    msgs = torch.arange(300, device=dev) % 16
    ct = lut.encrypt_message(g, msgs, 16, P.tlwe_lv0.alpha, sk.key_lv0)
    tab = lut.Generator.new(16, P).generate_lookup_table(
        lambda x: (5 * x + 2) % 16)
    before = (K2.ntt_step_fused.launches, K.ntt_inverse_to_crt_acc.launches,
              K.ntt_inverse_to_crt_acc.digit_launches)
    out = lut.bootstrap_lut(ct, tab, ck)
    torch.cuda.synchronize()
    assert (K2.ntt_step_fused.launches - before[0],
            K.ntt_inverse_to_crt_acc.launches - before[1],
            K.ntt_inverse_to_crt_acc.digit_launches - before[2]) == (
                steps, steps, steps - 1)
    monkeypatch.setattr(blind_rotate_ntt, "scan", _step_by_step_scan)
    want = lut.bootstrap_lut(ct, tab, ck)
    assert torch.equal(out, want)
    assert torch.equal(lut.decrypt_message(out, 16, sk.key_lv0).long(),
                       (5 * msgs + 2) % 16)
    # at 2048 lanes every step takes K2's instance compiled at the uint
    # keys' shape
    msgs = torch.arange(2048, device=dev) % 16
    ct = lut.encrypt_message(g, msgs, 16, P.tlwe_lv0.alpha, sk.key_lv0)
    fn = K2.ntt_step_fused
    before = (fn.launches, fn.shape_launches, fn.uint_shape_launches)
    out = lut.bootstrap_lut(ct, tab, ck)
    torch.cuda.synchronize()
    assert (fn.launches - before[0], fn.shape_launches - before[1],
            fn.uint_shape_launches - before[2]) == (steps, 0, steps)
    assert torch.equal(lut.decrypt_message(out, 16, sk.key_lv0).long(),
                       (5 * msgs + 2) % 16)


@pytest.mark.parametrize("knobs, steps", [({}, 234),
                                          ({"group": 2, "decomp_levels": (3, 2)}, 350)])
def test_128bit_launches_per_bootstrap(dev, knobs, steps):
    """Each step of a 128-bit bootstrap is one K2 and one K1 launch: 234
    steps at the group-3 default, 350 with the group-2 (3, 2) key; all but
    the last K1 write the next step's digits."""
    P = params.SECURITY_128_BIT
    g = torch.Generator(device=dev).manual_seed(3)
    sk = key.SecretKey.generate(g, P)
    ck = key.CloudKey.generate(g, sk, P, **knobs)
    ids, x, y, want = _lanes(20, 2)
    a = tlwe.encrypt_bool(g, x.to(dev), P.ksk_alpha, sk.key_lv0)
    b = tlwe.encrypt_bool(g, y.to(dev), P.ksk_alpha, sk.key_lv0)
    before = (K2.ntt_step_fused.launches, K.ntt_inverse_to_crt_acc.launches,
              K.ntt_inverse_to_crt_acc.digit_launches,
              K2.ntt_step_fused.shape_launches,
              K2.ntt_step_fused.uint_shape_launches)
    out = gates.apply_gates(ids.to(dev), a, b, ck)
    torch.cuda.synchronize()
    # one-limb digits: every K1 but the last writes the next step's digits;
    # 20 lanes take narrow tiles, so no step takes a K2 shape instance
    assert (K2.ntt_step_fused.launches - before[0],
            K.ntt_inverse_to_crt_acc.launches - before[1],
            K.ntt_inverse_to_crt_acc.digit_launches - before[2],
            K2.ntt_step_fused.shape_launches - before[3],
            K2.ntt_step_fused.uint_shape_launches - before[4]) == (
                steps, steps, steps - 1, 0, 0)
    assert np.array_equal(tlwe.decrypt_bool(out, sk.key_lv0).cpu().numpy(), want)


def _extprod_inputs(dev, name, n_kl, B, seed):
    """One digit limb (digits in [-Bg/2, Bg/2)) and one step of an ext-limb
    key (the limbs of [p, -p] of uniform rows, as keygen makes them)."""
    P = params.PARAMS_BY_NAME[name]
    rng = np.random.default_rng(seed)
    half = 1 << (P.bgbit - 1)
    digits = torch.from_numpy(rng.integers(-half, half, (B, 2 * P.L * P.N))
                              .astype(np.int8)).to(dev)
    rows = torch.from_numpy(rng.integers(-2**31, 2**31, (2 * P.L, 2, P.N))
                            .astype(np.int32))
    ext = trgsw.to_ext_limbs(rows, n_kl).to(dev)
    return P, digits, ext


@pytest.mark.parametrize("name", ["tiny", "128bit"])
@pytest.mark.parametrize("n_kl", [4, 3])
@pytest.mark.parametrize("B", [1, 8, 200, 2048])
def test_extprod_kernel_matches_plain(dev, name, n_kl, B):
    P, digits, ext = _extprod_inputs(dev, name, n_kl, B, B + n_kl)
    before = K3.extprod_matmul.launches
    out = K3.extprod_matmul(digits, ext, P)
    torch.cuda.synchronize()
    assert K3.extprod_matmul.launches == before + 1
    assert torch.equal(out, K3.extprod_matmul_reference(digits, ext, P))


# 128-bit shapes (N = 1024, 128-byte digit chunks, 16 column blocks) at
# every key-limb count: B = 63, 64, 65 end inside, at and past one 64-lane
# batch tile, 2049 leaves a last tile of one lane
@pytest.mark.parametrize("n_kl", [1, 2, 3, 4])
@pytest.mark.parametrize("B", [1, 63, 64, 65, 200, 2049])
def test_extprod_kernel_matches_plain_128bit(dev, n_kl, B):
    P, digits, ext = _extprod_inputs(dev, "128bit", n_kl, B, 7 * B + n_kl)
    before = K3.extprod_matmul.launches
    out = K3.extprod_matmul(digits, ext, P)
    torch.cuda.synchronize()
    assert K3.extprod_matmul.launches == before + 1
    assert torch.equal(out, K3.extprod_matmul_reference(digits, ext, P))


def test_extprod_kernel_rejects_what_it_cannot_take(dev):
    P, digits, ext = _extprod_inputs(dev, "tiny", 4, 4, 0)
    with pytest.raises(ValueError, match="shapes"):
        K3.extprod_matmul(digits[:, :-1], ext, P)
    with pytest.raises(ValueError, match="same CUDA device"):
        K3.extprod_matmul(digits, ext.cpu(), P)
    with pytest.raises(TypeError, match="int8"):
        K3.extprod_matmul(digits.int(), ext, P)


def test_tiny_toeplitz_gates_on_card_equal_cpu_path(dev):
    P = params.TEST_TINY
    g = torch.Generator().manual_seed(5)
    sk = key.SecretKey.generate(g, P)
    ck = key.CloudKey.generate(g, sk, P, engines=("toeplitz",))
    ids, x, y, want = _lanes(40, 5)
    a = tlwe.encrypt_bool(g, x, P.ksk_alpha, sk.key_lv0)
    b = tlwe.encrypt_bool(g, y, P.ksk_alpha, sk.key_lv0)
    cpu = gates.apply_gates(ids, a, b, ck)
    before = K3.extprod_matmul.launches
    out = gates.apply_gates(ids.to(dev), a.to(dev), b.to(dev), ck.to(dev))
    torch.cuda.synchronize()
    assert K3.extprod_matmul.launches - before == P.n0
    assert torch.equal(out.cpu(), cpu)
    assert np.array_equal(tlwe.decrypt_bool(out.cpu(), sk.key_lv0).numpy(), want)


def test_128bit_toeplitz_gates_on_card(dev):
    """A Toeplitz-only key at SECURITY_128_BIT made on the card: one K3
    launch per step (700 per bootstrap), no K1 or K2, accuracy 1.0 on 20
    lanes, and the first 2 lanes equal to the CPU path."""
    P = params.SECURITY_128_BIT
    g = torch.Generator(device=dev).manual_seed(6)
    sk = key.SecretKey.generate(g, P)
    ck = key.CloudKey.generate(g, sk, P, engines=("toeplitz",))
    assert ck.bsk_ntt is None
    assert tuple(ck.bsk_ext_limbs.shape) == (700, 4, 6, 2, 2048)
    ids, x, y, want = _lanes(20, 6)
    a = tlwe.encrypt_bool(g, x.to(dev), P.ksk_alpha, sk.key_lv0)
    b = tlwe.encrypt_bool(g, y.to(dev), P.ksk_alpha, sk.key_lv0)
    before = (K3.extprod_matmul.launches, K.ntt_inverse_to_crt_acc.launches,
              K2.ntt_step_fused.launches)
    out = gates.apply_gates(ids.to(dev), a, b, ck)
    torch.cuda.synchronize()
    assert (K3.extprod_matmul.launches - before[0],
            K.ntt_inverse_to_crt_acc.launches - before[1],
            K2.ntt_step_fused.launches - before[2]) == (700, 0, 0)
    assert np.array_equal(tlwe.decrypt_bool(out, sk.key_lv0).cpu().numpy(), want)
    ck_cpu = key.CloudKey.from_numpy(
        {n: t.cpu().numpy() for n, t in ck.named_buffers()}, P,
        bsk_ntt_drop=ck.bsk_ntt_drop, bsk_group=ck.bsk_group,
        bsk_levels=ck.bsk_levels, bsk_bgbit=ck.bsk_bgbit, device="cpu")
    cpu = gates.apply_gates(ids[:2], a[:2].cpu(), b[:2].cpu(), ck_cpu)
    assert torch.equal(out[:2].cpu(), cpu)


def _full_adder_plan():
    c = scheduler.Circuit()
    a, b, cin = c.input(), c.input(), c.input()
    x, g = c.gate("xor", a, b), c.gate("and", a, b)
    c.output(c.gate("xor", x, cin))
    c.output(c.gate("or", g, c.gate("and", x, cin)))
    return c.schedule()


@pytest.mark.parametrize("circuit", ["full_adder", "mult8"])
@pytest.mark.parametrize("engine", ["ntt", "toeplitz"])
def test_tiny_circuits_on_card_equal_cpu_path(dev, circuit, engine):
    """A scheduled circuit on a TEST_TINY key, single and serving mode
    (B = 3), on the card: bit-equal to the CPU path, exact results, and
    one launch per step of each bootstrapped level for the key's kernels."""
    P = params.TEST_TINY
    g = torch.Generator().manual_seed(7)
    sk = key.SecretKey.generate(g, P)
    ck = key.CloudKey.generate(g, sk, P, engines=(engine,), group=3)
    rng = np.random.default_rng(8)
    if circuit == "full_adder":
        plan, w = _full_adder_plan(), 1
        vals = rng.integers(0, 2, (3, 3))
        bits = vals
    else:
        plan, w = scheduler.parse_bristol(netlists.bristol_multiplier(8)), 8
        vals = rng.integers(0, 256, (2, 3))
        bits = (vals[np.arange(16) // 8] >> (np.arange(16) % 8)[:, None]) & 1
    cts = tlwe.encrypt_bool(g, torch.from_numpy(bits.astype(bool)),
                            P.ksk_alpha, sk.key_lv0)          # [n_in, 3, n0+1]
    cpu = scheduler.evaluate(plan, cts, ck)
    boot_levels = sum(1 for lvl in plan.levels
                      if ((lvl[:, 0] < 100) | (lvl[:, 0] == 104)).any())
    steps = P.n0 if engine == "toeplitz" else ck.bsk_ntt.shape[0]
    counters = (K.ntt_inverse_to_crt_acc, K2.ntt_step_fused, K3.extprod_matmul)
    before = [c.launches for c in counters]
    out = scheduler.evaluate(plan, cts.to(dev), ck.to(dev))
    torch.cuda.synchronize()
    ran = [c.launches - b for c, b in zip(counters, before)]
    want = ([0, 0, steps] if engine == "toeplitz" else [steps, steps, 0])
    assert ran == [n * boot_levels for n in want]
    assert torch.equal(out.cpu(), cpu)
    dec = tlwe.decrypt_bool(out.cpu(), sk.key_lv0).numpy().astype(np.int64)
    if circuit == "full_adder":
        total = vals.sum(0)
        assert np.array_equal(dec, np.stack([total % 2, total // 2]))
    else:
        got = (dec << np.arange(16)[:, None]).sum(0)
        assert np.array_equal(got, vals[0] * vals[1])
    single = scheduler.evaluate(plan, cts[:, 1].to(dev), ck.to(dev))
    assert torch.equal(single.cpu(), cpu[:, 1])


def test_tiny_uint_luts_on_card_equal_cpu_path(dev):
    """TEST_TINY_UINT (group 2, 2-limb digits: every step K2 + K1): a
    bootstrap_lut batch and both tree_pbs select shapes (radix m = 32
    interleaved, m = 64 per-family) on the card equal the CPU path."""
    P = params.TEST_TINY_UINT
    g = torch.Generator().manual_seed(31)
    sk = key.SecretKey.generate(g, P)
    ck = key.CloudKey.generate(g, sk, P)
    steps = ck.bsk_ntt.shape[0]
    ck_dev = key.CloudKey.from_numpy(
        {n: t.numpy() for n, t in ck.named_buffers()}, P,
        bsk_ntt_drop=ck.bsk_ntt_drop, bsk_group=ck.bsk_group,
        bsk_levels=ck.bsk_levels, bsk_bgbit=ck.bsk_bgbit,
        pksk_gadget=ck.pksk_gadget, device=dev)
    msgs = torch.arange(40) % 16
    ct = lut.encrypt_message(g, msgs, 16, 0.0, sk.key_lv0)
    tab = lut.Generator.new(16, P).generate_lookup_table(lambda x: (7 * x + 3) % 16)
    cpu = lut.bootstrap_lut(ct, tab, ck)
    before = (K2.ntt_step_fused.launches, K.ntt_inverse_to_crt_acc.launches)
    out = lut.bootstrap_lut(ct.to(dev), tab, ck_dev)
    torch.cuda.synchronize()
    assert (K2.ntt_step_fused.launches - before[0],
            K.ntt_inverse_to_crt_acc.launches - before[1]) == (steps, steps)
    assert torch.equal(out.cpu(), cpu)
    assert torch.equal(lut.decrypt_message(cpu, 16, sk.key_lv0), (7 * msgs + 3) % 16)
    for m in (32, 64):
        x = torch.arange(12) * 5 % m
        lo, hi = lut.encrypt_radix_message(g, x, m, 0.0, sk.key_lv0)
        f = lambda v, m=m: (3 * v + 1) % m       # noqa: E731
        want = lut.bootstrap_lut_radix(lo, hi, f, m, ck, ck.pksk)
        got = lut.bootstrap_lut_radix(lo.to(dev), hi.to(dev), f, m, ck_dev,
                                      ck_dev.pksk)
        for w, t in zip(want, got):
            assert torch.equal(t.cpu(), w)
        assert torch.equal(lut.decrypt_radix_message(want, m, sk.key_lv0).long(),
                           (3 * x + 1) % m)


def _tiny_uint_keys(dev, seed):
    """TEST_TINY_UINT keys made on the CPU (packing key by default), and
    copies of both on the card."""
    P = params.TEST_TINY_UINT
    g = torch.Generator().manual_seed(seed)
    sk = key.SecretKey.generate(g, P)
    ck = key.CloudKey.generate(g, sk, P)
    sk_dev = key.SecretKey.from_numpy(sk.key_lv0.numpy(), sk.key_lv1.numpy(),
                                      device=dev)
    ck_dev = key.CloudKey.from_numpy(
        {n: t.numpy() for n, t in ck.named_buffers()}, P,
        bsk_ntt_drop=ck.bsk_ntt_drop, bsk_group=ck.bsk_group,
        bsk_levels=ck.bsk_levels, bsk_bgbit=ck.bsk_bgbit,
        pksk_gadget=ck.pksk_gadget, device=dev)
    return g, (sk, sk_dev), ck, ck_dev


# op -> (function, blind rotations at 2 digits)
_INTEGER_OPS = {"add": (integer.radix_add, 2), "mul": (integer.radix_mul, 18),
                "eq": (integer.radix_eq, 2)}


@pytest.mark.parametrize("op", sorted(_INTEGER_OPS))
def test_tiny_uint_integer_ops_on_card_equal_cpu_path(dev, op):
    """radix_add, the tree-PBS radix_mul and radix_eq on 2-digit operands,
    6 lanes: bit-equal to the CPU path, exact, and K2 = K1 = steps x the
    op's blind rotations."""
    g, (sk, _), ck, ck_dev = _tiny_uint_keys(dev, 41)
    fn, rotations = _INTEGER_OPS[op]
    x, y = np.array([45, 5, 63, 0, 17, 17]), np.array([19, 7, 63, 1, 40, 17])
    a = integer.encrypt_radix(g, x, 2, 0.0, sk.key_lv0)
    b = integer.encrypt_radix(g, y, 2, 0.0, sk.key_lv0)
    cpu = fn(a, b, ck)
    steps = ck.bsk_ntt.shape[0]
    before = (K2.ntt_step_fused.launches, K.ntt_inverse_to_crt_acc.launches,
              K3.extprod_matmul.launches)
    out = fn(a.to(dev), b.to(dev), ck_dev)
    torch.cuda.synchronize()
    assert (K2.ntt_step_fused.launches - before[0],
            K.ntt_inverse_to_crt_acc.launches - before[1],
            K3.extprod_matmul.launches - before[2]) == (
        steps * rotations, steps * rotations, 0)
    assert torch.equal(out.cpu(), cpu)
    want = {"add": x + y, "mul": x * y, "eq": (x == y).astype(int)}[op]
    got = integer.decrypt_radix(cpu if cpu.dim() == 3 else cpu[:, None], sk.key_lv0)
    assert np.array_equal(got, want)


def test_tiny_uint_fheuint_chain_on_card(dev):
    """A FheUint operator chain on the card (add, plain and encrypted mul,
    sub, compare, select, divmod by a power of two and by an encrypted
    divisor, bitwise, shifts), exact against plain integers."""
    _, (_, sk), _, ck_dev = _tiny_uint_keys(dev, 43)
    gd = torch.Generator(device=dev).manual_seed(44)
    x, y = np.array([45, 5, 63, 12]), np.array([19, 7, 2, 12])
    a = integer.FheUint.encrypt(gd, x, 2, sk, ck_dev, alpha=0.0)
    b = integer.FheUint.encrypt(gd, y, 2, sk, ck_dev, alpha=0.0)
    assert a.digits.device == ck_dev.ksk1.device
    s = (a + b) * 3 - 5                                  # 3 digits, wraps
    assert np.array_equal(s.decrypt(sk), ((x + y) * 3 - 5) % 512)
    assert np.array_equal((a * b).decrypt(sk), x * y)
    assert np.array_equal((a < b).select(a, b).decrypt(sk), np.minimum(x, y))
    assert np.array_equal((a == b).decrypt(sk), (x == y).astype(int))
    q, r = divmod(a, b)
    assert np.array_equal(q.decrypt(sk), x // y)
    assert np.array_equal(r.decrypt(sk), x % y)
    assert np.array_equal((a // 4).decrypt(sk), x // 4)
    assert np.array_equal(((a ^ b) >> 1).decrypt(sk), (x ^ y) >> 1)
    assert np.array_equal((a << 2).decrypt(sk), x << 2)


@pytest.mark.parametrize("B", [1, 200, 2048])
def test_kernel_split_views_match_plain_and_exact(dev, B):
    """K1 at the split-ring step's shapes (SECURITY_128_BIT_T64: 4 primes,
    N/2 = 1024, drop 32 - 32 = 0): the residues [P, B, 2, 2, 1024] and the
    hi planes [B, 2, 2, 1024] as [P, 2B, 2, 1024] and [2B, 2, 1024]."""
    plan = ntt.plan_for_params(params.SECURITY_128_BIT_T64, 32, 2, (3, 2),
                               bgbit=8, pseudorandom_key=True)
    assert plan.n_primes == 4 and plan.N == 1024
    rng = np.random.default_rng(B + 64)
    c, acc = (torch.from_numpy(rng.integers(-2**31, 2**31, (B, 2, 2, plan.N))
                               .astype(np.int32)).to(dev) for _ in range(2))
    v = torch.stack(ntt.ntt_forward(c, plan, digit_limbs=4, digit_bound=128))
    vv, aa = v.reshape(4, 2 * B, 2, plan.N), acc.reshape(2 * B, 2, plan.N)
    before = K.ntt_inverse_to_crt_acc.launches
    out = K.ntt_inverse_to_crt_acc(vv, aa, plan, 0)
    torch.cuda.synchronize()
    assert K.ntt_inverse_to_crt_acc.launches == before + 1
    assert torch.equal(out, K.ntt_inverse_to_crt_acc_reference(vv, aa, plan, 0))
    assert torch.equal(out.reshape(B, 2, 2, plan.N), acc + c)


# K1's instance that writes the split ring's hi-plane half-rows, on the
# split views at tfhers_2_2's gadget (Bg_e 2^8 (3, 2), offsets with low
# words) and SECURITY_128_BIT_T64's own (3, 2), whose b hi offset differs
@pytest.mark.parametrize("name", ["tfhers_2_2", "128bit_t64"])
@pytest.mark.parametrize("B", [1, 200, 2048])
def test_kernel_writes_half_rows_of_its_output(dev, name, B):
    P = params.PARAMS_BY_NAME[name]
    plan = ntt.plan_for_params(P, 32, 2, (3, 2), bgbit=8,
                               pseudorandom_key=True)
    gadget = decomposition.half_row_gadget(P, 8, (3, 2))
    rng = np.random.default_rng(B + 65)
    c, acc = (torch.from_numpy(rng.integers(-2**31, 2**31, (B, 2, 2, plan.N))
                               .astype(np.int32)).to(dev) for _ in range(2))
    v = K.split_limbs(torch.stack(ntt.ntt_forward(c, plan, digit_limbs=4,
                                                  digit_bound=128)))
    vv, aa = v.reshape(4, 2 * B, 2, 2, plan.N), acc.reshape(2 * B, 2, plan.N)
    digits = torch.from_numpy(rng.integers(-128, 128, (B, 10, plan.N))
                              .astype(np.int8)).to(dev)   # all rewritten
    before = (K.ntt_inverse_to_crt_acc.launches,
              K.ntt_inverse_to_crt_acc.digit_launches)
    out = K.ntt_inverse_to_crt_acc(vv, aa, plan, 0, digits=digits,
                                   gadget=gadget)
    torch.cuda.synchronize()
    assert (K.ntt_inverse_to_crt_acc.launches,
            K.ntt_inverse_to_crt_acc.digit_launches) == (before[0] + 1,
                                                         before[1] + 1)
    assert torch.equal(out, K.ntt_inverse_to_crt_acc(vv, aa, plan, 0))
    assert torch.equal(out.reshape(B, 2, 2, plan.N), acc + c)
    want = torch.empty_like(digits).cpu()
    K.ntt_inverse_to_crt_acc_reference(vv.cpu(), aa.cpu(), plan, 0, want,
                                       gadget)
    assert torch.equal(digits.cpu(), want)
    assert torch.equal(want, decomposition.rows_hi32(
        out.reshape(B, 2, 2, plan.N), P, 8, (3, 2)).to(torch.int8).cpu())


def test_128bit_t64_gates_on_card(dev):
    """Keygen on the card at SECURITY_128_BIT_T64's defaults, 64 lanes:
    exact, 384 K2s and 384 K1 launches and no K2 or K3, the first 4 lanes
    equal to the CPU path."""
    P = params.SECURITY_128_BIT_T64
    g = torch.Generator(device=dev).manual_seed(64)
    sk = key.SecretKey.generate(g, P)
    ck = key.CloudKey.generate(g, sk, P, packing_key=False)
    ids, x, y, want = _lanes(64, 4)
    a = tlwe.encrypt_bool(g, x.to(dev), P.ksk_alpha, sk.key_lv0, width=64)
    b = tlwe.encrypt_bool(g, y.to(dev), P.ksk_alpha, sk.key_lv0, width=64)
    counters = (K.ntt_inverse_to_crt_acc, K2.ntt_step_fused,
                K3.extprod_matmul, K2S.split_step_fused)
    before = [c.launches for c in counters]
    out = gates.apply_gates(ids.to(dev), a, b, ck)
    torch.cuda.synchronize()
    assert tuple(c.launches - n for c, n in zip(counters, before)) == (
        384, 0, 0, 384)
    assert out.dtype == torch.int64
    assert np.array_equal(tlwe.decrypt_bool(out, sk.key_lv0).cpu().numpy(), want)
    ck_cpu = key.CloudKey.from_numpy(
        {n: t.cpu().numpy() for n, t in ck.named_buffers()}, P,
        bsk_ntt_drop=ck.bsk_ntt_drop, bsk_group=ck.bsk_group,
        bsk_levels=ck.bsk_levels, bsk_bgbit=ck.bsk_bgbit, device="cpu")
    cpu = gates.apply_gates(ids[:4], a[:4].cpu(), b[:4].cpu(), ck_cpu)
    assert torch.equal(out[:4].cpu(), cpu)


def test_tfhers_2_2_gates_on_card(dev):
    """Keygen on the card at SECURITY_TFHERS_2_2's default key form (group
    2, Bg_e 2^8 with (3, 2) levels, drop 32, four primes), 64 lanes: every
    lane decrypts to its truth table, 371 K2s and 371 K1 launches, 370 of
    them writing the next step's half-rows, and no K2 or K3 (the hi-plane
    scan with the offsets' low words carried in), the first 4 lanes equal
    to the CPU path; the scan alone (span ``blind_rotate.steps``) makes no
    synchronising CUDA operation and reads ``fused_steps`` 370 and
    ``plain_digit_steps`` 1."""
    from zig_tfhe_tpu_torch.utils import profiling

    P = params.SECURITY_TFHERS_2_2
    g = torch.Generator(device=dev).manual_seed(742)
    sk = key.SecretKey.generate(g, P)
    ck = key.CloudKey.generate(g, sk, P, packing_key=False)
    assert (ck.bsk_group, ck.bsk_bgbit, ck.bsk_levels, ck.bsk_ntt_drop,
            ck.bsk_ntt.shape[:3]) == (2, 8, (3, 2), 32, (371, 3, 4))
    ids, x, y, want = _lanes(64, 5)
    a = tlwe.encrypt_bool(g, x.to(dev), P.ksk_alpha, sk.key_lv0, width=64)
    b = tlwe.encrypt_bool(g, y.to(dev), P.ksk_alpha, sk.key_lv0, width=64)
    counters = (K.ntt_inverse_to_crt_acc, K2.ntt_step_fused,
                K3.extprod_matmul, K2S.split_step_fused)
    before = [c.launches for c in counters]
    digit_launches = K.ntt_inverse_to_crt_acc.digit_launches
    out = gates.apply_gates(ids.to(dev), a, b, ck)
    torch.cuda.synchronize()
    assert tuple(c.launches - n for c, n in zip(counters, before)) == (
        371, 0, 0, 371)
    assert K.ntt_inverse_to_crt_acc.digit_launches - digit_launches == 370
    # the scan alone: its span is then the outermost, which counts syncs
    with profiling.recording():
        profiling.clear()
        split_ring.blind_rotate_split(a, ck.testvec, ck.bsk_ntt, P, 32,
                                      group=2, levels=(3, 2), bgbit=8)
        steps = [sp for sp in profiling.spans()
                 if sp.name == "blind_rotate.steps"]
        profiling.clear()
    assert len(steps) == 1 and steps[0].attrs == {
        "steps": 371, "fused_steps": 370, "plain_digit_steps": 1}
    assert steps[0].syncs == 0
    assert out.dtype == torch.int64
    assert np.array_equal(tlwe.decrypt_bool(out, sk.key_lv0).cpu().numpy(), want)
    ck_cpu = key.CloudKey.from_numpy(
        {n: t.cpu().numpy() for n, t in ck.named_buffers()}, P,
        bsk_ntt_drop=ck.bsk_ntt_drop, bsk_group=ck.bsk_group,
        bsk_levels=ck.bsk_levels, bsk_bgbit=ck.bsk_bgbit, device="cpu")
    cpu = gates.apply_gates(ids[:4], a[:4].cpu(), b[:4].cpu(), ck_cpu)
    assert torch.equal(out[:4].cpu(), cpu)


def _cut_n0(P, n0):
    import dataclasses

    return dataclasses.replace(P, tlwe_lv0=dataclasses.replace(P.tlwe_lv0,
                                                               n=n0))


@pytest.fixture(scope="module")
def split_step_keys():
    """One step of a real split key per set, made on the card:
    SECURITY_128_BIT_T64 (n0 cut to 2: one group, 10 half-rows) and
    TEST_TINY_SPLIT (8 half-rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    out = {}
    for name, P in (("t64", _cut_n0(params.SECURITY_128_BIT_T64, 2)),
                    ("tiny_split", params.TEST_TINY_SPLIT)):
        g = torch.Generator(device=dev).manual_seed(len(name))
        sk = key.SecretKey.generate(g, P)
        ck = key.CloudKey.generate(g, sk, P, packing_key=False)
        plan = ntt.plan_for_params(P, 32, 2, ck.bsk_levels, bgbit=8,
                                   pseudorandom_key=True)
        out[name] = (P, plan, ck.bsk_levels, ck.bsk_ntt[0])
    return out


def _split_step_inputs(keys, name, B, seed):
    P, plan, levels, bsk = keys[name]
    rng = np.random.default_rng(seed)
    acc = torch.from_numpy(rng.integers(-2**31, 2**31, (B, 2, 2, plan.N))
                           .astype(np.int32)).to(bsk.device)
    digits = decomposition.rows_hi32(acc, P, 8, levels).to(torch.int8)
    ts = torch.from_numpy(rng.integers(0, 4 * plan.N, (2, B))
                          .astype(np.int32)).to(bsk.device)
    return plan, acc, digits, bsk, ts


# t64: 6 lanes a tile (B = 7 and 2049 end inside one), 32 wide tiles at B =
# 1 take the narrow tile; tiny_split: 8 lanes a tile; t64_rl6: the key's
# first 6 half-rows, which the instance that reads 2R at run time takes
@pytest.mark.parametrize("name, B", [("t64", 1), ("t64", 7), ("t64", 200),
                                     ("t64", 2048), ("t64", 2049),
                                     ("tiny_split", 1), ("tiny_split", 33),
                                     ("t64_rl6", 2049)])
def test_split_step_kernel_matches_plain(split_step_keys, name, B):
    key, rows = ("t64", 6) if name == "t64_rl6" else (name, None)
    plan, acc, digits, bsk, ts = _split_step_inputs(split_step_keys, key, B, B)
    if rows:
        digits, bsk = digits[:, :rows].contiguous(), bsk[:, :, :rows].contiguous()
    before = K2S.split_step_fused.launches
    out = K2S.split_step_fused(digits, bsk, ts, plan, 8)
    torch.cuda.synchronize()
    assert K2S.split_step_fused.launches == before + 1
    assert out.dtype == torch.int8
    assert tuple(out.shape) == (plan.n_primes, B, 2, 2, 2, plan.N)
    assert torch.equal(out, K2S.split_step_fused_reference(digits, bsk, ts,
                                                           plan, 8))
    # K1 takes the limb planes as they stand: the hi-plane step's finish
    fin = K.ntt_inverse_to_crt_acc(out.reshape(plan.n_primes, 2 * B, 2, 2,
                                               plan.N),
                                   acc.reshape(2 * B, 2, plan.N), plan, 0)
    want = K.ntt_inverse_to_crt_acc_reference(
        K.join_limbs(out).reshape(plan.n_primes, 2 * B, 2, plan.N),
        acc.reshape(2 * B, 2, plan.N), plan, 0)
    assert torch.equal(fin, want)


@pytest.mark.parametrize("p", (18433, 40961, 59393, 61441))
def test_split_barrett_exhaustive_on_card(dev, p):
    """K2s's Barrett (the rounding by an f32 add, off the conversion pipe)
    equals the plain version's __float2int_rn form on all 2^32 int32, for
    each prime of the SECURITY_128_BIT_T64 plan, run by the kernel's own
    device function; the check refuses a prime below ``MIN_PRIME``, where
    the rounding is not exact, and a CPU device."""
    plan = ntt.plan_for_params(params.SECURITY_128_BIT_T64, 32, 2, (3, 2),
                               bgbit=8, pseudorandom_key=True)
    assert p in plan.primes
    assert K2S.barrett_mismatches(p, dev) == 0
    with pytest.raises(ValueError, match="not exact"):
        K2S.barrett_mismatches(K2S.MIN_PRIME - 1, dev, 0, 16)
    with pytest.raises(ValueError, match="CUDA device"):
        K2S.barrett_mismatches(p, "cpu", 0, 16)


@pytest.mark.parametrize("p", (12289, 18433, 40961, 59393, 61441))
def test_step_barrett_exhaustive_on_card(dev, p):
    """K2's shape instances' Barrett (the rounding by an f32 add) equals
    the general instance's __float2int_rn form on all 2^32 int32, for each
    prime of g3's and uint4's plans, run by the kernel's own device
    functions; the check refuses a prime below ``MIN_PRIME`` and a CPU
    device."""
    plan = ntt.plan_for_params(params.SECURITY_128_BIT, 5, 3, (2, 2), bgbit=7,
                               pseudorandom_key=True)
    uplan = ntt.plan_for_params(params.SECURITY_UINT4, 0, 2, (1, 1), bgbit=22,
                                pseudorandom_key=True)
    assert p in plan.primes + uplan.primes
    assert K2.barrett_mismatches(p, dev) == 0
    with pytest.raises(ValueError, match="not exact"):
        K2.barrett_mismatches(K2.MIN_PRIME - 1, dev, 0, 16)
    with pytest.raises(ValueError, match="CUDA device"):
        K2.barrett_mismatches(p, "cpu", 0, 16)


def test_split_step_kernel_rejects_what_it_cannot_take(split_step_keys):
    plan, acc, digits, bsk, ts = _split_step_inputs(split_step_keys, "t64", 4, 0)
    with pytest.raises(ValueError, match="shapes"):
        K2S.split_step_fused(digits[:, :8], bsk, ts, plan, 8)
    with pytest.raises(ValueError, match="same CUDA device"):
        K2S.split_step_fused(digits, bsk.cpu(), ts, plan, 8)
    with pytest.raises(NotImplementedError, match="group 2"):
        K2S.split_step_fused(digits, bsk[:1], ts[:1], plan, 8)
    with pytest.raises(NotImplementedError, match="one-limb"):
        K2S.split_step_fused(digits, bsk, ts, plan, 11)
    small = dataclasses.replace(plan, primes=(K2S.MIN_PRIME - 1,) + plan.primes[1:])
    with pytest.raises(ValueError, match=f"all >= {K2S.MIN_PRIME}"):
        K2S.split_step_fused(digits, bsk, ts, small, 8)


def test_int64_finish_raises_on_card(dev):
    """The int64 finish (K1's int64 variant, no kernel) runs its plain
    version on the card: the direct 64-bit engine (TEST_TINY64) gives
    gates bit-equal to the CPU path, and finish_int64 on CUDA tensors
    equals it on CPU tensors."""
    P = params.TEST_TINY64
    g = torch.Generator().manual_seed(3)
    sk = key.SecretKey.generate(g, P)
    ck = key.CloudKey.generate(g, sk, P, packing_key=False)
    x = torch.tensor([True, False, True, False, True, True, False, False])
    y = torch.tensor([True, True, False, False, True, False, True, False])
    a = tlwe.encrypt_bool(g, x, 0.0, sk.key_lv0, width=64)
    b = tlwe.encrypt_bool(g, y, 0.0, sk.key_lv0, width=64)
    ids = torch.arange(8) % 10
    cpu = gates.apply_gates(ids, a, b, ck)
    ck.to(dev)                                  # moves the module in place
    out = gates.apply_gates(ids.to(dev), a.to(dev), b.to(dev), ck)
    assert out.dtype == torch.int64 and torch.equal(out.cpu(), cpu)
    assert tlwe.decrypt_bool(out.cpu(), sk.key_lv0).tolist() == [
        _TRUTH[gates.GATE_NAMES[i]](bool(p), bool(q))
        for i, p, q in zip(ids.tolist(), x.tolist(), y.tolist())]
    plan = ntt.plan_for_params(P, 0, 2, (2, 2), bgbit=6, pseudorandom_key=True)
    rng = np.random.default_rng(10)
    c = torch.from_numpy(rng.integers(-2**40, 2**40, (3, 2, plan.N)))
    acc = torch.from_numpy(rng.integers(-2**62, 2**62, (3, 2, plan.N)))
    v = ntt.ntt_forward(c, plan, digit_limbs=8, digit_bound=128)
    want = ntt.finish_int64(v, acc, plan, 3)
    assert torch.equal(want, acc + (c << 3))
    got = ntt.finish_int64([t.to(dev) for t in v], acc.to(dev), plan, 3)
    assert torch.equal(got.cpu(), want)


def test_threefry_on_card_equals_cpu(dev):
    from zig_tfhe_tpu_torch.utils import threefry

    kd = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
    for shape in ((7,), (2048, 701)):
        assert torch.equal(threefry.random_bits32(kd, shape, dev).cpu(),
                           threefry.random_bits32(kd, shape))
    g = torch.Generator(device=dev).manual_seed(5)
    sk = key.SecretKey.generate(g, params.SECURITY_128_BIT)
    seed, b = tlwe.encrypt_bool_seeded(g, torch.ones(64, dtype=torch.bool,
                                                     device=dev),
                                       params.SECURITY_128_BIT.ksk_alpha,
                                       sk.key_lv0)
    ct = tlwe.expand_seeded(seed, b, params.SECURITY_128_BIT.n0)
    assert ct.device.type == dev.type
    assert torch.equal(ct.cpu(), tlwe.expand_seeded(seed, b.cpu(),
                                                    params.SECURITY_128_BIT.n0))
    assert bool(tlwe.decrypt_bool(ct, sk.key_lv0).all())


def test_reencrypt_on_card_equals_cpu(dev):
    """The subset sum (public-key encryption, the asymmetric key) and the
    re-encryption key switch on the card against the same draws on the
    CPU, at SECURITY_128_BIT."""
    P = params.SECURITY_128_BIT
    g = torch.Generator(device=dev).manual_seed(6)
    alice = key.SecretKey.generate(g, P)
    bob = key.SecretKey.generate(g, P)
    pk = proxy_reenc.PublicKeyLv0.generate(g, bob.key_lv0, P)
    shape = (P.n0, P.iks_t)
    signs = proxy_reenc.draw_signs(g, (*shape, pk.encryptions.shape[0]))
    noise = torch.zeros(shape, dtype=torch.int32, device=dev)
    rk = proxy_reenc.asym_key_core(alice.key_lv0, pk.encryptions, signs,
                                   noise, P.basebit, P.iks_t)
    rk_cpu = proxy_reenc.asym_key_core(alice.key_lv0.cpu(),
                                       pk.encryptions.cpu(), signs.cpu(),
                                       noise.cpu(), P.basebit, P.iks_t)
    assert torch.equal(rk.cpu(), rk_cpu)
    rkey = proxy_reenc.ProxyReencryptionKey(rk, P.basebit, P.iks_t)
    bits = torch.rand(256, generator=g, device=dev) < 0.5
    ct = tlwe.encrypt_bool(g, bits, P.tlwe_lv0.alpha, alice.key_lv0)
    out = proxy_reenc.reencrypt(ct, rkey)
    cpu = proxy_reenc.reencrypt(
        ct.cpu(), proxy_reenc.ProxyReencryptionKey(rk_cpu, P.basebit, P.iks_t))
    assert torch.equal(out.cpu(), cpu)
    assert (tlwe.decrypt_bool(out, bob.key_lv0) == bits).float().mean() > 0.9


def test_nccl_one_rank_gates_equal_apply_gates(dev):
    import socket

    import torch.distributed as dist

    from zig_tfhe_tpu_torch.parallel import distributed as D
    from zig_tfhe_tpu_torch.parallel import mesh as M

    P = params.TEST_TINY
    g = torch.Generator(device=dev).manual_seed(7)
    sk = key.SecretKey.generate(g, P)
    ck = key.CloudKey.generate(g, sk, P)
    ids = torch.arange(16, device=dev) % 10
    a = tlwe.encrypt_bool(g, torch.rand(16, generator=g, device=dev) < 0.5,
                          0.0, sk.key_lv0)
    b = tlwe.encrypt_bool(g, torch.rand(16, generator=g, device=dev) < 0.5,
                          0.0, sk.key_lv0)
    want = gates.apply_gates(ids, a, b, ck)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    D.initialize(f"localhost:{port}", 1, 0)
    try:
        mesh = M.make_mesh()
        assert mesh.shape == (1, 1) and mesh.device.type == "cuda"
        run = D.distributed_gates(mesh, D.replicate_global(mesh, ck))
        out = run(*(D.global_batch(mesh, x) for x in (ids, a, b)))
        assert torch.equal(out, want)
        assert torch.equal(M.shard_map_gates(mesh, ck)(ids, a, b), want)
    finally:
        dist.destroy_process_group()
