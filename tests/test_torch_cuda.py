"""Tests of the port that need an NVIDIA CUDA card (marker ``cuda``).

Each test skips without a card.  The file imports no jax, so it also runs
where jax is not installed, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The hand-written kernels are held bit-equal to their plain PyTorch versions
(K1 also to the closed-form exact result) at the paths' shapes; the gate
paths on the card (the NTT engine's and the Toeplitz engine's) are held
bit-equal to the port's CPU path, which the other tests/test_torch_*.py
files hold bit-equal to the JAX package.
"""

import numpy as np
import pytest
import torch

from zig_tfhe_tpu_torch import key, params, tlwe, trgsw
from zig_tfhe_tpu_torch.models import gates
from zig_tfhe_tpu_torch.ops import ntt
from zig_tfhe_tpu_torch.ops.cuda import extprod as K3
from zig_tfhe_tpu_torch.ops.cuda import ntt_inverse as K
from zig_tfhe_tpu_torch.ops.cuda import ntt_step as K2

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
# (16 lanes a tile at R = 4, 12 at R = 5)
@pytest.mark.parametrize("case", sorted(_STEP_CASES))
@pytest.mark.parametrize("B", [1, 33, 64, 200, 2048, 2049])
def test_step_kernel_matches_plain(dev, case, B):
    plan, bgbit, digits, bsk, ts = _step_inputs(dev, case, B, B)
    before = K2.ntt_step_fused.launches
    out = K2.ntt_step_fused(digits, bsk, ts, plan, bgbit)
    torch.cuda.synchronize()
    assert K2.ntt_step_fused.launches == before + 1
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
    with pytest.raises(NotImplementedError, match="one-limb"):
        K2.ntt_step_fused(digits, bsk, ts, plan, 10)


@pytest.mark.parametrize("knobs, steps", [({}, 234),
                                          ({"group": 2, "decomp_levels": (3, 2)}, 350)])
def test_128bit_launches_per_bootstrap(dev, knobs, steps):
    """Each step of a 128-bit bootstrap is one K2 and one K1 launch: 234
    steps at the group-3 default, 350 with the group-2 (3, 2) key."""
    P = params.SECURITY_128_BIT
    g = torch.Generator(device=dev).manual_seed(3)
    sk = key.SecretKey.generate(g, P)
    ck = key.CloudKey.generate(g, sk, P, **knobs)
    ids, x, y, want = _lanes(20, 2)
    a = tlwe.encrypt_bool(g, x.to(dev), P.ksk_alpha, sk.key_lv0)
    b = tlwe.encrypt_bool(g, y.to(dev), P.ksk_alpha, sk.key_lv0)
    before = (K2.ntt_step_fused.launches, K.ntt_inverse_to_crt_acc.launches)
    out = gates.apply_gates(ids.to(dev), a, b, ck)
    torch.cuda.synchronize()
    assert (K2.ntt_step_fused.launches - before[0],
            K.ntt_inverse_to_crt_acc.launches - before[1]) == (steps, steps)
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
