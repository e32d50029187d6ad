"""Tests of the port that need an NVIDIA CUDA card (marker ``cuda``).

Each test skips without a card.  The file imports no jax, so it also runs
where jax is not installed, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The hand-written kernel is held bit-equal to its plain PyTorch version and
to the closed-form exact result at the slice's shapes; the gate path on the
card is held bit-equal to the port's CPU path, which the other
tests/test_torch_*.py files hold bit-equal to the JAX package.
"""

import numpy as np
import pytest
import torch

from zig_tfhe_tpu_torch import key, params, tlwe
from zig_tfhe_tpu_torch.models import gates
from zig_tfhe_tpu_torch.ops import ntt
from zig_tfhe_tpu_torch.ops.cuda import ntt_inverse as K

pytestmark = pytest.mark.cuda

# (params, drop, group, levels, engine bgbit)
_CASES = {"tiny": (params.TEST_TINY, 0, 3, (2, 2), 6),
          "128bit": (params.SECURITY_128_BIT, 5, 3, (2, 2), 7)}

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


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("B", [1, 8, 200, 2048])
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
    out = gates.apply_gates(ids.to(dev), a.to(dev), b.to(dev), ck)
    torch.cuda.synchronize()
    assert K.ntt_inverse_to_crt_acc.launches - before == steps
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
        bsk_levels=ck.bsk_levels, bsk_bgbit=ck.bsk_bgbit)
    cpu = gates.apply_gates(ids[:4], a[:4].cpu(), b[:4].cpu(), ck_cpu)
    assert torch.equal(out[:4].cpu(), cpu)
