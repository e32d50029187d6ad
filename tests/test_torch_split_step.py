"""K2s's wrapper (ops/cuda/split_step.py) on the CPU: the split-ring step
core of the 64-bit torus (forward NTT, pointwise sums, Y-twisted combine;
csrc/split_step.cu on the card).

Held bit-equal: ``split_step_fused_reference`` to the prime-batched chain
``forward`` -> ``pointwise`` -> ``rotate_combine_multi_split`` ->
``split_limbs`` written out; that chain finished by K1's wrapper (the
hi-plane step of ``blind_rotate_split``) to the JAX package's hi-plane step
(``rows_hi32``, ``ntt_forward``, ``pointwise_extprod``,
``rotate_combine_multi_split``, ``acc + ntt_inverse_to_crt(v, plan, 32)``)
on TEST_TINY_SPLIT and on two consecutive SECURITY_128_BIT_T64 steps at B
<= 3, whose residues are congruent to the JAX package's mod p.  Inputs are
made with numpy from a seed: hi-plane accumulators, rotations, and key
residues folded from uniform int64 rows by the JAX package (in range, as a
real key's).  The wrapper's CPU path counts no launch; its refusals
(groups 1 and 3, multi-limb digits, dtypes, shapes, mixed devices); the
scan's route: every step of a group-2 hi-plane key goes through the
wrapper, a group-1 key's through none, and the port's entry points still
default to the card.  The kernel's own source is held to the same plain
version in tests/test_torch_kernel_emulation.py and on the card in
tests/test_torch_cuda.py.  Tolerance: exact equality.
"""

import dataclasses
import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zig_tfhe_tpu import params as JP
from zig_tfhe_tpu.ops import ntt as jntt
from zig_tfhe_tpu.ops import split_ring as JSR
from zig_tfhe_tpu_torch import key as TK
from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch.ops import decomposition as TD
from zig_tfhe_tpu_torch.ops import ntt as tntt
from zig_tfhe_tpu_torch.ops import split_ring as TSR
from zig_tfhe_tpu_torch.ops.cuda import ntt_inverse as K1
from zig_tfhe_tpu_torch.ops.cuda import split_step as K2S


def _t(a):
    return torch.from_numpy(np.array(a))


def _cut(P, n0):
    return dataclasses.replace(P, tlwe_lv0=dataclasses.replace(P.tlwe_lv0,
                                                               n=n0))


# name -> (JAX params, port params, levels); n0 cut to 4: two key groups
_SETS = {"tiny_split": (JP.TEST_TINY_SPLIT, TP.TEST_TINY_SPLIT, (2, 2)),
         "t64": (_cut(JP.SECURITY_128_BIT_T64, 4),
                 _cut(TP.SECURITY_128_BIT_T64, 4), (3, 2))}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup(name, B, seed):
    """Both plans, a folded split key of two groups [2, 3, P, 2R, 4, Nh]
    (JAX's fold of the split residues of uniform int64 rows), hi-plane
    accumulators [B, 2, 2, Nh] and rotations [2 groups, 2, B]."""
    jp, tp, levels = _SETS[name]
    kw = dict(bgbit=8, pseudorandom_key=True)
    jplan = jntt.plan_for_params(jp, 32, 2, levels, **kw)
    tplan = tntt.plan_for_params(tp, 32, 2, levels, **kw)
    assert tplan.primes == jplan.primes and tplan.n_primes == 4
    rng = np.random.default_rng(seed)
    R = sum(levels)
    rows = rng.integers(-2**63, 2**63 - 1, (2, 3, R, 2, tp.N), dtype=np.int64,
                        endpoint=True)
    halves = JSR.split(jnp.asarray(rows))
    res = [jntt.to_ntt_form(halves[..., q, :], jplan, 32, width=64)
           for q in range(2)]
    bsk = np.asarray(JSR.fold_key_split(res[0], res[1], jplan))
    assert bsk.shape == (2, 3, 4, 2 * R, 4, tplan.N)
    acc = rng.integers(-2**31, 2**31, (B, 2, 2, tplan.N)).astype(np.int32)
    ts = rng.integers(0, 4 * tplan.N, (2, 2, B)).astype(np.int32)
    return jp, tp, levels, jplan, tplan, bsk, acc, ts


def _jax_step(jp, jplan, levels, acc, bsk_g, ts):
    """The JAX package's hi-plane step (split_ring.py step_multi with
    hi32, drop 32): its residues v and the next accumulator."""
    rows = JSR._rows_hi32(jnp.asarray(acc), jp, 8, levels)
    d_hat = jntt.ntt_forward(rows, jplan, 1, jntt.top_limb_bound(128, 1))
    us = [jntt.pointwise_extprod(d_hat, jnp.asarray(bsk_g[m]), jplan)
          for m in range(3)]
    v = JSR.rotate_combine_multi_split(us, [jnp.asarray(t) for t in ts], jplan)
    return v, np.asarray(jnp.asarray(acc) + jntt.ntt_inverse_to_crt(v, jplan, 32))


def _port_step(tp, tplan, levels, acc, bsk_g, ts):
    """The port's hi-plane step as ``blind_rotate_split`` runs it: the
    decompose, the wrapper (its plain version on CPU tensors), K1's
    wrapper on the limb-plane views."""
    B, Nh = acc.shape[0], tplan.N
    rows = TD.rows_hi32(_t(acc), tp, 8, levels).to(torch.int8)
    v8 = K2S.split_step_fused(rows, _t(bsk_g), _t(ts), tplan, 8)
    out = K1.ntt_inverse_to_crt_acc(
        v8.reshape(tplan.n_primes, 2 * B, 2, 2, Nh),
        _t(acc).reshape(2 * B, 2, Nh), tplan, 0)
    return v8, out.reshape(B, 2, 2, Nh).numpy()


@pytest.mark.parametrize("name, B", [("tiny_split", 3), ("t64", 3),
                                     ("t64", 1)])
def test_reference_is_the_plain_chain(name, B):
    jp, tp, levels, jplan, tplan, bsk, acc, ts = _setup(name, B, 1)
    rows = TD.rows_hi32(_t(acc), tp, 8, levels)
    d_hat = TSR.forward(rows, tplan)
    us = [TSR.pointwise(d_hat, _t(bsk[0, m]), tplan) for m in range(3)]
    v = TSR.rotate_combine_multi_split(us, [_t(ts[0, 0]), _t(ts[0, 1])], tplan)
    got = K2S.split_step_fused_reference(rows.to(torch.int8), _t(bsk[0]),
                                         _t(ts[0]), tplan, 8)
    assert got.dtype == torch.int8
    assert tuple(got.shape) == (4, B, 2, 2, 2, tplan.N)
    assert torch.equal(got, K1.split_limbs(v))
    assert torch.equal(K1.join_limbs(got), v)


@pytest.mark.parametrize("name, B", [("tiny_split", 3), ("t64", 2)])
def test_step_equals_jax_step(name, B):
    """Two consecutive hi-plane steps (the key's two groups): the port's
    accumulator equals the JAX package's after each, and the residues are
    congruent to JAX's mod p."""
    jp, tp, levels, jplan, tplan, bsk, acc, ts = _setup(name, B, 2)
    acc_j = acc_t = acc
    for s in range(2):
        v_j, acc_j = _jax_step(jp, jplan, levels, acc_j, bsk[s], ts[s])
        v8, acc_t = _port_step(tp, tplan, levels, acc_t, bsk[s], ts[s])
        assert np.array_equal(acc_t, acc_j)
        v = K1.join_limbs(v8).numpy().astype(np.int64)
        for i, p in enumerate(tplan.primes):
            assert not ((v[i] - np.asarray(v_j[i], np.int64)) % p).any()


def test_wrapper_cpu_path_counts_no_launch():
    jp, tp, levels, jplan, tplan, bsk, acc, ts = _setup("t64", 1, 1)
    rows = TD.rows_hi32(_t(acc), tp, 8, levels).to(torch.int8)
    args = (rows, _t(bsk[0]), _t(ts[0]), tplan, 8)
    before = K2S.split_step_fused.launches
    assert torch.equal(K2S.split_step_fused(*args),
                       K2S.split_step_fused_reference(*args))
    assert K2S.split_step_fused.launches == before


def test_wrapper_refuses_what_it_cannot_take():
    jp, tp, levels, jplan, tplan, bsk, acc, ts = _setup("t64", 1, 1)
    d = TD.rows_hi32(_t(acc), tp, 8, levels).to(torch.int8)
    k, t = _t(bsk[0]), _t(ts[0])
    with pytest.raises(NotImplementedError, match="group 2"):     # group 1
        K2S.split_step_fused(d, k[:1], t[:1], tplan, 8)
    with pytest.raises(NotImplementedError, match="group 2"):     # group 3
        K2S.split_step_fused(d, torch.cat([k, k, k[:1]]),
                             torch.cat([t, t[:1]]), tplan, 8)
    with pytest.raises(NotImplementedError, match="one-limb"):    # 2 limbs
        K2S.split_step_fused(d, k, t, tplan, 11)
    with pytest.raises(NotImplementedError, match="int8"):        # int32 rows
        K2S.split_step_fused(d.int(), k, t, tplan, 8)
    with pytest.raises(NotImplementedError, match="int8"):
        K2S.split_step_fused(d, k.int(), t, tplan, 8)
    with pytest.raises(ValueError, match="shapes"):
        K2S.split_step_fused(d[:, :8], k, t, tplan, 8)
    with pytest.raises(ValueError, match="shapes"):
        K2S.split_step_fused(d, k, torch.cat([t, t], 1), tplan, 8)
    with pytest.raises(ValueError, match="same CUDA device"):
        K2S.split_step_fused(d.to("meta"), k, t, tplan, 8)
    assert K2S.supports(2, 1, True)
    assert not any((K2S.supports(1, 1, True), K2S.supports(3, 1, True),
                    K2S.supports(2, 2, True), K2S.supports(2, 1, False)))


@pytest.mark.parametrize("group, calls", [(2, 4), (1, 0)])
def test_scan_routes_through_the_wrapper(monkeypatch, group, calls):
    """``blind_rotate_split`` on a port-made TEST_TINY_SPLIT key: every
    step of the group-2 hi-plane scan is one call of K2s's wrapper (the
    launch on the card, its plain version here), the group-1 scan makes
    none; the entry points that make split keys default to the card."""
    seen = []
    wrapped = K2S.split_step_fused

    def count(digits, *args):
        seen.append(digits.device.type)
        return wrapped(digits, *args)

    monkeypatch.setattr(K2S, "split_step_fused", count)
    g = torch.Generator().manual_seed(9)
    P = TP.TEST_TINY_SPLIT
    sk = TK.SecretKey.generate(g, P)
    ck = TK.CloudKey.generate(g, sk, P, group=group, packing_key=False)
    ct = torch.from_numpy(np.random.default_rng(9).integers(
        -2**63, 2**63 - 1, (2, P.n0 + 1), dtype=np.int64, endpoint=True))
    out = TSR.blind_rotate_split(ct, ck.testvec, ck.bsk_ntt, P, 32,
                                 group=group, levels=(2, 2), bgbit=8)
    assert out.dtype == torch.int64 and tuple(out.shape) == (2, 2, P.N)
    assert seen == ["cpu"] * calls
    for fn in (TK.CloudKey.from_numpy, TK.CloudKey.generate_no_ksk):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
