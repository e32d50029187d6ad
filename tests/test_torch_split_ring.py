"""The port's split-ring engine (ops/split_ring.py) against the JAX
package's, bit for bit, on TEST_TINY_SPLIT (N = 2048 on the 64-bit torus,
n0 = 8, the key defaults: group 2, Bg_e 2^8 with (2, 2) levels, drop 32,
the four-prime N/2 = 1024 plan) and on a few SECURITY_128_BIT_T64 steps.

Inputs come from one numpy seed (in-range residues: NTTs of bounded or
uniform torus rows) and go to both packages; JAX-made TEST_TINY_SPLIT keys
(group 2 and group 1) go to the port through ``CloudKey.from_numpy``.
Held bit-equal to JAX: ``split`` / ``unsplit``, ``fold_key_split``,
``rotate_minus1_split``, ``rotate_combine_multi_split`` (g = 1, 2, 3),
``rows_hi32``, ``hi32_viable`` over a grid of configurations, and
``blind_rotate_split`` at groups 1 and 2 on an arbitrary int64 testvec
and on the gate testvec (the port's one start, the int64 rotation, against
the JAX package's full start and its ``tv_lo_zero`` hi-plane start).  The
port against itself: the hi-plane scan equals the generic int64 scan, and
K1's plain version on the split views ([P, 2B, 2, Nh], rows (b, c)) equals
the JAX package's ``ntt_inverse_to_crt(v, plan, 32)`` finish of a real
step.  At SECURITY_128_BIT_T64, n0 cut to 2g + 1 = 5 (two full steps and a
ragged one, as test_torch_blind_rotate.py's 128-bit step test builds them)
with the key residues of uniform int64 rows: the port's scan equals JAX's
from both of its starts.  Tolerance: exact equality.
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
from zig_tfhe_tpu.ops import split_ring as JSR
from zig_tfhe_tpu_torch import key as TK
from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch.ops import blind_rotate_ntt as BRN
from zig_tfhe_tpu_torch.ops import decomposition as TD
from zig_tfhe_tpu_torch.ops import ntt as tntt
from zig_tfhe_tpu_torch.ops import split_ring as TSR
from zig_tfhe_tpu_torch.ops.cuda import ntt_inverse as K1

JPAR, TPAR = JP.TEST_TINY_SPLIT, TP.TEST_TINY_SPLIT


def _t(a):
    return torch.from_numpy(np.array(a))


def _full64(rng, shape):
    return rng.integers(-2**63, 2**63 - 1, shape, dtype=np.int64,
                        endpoint=True)


def _plans(params=(JPAR, TPAR), levels=(2, 2)):
    kw = dict(bgbit=8, pseudorandom_key=True)
    return (jntt.plan_for_params(params[0], 32, 2, levels, **kw),
            tntt.plan_for_params(params[1], 32, 2, levels, **kw))


def _residues(rng, plan, shape):
    """In-range per-prime residues of NTTs of bounded polys (|.| <= 2^40)."""
    x = rng.integers(-2**40, 2**40, shape + (plan.N,))
    return [np.asarray(r) for r in jntt.ntt_forward(jnp.asarray(x), plan, 8,
                                                    128)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def keys():
    """JAX TEST_TINY_SPLIT keys: the default (group 2, packing key) and a
    group-1 key without a packing key; each with its port copy."""
    sk = JK.SecretKey.generate(jax.random.key(71), JPAR)
    out = {}
    for group, seed in ((2, 72), (1, 73)):
        ck = JK.CloudKey.generate(jax.random.key(seed), sk, JPAR, group=group,
                                  packing_key=False)
        assert ck.bsk_ntt_drop == 32 and ck.bsk_levels == (2, 2)
        arrays = {n: np.asarray(getattr(ck, n))
                  for n in ("testvec", "ksk1", "bsk_ntt")}
        out[group] = (ck, TK.CloudKey.from_numpy(
            arrays, TPAR, bsk_ntt_drop=32, bsk_group=group, bsk_levels=(2, 2),
            bsk_bgbit=8, device="cpu"))
    return sk, out


def test_split_unsplit():
    x = _full64(np.random.default_rng(0), (3, 2, TPAR.N))
    s = TSR.split(_t(x))
    assert np.array_equal(s.numpy(), np.asarray(JSR.split(jnp.asarray(x))))
    assert s.shape == (3, 2, 2, TPAR.N // 2)
    assert np.array_equal(TSR.unsplit(s).numpy(), x)


def test_fold_key_split():
    jplan, tplan = _plans()
    rng = np.random.default_rng(1)
    halves = [np.stack([_center(rng.integers(0, p, (3, 2, 2, tplan.N)), p)
                        for p in tplan.primes]).astype(np.int16)
              for _ in range(2)]
    want = JSR.fold_key_split(jnp.asarray(halves[0]), jnp.asarray(halves[1]),
                              jplan)
    got = TSR.fold_key_split(_t(halves[0]), _t(halves[1]), tplan)
    assert got.dtype == torch.int16 and got.shape == (3, 4, 4, 4, tplan.N)
    assert np.array_equal(got.numpy(), np.asarray(want))


def _center(a, p):
    return ((a % p) + p // 2) % p - p // 2


def test_rotate_minus1_split():
    jplan, tplan = _plans()
    rng = np.random.default_rng(2)
    us = _residues(rng, jplan, (6, 4))
    t = np.array([0, 1, 2047, 2048, 4095, 1234], np.int32)
    want = JSR.rotate_minus1_split([jnp.asarray(u) for u in us],
                                   jnp.asarray(t), jplan)
    got = TSR.rotate_minus1_split(torch.stack([_t(u) for u in us]), _t(t),
                                  tplan)
    for w, g in zip(want, got, strict=True):
        assert g.shape == (6, 2, 2, tplan.N)
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("g", [1, 2, 3])
def test_rotate_combine_multi_split(g):
    jplan, tplan = _plans()
    rng = np.random.default_rng(3 + g)
    B = 5
    us = [_residues(rng, jplan, (B, 4)) for _ in range((1 << g) - 1)]
    ts = [rng.integers(0, 4 * tplan.N, B).astype(np.int32) for _ in range(g)]
    want = JSR.rotate_combine_multi_split(
        [[jnp.asarray(x) for x in u] for u in us],
        [jnp.asarray(t) for t in ts], jplan)
    got = TSR.rotate_combine_multi_split(
        [torch.stack([_t(x) for x in u]) for u in us], [_t(t) for t in ts],
        tplan)
    for w, o in zip(want, got, strict=True):
        assert np.array_equal(o.numpy(), np.asarray(w))


def test_hi32_viable_and_rows():
    for name in ("tiny_split", "128bit_t64", "tiny64", "128bit"):
        jp, tp = JP.PARAMS_BY_NAME[name], TP.PARAMS_BY_NAME[name]
        for drop in (12, 31, 32, 40):
            for e, levels in ((8, (2, 2)), (8, (3, 2)), (6, (2, 2)),
                              (7, (2, 2)), (11, (1, 1))):
                if max(levels) > (tp.L if e == tp.bgbit
                                  else tp.torus_bits // e):
                    continue
                assert (TD.hi32_viable(tp, drop, e, levels)
                        == JSR._hi32_viable(jp, drop, e, levels)), (name, drop,
                                                                    e, levels)
    acc = np.random.default_rng(4).integers(-2**31, 2**31, (3, 2, 2, 1024),
                                            dtype=np.int64).astype(np.int32)
    for jp, tp, levels in ((JPAR, TPAR, (2, 2)),
                           (JP.SECURITY_128_BIT_T64, TP.SECURITY_128_BIT_T64,
                            (3, 2))):
        want = JSR._rows_hi32(jnp.asarray(acc), jp, 8, levels)
        got = TD.rows_hi32(_t(acc), tp, 8, levels)
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("group", [1, 2])
def test_blind_rotate_split_bit_equal(keys, group):
    """Both packages' scans on one key: an arbitrary int64 testvec (the
    int64 start, then the hi-plane scan) and the gate testvec, where the
    port's one start equals the JAX package's full start and its
    ``tv_lo_zero`` hi-plane start."""
    sk, cks = keys
    jck, tck = cks[group]
    rng = np.random.default_rng(10 + group)
    ct = _full64(rng, (3, TPAR.n0 + 1))
    tv = _full64(rng, (2, TPAR.N))
    kw = dict(group=group, levels=(2, 2), bgbit=8)
    want = JSR.blind_rotate_split(jnp.asarray(ct), jnp.asarray(tv), jck.bsk_ntt,
                                  JPAR, 32, **kw)
    got = TSR.blind_rotate_split(_t(ct), _t(tv), tck.bsk_ntt, TPAR, 32, **kw)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(),
                                                       np.asarray(want))
    gate_tv = tck.testvec
    assert not (gate_tv & 0xFFFFFFFF).any()
    got = TSR.blind_rotate_split(_t(ct), gate_tv, tck.bsk_ntt, TPAR, 32, **kw)
    for lo_zero in (False, True):
        want = JSR.blind_rotate_split(jnp.asarray(ct), jck.testvec,
                                      jck.bsk_ntt, JPAR, 32,
                                      tv_lo_zero=lo_zero, **kw)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_hi32_scan_equals_generic(keys, monkeypatch):
    """The hi-plane scan is an exact rewrite of the generic int64 scan at
    drop 32 (the generic scan reached by resolving the key's form without
    hi planes: ``blind_rotate_ntt.key_form``, the one place the scan is
    routed), which finishes every step with ``finish_int64``."""
    sk, cks = keys
    tck = cks[2][1]
    rng = np.random.default_rng(20)
    ct, tv = _t(_full64(rng, (2, TPAR.n0 + 1))), _t(_full64(rng, (2, TPAR.N)))
    kw = dict(group=2, levels=(2, 2), bgbit=8)
    hi = TSR.blind_rotate_split(ct, tv, tck.bsk_ntt, TPAR, 32, **kw)
    form, finish, finishes = BRN.key_form, tntt.finish_int64, []
    monkeypatch.setattr(BRN, "key_form", lambda *a: dataclasses.replace(
        form(*a), hi32=False, path=BRN.Path.MULTI))
    monkeypatch.setattr(tntt, "finish_int64",
                        lambda *a: finishes.append(1) or finish(*a))
    generic = TSR.blind_rotate_split(ct, tv, tck.bsk_ntt, TPAR, 32, **kw)
    assert len(finishes) == tck.bsk_ntt.shape[0]
    assert torch.equal(hi, generic)


def test_plain_k1_on_split_views(keys):
    """One real hi-plane step (the hi planes of a rotated gate testvec,
    decomposed, forward NTT, pointwise against the key's first group,
    combined) finished by K1's wrapper on the split views: the CPU tensors
    take the plain version (no launch counted), equal to JAX's
    ``acc + ntt_inverse_to_crt(v, plan, 32)``."""
    sk, cks = keys
    jck, tck = cks[2]
    jplan, tplan = _plans()
    rng = np.random.default_rng(30)
    B, Nh = 5, tplan.N
    acc = rng.integers(-2**31, 2**31, (B, 2, 2, Nh), dtype=np.int64).astype(
        np.int32)
    rows = TD.rows_hi32(_t(acc), TPAR, 8, (2, 2))
    d_hat = tntt.ntt_forward(rows, tplan, 1, 128)
    us = [torch.stack(tntt.pointwise_extprod(d_hat, tck.bsk_ntt[0, m], tplan))
          for m in range(3)]
    ts = [_t(rng.integers(0, 4 * Nh, B).astype(np.int32)) for _ in range(2)]
    v = TSR.rotate_combine_multi_split(us, ts, tplan)
    assert max(int(x.abs().max()) for x in v) <= 32639      # split_limbs' range
    before = K1.ntt_inverse_to_crt_acc.launches
    got = K1.ntt_inverse_to_crt_acc(
        v.reshape(tplan.n_primes, 2 * B, 2, Nh),
        _t(acc).reshape(2 * B, 2, Nh), tplan, 0).reshape(B, 2, 2, Nh)
    assert K1.ntt_inverse_to_crt_acc.launches == before
    want = jnp.asarray(acc) + jntt.ntt_inverse_to_crt(
        [jnp.asarray(x.numpy()) for x in v], jplan, 32)
    assert np.array_equal(got.numpy(), np.asarray(want))


def _cut(P, n0):
    return dataclasses.replace(P, tlwe_lv0=dataclasses.replace(P.tlwe_lv0,
                                                               n=n0))


def test_blind_rotate_128bit_t64_steps():
    """SECURITY_128_BIT_T64 at its key defaults (group 2, Bg_e 2^8 (3, 2),
    drop 32, 4 primes on the N/2 plan), n0 cut to 5, the key the folded
    split residues of uniform int64 rows; the gate testvec against the
    JAX package's ``tv_lo_zero`` start."""
    n0, group, levels = 5, 2, (3, 2)
    jp, tp = _cut(JP.SECURITY_128_BIT_T64, n0), _cut(TP.SECURITY_128_BIT_T64, n0)
    jplan, tplan = _plans((jp, tp), levels)
    assert tplan.n_primes == 4 and tplan.N == 1024
    rng = np.random.default_rng(40)
    rows = JSR.split(jnp.asarray(_full64(rng, (3, 3, 5, 2, tp.N))))
    res = [jntt.to_ntt_form(rows[..., q, :], jplan, 32, width=64)
           for q in range(2)]
    bsk = np.asarray(JSR.fold_key_split(res[0], res[1], jplan))
    assert bsk.shape == (3, 3, 4, 10, 4, 1024)
    ct = _full64(rng, (2, n0 + 1))
    tv = _full64(rng, (2, tp.N))
    gate_tv = np.zeros((2, tp.N), np.int64)
    gate_tv[1] = 1 << 61
    kw = dict(group=group, levels=levels, bgbit=8)
    for tvec, lo_zero in ((tv, False), (gate_tv, True)):
        want = JSR.blind_rotate_split(jnp.asarray(ct), jnp.asarray(tvec),
                                      jnp.asarray(bsk), jp, 32,
                                      tv_lo_zero=lo_zero, **kw)
        got = TSR.blind_rotate_split(_t(ct), _t(tvec), _t(bsk), tp, 32, **kw)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_port_split_key_layout():
    """The port's own split BSK (TEST_TINY_SPLIT, group 2): the shape of
    the folded form and its fold identities, K[(r,1),(c,1)] = K[(r,0),(c,0)]
    and K[(r,1),(c,0)] = psi1 * K[(r,0),(c,1)] (mod p, centred)."""
    g = torch.Generator().manual_seed(50)
    sk = TK.SecretKey.generate(g, TPAR)
    ck = TK.CloudKey.generate(g, sk, TPAR, packing_key=False)
    _, tplan = _plans()
    k = ck.bsk_ntt
    assert k.dtype == torch.int16 and k.shape == (4, 3, 4, 8, 4, tplan.N)
    assert (ck.bsk_group, ck.bsk_bgbit, ck.bsk_levels, ck.bsk_ntt_drop) == (
        2, 8, (2, 2), 32)
    k = k.to(torch.int32)
    assert torch.equal(k[..., 1::2, 1::2, :], k[..., 0::2, 0::2, :])
    for i, p in enumerate(tplan.primes):
        psi1 = torch.from_numpy(tplan.rot[i][1].astype(np.int32))
        want = _center((psi1 * k[:, :, i, 0::2, 1::2, :]).numpy(), p)
        assert np.array_equal(k[:, :, i, 1::2, 0::2, :].numpy(), want)
