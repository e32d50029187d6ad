"""The fused blind-rotation step core (K2) of the port against the JAX code
it follows, and the keygen knobs that select its configurations.

* Group 2: the plain version, followed by the port's plain inverse before
  the CRT lift, is bit-equal per prime to the TPU kernel it replaces,
  zig_tfhe_tpu/ops/pallas/ntt_step.py:ntt_step_fused_pallas, in interpret
  mode; the accumulator after K1's plain version equals the kernel's
  caller (crt_combine, << drop, acc +).
* Group 2 with multi-limb engine digits (the uint sets): the accumulator
  is bit-equal to the JAX package's XLA step2, which runs those keys, and
  the residues equal its own modulo p.
* Group 3: the residues are bit-equal to the XLA step_multi fold
  (pointwise_extprod(reduce_output=False), rotate_combine_multi(u_wide)),
  and the accumulator to its ``finish``.
* The port's blind rotation is bit-equal to the JAX one with the Pallas
  step kernel engaged (``ZTFHE_PALLAS=1``, TPU interpret mode), at
  TEST_TINY and over two steps of the 128-bit group-2 (3, 2) key.

Key residues are NTTs of uniform torus rows, as keygen makes them
(uniform residues would break the CRT lift).  Tolerance: exact equality.
The CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py.
"""

import inspect
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_blind_rotate import _cut
from tests.test_torch_gates import _IDS, _WANT, _X, _Y
from zig_tfhe_tpu import key as JK
from zig_tfhe_tpu import params as JP
from zig_tfhe_tpu.ops import ntt as jntt
from zig_tfhe_tpu.ops.blind_rotate_ntt import blind_rotate_ntt as j_brn
from zig_tfhe_tpu.ops.pallas.ntt_step import ntt_step_fused_pallas
from zig_tfhe_tpu_torch import key as TK
from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch import tlwe as TT
from zig_tfhe_tpu_torch.models import gates as TG
from zig_tfhe_tpu_torch.ops import ntt as tntt
from zig_tfhe_tpu_torch.ops.blind_rotate_ntt import blind_rotate_ntt as t_brn
from zig_tfhe_tpu_torch.ops.cuda import ntt_inverse as K1
from zig_tfhe_tpu_torch.ops.cuda import ntt_step as K2

# name -> (params name, drop, group, levels, engine bgbit)
_CASES = {
    "128bit_g2": ("128bit", 7, 2, (3, 2), 6),    # group=2, decomp_levels=(3, 2)
    "128bit_g3": ("128bit", 5, 3, (2, 2), 7),    # the 128-bit key default
    "tiny_g2": ("tiny", 0, 2, (2, 2), 6),        # TEST_TINY's default
    "tiny_g3": ("tiny", 0, 3, (2, 2), 6),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _plans(case):
    name, drop, group, levels, bgbit = _CASES[case]
    kw = dict(bgbit=bgbit, pseudorandom_key=True)
    return (jntt.plan_for_params(JP.PARAMS_BY_NAME[name], drop, group, levels, **kw),
            tntt.plan_for_params(TP.PARAMS_BY_NAME[name], drop, group, levels, **kw))


def _step_inputs(case, B, seed):
    """Digits, one step of in-range key residues, rotations, accumulator."""
    _, drop, group, levels, bgbit = _CASES[case]
    jplan, tplan = _plans(case)
    N, R, S = jplan.N, sum(levels), (1 << group) - 1
    rng = np.random.default_rng(seed)
    half = 1 << (bgbit - 1)
    digits = rng.integers(-half, half, (B, R, N)).astype(np.int8)
    rows = rng.integers(-2**31, 2**31, (S, R, 2, N)).astype(np.int32)
    bsk = np.moveaxis(np.asarray(jntt.to_ntt_form(jnp.asarray(rows), jplan,
                                                  drop)), 0, 1)
    ts = rng.integers(0, 2 * N + 1, (group, B)).astype(np.int32)
    acc = rng.integers(-2**31, 2**31, (B, 2, N)).astype(np.int32)
    return jplan, tplan, drop, bgbit, digits, np.ascontiguousarray(bsk), ts, acc


@pytest.mark.parametrize("case", ["128bit_g2", "tiny_g2"])
def test_group2_matches_pallas_step_kernel(case):
    jplan, tplan, drop, bgbit, digits, bsk, ts, acc = _step_inputs(case, 64, 3)
    N = jplan.N
    tabs = [jnp.asarray(t) for t in jplan.rot]
    t1, t2 = (jnp.asarray(t & (2 * N - 1)) for t in ts)
    rows1 = jnp.stack([jnp.take(t, t1, axis=0) for t in tabs])
    rows2 = jnp.stack([jnp.take(t, t2, axis=0) for t in tabs])
    x_f = ntt_step_fused_pallas(jnp.asarray(digits), jnp.asarray(bsk), rows1,
                                rows2, jplan, tile_b=64, interpret=True)
    v8 = K2.ntt_step_fused_reference(_t(digits), _t(bsk), _t(ts), tplan, bgbit)
    assert v8.dtype == torch.int8
    assert tuple(v8.shape) == (jplan.n_primes, 64, 2, 2, N)
    v = K1.join_limbs(v8)           # the residues, from their int8 limb planes
    assert v.dtype == torch.int32 and torch.equal(K1.split_limbs(v), v8)
    xs = tntt.ntt_inverse_residues(list(v), tplan)
    for i, p in enumerate(tplan.primes):
        assert np.array_equal(xs[i].numpy(), np.asarray(x_f[i])), p
        assert int(v[i].abs().max()) <= 0.55 * p
    delta = jntt.crt_combine([x_f[i] for i in range(jplan.n_primes)], jplan)
    want = np.asarray(jnp.asarray(acc) + (delta << drop))
    got = K1.ntt_inverse_to_crt_acc_reference(v8, _t(acc), tplan, drop)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(
        got, K1.ntt_inverse_to_crt_acc_reference(v, _t(acc), tplan, drop))


@pytest.mark.parametrize("case", ["128bit_g3", "tiny_g3"])
def test_group3_matches_xla_step_multi(case):
    jplan, tplan, drop, bgbit, digits, bsk, ts, acc = _step_inputs(case, 8, 4)
    d_hat = jntt.ntt_forward(jnp.asarray(digits, jnp.int32), jplan, 1,
                             1 << (bgbit - 1))
    us = [jntt.pointwise_extprod(d_hat, jnp.asarray(bsk[m]), jplan,
                                 reduce_output=False) for m in range(7)]
    v_j = jntt.rotate_combine_multi(us, [jnp.asarray(t) for t in ts], jplan,
                                    u_wide=True)
    v = K2.ntt_step_fused_reference(_t(digits), _t(bsk), _t(ts), tplan, bgbit)
    for i, p in enumerate(tplan.primes):
        assert np.array_equal(K1.join_limbs(v[i]).numpy(), np.asarray(v_j[i])), p
    delta = jntt.ntt_inverse_to_crt(v_j, jplan)
    want = np.asarray(jnp.asarray(acc) + (delta << drop))
    got = K1.ntt_inverse_to_crt_acc_reference(v, _t(acc), tplan, drop)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["tiny_uint", "uint1", "uint4"])
def test_group2_multi_limb_matches_xla_step2(name):
    """One step of a uint key at its defaults (group 2; Bg_e 2^11, 2^10, 2^22
    with 2, 2, 3 digit limbs; 4, 4, 5 primes): the digits of a real
    accumulator, as limb planes, through the plain version and K1's plain
    version give the JAX package's XLA step2 accumulator bit for bit
    (pointwise_extprod + rotate_combine2, no fold, as it runs these keys).
    The forward NTT is bit-equal per prime; the residues follow the group-2
    Pallas arithmetic, so they equal JAX's modulo p, within 0.55p."""
    from zig_tfhe_tpu.ops.blind_rotate import _decompose_to_rows as j_rows
    from zig_tfhe_tpu_torch.ops.decomposition import decompose_rows as t_rows
    from zig_tfhe_tpu_torch.ops.decomposition import digit_planes

    jp, tp = JP.PARAMS_BY_NAME[name], TP.PARAMS_BY_NAME[name]
    bgbit, levels = tntt.default_engine_gadget(tp, 2)
    drop = tntt.default_drop_bits(tp, 2, bgbit)
    n_dl = tntt.engine_digit_limbs(bgbit)
    kw = dict(bgbit=bgbit, pseudorandom_key=True)
    jplan = jntt.plan_for_params(jp, drop, 2, levels, **kw)
    tplan = tntt.plan_for_params(tp, drop, 2, levels, **kw)
    N, R, B = tplan.N, sum(levels), 5
    assert n_dl > 1 and tplan.primes == jplan.primes
    rng = np.random.default_rng(len(name))
    acc = rng.integers(-2**31, 2**31, (B, 2, N)).astype(np.int32)
    rows = rng.integers(-2**31, 2**31, (3, R, 2, N)).astype(np.int32)
    bsk = np.ascontiguousarray(np.moveaxis(np.asarray(jntt.to_ntt_form(
        jnp.asarray(rows), jplan, drop)), 0, 1))
    ts = rng.integers(0, 2 * N + 1, (2, B)).astype(np.int32)

    digits_j = j_rows(jnp.asarray(acc), jp, levels, bgbit=bgbit)
    digits_t = t_rows(_t(acc), tp, levels, bgbit=bgbit)
    assert np.array_equal(digits_t.numpy(), np.asarray(digits_j))
    dbound = jntt.top_limb_bound(1 << (bgbit - 1), n_dl)
    d_hat = jntt.ntt_forward(digits_j, jplan, n_dl, dbound)
    us = [jntt.pointwise_extprod(d_hat, jnp.asarray(bsk[m]), jplan)
          for m in range(3)]
    v_j = jntt.rotate_combine2(*us, jnp.asarray(ts[0]), jnp.asarray(ts[1]),
                               jplan)
    delta = jntt.ntt_inverse_to_crt(v_j, jplan)
    want = np.asarray(jnp.asarray(acc) + (delta << drop))

    planes = digit_planes(digits_t, n_dl)
    assert planes.dtype == torch.int8 and tuple(planes.shape) == (B, R * n_dl, N)
    limbs = planes.reshape(B, R, n_dl, N)
    d_hat_t = tntt.ntt_forward_limbs([limbs[:, :, l] for l in range(n_dl)],
                                     tplan, dbound)
    for i in range(tplan.n_primes):
        assert np.array_equal(d_hat_t[i].numpy(), np.asarray(d_hat[i]))
    v8 = K2.ntt_step_fused_reference(planes, _t(bsk), _t(ts), tplan, bgbit)
    v = K1.join_limbs(v8)
    for i, p in enumerate(tplan.primes):
        assert not ((v[i].numpy().astype(np.int64)
                     - np.asarray(v_j[i]).astype(np.int64)) % p).any(), p
        assert int(v[i].abs().max()) <= 0.55 * p
    got = K1.ntt_inverse_to_crt_acc_reference(v8, _t(acc), tplan, drop)
    assert np.array_equal(got.numpy(), want)


def _jax_blind_rotate_pallas(monkeypatch, *args, **kw):
    """JAX blind_rotate_ntt with the Pallas step kernel engaged: any warning
    (the kernel refusing the shapes) fails the test."""
    monkeypatch.setenv("ZTFHE_PALLAS", "1")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(j_brn(*args, **kw))


def test_blind_rotate_tiny_group2_matches_jax_pallas(monkeypatch):
    params = JP.TEST_TINY
    sk = JK.SecretKey.generate(jax.random.key(21), params)
    ck = JK.CloudKey.generate(jax.random.key(22), sk, params, group=2)
    assert (ck.bsk_group, ck.bsk_bgbit) == (2, 6)
    ct = np.random.default_rng(5).integers(
        -2**31, 2**31, (64, params.n0 + 1)).astype(np.int32)
    kw = dict(group=2, levels=ck.bsk_levels, bgbit=ck.bsk_bgbit)
    want = _jax_blind_rotate_pallas(monkeypatch, jnp.asarray(ct), ck.testvec,
                                    ck.bsk_ntt, params, ck.bsk_ntt_drop, **kw)
    got = t_brn(_t(ct), _t(ck.testvec), _t(ck.bsk_ntt), TP.TEST_TINY,
                ck.bsk_ntt_drop, **kw)
    assert np.array_equal(got.numpy(), want)


def test_blind_rotate_128bit_group2_steps_match_jax_pallas(monkeypatch):
    """Two scan steps (n0 = 4) of the 128-bit group-2 (3, 2) key: Bg_e 2^6,
    5 rows, drop 7, 3 primes."""
    jp, tp = _cut(JP, 4), _cut(TP, 4)
    drop, group, levels, bgbit = 7, 2, (3, 2), 6
    jplan = jntt.plan_for_params(jp, drop, group, levels, bgbit=bgbit,
                                 pseudorandom_key=True)
    assert jplan.n_primes == 3
    rng = np.random.default_rng(6)
    rows = rng.integers(-2**31, 2**31, (2, 3, 5, 2, jplan.N)).astype(np.int32)
    bsk = np.moveaxis(np.asarray(jntt.to_ntt_form(jnp.asarray(rows), jplan,
                                                  drop)), 0, 2)
    ct = rng.integers(-2**31, 2**31, (64, 5)).astype(np.int32)
    tv = rng.integers(-2**31, 2**31, (2, jplan.N)).astype(np.int32)
    kw = dict(group=group, levels=levels, bgbit=bgbit)
    want = _jax_blind_rotate_pallas(monkeypatch, jnp.asarray(ct),
                                    jnp.asarray(tv), jnp.asarray(bsk), jp,
                                    drop, **kw)
    got = t_brn(_t(ct), _t(tv), _t(np.ascontiguousarray(bsk)), tp, drop, **kw)
    assert np.array_equal(got.numpy(), want)


# CloudKey.generate knobs: (group, decomp_levels, engine_bgbit)
_KNOBS = [(2, (3, 2), None), (None, None, None), (2, None, None),
          (3, None, None), (2, None, 8), (1, (3, 3), None), (3, (2, 2), 7)]


@pytest.mark.parametrize("knobs", _KNOBS, ids=str)
def test_keygen_knobs_resolve_like_jax(monkeypatch, knobs):
    """Both packages resolve the knobs to the same key configuration (the
    array generation itself is stubbed out: only the resolution runs)."""
    group, levels, bgbit = knobs
    seen = {}

    def jax_arrays(key, sk, **kw):
        seen["jax"] = (kw["group"], kw["bgbit"], tuple(kw["levels"]),
                       kw["ntt_drop"])
        return None, None, None, None

    def port_bsk(gen, sk, params, drop, group, levels, bgbit):
        seen["port"] = (group, bgbit, tuple(levels), drop)
        return torch.zeros(1, dtype=torch.int16)

    monkeypatch.setattr(JK, "_gen_cloud_key_arrays", jax_arrays)
    monkeypatch.setattr(TK, "gen_key_switching_key", lambda *a: torch.zeros(1))
    monkeypatch.setattr(TK, "gen_bootstrapping_key_ntt", port_bsk)
    jck = JK.CloudKey.generate(None, None, JP.SECURITY_128_BIT, group=group,
                               decomp_levels=levels, engine_bgbit=bgbit)
    tck = TK.CloudKey.generate(torch.Generator(), None, TP.SECURITY_128_BIT,
                               group=group, decomp_levels=levels,
                               engine_bgbit=bgbit)
    assert seen["port"] == seen["jax"]
    assert (tck.bsk_group, tck.bsk_bgbit, tck.bsk_levels, tck.bsk_ntt_drop) == (
        jck.bsk_group, jck.bsk_bgbit, tuple(jck.bsk_levels), jck.bsk_ntt_drop)
    g, e, lv, drop = seen["port"]
    kw = dict(bgbit=e, pseudorandom_key=True)
    assert (tntt.plan_for_params(TP.SECURITY_128_BIT, drop, g, lv, **kw).primes
            == jntt.plan_for_params(JP.SECURITY_128_BIT, drop, g, lv, **kw).primes)
    if knobs == (2, (3, 2), None):
        assert seen["port"] == (2, 6, (3, 2), 7)
    if knobs == (None, None, None):
        assert seen["port"] == (3, 7, (2, 2), 5)


@pytest.mark.parametrize("knobs", [dict(group=2, engine_bgbit=7),
                                   dict(group=3, decomp_levels=(2, 2)),
                                   dict(group=2, decomp_levels=(2, 2),
                                        engine_bgbit=8)], ids=str)
def test_port_keygen_with_knobs_decrypts_truth_tables(knobs):
    params = TP.TEST_TINY
    g = torch.Generator().manual_seed(12)
    sk = TK.SecretKey.generate(g, params)
    ck = TK.CloudKey.generate(g, sk, params, **knobs)
    assert ck.bsk_group == knobs["group"]
    a = TT.encrypt_bool(g, _t(_X), params.ksk_alpha, sk.key_lv0)
    b = TT.encrypt_bool(g, _t(_Y), params.ksk_alpha, sk.key_lv0)
    out = TG.apply_gates(_t(_IDS), a, b, ck)
    assert np.array_equal(TT.decrypt_bool(out, sk.key_lv0).numpy(), _WANT)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_wrapper_runs_plain_version_on_cpu(case):
    """CPU tensors take the plain version and count no launch, at a batch
    the Pallas kernel's tile rule would refuse."""
    _, tplan, _, bgbit, digits, bsk, ts, _ = _step_inputs(case, 3, 7)
    before = K2.ntt_step_fused.launches
    got = K2.ntt_step_fused(_t(digits), _t(bsk), _t(ts), tplan, bgbit)
    want = K2.ntt_step_fused_reference(_t(digits), _t(bsk), _t(ts), tplan, bgbit)
    assert torch.equal(got, want)
    assert K2.ntt_step_fused.launches == before


# name -> (params name, drop, group, levels, engine bgbit, B): the launches
# whose instance the wrapper picks on a card of 132 SMs.  Only g3's key
# shape at 2048 lanes (group 3, R = 4 one-limb rows, row groups 4, 2, 2,
# wide tiles) takes the instance compiled at that shape.
# name -> (params, drop, group, levels, engine bgbit, B, the instance taken
# on a card of 132 SMs).  uint4's wide tiles give every SM one from B = 31
# (4 row tiles of 10 lanes, 160 tiles); 30 lanes make 120.
_ROUTES = {
    "g3_b2048": ("128bit", 5, 3, (2, 2), 7, 2048, K2.G3_SHAPE),
    "g2_b2048": ("128bit", 7, 2, (3, 2), 6, 2048, K2.GENERAL),
    "uint4_b2048": ("uint4", 0, 2, (1, 1), 22, 2048, K2.UINT_SHAPE),
    "uint4_b31": ("uint4", 0, 2, (1, 1), 22, 31, K2.UINT_SHAPE),
    "uint4_b30": ("uint4", 0, 2, (1, 1), 22, 30, K2.GENERAL),
    "tiny_g3_b2048": ("tiny", 0, 3, (2, 2), 6, 2048, K2.GENERAL),
    "g3_b1": ("128bit", 5, 3, (2, 2), 7, 1, K2.GENERAL),
}


class _RecordingLibrary:
    """Stands in for the kernel's library: records the instance each launch
    asks for and launches nothing."""

    def __init__(self):
        self.shapes = []

    def ztfhe_ntt_step_fused(self, *args):
        self.shapes.append(args[-2])
        return 0


@pytest.mark.parametrize("case", sorted(_ROUTES))
def test_wrapper_routes_the_shape_instance(case):
    """The launch path picks g3's shape instance for g3's key shape at B =
    2048, the uint keys' for uint4's 3-limb digits where its wide tiles
    give every SM one, and the general one elsewhere (g2, uint4 at 30
    lanes, TEST_TINY's group 3 at N = 64, B = 1); it counts each launch in
    ``ntt_step_fused.launches`` and a shape instance's also in
    ``shape_launches`` (g3's) or ``uint_shape_launches`` (the uint keys')."""
    name, drop, group, levels, bgbit, B, want = _ROUTES[case]
    P = TP.PARAMS_BY_NAME[name]
    plan = tntt.plan_for_params(P, drop, group, levels, bgbit=bgbit,
                                pseudorandom_key=True)
    n_dl, R = tntt.engine_digit_limbs(bgbit), sum(levels)
    assert (n_dl == 3) == (name == "uint4")
    assert K2.shape_instance(plan, group, R, n_dl, B, 132) == want
    digits = torch.empty((B, R * n_dl, plan.N), dtype=torch.int8)
    bsk = torch.empty(((1 << group) - 1, plan.n_primes, R, 2, plan.N),
                      dtype=torch.int16)
    ts = torch.empty((group, B), dtype=torch.int32)
    lib = _RecordingLibrary()
    fn = K2.ntt_step_fused
    before = (fn.launches, fn.shape_launches, fn.uint_shape_launches)
    v = K2._launch(lib, digits, bsk, ts, plan, bgbit, 132, None)
    assert tuple(v.shape) == (plan.n_primes, B, 2, 2, plan.N)
    assert lib.shapes == [want]
    assert (fn.launches, fn.shape_launches, fn.uint_shape_launches) == (
        before[0] + 1, before[1] + (want == K2.G3_SHAPE),
        before[2] + (want == K2.UINT_SHAPE))


def test_wrapper_refuses_what_it_cannot_take():
    _, tplan, _, bgbit, digits, bsk, ts, _ = _step_inputs("tiny_g2", 3, 8)
    d, k, t = _t(digits), _t(bsk), _t(ts)
    with pytest.raises(NotImplementedError, match="groups"):      # group 1
        K2.ntt_step_fused(d, k[:1], t[:1], tplan, bgbit)
    with pytest.raises(NotImplementedError, match="one-limb"):    # 4 limbs
        K2.ntt_step_fused(d, k, t, tplan, 25)
    with pytest.raises(NotImplementedError, match="32-bit"):      # width 64
        K2.ntt_step_fused(d.long(), k, t, tplan, bgbit)


def test_port_entry_points_default_to_the_card():
    from zig_tfhe_tpu_torch.utils import serialization as tser

    from zig_tfhe_tpu_torch.models import lut as TL

    for fn in (TK.SecretKey.from_numpy, TK.CloudKey.from_numpy,
               TK.gen_testvec, tser.load_secret_key, tser.load_cloud_key,
               tser.load_packing_ksk, TL.LookupTable.as_torch, TG.constant):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if torch.cuda.is_available():
        assert TK.gen_testvec(TP.TEST_TINY).device.type == "cuda"
    else:                       # no card: the default raises, no fallback
        with pytest.raises((RuntimeError, AssertionError)):
            TK.gen_testvec(TP.TEST_TINY)
        with pytest.raises((RuntimeError, AssertionError)):
            TG.constant(True, TP.TEST_TINY, (2,))
