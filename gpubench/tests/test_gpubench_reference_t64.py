"""The program on t64's set against the plain 64-bit gate bootstrap
(reference/bootstrap64.py), on the CPU, at the configuration's sizes with
n0 cut to 16 and both noises at 0.

Both take the same secret keys and the same input ciphertexts; each makes
its own cloud key, the program at its default key form (group 2, Bg_e 2^8
with (3, 2) levels, drop 32, the split ring, K2s's plain version) and the
reference at tfhe-rs's own gadgets (2^23 x 1, key switch 2^3 x 5).

The comparison is the blind rotation's, phase by phase: on 4 lanes and an
arbitrary int64 test vector (every coefficient a uniform torus value),
both accumulators are decrypted with the lv1 key, and every one of the
4 x 2048 coefficients of the program's phase lies within ``TOL_BR`` of the
reference's.  The reference is itself held to the definition, X^(-phase)
tv with the phase rounded to a multiple of 1/(2N), within ``TOL_REF``.  A
rotation that is off by one place, or a digit that decodes to another
value, moves a coefficient by a uniform torus value (read: 0.5 at an
added X^1).

Why ``TOL_BR`` = 2^-9 (~0.00195 of the torus).  With the noises at 0 what
is left is each side's gadget rounding; the program's dominates, its body
rounded to 16 bits (2^-17 a coefficient a step, carried through the
multi-bit key's rotation factors over 8 steps), while the reference's 23
bits leave 2^-24 (its distance from the definition reads ~1e-5, under
``TOL_REF`` = 2^-14).  Read: max 0.00043-0.00047, RMS 0.00011-0.00014 on
three seeds.  The program's key one level short on the body (the
configuration's ``control_key``, (3, 1)) rounds the body to 8 bits: max
0.0122-0.0143 on the same seeds, a margin of 4 below the limit and 6
above it.

At the gates, on 80 lanes, each side decrypts to its gate's truth table
with the root mean square of its phase distance from +-1/8 within ``TOL``
= 2^-10 (~0.00098).  With the noises at 0 the key switch's rounding
dominates on both sides: each of the ~N/2 = 1024 key bits set carries the
mask coefficient's rounding to 15 bits, uniform in +-2^-16, so the phase
error is ~sqrt(1024 / 3) 2^-16 = 2^-11.8 ~ 0.00028 (read: program
0.00029-0.00042, reference 0.00025-0.00032 on six seeds); the control
reads 0.0027-0.0042.
"""

import json

import numpy as np
import pytest
import torch
from conftest import ROOT

from gpubench.reference import bootstrap64 as ref64
from gpubench.reference import gates as ref

TOL = 2.0 ** -10
TOL_BR = 2.0 ** -9
TOL_REF = 2.0 ** -14
N0, LANES, SEED = 16, 80, 2 ** 31 + 77
CFG = dict(json.loads((ROOT / "gpubench/configs/t64.json").read_text()),
           n0=N0, lwe_alpha=0.0, glwe_alpha=0.0)


@pytest.fixture(scope="module")
def case():
    """Secret keys, two input ciphertexts a lane, gate ids and the bits
    every lane must decrypt to."""
    rng = np.random.default_rng(SEED)
    s0 = rng.integers(0, 2, N0)
    s1 = rng.integers(0, 2, CFG["N"])
    ids = np.arange(LANES) % len(ref.GATE_NAMES)
    x, y = rng.integers(0, 2, LANES), rng.integers(0, 2, LANES)

    def encrypt(bits):
        a = rng.integers(-2 ** 63, 2 ** 63 - 1, (LANES, N0), dtype=np.int64,
                         endpoint=True)
        mu = np.where(bits, 1 << 61, -(1 << 61)).astype(np.int64)
        b = ((a.view(np.uint64) * s0.astype(np.uint64)).sum(1, dtype=np.uint64)
             + mu.view(np.uint64))
        return torch.from_numpy(np.concatenate([a, b.view(np.int64)[:, None]],
                                               1))

    return {"s0": s0, "s1": s1, "ids": torch.from_numpy(ids),
            "a": encrypt(x), "b": encrypt(y),
            "want": ref.expected_bits(ids, x, y)}


def _cloud_key(case, key_form):
    from zig_tfhe_tpu_torch import key as TK
    from zig_tfhe_tpu_torch import params as TP

    base = TP.PARAMS_BY_NAME[CFG["params"]]
    p = TP._sp("t64_cut", 0, "t64 with n0 cut, noises 0", N0, 0.0, 0.0,
               base.nbit, base.bgbit, base.L, base.basebit, base.iks_t,
               N=base.N, torus_bits=64)
    sk = TK.SecretKey.from_numpy(case["s0"], case["s1"], device="cpu")
    form = dict(key_form, decomp_levels=tuple(key_form["decomp_levels"]))
    ck = TK.CloudKey.generate(torch.Generator().manual_seed(SEED), sk, p,
                              packing_key=False, **form)
    assert (ck.bsk_ntt_drop, ck.bsk_ntt.shape[-4]) == (CFG["drop"],
                                                       CFG["n_primes"])
    return p, ck


def _program(case, key_form):
    from zig_tfhe_tpu_torch.models import gates as TG

    _, ck = _cloud_key(case, key_form)
    return TG.apply_gates(case["ids"], case["a"], case["b"], ck).numpy()


def _blind_rotate(case, key_form, ct, tv):
    from zig_tfhe_tpu_torch.ops import split_ring as TSR

    p, ck = _cloud_key(case, key_form)
    return TSR.blind_rotate_split(ct, tv, ck.bsk_ntt, p, ck.bsk_ntt_drop,
                                  group=ck.bsk_group, levels=ck.bsk_levels,
                                  bgbit=ck.bsk_bgbit)


def _torus_frac(x: torch.Tensor) -> torch.Tensor:
    """int64 torus values as signed fractions in [-1/2, 1/2)."""
    return x.double() / 2.0 ** 64


@pytest.fixture(scope="module")
def rotations(case):
    """The decrypted blind rotations of 4 lanes and an arbitrary test
    vector: the reference's, the program's at its key and at the control
    key, and the definition's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rng = np.random.default_rng(SEED + 1)
        tv = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1,
                                           (2, CFG["N"]), dtype=np.int64,
                                           endpoint=True))
        ct = case["a"][:4]
        s0, s1 = (torch.from_numpy(case[k]) for k in ("s0", "s1"))
        m = ref64.negacyclic_matrix(s1)

        def phase(acc):                    # [B, 2, N] -> [B, N]: b - a s
            return acc[:, 1] - acc[:, 0] @ m

        keys = ref64.make_keys(torch.Generator().manual_seed(SEED), s0, s1,
                               CFG)
        twice_n = 2 * CFG["N"]
        ph = (ref64._modswitch(ct[:, N0], CFG["N"])
              - (ref64._modswitch(ct[:, :N0], CFG["N"]) * s0).sum(1))
        exact = ref64.rotate(tv.expand(4, 2, CFG["N"]), (-ph) % twice_n)
        return {"definition": phase(exact),
                "reference": phase(ref64.blind_rotate(ct, tv, keys, CFG)),
                "program": phase(_blind_rotate(case, CFG["key"], ct, tv)),
                "control": phase(_blind_rotate(case, CFG["control_key"], ct,
                                               tv))}
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def judged(case):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        keys = ref64.make_keys(torch.Generator().manual_seed(SEED),
                               torch.from_numpy(case["s0"]),
                               torch.from_numpy(case["s1"]), CFG)
        outs = {"reference": ref64.apply_gates(case["ids"], case["a"],
                                               case["b"], keys, CFG).numpy(),
                "program": _program(case, CFG["key"]),
                "control": _program(case, CFG["control_key"])}
    finally:
        torch.set_num_threads(n)
    return {k: ref.judge(v, case["s0"], 64, case["want"]) | {"ct": v}
            for k, v in outs.items()}


def test_the_reference_decrypts_to_the_truth_tables(judged):
    r = judged["reference"]
    assert r["lanes"] == LANES and r["wrong"] == 0
    assert r["noise_sd"] <= TOL


def test_the_program_decrypts_to_the_truth_tables(judged):
    p = judged["program"]
    assert p["lanes"] == LANES and p["wrong"] == 0
    assert p["noise_sd"] <= TOL


def test_the_reference_rotates_the_test_vector(rotations):
    d = _torus_frac(rotations["reference"] - rotations["definition"])
    assert d.abs().max() <= TOL_REF


def test_the_program_agrees_with_the_reference(rotations):
    d = _torus_frac(rotations["program"] - rotations["reference"])
    assert d.abs().max() <= TOL_BR


def test_a_key_short_on_the_body_fails_the_tolerance(judged, rotations):
    assert judged["control"]["noise_sd"] > TOL
    d = _torus_frac(rotations["control"] - rotations["reference"])
    assert d.abs().max() > TOL_BR


def test_the_reference_keys_hold_their_messages():
    """With the noises at 0, each bootstrapping-key row's phase is the bit
    times its gadget factor (on the mask row times -s(X)), and each
    key-switching row's phase its digit times the lv1 bit times its
    factor."""
    rng = np.random.default_rng(3)
    cfg = dict(CFG, n0=2, N=64)
    s0, s1 = (torch.from_numpy(rng.integers(0, 2, n)) for n in (2, 64))
    k = ref64.make_keys(torch.Generator().manual_seed(3), s0, s1, cfg)
    bsk = k["bsk"]                                   # [n0, 2L, 2, N], L = 1
    ph = bsk[:, :, 1] - bsk[:, :, 0] @ ref64.negacyclic_matrix(s1)
    g = ref64.torus(2.0 ** -cfg["bg_bits"])
    for i in range(2):
        assert torch.equal(ph[i, 0], -(s0[i] * g) * s1)
        assert torch.equal(ph[i, 1], torch.nn.functional.pad(
            (s0[i] * g).view(1), (0, 63)))
    ksk = k["ksk"]                                   # [N, t, base, n0 + 1]
    got = ksk[..., -1] - (ksk[..., :-1] * s0).sum(-1)
    bb = cfg["ks_base_bits"]
    want = (s1[:, None, None] * torch.arange(1 << bb)[None, None, :]
            * torch.tensor([ref64.torus(2.0 ** (-(j + 1) * bb))
                            for j in range(cfg["ks_levels"])])[None, :, None])
    assert torch.equal(got, want)
