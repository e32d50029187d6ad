"""The port's programmable bootstrap on uint4's set against the plain
32-bit programmable bootstrap (``gpubench/reference/pbs32.py``), on the
CPU, at the configuration's sizes (``gpubench/configs/uint4.json``: N =
1024, PBS 2^22 x 1, key switch 2^5 x 3) with n0 cut to 16 and both noises
at 0.

Both take the same secret keys, input ciphertexts and test vectors; each
makes its own cloud key, the program at the configuration's key form
(group 2, Bg_e 2^22 with (1, 1) levels, drop 0, 5 primes: 3-limb digits,
the scan's fused path with K2's and K1's plain versions) and the
reference at the published gadgets, one TRGSW a bit.

The blind rotation, phase by phase: on 4 lanes, each with its own
arbitrary int32 test vector (every coefficient a uniform torus value),
both accumulators are decrypted with the lv1 key, and every one of the
4 x 1024 coefficients of the program's phase lies within ``TOL_BR`` of
the reference's.  The reference is itself held to the definition, X^(-
phase) tv with the phase rounded to a multiple of 1/(2N), within
``TOL_REF``.  A rotation off by one place, or a digit that decodes to
another value, moves a coefficient by a uniform torus value.

Why ``TOL_BR`` = 2^-12 (~0.000244 of the torus).  With the noises at 0
what is left is each side's gadget rounding: 22 of 32 bits kept, so each
digit's rounding is uniform within 2^-23, carried into the phase by the
~N/2 lv1 key bits set on the mask (sqrt(512 / 3) 2^-23 ~ 1.6e-6 a set
bit; ~8 of the 16 bits set: ~4.4e-6 a side); the program's key residues
are exact (drop 0).  Read on three seeds (2^31 + 404, 11, 4000000007):
program against reference max 0.0000260-0.0000327 (RMS 0.0000075-
0.0000089), a margin of 7.5 below the limit; the reference against the
definition max 0.0000148-0.0000192, under ``TOL_REF`` = 2^-14
(~0.000061, a margin of 3.2).  The program at the configuration's control
key (Bg_e 2^15, the precision below the stated one) rounds each digit
within 2^-16, 128 times coarser: max 0.00243-0.00336, 10 times the limit.

At the bootstrap, 7 functions x 16 inputs (112 lanes), each side decodes
to f(x) with the root mean square of its phase distance from f(x) / 32
within ``TOL`` = 2^-11.5 (~0.000345).  With the noises at 0 the key
switch's rounding dominates on both sides: each of the ~N/2 = 512 lv1 key
bits set carries its mask coefficient's rounding to 15 bits, uniform
within 2^-16, so the phase error is ~sqrt(512 / 3) 2^-16 ~ 0.00020.  Read
on the same seeds: program 0.000182-0.000195, reference 0.000199-0.000204
(a margin of 1.7 below the limit); the control 0.000668-0.000815 (1.9
above it), and fails both limits.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench.reference import bootstrap64 as ref64  # noqa: E402
from gpubench.reference import lut as ref_lut  # noqa: E402
from gpubench.reference import pbs32  # noqa: E402

TOL = 2.0 ** -11.5
TOL_BR = 2.0 ** -12
TOL_REF = 2.0 ** -14
N0, M, SEED = 16, 16, 2 ** 31 + 404
CFG = dict(json.loads((ROOT / "gpubench/configs/uint4.json").read_text()),
           n0=N0, lwe_alpha=0.0, glwe_alpha=0.0)
N = CFG["N"]


@pytest.fixture(scope="module")
def one_thread():
    # many small CPU ops: torch's intra-op pool stalls beside other workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params():
    from zig_tfhe_tpu_torch import params as TP

    base = TP.PARAMS_BY_NAME[CFG["params"]]
    return TP._sp("uint4_cut", 0, "uint4 with n0 cut, noises 0", N0, 0.0, 0.0,
                  base.nbit, base.bgbit, base.L, base.basebit, base.iks_t,
                  N=base.N)


def _encrypt(rng, s0, mu):
    """Noise-free lv0 encryptions of the torus values ``mu`` (int64 [B])."""
    a = rng.integers(-2 ** 31, 2 ** 31, (len(mu), N0))
    b = ((a * s0).sum(1) + mu) % 2 ** 32
    b = np.where(b >= 2 ** 31, b - 2 ** 32, b)
    return torch.from_numpy(np.concatenate([a, b[:, None]], 1).astype(np.int32))


def case_for(seed):
    """Secret keys, 7 x 16 lanes (every function on every input) with their
    test vectors, and 4 lanes of arbitrary test vectors."""
    from zig_tfhe_tpu_torch.models import lut as TL

    rng = np.random.default_rng(seed)
    s0, s1 = rng.integers(0, 2, N0), rng.integers(0, 2, N)
    names = ref_lut.FUNCTION_NAMES
    fn_ids = np.repeat(np.arange(len(names)), M)
    x = np.tile(np.arange(M), len(names))
    gen = TL.Generator.new(M, _params())
    tables = np.stack([gen.generate_lookup_table(
        lambda v, f=ref_lut.FUNCTIONS[n]: f(v, M)).poly for n in names])
    arbitrary = rng.integers(-2 ** 31, 2 ** 31, 4)
    return {"s0": s0, "s1": s1, "fn_ids": fn_ids, "x": x,
            "ct": _encrypt(rng, s0, x << (32 - M.bit_length())),
            "tv": torch.from_numpy(tables[fn_ids]),
            "want": ref_lut.expected(names, fn_ids, x, M),
            "br_ct": _encrypt(rng, s0, arbitrary),
            "br_tv": torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (4, 2, N))
                                      .astype(np.int32))}


def _cloud_key(case, key_form):
    from zig_tfhe_tpu_torch import key as TK

    p = _params()
    sk = TK.SecretKey.from_numpy(case["s0"], case["s1"], device="cpu")
    form = dict(key_form, decomp_levels=tuple(key_form["decomp_levels"]))
    ck = TK.CloudKey.generate(torch.Generator().manual_seed(SEED), sk, p,
                              packing_key=False, **form)
    return p, ck


def _ref_keys(case):
    return pbs32.make_keys(torch.Generator().manual_seed(SEED),
                           torch.from_numpy(case["s0"]),
                           torch.from_numpy(case["s1"]), CFG)


def _phase(acc, s1):
    """[B, 2, N] -> the lv1 phase b - a s1 as torus fractions."""
    ph = (acc[:, 1].long() - acc[:, 0].long() @ ref64.negacyclic_matrix(
        torch.from_numpy(s1))) % 2 ** 32
    return torch.where(ph >= 2 ** 31, ph - 2 ** 32, ph).double() / 2.0 ** 32


def _wrap(d):
    """Torus fractions of a difference, back into [-1/2, 1/2)."""
    return (d + 0.5) % 1.0 - 0.5


def rotations_for(case):
    """The decrypted blind rotations of the 4 arbitrary lanes: the
    reference's, the program's at its key and at the control key, and the
    definition's."""
    from zig_tfhe_tpu_torch.ops import blind_rotate as TBR

    ct, tv = case["br_ct"], case["br_tv"]
    s0 = torch.from_numpy(case["s0"])
    ph = (ref64._modswitch(pbs32.lift(ct[:, N0]), N)
          - (ref64._modswitch(pbs32.lift(ct[:, :N0]), N) * s0).sum(1))
    exact = ref64.rotate(tv.long(), (-ph) % (2 * N))
    out = {"definition": exact,
           "reference": pbs32.blind_rotate(ct, tv, _ref_keys(case), CFG)}
    for name, form in (("program", CFG["key"]), ("control", CFG["control_key"])):
        p, ck = _cloud_key(case, form)
        out[name] = TBR.blind_rotate(ct, tv, ck, p)
    return {k: _phase(v, case["s1"]) for k, v in out.items()}


def bootstraps_for(case):
    """Every lane's output judged against f(x), on each side."""
    from zig_tfhe_tpu_torch.models import lut as TL

    outs = {"reference": pbs32.bootstrap_lut(case["ct"], case["tv"],
                                             _ref_keys(case), CFG)}
    for name, form in (("program", CFG["key"]), ("control", CFG["control_key"])):
        _, ck = _cloud_key(case, form)
        outs[name] = TL.bootstrap_lut(case["ct"], case["tv"], ck)
    return {k: ref_lut.judge(v.numpy(), case["s0"], 32, case["want"], M)
            for k, v in outs.items()}


@pytest.fixture(scope="module")
def case(one_thread):
    return case_for(SEED)


@pytest.fixture(scope="module")
def rotations(case):
    return rotations_for(case)


@pytest.fixture(scope="module")
def judged(case):
    return bootstraps_for(case)


def test_the_program_takes_the_configurations_key_form(case):
    _, ck = _cloud_key(case, CFG["key"])
    assert (ck.bsk_group, ck.bsk_bgbit, ck.bsk_levels, ck.bsk_ntt_drop,
            ck.bsk_ntt.shape[-4]) == (2, 22, (1, 1), CFG["drop"],
                                      CFG["n_primes"])


def test_the_reference_rotates_the_test_vectors(rotations):
    d = _wrap(rotations["reference"] - rotations["definition"])
    assert d.abs().max() <= TOL_REF


def test_the_program_agrees_with_the_reference(rotations):
    d = _wrap(rotations["program"] - rotations["reference"])
    assert d.abs().max() <= TOL_BR


@pytest.mark.parametrize("side", ["reference", "program"])
def test_every_lane_decodes_to_its_function(judged, side):
    r = judged[side]
    assert r["lanes"] == len(ref_lut.FUNCTION_NAMES) * M
    assert r["wrong"] == 0
    assert r["noise_sd"] <= TOL


def test_the_control_key_fails_the_tolerances(judged, rotations):
    """The program at Bg_e 2^15, the precision below the stated one."""
    d = _wrap(rotations["control"] - rotations["reference"])
    assert d.abs().max() > TOL_BR
    assert judged["control"]["noise_sd"] > TOL


def test_the_reference_keys_hold_their_messages():
    """With the noises at 0, each bootstrapping-key row's phase is the bit
    times its gadget factor 2^(32 - bg) (on the mask row times -s(X)), and
    each key-switching row's phase its digit times the lv1 bit times
    2^(32 - j bb), on the 32-bit torus."""
    rng = np.random.default_rng(3)
    cfg = dict(CFG, n0=2, N=64)
    s0, s1 = (torch.from_numpy(rng.integers(0, 2, n)) for n in (2, 64))
    k = pbs32.make_keys(torch.Generator().manual_seed(3), s0, s1, cfg)
    bsk = pbs32.lower(k["bsk"]).long()               # [n0, 2L, 2, N], L = 1
    ph = (bsk[:, :, 1] - bsk[:, :, 0] @ ref64.negacyclic_matrix(s1)) % 2 ** 32
    g = 1 << (32 - cfg["bg_bits"])
    for i in range(2):
        assert torch.equal(ph[i, 0], (-(s0[i] * g) * s1) % 2 ** 32)
        assert torch.equal(ph[i, 1], torch.nn.functional.pad(
            (s0[i] * g).view(1), (0, 63)))
    ksk = pbs32.lower(k["ksk"]).long()               # [N, t, base, n0 + 1]
    got = (ksk[..., -1] - (ksk[..., :-1] * s0).sum(-1)) % 2 ** 32
    bb = cfg["ks_base_bits"]
    want = (s1[:, None, None] * torch.arange(1 << bb)[None, None, :]
            * torch.tensor([1 << (32 - (j + 1) * bb)
                            for j in range(cfg["ks_levels"])])[None, :, None])
    assert torch.equal(got, want)


def test_the_lift_refuses_gadgets_past_the_32_bit_torus():
    with pytest.raises(ValueError, match="lift"):
        pbs32.make_keys(torch.Generator(), torch.zeros(2, dtype=torch.int64),
                        torch.zeros(64, dtype=torch.int64),
                        dict(CFG, n0=2, N=64, bg_bits=16, levels=2))


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda", 0)


# the phase of an output lane against the reference's, in the two sides'
# combined noise: both select the same test-vector coefficient (the same
# input, the same modswitch), so they differ by their noises alone
SIGMAS = 6


@pytest.mark.cuda
def test_a_timed_call_at_the_published_widths_agrees_with_the_reference(
        cuda_dev):
    """16 lanes of one timed call of the cell ``uint4.lut_b2048`` (n0 820,
    N 1024, the lv0 and lv1 noises as published, the program's key made
    on the card), run again through the reference on the host from the
    same secret keys, input ciphertexts and test vectors: every lane of
    both decodes to f(x), and each lane's phase lies within ``SIGMAS``
    times sqrt(sd_program^2 + sd_reference^2) of the reference's, the sd
    being each side's RMS distance from f(x) / 32 over the 16 lanes."""
    import time

    from gpubench import manifest, system, traffic
    from gpubench.reference import gates as ref_gates

    bench = manifest.Bench(ROOT)
    cfg = bench.config("uint4")
    seed, k, lanes = 2 ** 32 + 24, 3, 16
    mix = traffic.draw(bench.traffic("lut_b2048"), seed)
    prog = manifest.kind("lut").Program(cfg, seed, cuda_dev)
    pool = prog.encrypt(mix)
    for i in range(mix.warm_calls):
        prog.apply(pool, mix.batch(i))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = prog.apply(pool, k).cpu()
    call_s = time.perf_counter() - t0
    fn_ids, cts, tvs = pool
    ct = cts[k, :lanes].cpu()
    tv = tvs[fn_ids[k, :lanes]].cpu()
    prog.free()
    s0, s1 = system.secret_keys(seed, cfg["n0"], cfg["N"])
    t0 = time.perf_counter()
    keys = pbs32.make_keys(torch.Generator().manual_seed(seed),
                           torch.from_numpy(s0), torch.from_numpy(s1), cfg)
    ref = pbs32.bootstrap_lut(ct, tv, keys, cfg)
    ref_s = time.perf_counter() - t0
    want = ref_lut.expected(mix.functions, mix.fn_ids[k, :lanes],
                            mix.x[k, :lanes], mix.message_modulus)
    got = {"program": out[:lanes].numpy(), "reference": ref.numpy()}
    judged = {n: ref_lut.judge(v, s0, 32, want, mix.message_modulus)
              for n, v in got.items()}
    ph = {n: ref_gates.phases(v, s0, 32).astype(np.int64)
          for n, v in got.items()}
    d = (ph["program"] - ph["reference"]) % 2 ** 32
    d = np.where(d >= 2 ** 31, d - 2 ** 32, d) / 2.0 ** 32
    combined = np.hypot(judged["program"]["noise_sd"],
                        judged["reference"]["noise_sd"])
    print(json.dumps({"call_s": call_s, "reference_s": ref_s,
                      "judged": judged, "combined_sd": combined,
                      "max_phase_difference": float(np.abs(d).max()),
                      "device": torch.cuda.get_device_name(cuda_dev)}))
    assert judged["program"]["wrong"] == 0 and judged["reference"]["wrong"] == 0
    assert np.abs(d).max() <= SIGMAS * combined
