"""The port's programmable bootstrap on tfhe-rs's default 64-bit key
(``gpubench/configs/t64s.json``: the shortint PBS of
PARAM_MESSAGE_2_CARRY_2_KS_PBS) against the plain 64-bit programmable
bootstrap (``gpubench/reference/pbs64.py``), on the CPU, at the
configuration's sizes (N = 2048, PBS 2^23 x 1, key switch 2^3 x 5) with n0
cut to 8 and both noises at 0.

Both take the same secret keys, input ciphertexts and test vectors; each
makes its own cloud key, the program at the configuration's key form
(group 2, Bg_e 2^8 with (3, 2) levels, drop 32, 4 primes: the split ring's
hi-plane scan, K2s's and K1's plain versions) and the reference at
tfhe-rs's own gadgets, one TRGSW a bit.

The blind rotation, phase by phase: on 4 lanes, each with its own
arbitrary int64 test vector (every coefficient a uniform torus value, so
that the low words the hi-plane scan carries aside are nonzero), both
accumulators are decrypted with the lv1 key, and every one of the 4 x
2048 coefficients of the program's phase lies within ``TOL_BR`` of the
reference's.  The reference is itself held to the definition, X^(-phase)
tv with the phase rounded to a multiple of 1/(2N), within ``TOL_REF``.  A
rotation off by one place, another lane's table, or a low word lost or
taken from another lane moves a coefficient by a uniform torus value.

Why ``TOL_BR`` = 2^-9 (~0.00195 of the torus).  With the noises at 0
what is left is each side's gadget rounding; the program's dominates, its
body rounded to 16 bits (2^-17 a coefficient a step, carried through the
multi-bit key's rotation factors over 4 steps), while the reference's 23
bits leave 2^-24.  Read on three seeds (2^31 + 626, 11, 4000000007):
program against reference max 0.000328-0.000434 (RMS 0.000088-0.000116),
a margin of 4.5 below the limit; the reference against the definition
max 0.0000080-0.0000095, under ``TOL_REF`` = 2^-14 (~0.000061, a margin
of 6.4).  The program at the configuration's control key, one b-level
fewer (3, 1), rounds the body to 8 bits: max 0.0095-0.0125, 4.9 times the
limit.

At the bootstrap, 7 functions x 16 inputs (112 lanes), each side decodes
to f(x) with the root mean square of its phase distance from f(x) / 32
within ``TOL`` = 2^-10 (~0.00098).  With the noises at 0 the key switch's
rounding dominates on both sides: each of the ~N/2 = 1024 lv1 key bits
set carries its mask coefficient's rounding to 15 bits, uniform within
2^-16, so the phase error is ~sqrt(1024 / 3) 2^-16 = 0.00028; the
program's blind rotation adds its body's rounding.  Read on the same
seeds: program 0.000379-0.000400, reference 0.000276-0.000304 (a margin
of 2.4 below the limit); the control 0.00258-0.00273 (2.6 above it), and
fails both limits.  The whole file takes ~35 s on one CPU thread, the
reference's blind rotation of all 116 lanes ~18 s of it.
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
from gpubench.reference import pbs64  # noqa: E402

TOL = 2.0 ** -10
TOL_BR = 2.0 ** -9
TOL_REF = 2.0 ** -14
N0, M, SEED, BR_LANES = 8, 16, 2 ** 31 + 626, 4
CFG = dict(json.loads((ROOT / "gpubench/configs/t64s.json").read_text()),
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
    return TP._sp("t64s_cut", 0, "tfhers_2_2 with n0 cut, noises 0", N0,
                  0.0, 0.0, base.nbit, base.bgbit, base.L, base.basebit,
                  base.iks_t, N=base.N, torus_bits=64)


def _encrypt(rng, s0, mu):
    """Noise-free lv0 encryptions of the torus values ``mu`` (int64 [B])."""
    a = rng.integers(-2 ** 63, 2 ** 63 - 1, (len(mu), N0), dtype=np.int64,
                     endpoint=True)
    b = ((a.view(np.uint64) * s0.astype(np.uint64)).sum(1, dtype=np.uint64)
         + np.asarray(mu, dtype=np.int64).view(np.uint64))
    return torch.from_numpy(np.concatenate([a, b.view(np.int64)[:, None]], 1))


def _uniform(rng, shape):
    return rng.integers(-2 ** 63, 2 ** 63 - 1, shape, dtype=np.int64,
                        endpoint=True)


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
    assert tables.dtype == np.int64
    return {"s0": s0, "s1": s1, "fn_ids": fn_ids, "x": x,
            # tfhe-rs's block codec: delta 2^59 = 2^64 / 32 under the
            # padding bit
            "ct": _encrypt(rng, s0, x << 59),
            "tv": torch.from_numpy(tables[fn_ids]),
            "want": ref_lut.expected(names, fn_ids, x, M),
            "br_ct": _encrypt(rng, s0, _uniform(rng, BR_LANES)),
            "br_tv": torch.from_numpy(_uniform(rng, (BR_LANES, 2, N)))}


def _cloud_key(case, key_form):
    from zig_tfhe_tpu_torch import key as TK

    p = _params()
    sk = TK.SecretKey.from_numpy(case["s0"], case["s1"], device="cpu")
    form = dict(key_form, decomp_levels=tuple(key_form["decomp_levels"]))
    ck = TK.CloudKey.generate(torch.Generator().manual_seed(SEED), sk, p,
                              packing_key=False, **form)
    return p, ck


def _phase(acc, s1):
    """[B, 2, N] -> the lv1 phase b - a s1 as torus fractions."""
    ph = acc[:, 1] - acc[:, 0] @ ref64.negacyclic_matrix(torch.from_numpy(s1))
    return ph.double() / 2.0 ** 64


def _wrap(d):
    """Torus fractions of a difference, back into [-1/2, 1/2)."""
    return (d + 0.5) % 1.0 - 0.5


def _reference(case):
    """The reference's blind rotations of the 4 arbitrary lanes and its
    bootstraps of the 112 function lanes, from one blind rotation of all
    of them (``pbs64.bootstrap_lut``'s steps, its per-step cost shared)."""
    keys = pbs64.make_keys(torch.Generator().manual_seed(SEED),
                           torch.from_numpy(case["s0"]),
                           torch.from_numpy(case["s1"]), CFG)
    acc = pbs64.blind_rotate(torch.cat([case["br_ct"], case["ct"]]),
                             torch.cat([case["br_tv"], case["tv"]]), keys, CFG)
    out = pbs64.key_switch(pbs64.sample_extract(acc[BR_LANES:]), keys, CFG)
    return acc[:BR_LANES], out


def sides_for(case):
    """The decrypted blind rotations of the 4 arbitrary lanes (the
    reference's, the program's at its key and at the control key, and the
    definition's) and every function lane judged against f(x), on each
    side."""
    from zig_tfhe_tpu_torch.models import lut as TL
    from zig_tfhe_tpu_torch.ops import blind_rotate as TBR

    ct, tv = case["br_ct"], case["br_tv"]
    s0 = torch.from_numpy(case["s0"])
    ph = (ref64._modswitch(ct[:, N0], N)
          - (ref64._modswitch(ct[:, :N0], N) * s0).sum(1))
    acc, boot = _reference(case)
    rot = {"definition": ref64.rotate(tv, (-ph) % (2 * N)), "reference": acc}
    outs = {"reference": boot}
    for name, form in (("program", CFG["key"]), ("control", CFG["control_key"])):
        p, ck = _cloud_key(case, form)
        rot[name] = TBR.blind_rotate(ct, tv, ck, p)
        outs[name] = TL.bootstrap_lut(case["ct"], case["tv"], ck)
    return ({k: _phase(v, case["s1"]) for k, v in rot.items()},
            {k: ref_lut.judge(v.numpy(), case["s0"], 64, case["want"], M)
             for k, v in outs.items()})


@pytest.fixture(scope="module")
def case(one_thread):
    return case_for(SEED)


@pytest.fixture(scope="module")
def sides(case):
    return sides_for(case)


@pytest.fixture(scope="module")
def rotations(sides):
    return sides[0]


@pytest.fixture(scope="module")
def judged(sides):
    return sides[1]


def test_the_program_takes_the_configurations_key_form(case):
    from zig_tfhe_tpu_torch.ops import blind_rotate_ntt as TBN

    p, ck = _cloud_key(case, CFG["key"])
    assert (ck.bsk_group, ck.bsk_bgbit, ck.bsk_levels, ck.bsk_ntt_drop,
            ck.bsk_ntt.shape[-4]) == (2, 8, (3, 2), CFG["drop"],
                                      CFG["n_primes"])
    form = TBN.key_form(p, ck.bsk_ntt, ck.bsk_ntt_drop, ck.bsk_group,
                        ck.bsk_levels, ck.bsk_bgbit)
    assert form.hi32 and form.path is TBN.Path.FUSED


def test_the_lanes_carry_distinct_tables(case):
    """7 distinct function tables over the 112 lanes, and 4 arbitrary
    ones whose low words (which the hi-plane scan carries aside) are
    nonzero on both components of every lane."""
    assert len(torch.unique(case["tv"][:, 1], dim=0)) == len(
        ref_lut.FUNCTION_NAMES)
    assert len(torch.unique(case["br_tv"].flatten(1), dim=0)) == BR_LANES
    assert bool((case["br_tv"] & 0xFFFFFFFF).ne(0).any(-1).all())


def test_each_lane_rotates_its_own_table(case):
    """The program's blind rotation of 4 lanes, a table each, equals each
    lane's rotation alone with its table shared: bit for bit."""
    from zig_tfhe_tpu_torch.ops import blind_rotate as TBR

    p, ck = _cloud_key(case, CFG["key"])
    ct, tv = case["br_ct"], case["br_tv"]
    together = TBR.blind_rotate(ct, tv, ck, p)
    for i in range(BR_LANES):
        alone = TBR.blind_rotate(ct[i:i + 1], tv[i], ck, p)
        assert torch.equal(together[i:i + 1], alone)


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
    """The program one b-level short, (3, 1): the body rounded to 8 bits."""
    d = _wrap(rotations["control"] - rotations["reference"])
    assert d.abs().max() > TOL_BR
    assert judged["control"]["noise_sd"] > TOL


def test_the_reference_takes_a_table_a_lane_or_one_shared():
    """On two lanes of a shrunken ring, one table shared or the same table
    given a lane each bootstrap alike, and the extraction at 0 keeps the
    phase of the accumulator's coefficient 0."""
    rng = np.random.default_rng(5)
    cfg = dict(CFG, n0=2, N=64)
    s0, s1 = (torch.from_numpy(rng.integers(0, 2, n)) for n in (2, 64))
    keys = pbs64.make_keys(torch.Generator().manual_seed(5), s0, s1, cfg)
    ct = torch.from_numpy(_uniform(rng, (2, 3)))
    tv = torch.from_numpy(_uniform(rng, (2, 64)))
    assert torch.equal(pbs64.bootstrap_lut(ct, tv, keys, cfg),
                       pbs64.bootstrap_lut(ct, tv.expand(2, 2, 64), keys, cfg))
    acc = pbs64.blind_rotate(ct, tv, keys, cfg)
    lv1 = pbs64.sample_extract(acc)
    ph = acc[:, 1, 0] - (acc[:, 0] @ ref64.negacyclic_matrix(s1))[:, 0]
    assert torch.equal(lv1[:, -1] - (lv1[:, :-1] * s1).sum(-1), ph)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda", 0)


# the phase of an output lane against the reference's, in the two sides'
# combined noise: both select the same test-vector coefficient (the same
# input, the same modswitch), so they differ by their noises alone
SIGMAS = 6
# lanes of the timed call run again through the reference: the first
# ``PER_FUNCTION`` of each function, 21 in all
PER_FUNCTION = 3


@pytest.mark.cuda
def test_a_timed_call_at_the_published_widths_agrees_with_the_reference(
        cuda_dev):
    """21 lanes of one timed call of the cell ``t64s.lut_b2048`` (n0 742,
    N 2048, the lv0 and lv1 noises as published, the program's key made
    on the card), the first 3 of each function, run again through the
    reference on the host from the same secret keys, input ciphertexts
    and gathered test vectors: every lane of both decodes to f(x), and
    each lane's phase lies within ``SIGMAS`` times sqrt(sd_program^2 +
    sd_reference^2) of the reference's, the sd being each side's RMS
    distance from f(x) / 32 over the lanes."""
    import time

    from gpubench import manifest, system, traffic
    from gpubench.reference import gates as ref_gates

    bench = manifest.Bench(ROOT)
    cfg = bench.config("t64s")
    seed, k = 2 ** 32 + 26, 5
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
    lanes = np.concatenate([np.flatnonzero(mix.fn_ids[k] == f)[:PER_FUNCTION]
                            for f in range(len(mix.functions))])
    sel = torch.from_numpy(lanes).to(cuda_dev)
    ct = cts[k, sel].cpu()
    tv = tvs[fn_ids[k, sel]].cpu()
    prog.free()
    s0, s1 = system.secret_keys(seed, cfg["n0"], cfg["N"])
    t0 = time.perf_counter()
    keys = pbs64.make_keys(torch.Generator().manual_seed(seed),
                           torch.from_numpy(s0).long(),
                           torch.from_numpy(s1).long(), cfg)
    ref = pbs64.bootstrap_lut(ct, tv, keys, cfg)
    ref_s = time.perf_counter() - t0
    want = ref_lut.expected(mix.functions, mix.fn_ids[k, lanes],
                            mix.x[k, lanes], mix.message_modulus)
    got = {"program": out[lanes].numpy(), "reference": ref.numpy()}
    judged = {n: ref_lut.judge(v, s0, 64, want, mix.message_modulus)
              for n, v in got.items()}
    ph = {n: ref_gates.phases(v, s0, 64).view(np.int64)
          for n, v in got.items()}
    d = (ph["program"] - ph["reference"]).astype(np.float64) / 2.0 ** 64
    combined = np.hypot(judged["program"]["noise_sd"],
                        judged["reference"]["noise_sd"])
    print(json.dumps({"lanes": len(lanes), "call_s": call_s,
                      "reference_s": ref_s, "judged": judged,
                      "combined_sd": combined,
                      "max_phase_difference": float(np.abs(d).max()),
                      "device": torch.cuda.get_device_name(cuda_dev)}))
    assert sorted(set(mix.fn_ids[k, lanes])) == list(range(len(mix.functions)))
    assert judged["program"]["wrong"] == 0 and judged["reference"]["wrong"] == 0
    assert np.abs(d).max() <= SIGMAS * combined
