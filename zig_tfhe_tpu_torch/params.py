"""TFHE security parameter sets as runtime configuration objects.

A copy of zig_tfhe_tpu/params.py, kept field-for-field identical (the
JAX package imports jax at package level, so the port cannot import it;
tests/test_torch_params.py holds the two copies equal).  The port adds one
set the JAX package lacks, ``SECURITY_TFHERS_2_2`` (tfhe-rs's default
64-bit key).

The reference (params.zig) pins one parameter set at comptime
(params.zig:386-416) so every ciphertext array length is a compile-time
constant and switching security levels requires recompiling.  Here parameter
sets are frozen dataclasses: all shapes are static Python values, so all
sets coexist at runtime.  The PyTorch port runs both torus widths.

Parameter values mirror params.zig:70-378 exactly (80/110/128-bit and
Uint1..Uint8).  A 12th, cryptographically meaningless ``TEST_TINY`` set is
added for fast exact-pipeline unit tests (the reference has no equivalent; its
tests pay 30s keygen, key.zig:240-241).
"""

from __future__ import annotations

import dataclasses

TORUS_SIZE = 32  # params.zig:30
TORUS_MOD = 1 << TORUS_SIZE


@dataclasses.dataclass(frozen=True)
class TlweParams:
    n: int
    alpha: float


@dataclasses.dataclass(frozen=True)
class TrlweParams:
    n: int
    alpha: float


@dataclasses.dataclass(frozen=True)
class TrgswParams:
    n: int
    nbit: int
    bgbit: int
    bg: int
    l: int
    basebit: int
    iks_t: int
    alpha: float


@dataclasses.dataclass(frozen=True)
class SecurityParams:
    """One TFHE parameter set (params.zig:36-43).

    ``torus_bits`` generalizes the discretized-torus width.  The reference
    pins Torus=u32 at comptime (params.zig:21-30); here the width is a
    runtime parameter: 32 (the default, int32 carriers — every stock set)
    or 64 (int64 carriers — the N=2048 door: secure lv1 noise at N=2048
    is ~2^-50 of the torus, which underflows u32; see docs/TORUS64.md).
    The PyTorch port runs both widths (int64 carriers at 64; the N > 1024
    sets on the split-ring engine, ops/split_ring.py).
    """

    security_bits: int
    description: str
    tlwe_lv0: TlweParams
    tlwe_lv1: TlweParams
    trlwe_lv1: TrlweParams
    trgsw_lv1: TrgswParams
    name: str = ""
    torus_bits: int = 32

    # ----- derived shape/constant helpers (all static Python ints) -----

    @property
    def n0(self) -> int:
        """LWE lv0 dimension (mask length)."""
        return self.tlwe_lv0.n

    @property
    def n1(self) -> int:
        """LWE lv1 dimension == ring degree N."""
        return self.tlwe_lv1.n

    @property
    def N(self) -> int:
        """Ring polynomial degree."""
        return self.trgsw_lv1.n

    @property
    def L(self) -> int:
        return self.trgsw_lv1.l

    @property
    def bgbit(self) -> int:
        return self.trgsw_lv1.bgbit

    @property
    def nbit(self) -> int:
        return self.trgsw_lv1.nbit

    @property
    def basebit(self) -> int:
        return self.trgsw_lv1.basebit

    @property
    def iks_t(self) -> int:
        return self.trgsw_lv1.iks_t

    @property
    def ksk_alpha(self) -> float:
        """Key-switching key noise (params.zig:419)."""
        return self.tlwe_lv0.alpha

    @property
    def bsk_alpha(self) -> float:
        """Bootstrapping key noise (params.zig:422)."""
        return self.tlwe_lv1.alpha

    @property
    def torus_mod(self) -> int:
        """2^torus_bits (the discretized-torus modulus)."""
        return 1 << self.torus_bits

    @property
    def decomposition_offset(self) -> int:
        """Gadget decomposition offset, mod 2^torus_bits (key.zig:121-131).

        offset = sum_i (Bg/2) * 2^(torus_bits - (i+1)*bgbit)
        """
        w = self.torus_bits
        off = 0
        for i in range(self.L):
            off = (off + (self.trgsw_lv1.bg // 2)
                   * (1 << (w - (i + 1) * self.bgbit))) % (1 << w)
        return off

    @property
    def ks_prec_offset(self) -> int:
        """Key-switch rounding offset 2^(w-(1+basebit*iks_t)) (trgsw.zig:483)."""
        return 1 << (self.torus_bits - (1 + self.basebit * self.iks_t))

    @property
    def ks_balance_offset(self) -> int:
        """Balancing offset for *signed*-digit key-switch decomposition.

        The reference decomposes key-switch digits unsigned and stores
        base*iks_t*N KSK entries, skipping k=0 (key.zig:148-172).  This
        framework uses signed digits in [-base/2, base/2) so the whole key
        switch becomes ONE int8 matmul on the MXU; the KSK then needs only a
        single entry per (i, j).  Balancing uses the same offset trick as the
        gadget decomposition: add sum_j (base/2)*2^(32-(j+1)*basebit).
        """
        w = self.torus_bits
        off = 0
        base = 1 << self.basebit
        for j in range(self.iks_t):
            off = (off + (base // 2)
                   * (1 << (w - (j + 1) * self.basebit))) % (1 << w)
        return off

    @property
    def split_ring(self) -> bool:
        """True when ring products run on the even/odd split engine.

        The matmul-NTT engine's int8 residue-limb cap leaves only 44.8
        bits of CRT primes p ≡ 1 (mod 2N) at N=2048 — a direct transform
        is impossible (docs/TORUS64.md §3), so N > 1024 sets factor the
        ring as Z[X]/(X^N+1) ≅ pairs over Y=X^2 on the N/2 plan
        (ops/split_ring.py).  Purely size-derived: no flag to keep in
        sync with N.
        """
        return self.N > 1024

    @property
    def digit_limbs(self) -> int:
        """Number of signed int8 limbs needed for a gadget digit.

        Digits lie in [-Bg/2, Bg/2); k signed 8-bit limbs cover
        [-2^(8k-1), 2^(8k-1)), so we need ceil over 8-bit groups of bgbit.
        """
        return -(-self.bgbit // 8)

    @property
    def ks_digit_limbs(self) -> int:
        """int8 limbs per key-switch digit (basebit <= 8 everywhere => 1)."""
        return -(-self.basebit // 8)

    def __hash__(self):
        return hash((self.name, self.security_bits, self.torus_bits))


def _sp(name, bits, desc, n0, a0, a1, nbit, bgbit, l, basebit, iks_t, N=1024,
        torus_bits=32):
    return SecurityParams(
        name=name,
        security_bits=bits,
        description=desc,
        tlwe_lv0=TlweParams(n=n0, alpha=a0),
        tlwe_lv1=TlweParams(n=N, alpha=a1),
        trlwe_lv1=TrlweParams(n=N, alpha=a1),
        trgsw_lv1=TrgswParams(
            n=N, nbit=nbit, bgbit=bgbit, bg=1 << bgbit, l=l,
            basebit=basebit, iks_t=iks_t, alpha=a1,
        ),
        torus_bits=torus_bits,
    )


# params.zig:70-95
SECURITY_80_BIT = _sp("80bit", 80, "80-bit security (performance-optimized)",
                      550, 5.0e-5, 3.73e-8, 10, 6, 3, 2, 7)
# params.zig:98-123
SECURITY_110_BIT = _sp("110bit", 110, "110-bit security (balanced, original TFHE)",
                       630, 3.0517578125e-05, 2.9802322387695313e-08, 10, 6, 3, 2, 8)
# params.zig:350-378
SECURITY_128_BIT = _sp("128bit", 128, "128-bit security (high security, quantum-resistant)",
                       700, 2.0e-5, 2.0e-8, 10, 6, 3, 2, 9)
# params.zig:126-151
SECURITY_UINT1 = _sp("uint1", 1, "Uint1 parameters (1-bit binary/boolean, messageModulus=2, N=1024)",
                     700, 2.0e-05, 2.0e-08, 10, 10, 2, 2, 8)
# params.zig:154-179
SECURITY_UINT2 = _sp("uint2", 2, "Uint2 parameters (2-bit messages, messageModulus=4, N=1024)",
                     687, 0.00002120846893069971872305794214,
                     0.00000000000231841227527049948463, 10, 18, 1, 4, 3)
# params.zig:182-207
SECURITY_UINT3 = _sp("uint3", 3, "Uint3 parameters (3-bit messages, messageModulus=8, N=1024)",
                     820, 0.00000251676160959795544987084234,
                     0.00000000000000022204460492503131, 10, 23, 1, 6, 2)
# params.zig:210-235
SECURITY_UINT4 = _sp("uint4", 4, "Uint4 parameters (4-bit messages, messageModulus=16, N=1024)",
                     820, 0.00000251676160959795544987084234,
                     0.00000000000000022204460492503131, 10, 22, 1, 5, 3)
# params.zig:238-263
SECURITY_UINT5 = _sp("uint5", 5, "Uint5 parameters (5-bit messages, messageModulus=32, N=1024)",
                     1071, 7.088226765410429399593757e-08,
                     2.2204460492503131e-17, 10, 22, 1, 6, 3)
# params.zig:266-291
SECURITY_UINT6 = _sp("uint6", 6, "Uint6 parameters (6-bit messages, messageModulus=64, N=1024)",
                     1071, 7.088226765410429399593757e-08,
                     2.2204460492503131e-17, 10, 22, 1, 6, 3)
# params.zig:294-319
SECURITY_UINT7 = _sp("uint7", 7, "Uint7 parameters (7-bit messages, messageModulus=128, N=1024)",
                     1160, 1.966220007498402695211596e-08,
                     2.2204460492503131e-17, 10, 22, 1, 7, 3)
# params.zig:322-347
SECURITY_UINT8 = _sp("uint8", 8, "Uint8 parameters (8-bit messages, messageModulus=256, N=1024)",
                     1160, 1.966220007498402695211596e-08,
                     2.2204460492503131e-17, 10, 22, 1, 7, 3)

# Fast exact-pipeline test set (NOT SECURE; no reference analog).  alpha=0 so
# the full gate pipeline is deterministic; margins: modswitch phase error
# <= (n0+1)/(4N) = 9/256 << 1/8, gadget truncation 2^-12, KS truncation 2^-16.
TEST_TINY = _sp("tiny", 0, "INSECURE tiny test-only parameters",
                8, 0.0, 0.0, 6, 6, 2, 2, 8, N=64)

# Tiny 64-BIT-TORUS test set (NOT SECURE; alpha=0 exact pipeline).  Same
# shape story as TEST_TINY but with int64 carriers: margins are modswitch
# phase error <= (n0+1)/(4N) = 9/256 << 1/8, gadget truncation 2^-13
# (L*bgbit = 12 of 64 bits decomposed, remainder centered), KS truncation
# 2^-17.  Exercises the width-generalized pipeline (the N=2048 door —
# docs/TORUS64.md); requires jax_enable_x64.
TEST_TINY64 = _sp("tiny64", 0, "INSECURE tiny 64-bit-torus test-only parameters",
                  8, 0.0, 0.0, 6, 6, 2, 2, 8, N=64, torus_bits=64)

# Tiny split-ring test set: N=2048 on the 64-bit torus, alpha=0 — the
# even/odd split engine's exact-pipeline proof (ops/split_ring.py,
# docs/TORUS64.md §4).  NOT SECURE (n0=8).  Margins: modswitch phase error
# <= (n0+1)/(4N) = 9/8192, gadget truncation 2^(64-L*bgbit) = 2^48
# statistical amplitude ~sqrt(N/2)*2^47 ~ 2^52 (2^-12 of the torus), BSK
# rounding at the engine's default drop=32 (the hi-plane-scan threshold)
# a deterministic |conv| <= R*N*(Bg/2)*2^31 ~ 2^52 (2^-12 relative per
# step, ~2^-8 worst-case over the 4-step scan; statistically ~2^-17), KS
# truncation
# 2^(64-1-basebit*iks_t) with n1=2048 -> ~2^-14 relative — all far inside
# the 1/16 gate margin.  Requires jax_enable_x64.
TEST_TINY_SPLIT = _sp("tiny_split", 0,
                      "INSECURE N=2048 split-ring 64-bit-torus test-only "
                      "parameters",
                      8, 0.0, 0.0, 11, 8, 2, 4, 6, N=2048, torus_bits=64)

# 128-bit N=2048/64-bit-torus set (docs/TORUS64.md §6, docs/SECURITY.md),
# pinned by the in-tree primal-uSVP estimator (utils/security.py) under
# the ecosystem-standard sieve gate-count model: lv0 (n=768, sigma 2^-17)
# -> 139.4 gate bits (109.5 core-SVP classical), lv1 (N=2048, k=1, sigma
# 2^-49) -> 137.0 gate bits (105.7 core-SVP) — both >= 128 with ~10 bits
# of model margin, and both strictly dominate the audited public tfhe-rs
# Q=2^64 corpus point (n=742 @ 2^-17.1 lwe / N=2048 @ 2^-51.5 glwe: more
# dimension AND more noise on each level).  Noise budget at the
# bg8/(3,2) asymmetric gadget, basebit2/iks_t12 (all torus-relative):
# KS sqrt(2048*12*1.5)*2^-17 = 2^-9.4, modswitch sqrt(768/12)/4096 =
# 2^-9.2, a-side gadget truncation (key-amplified: rho_a enters as
# s * rho_a, a sqrt(N/2) x sqrt(steps) amplification) 2^-25 * 18.5 *
# 19.6 = 2^-16.5, b-side 2^-13.5, BSK accumulation ~2^-15 (drop=32,
# the hi-plane-scan threshold; ops/ntt.py:default_drop_bits) -> total
# sigma ~2^-8.7 vs the 1/16 gate margin = ~26 sigma.  Both precision gadgets
# here are measurement-tuned (docs/TORUS64.md §8): the first cut ran
# basebit4/iks_t6 KS (sigma_KS = 2^-8.0 — ON the m=64 LUT half-bin;
# measured accuracy 0.52) and an L=2 / (2,2) gadget whose key-amplified
# a-remainder alone is sigma ~2^-8.2 (measured via the phase probe:
# no bias, pure noise) — L=3 picks the (3,2) default and removes that
# term for +25% rotation rows.  Single-shot m=64 remains modswitch-
# limited at ~2.3 sigma — m<=32 is the solid single-shot envelope; use
# the radix route above that.  The in-tree estimator models the primal
# attack only (no hybrid) — see docs/SECURITY.md for scope.  Runs on
# the even/odd split-ring engine (ops/split_ring.py); requires
# jax_enable_x64.  Not in ALL_PARAMS (the reference-parity tuple).
SECURITY_128_BIT_T64 = _sp(
    "128bit_t64", 128,
    "128-bit N=2048 64-bit-torus parameters (in-tree gate-model estimate "
    "139/137 bits, docs/SECURITY.md)",
    768, 2 ** -17.0, 2 ** -49.0, 11, 8, 3, 2, 12, N=2048, torus_bits=64)

# tfhe-rs's default 64-bit key: zama-ai/tfhe-rs, tag tfhe-rs-0.4.0,
# tfhe/src/shortint/parameters/mod.rs, PARAM_MESSAGE_2_CARRY_2_KS_PBS (the
# default of its integer and high-level API in that release):
# lwe_dimension 742, glwe_dimension 1, polynomial_size 2048,
# lwe_modular_std_dev 7.069849454709433e-06 (2^-17.1),
# glwe_modular_std_dev 2.9403601535432533e-16 (2^-51.6), pbs_base_log 23,
# pbs_level 1, ks_base_log 3, ks_level 5, ciphertext modulus 2^64 (native).
# 128 is the publisher's claim; the in-tree estimator (utils/security.py)
# scores lv0 133.7 gate bits (104.0 core-SVP classical) and lv1 129.7
# gate bits (98.4 core-SVP).  The published digit (2^23) is wider than one
# int8 limb, so the NTT key is made at the one-limb engine gadget 2^8 with
# (3, 2) levels (ops/ntt.py:default_engine_gadget), not at tfhe-rs's
# 2^23 x 1.  Runs on the split-ring engine.  Not in ALL_PARAMS (the
# reference-parity tuple); the JAX package has no such set.
SECURITY_TFHERS_2_2 = _sp(
    "tfhers_2_2", 128,
    "tfhe-rs 0.4.0 PARAM_MESSAGE_2_CARRY_2_KS_PBS (N=2048, n=742, 64-bit "
    "torus; gate model 133.7/129.7 bits)",
    742, 7.069849454709433e-06, 2.9403601535432533e-16, nbit=11, bgbit=23,
    l=1, basebit=3, iks_t=5, N=2048, torus_bits=64)

# Backwards-compatible alias: the round-4 spike shipped this set under a
# DRAFT_ name with corpus-tracked alphas and the claim deferred; the
# in-tree estimator (landed later the same round) retuned and pinned it.
DRAFT_SECURITY_128_BIT_T64 = SECURITY_128_BIT_T64

# Estimator-compliant 32-bit boolean set (VERDICT r4 #4).  The inherited
# reference constants (params.zig:350-378, = SECURITY_128_BIT) score
# 126.4 gate bits on lv1 under the in-tree calibrated gate model — 1.6
# bits short of their name.  This set keeps every shape and the lv0
# instance (n=700 @ 2^-15.6 -> 136.9 gate bits / 136.3 dual) and raises
# ONLY the lv1 noise to 2^-24.8 (-> 130.4 gate bits primal / 130.2
# dual; core-SVP classical 100.2): alpha1 enters the gate noise budget
# solely through the BSK rows' encryption noise, a measured ~0.9% of
# the output variance at the group-3 engine gadget (margin/sigma 6.59
# -> 6.56) — the honest claim costs nothing operationally.  128bit
# itself stays bit-identical to the reference (ALL_PARAMS is the parity
# surface); benchmark rows state which set they ran on.
SECURITY_128_BIT_V2 = _sp(
    "128bit_v2", 128,
    "128-bit boolean parameters, estimator-pinned (gate model 136.9/"
    "130.4 bits, docs/SECURITY.md; reference-parity shapes, lv1 noise "
    "raised 2^-25.6 -> 2^-24.8)",
    700, 2.0e-5, 2 ** -24.8, 10, 6, 3, 2, 9)

# Tiny multi-bit (Uint-style) test set: N=256 supports message modulus up to
# 16 with modswitch error (n0+1)/(4N) = 9/1024 < 1/(2*16); bgbit=11 forces
# the 2-limb digit path the real Uint sets use.  NOT SECURE.
TEST_TINY_UINT = _sp("tiny_uint", 0, "INSECURE tiny multi-bit test-only parameters",
                     8, 0.0, 0.0, 8, 11, 2, 4, 3, N=256)

DEFAULT_SECURITY = SECURITY_128_BIT  # params.zig:378

ALL_PARAMS = (
    SECURITY_80_BIT, SECURITY_110_BIT, SECURITY_128_BIT,
    SECURITY_UINT1, SECURITY_UINT2, SECURITY_UINT3, SECURITY_UINT4,
    SECURITY_UINT5, SECURITY_UINT6, SECURITY_UINT7, SECURITY_UINT8,
)

PARAMS_BY_NAME = {p.name: p for p in ALL_PARAMS
                  + (TEST_TINY, TEST_TINY_UINT, TEST_TINY64,
                     TEST_TINY_SPLIT, SECURITY_128_BIT_T64,
                     SECURITY_128_BIT_V2, SECURITY_TFHERS_2_2)}
PARAMS_BY_NAME["draft128_t64"] = SECURITY_128_BIT_T64  # round-4 spike name


def security_info(params: SecurityParams) -> str:
    """Human-readable description (params.zig:381-383)."""
    return f"Security level: {params.security_bits} bits ({params.description})"
