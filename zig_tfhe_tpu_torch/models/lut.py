"""Programmable (LUT) bootstrapping: encoder, generator, lookup tables,
multi-value and tree PBS.

Counterpart of zig_tfhe_tpu/models/lut.py (the reference's lut/ package,
encoder.zig, generator.zig, lookup_table.zig, plus the batched
``bootstrap_lut`` the reference documents but does not ship, lut.zig:42),
on the 32-bit and the 64-bit torus (int64 tables and codec on the 64-bit
sets).  Test vectors are built on the host with numpy (key-independent,
cached where the JAX package caches them); evaluation is the batched blind
rotation of ops/blind_rotate.py, which on a uint key runs K2 and K1 at
every step, and on a split-ring key the hi-plane scan with K1.  A batch
can evaluate a different function per lane (per-lane test vectors
[B, 2, N]).

Where a factored (CIM17) table's ||q||_1 exceeds the key's budget
(``mid_norm1_budget``: infinite at width 32, finite on the 64-bit sets'
coarser engine gadget), ``tree_pbs`` and ``bootstrap_multi_lut`` give it a
dedicated blind-rotation lane, as the JAX package does.  Not ported: the
JAX package's ``ZTFHE_NO_INTERLEAVE`` and ``ZTFHE_MID`` switches (the port
runs its defaults) and the TPU knee chunking of the dedicated lanes
(``_rotation_knee``, ``_chunked_blind_rotate``): lanes are independent, so
one rotation over all of them gives the same bits.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Sequence

import numpy as np
import torch

from zig_tfhe_tpu_torch import bootstrap as _bootstrap
from zig_tfhe_tpu_torch import tlwe as _tlwe
from zig_tfhe_tpu_torch import trlwe as _trlwe
from zig_tfhe_tpu_torch.key import CloudKey
from zig_tfhe_tpu_torch.ops.blind_rotate import blind_rotate
from zig_tfhe_tpu_torch.ops.keyswitch import identity_key_switch
from zig_tfhe_tpu_torch.ops.packing_keyswitch import pack_tlwes_blocks
from zig_tfhe_tpu_torch.ops.poly import negacyclic_rotate
from zig_tfhe_tpu_torch.params import SecurityParams
from zig_tfhe_tpu_torch.utils import profiling
from zig_tfhe_tpu_torch.utils.torus import (carrier_dtype, require_width,
                                            torus_constant_w)


def div_round(a: int, b: int) -> int:
    """(a + b/2) // b (generator.zig:253-255)."""
    return (a + b // 2) // b


@dataclasses.dataclass(frozen=True)
class Encoder:
    """Message <-> torus codec with scale 1/(2m) (encoder.zig:29-116);
    encodings are unsigned Python ints mod 2^width."""

    message_modulus: int
    scale: float
    width: int = 32

    def __post_init__(self):
        require_width(self.width)

    @classmethod
    def new(cls, message_modulus: int, width: int = 32) -> "Encoder":
        return cls(message_modulus, 1.0 / (2.0 * message_modulus), width)

    @classmethod
    def with_scale(cls, message_modulus: int, scale: float,
                   width: int = 32) -> "Encoder":
        return cls(message_modulus, scale, width)

    @property
    def _mask(self) -> int:
        return (1 << self.width) - 1

    def encode(self, message: int) -> int:
        """Torus encoding (unsigned Python int mod 2^width)."""
        m = message % self.message_modulus
        return torus_constant_w(m * self.scale, self.width) & self._mask

    def encode_with_scale(self, message: int, scale: float) -> int:
        """Encode with a per-call scale override (encoder.zig:83-93)."""
        m = message % self.message_modulus
        return torus_constant_w(m * scale, self.width) & self._mask

    def decode(self, torus_value: int) -> int:
        f = (int(torus_value) & self._mask) / float(1 << self.width)
        return int(f / self.scale + 0.5) % self.message_modulus

    def decode_bool(self, torus_value: int) -> bool:
        return self.decode(torus_value) != 0


@dataclasses.dataclass
class LookupTable:
    """A trivial TRLWE (a = 0) whose body encodes the function
    (lookup_table.zig:16-77).  ``poly``: numpy int32 [2, N] (int64 on the
    64-bit torus)."""

    poly: np.ndarray

    @classmethod
    def new(cls, N: int, width: int = 32) -> "LookupTable":
        require_width(width)
        return cls(np.zeros((2, N), np.int32 if width == 32 else np.int64))

    @classmethod
    def from_poly(cls, poly) -> "LookupTable":
        """Wrap an existing TRLWE [2, N] as a LUT (lookup_table.zig:33-36);
        it may be a real (a != 0) TRLWE, e.g. a bootstrap's output.  The
        carrier follows the input (int64 kept, anything else int32)."""
        arr = _host(poly)
        arr = np.array(arr, np.int64 if arr.dtype == np.int64 else np.int32,
                       copy=True)
        if arr.ndim != 2 or arr.shape[0] != 2:
            raise ValueError(f"LUT poly must be [2, N], got {arr.shape}")
        return cls(arr)

    def get_poly(self) -> np.ndarray:
        """The underlying TRLWE polynomial (lookup_table.zig:38-48)."""
        return self.poly

    def is_empty(self) -> bool:
        return not np.any(self.poly)

    def clear(self) -> None:
        self.poly[:] = 0

    def copy_from(self, other: "LookupTable") -> None:
        self.poly[:] = other.poly

    def as_torch(self, device="cuda") -> torch.Tensor:
        return torch.from_numpy(self.poly).to(device)


def _host(a) -> np.ndarray:
    """A table (LookupTable, tensor on any device, or array) on the host."""
    if isinstance(a, LookupTable):
        return a.poly
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass
class Generator:
    """Builds LUT test vectors from functions (generator.zig:15-227)."""

    encoder: Encoder
    poly_degree: int
    lookup_table_size: int

    @classmethod
    def new(cls, message_modulus: int, params: SecurityParams) -> "Generator":
        return cls(Encoder.new(message_modulus, params.torus_bits),
                   params.N, params.N)

    @classmethod
    def with_scale(cls, message_modulus: int, scale: float,
                   params: SecurityParams) -> "Generator":
        return cls(Encoder.with_scale(message_modulus, scale,
                                      params.torus_bits),
                   params.N, params.N)

    def _build(self, encoded: Sequence[int]) -> LookupTable:
        """Shared tail of generateLookupTable*Assign (generator.zig:85-191):
        fill per-message ranges, rotate left by N/(2m), two's-complement
        negate the wrapped tail, store as trivial TRLWE body."""
        n = self.lookup_table_size
        m = self.encoder.message_modulus
        w = self.encoder.width
        udt, sdt = (np.uint32, np.int32) if w == 32 else (np.uint64, np.int64)
        raw = np.zeros(n, udt)
        for x in range(m):
            start = div_round(x * n, m)
            end = div_round((x + 1) * n, m)
            raw[start:end] = udt(encoded[x])
        offset = div_round(n, 2 * m)
        rotated = np.roll(raw, -offset)  # rotated[i] = raw[(i+offset) % n]
        rotated[n - offset:] = (~rotated[n - offset:] + udt(1))
        lut = LookupTable.new(self.poly_degree, w)
        lut.poly[1, :] = rotated.astype(sdt)
        return lut

    def generate_lookup_table(self, f: Callable[[int], int]) -> LookupTable:
        """LUT of f: message -> message (generator.zig:63-135)."""
        m = self.encoder.message_modulus
        return self._build([self.encoder.encode(f(x)) for x in range(m)])

    def generate_lookup_table_full(self, f: Callable[[int], int]) -> LookupTable:
        """LUT of f: message -> raw torus value (generator.zig:155-191)."""
        m = self.encoder.message_modulus
        mask = (1 << self.encoder.width) - 1
        return self._build([int(f(x)) & mask for x in range(m)])

    def generate_lookup_table_custom(self, f: Callable[[int], int],
                                     message_modulus: int,
                                     scale: float) -> LookupTable:
        """Custom modulus/scale variant (generator.zig:202-212)."""
        tmp = Generator(Encoder.with_scale(message_modulus, scale,
                                           self.encoder.width),
                        self.poly_degree, self.lookup_table_size)
        return tmp.generate_lookup_table(f)

    def mod_switch(self, x: int) -> int:
        """Torus -> [0, lookup_table_size) (generator.zig:223-227)."""
        mask = (1 << self.encoder.width) - 1
        scaled = ((int(x) & mask) / float(mask)) * self.lookup_table_size
        return int(scaled + 0.5) % self.lookup_table_size

    @property
    def message_modulus(self) -> int:
        return self.encoder.message_modulus


def encrypt_message(gen: torch.Generator, message, message_modulus: int,
                    alpha: float, sk: torch.Tensor, width: int = 32):
    """Batched PBS-codec encrypt (tlwe.zig:74-88)."""
    return _tlwe.encrypt_message(gen, message, message_modulus, alpha, sk,
                                 width)


def decrypt_message(ct, message_modulus: int, sk, width: int = 32):
    return _tlwe.decrypt_message(ct, message_modulus, sk, width)


def bootstrap_lut(ct_batch: torch.Tensor, lut, ck: CloudKey) -> torch.Tensor:
    """Programmable bootstrap: apply a LUT to a batch of ciphertexts.

    ct_batch: carrier [B, n0+1] encrypted with the PBS message codec.  lut:
    a LookupTable (shared), a [2, N] table, or [B, 2, N] per-lane test
    vectors.  Returns refreshed carrier [B, n0+1] encrypting f(message):
    blindRotateWithTestvec (trgsw.zig:336-400) -> sampleExtractIndex
    (trlwe.zig:146) -> identityKeySwitching (trgsw.zig:471).  Recorded
    as span ``lut.apply``."""
    with profiling.span("lut.apply", device=ct_batch.device):
        tv = (lut.as_torch(ct_batch.device) if isinstance(lut, LookupTable)
              else torch.as_tensor(lut,
                                   dtype=carrier_dtype(ck.params.torus_bits),
                                   device=ct_batch.device))
        return _bootstrap.bootstrap_with_testvec(ct_batch, tv, ck)


# ---------------------------------------------------------------------------
# Multi-value bootstrapping (CIM17 factoring): K LUTs, one blind rotation
# ---------------------------------------------------------------------------
#
# A Generator-built testvec tv over a power-of-two modulus m factors as
# tv = T0 * q in Z_2^w[X]/(X^N + 1), with T0 = s (1 + X + ... + X^(N-1)),
# s = 2^w / (4m), and q = tv (1 - X) / (2s) sparse (nonzero only at the
# ~m bin edges): T0 (1 - X) = s (1 - X^N) = 2s.  So K LUTs of one input
# cost one blind rotation with T0 and, per LUT, a few static negacyclic
# rotations of the rotated accumulator.  The factored route multiplies the
# rotation's amplitude error by ||q||_1 (the JAX package's module notes and
# docs/NOISE.md section 9; the uint family's deep gadgets leave ample margin).


def multi_lut_base(message_modulus: int, N: int, width: int = 32) -> np.ndarray:
    """The shared testvec T0 (trivial TRLWE [2, N], int32 at width 32,
    int64 at 64) for modulus m."""
    require_width(width)
    m = message_modulus
    if m & (m - 1) or not 1 <= m <= (1 << 30):
        raise ValueError(f"multi-value LUT needs power-of-two modulus, got {m}")
    tv = np.zeros((2, N), np.int32 if width == 32 else np.int64)
    tv[1, :] = (1 << width) // (4 * m)      # < 2^(width-2): fits the carrier
    return tv


@functools.lru_cache(maxsize=None)
def _multi_lut_base_on(message_modulus: int, N: int, width: int,
                       device: torch.device) -> torch.Tensor:
    """multi_lut_base on ``device``, copied there once per (m, N, width,
    device): a multi-value round copies no table from the host.  Callers
    must not mutate it."""
    return torch.from_numpy(multi_lut_base(message_modulus, N, width)).to(device)


def factor_lut(lut, message_modulus: int):
    """Factor a Generator-built LUT: returns (offsets, coeffs, norm1).

    offsets: ascending int tuple; coeffs: centred ints (|c| < m); the
    identity tv == T0 * sum_j c_j X^(o_j) is verified exactly (host
    schoolbook, mod 2^width: int64 tables are 64-bit) before returning.
    Raises ValueError for tables that do not factor (non-trivial a-part,
    non-power-of-two modulus, coefficients off the encode grid)."""
    m = message_modulus
    tv = _host(lut)
    if tv.ndim != 2 or tv.shape[0] != 2:
        raise ValueError(f"LUT poly must be [2, N], got {tv.shape}")
    if np.any(tv[0]):
        raise ValueError("multi-value factoring needs a trivial (a=0) LUT")
    if m & (m - 1) or not 1 <= m <= (1 << 30):
        raise ValueError(f"multi-value LUT needs power-of-two modulus, got {m}")
    width = 64 if tv.dtype == np.int64 else 32
    tv = np.ascontiguousarray(tv, np.int32 if width == 32 else np.int64)
    return _factor_lut_cached(tv[1].tobytes(), tv.shape[1], m, width)


@functools.lru_cache(maxsize=1024)
def _factor_lut_cached(b_bytes: bytes, N: int, m: int, width: int = 32):
    """factor_lut's host factorization and O(nnz N) exactness check, cached
    on the table bytes.  Two constructions, both verified: (1) centred
    mod-2m quotients of the first difference (smallest ||q||_1, ambiguous
    where a jump reaches m); (2) the true differences of the canonical grid
    lifts g = tv / delta in [0, 2m), wrap term c_0 = g_0 + g_{N-1}, used
    only when (1)'s check fails (the JAX package's docstring proves it).
    Width 64 runs the same algebra on numpy uint64, which wraps mod 2^64."""
    if width == 64:
        b = np.frombuffer(b_bytes, np.int64).view(np.uint64)
        d = np.empty(N, np.uint64)
        # a wrap-exact scalar add (numpy warns on uint64 scalar overflow)
        d[0] = np.uint64((int(b[0]) + int(b[N - 1])) & ((1 << 64) - 1))
        d[1:] = b[1:] - b[:-1]
        delta = np.uint64((1 << 64) // (2 * m))
        ones = np.full(N, np.uint64(int(delta) // 2), np.uint64)
    else:
        b = np.frombuffer(b_bytes, np.int32).astype(np.int64) & 0xFFFFFFFF
        # d = (1-X)*tv (negacyclic): d_0 = tv_0 + tv_{N-1}, d_j = tv_j - tv_{j-1}
        d = np.empty(N, np.int64)
        d[0] = b[0] + b[N - 1]
        d[1:] = b[1:] - b[:-1]
        d &= 0xFFFFFFFF
        delta = (1 << 32) // (2 * m)             # = 2s
        ones = np.full(N, delta // 2, np.int64)
    if np.any(d % delta):
        raise ValueError(
            "LUT values are not on the 1/(2m) encode grid; only "
            "generate_lookup_table outputs (power-of-two m) factor")

    def _verify(offsets, coeffs):
        # exact check: T0 * q == tv (schoolbook negacyclic, mod 2^width)
        if width == 64:
            recon = np.zeros(N, np.uint64)
            for j, cj in zip(offsets, coeffs):
                rot = (np.concatenate([np.uint64(0) - ones[N - j:],
                                       ones[:N - j]]) if j else ones)
                recon += np.uint64(cj % (1 << 64)) * rot
            return not np.any(recon - b)
        recon = np.zeros(N, np.int64)
        for j, cj in zip(offsets, coeffs):
            rot = np.concatenate([-ones[N - j:], ones[:N - j]]) if j else ones
            recon += cj * rot
        return not np.any((recon - b) & 0xFFFFFFFF)

    def _pack(c):
        nz = np.nonzero(c)[0]
        return (tuple(int(j) for j in nz), tuple(int(c[j]) for j in nz))

    c = (d // delta).astype(np.int64)            # quotients mod 2m
    c = np.where(c >= m, c - 2 * m, c)           # centred lift
    offsets, coeffs = _pack(c)
    if not _verify(offsets, coeffs):
        g = (b // delta).astype(np.int64)        # canonical lifts [0, 2m)
        c2 = np.empty(N, np.int64)
        c2[1:] = g[1:] - g[:-1]
        c2[0] = g[0] + g[N - 1]
        offsets, coeffs = _pack(c2)
        if not _verify(offsets, coeffs):
            raise ValueError("internal: multi-value factorization check failed")
    return offsets, coeffs, int(np.abs(np.asarray(coeffs)).sum())


def apply_factored(acc: torch.Tensor, offsets, coeffs) -> torch.Tensor:
    """Multiply a rotated accumulator TRLWE batch [..., 2, N] by the
    factored q = sum_j c_j X^(o_j): static negacyclic rotations and
    wrapping multiply-adds on the carrier (exact mod 2^w)."""
    out = None
    for j, c in zip(offsets, coeffs):
        term = negacyclic_rotate(acc, j) if j else acc
        term = term * c
        out = term if out is None else out + term
    if out is None:                              # q == 0: the zero LUT
        out = torch.zeros_like(acc)
    return out


# ---------------------------------------------------------------------------
# Radix (carry-decomposed) PBS: message moduli beyond the modswitch capacity
# ---------------------------------------------------------------------------
#
# Single-shot PBS at N = 1024 is modswitch-limited to m <= ~32
# (docs/NOISE.md section 8).  Carry decomposition encrypts x as two digits
# (x_lo = x mod 16 at modulus 16, x_hi = x // 16 at modulus m/16) and
# evaluates f: [0, m) -> [0, m) as a two-layer tree PBS: one multi-value
# rotation of ct_lo gives, for every hypothesis h of the hi digit, the two
# output-digit tables (kept at lv1); each family's m_hi candidates pack into
# one TRLWE testvec (ops/packing_keyswitch.py); one blind rotation over
# ct_hi selects the true h's block.  Every constituent PBS runs at modulus
# <= 16.


def encrypt_radix_message(gen: torch.Generator, message, message_modulus: int,
                          alpha: float, sk: torch.Tensor, width: int = 32):
    """Encrypt messages of modulus m in 32..256 as (lo, hi) digit
    ciphertexts: lo = message mod 16 at modulus 16, hi = message // 16 at
    modulus m/16, each carrier [B, n0+1] (a scalar gets a batch of one); the
    hi digits draw after the lo ones."""
    m = message_modulus
    if m & (m - 1) or not 32 <= m <= 256:
        raise ValueError(
            f"radix encoding needs a power-of-two modulus in 32..256, "
            f"got {m} (the hi-digit tables must sit on the 1/32 factoring "
            f"grid and the packing blocks must divide N)")
    msg = torch.atleast_1d(torch.as_tensor(message, device=gen.device).long()) % m
    ct_lo = _tlwe.encrypt_message(gen, msg % 16, 16, alpha, sk, width)
    ct_hi = _tlwe.encrypt_message(gen, msg // 16, m // 16, alpha, sk, width)
    return ct_lo, ct_hi


def decrypt_radix_message(cts, message_modulus: int, sk, width: int = 32):
    """Inverse of encrypt_radix_message: (ct_lo, ct_hi) -> int32 [B]."""
    m = message_modulus
    ct_lo, ct_hi = cts
    lo = _tlwe.decrypt_message(ct_lo, 16, sk, width)
    hi = _tlwe.decrypt_message(ct_hi, m // 16, sk, width)
    return (lo + 16 * hi) % m


@functools.lru_cache(maxsize=256)
def radix_lut_testvecs(f: Callable[[int], int], message_modulus: int,
                       params: SecurityParams) -> np.ndarray:
    """The mid layer's 2 * m_hi test vectors: carrier [2, m_hi, 2, N]; [0, h]
    is g_h_lo (f's low output digit, modulus-16 encoding), [1, h] is g_h_hi
    (high digit, modulus-m_hi encoding).  Cached per (f, m, params): pass a
    stable function object to hit the cache."""
    m = message_modulus
    m_hi = m // 16
    gen = Generator.new(16, params)
    tvs = np.zeros((2, m_hi, 2, params.N),
                   np.int32 if params.torus_bits == 32 else np.int64)
    for h in range(m_hi):
        lo = gen.generate_lookup_table(lambda xl, h=h: f(16 * h + xl) % 16)
        hi = gen.generate_lookup_table_custom(
            lambda xl, h=h: (f(16 * h + xl) % m) // 16, 16, 1.0 / (2 * m_hi))
        tvs[0, h] = lo.poly
        tvs[1, h] = hi.poly
    tvs.setflags(write=False)           # cached: callers must not mutate
    return tvs


def bootstrap_lut_radix(ct_lo: torch.Tensor, ct_hi: torch.Tensor,
                        f: Callable[[int], int], message_modulus: int,
                        ck: CloudKey, pksk: torch.Tensor,
                        pksk_basebit: int | None = None,
                        pksk_t: int | None = None):
    """Evaluate f: [0, m) -> [0, m) on radix-encoded inputs (m a power of
    two in 32..256).  ct_lo/ct_hi: carriers [B, n0+1] from
    encrypt_radix_message; pksk: the packing key (gen_packing_ksk, or the
    cloud key's ``pksk``), built at (pksk_basebit, pksk_t) (None: the set's
    defaults).  Returns (out_lo, out_hi) in the same radix encoding, so
    evaluations chain."""
    m = message_modulus
    m_hi = m // 16
    if m & (m - 1) or not 2 <= m_hi <= 16:
        raise ValueError(f"radix LUT supports power-of-two m = 32..256, got {m}")
    tvs = radix_lut_testvecs(f, m, ck.params)                 # [2, mh, 2, N]
    out = tree_pbs(ct_lo, ct_hi, tvs, m_hi, ck, pksk,
                   pksk_basebit=pksk_basebit, pksk_t=pksk_t)  # [B, 2, n0+1]
    return out[:, 0], out[:, 1]


def mid_norm1_budget(ck) -> float:
    """Max ||q||_1 a factored (CIM17) mid-layer table may carry before it
    needs a dedicated blind rotation: the factored route multiplies the
    mid rotation's amplitude error by ||q||_1, which lands on the packed
    value that the select rotation decodes against the modulus-16 half-bin
    (2^-6).  Past the budget a table takes a dedicated blind rotation.  The
    JAX package's docstring derives it:

        sigma_b = 2^-(e*lb+1) sqrt(steps),  sigma_a = 2^-(e*la+1)
                  sqrt(N/6) sqrt(steps),  calibrated x 4 (MID_SIGMA_CAL);
        budget = sqrt((2^-6 / 4.5)^2 - sigma_KS^2)
                 / (4 sqrt(sigma_a^2 + sigma_b^2)),

    sigma_KS = sqrt(n1 t Bks^2 / 12) ksk_alpha.  32-bit sets return inf
    (their deep uint gadgets leave orders of magnitude of margin); the
    formula prices the 64-bit sets' coarser engine gadget."""
    params = ck.params
    if params.torus_bits == 32:
        return math.inf
    e = ck.bsk_bgbit if ck.bsk_bgbit is not None else params.bgbit
    levels = ck.bsk_levels
    la = levels[0] if levels is not None else params.L
    lb = levels[1] if levels is not None else params.L
    steps = -(-params.n0 // max(ck.bsk_group, 1))
    mid_sigma_cal = 4.0           # measured 2.6x + margin (JAX docstring)
    sigma_b = 2.0 ** -(e * lb + 1) * math.sqrt(steps)
    sigma_a = (2.0 ** -(e * la + 1) * math.sqrt(params.N / 6.0)
               * math.sqrt(steps))
    sigma_b = mid_sigma_cal * math.hypot(sigma_a, sigma_b)
    base = 1 << params.basebit
    sigma_ks = (math.sqrt(params.n1 * params.iks_t * base * base / 12.0)
                * params.ksk_alpha)
    target = (1.0 / 64.0) / 4.5
    avail_sq = target * target - sigma_ks * sigma_ks
    if avail_sq <= 0:
        return -1.0
    return math.sqrt(avail_sq) / sigma_b


def _route_tables(ct: torch.Tensor, tables, message_modulus: int,
                  ck: CloudKey) -> torch.Tensor:
    """Rotated accumulators [B, K, 2, N] of K tables of the same inputs ct
    [B, n0+1]: one shared rotation against the all-ones base T0 and a
    factored multiplication per table within the key's ||q||_1 budget
    (``mid_norm1_budget``), one dedicated rotation lane per table over it
    (all of them one blind rotation over D * B lanes, lane d * B + b)."""
    params = ck.params
    N, B = params.N, ct.shape[0]
    tables = [_host(t) for t in tables]
    factored = [factor_lut(t, message_modulus) for t in tables]
    budget = mid_norm1_budget(ck)
    use_fact = [n1 <= budget for _, _, n1 in factored]
    acc = None
    if any(use_fact):
        base = _multi_lut_base_on(message_modulus, N, params.torus_bits,
                                  ct.device)
        acc = blind_rotate(ct, base, ck, params)              # [B, 2, N]
    ded = [i for i, u in enumerate(use_fact) if not u]
    ded_out = None
    if ded:
        tv = torch.from_numpy(np.stack([tables[i] for i in ded])).to(ct.device)
        ded_out = blind_rotate(
            ct.repeat(len(ded), 1), tv.repeat_interleave(B, dim=0), ck,
            params).reshape(len(ded), B, 2, N)
    pos = {i: k for k, i in enumerate(ded)}
    return torch.stack([apply_factored(acc, *factored[i][:2]) if use_fact[i]
                        else ded_out[pos[i]] for i in range(len(tables))],
                       dim=1)


def tree_pbs(ct_in: torch.Tensor, ct_sel: torch.Tensor, tvs, n_blocks: int,
             ck: CloudKey, pksk: torch.Tensor, pksk_basebit: int | None = None,
             pksk_t: int | None = None) -> torch.Tensor:
    """Two-layer tree PBS: F output families, H hypotheses.

    tvs: carrier [F, H, 2, N], Generator-built (modulus-16 grid) test
    vectors; table [fam, h] is the family's LUT of ct_in under hypothesis h
    of the selector.  ct_in: carrier [B, n0+1] at the modulus-16 codec;
    ct_sel: carrier [B, n0+1] at modulus n_blocks (a power of two, 2..16; H
    <= n_blocks, unused blocks packed as zero samples).  Returns carrier
    [B, F, n0+1].

    Mid layer: one blind rotation of ct_in against the all-ones base, then
    one factored multiplication per table (a table over the key's ||q||_1
    budget gets a dedicated rotation lane instead, ``_route_tables``).  Pack layer: each family's
    candidates land on the selector's coefficient blocks.  Select layer:
    interleaved when F == 2 and 2 * n_blocks * 64 <= N (both families in
    one testvec, family fam's hypothesis h on the block centred at
    (2h + fam) N / (2 n_blocks): one rotation lane per input, family 1
    extracted at N / (2 n_blocks)); else one select lane per family."""
    params = ck.params
    N = params.N
    tvs = _host(tvs)
    F, H = tvs.shape[0], tvs.shape[1]
    if n_blocks & (n_blocks - 1) or not 2 <= n_blocks <= 16:
        raise ValueError(f"selector modulus must be a power of two in "
                         f"2..16, got {n_blocks}")
    if H > n_blocks:
        raise ValueError(f"{H} hypotheses exceed {n_blocks} selector blocks")
    B = ct_in.shape[0]
    interleave = F == 2 and 2 * n_blocks * 64 <= N

    outs = _route_tables(ct_in, [tvs[fam, h] for fam in range(F)
                                 for h in range(H)], 16, ck)  # [B, F*H, 2, N]
    lv1 = _trlwe.sample_extract(outs.reshape(B * F * H, 2, N), 0)
    lv1 = lv1.reshape(B, F, H, N + 1)
    if H < n_blocks:                                          # pad blocks
        lv1 = torch.cat([lv1, lv1.new_zeros(B, F, n_blocks - H, N + 1)], dim=2)

    if interleave:
        # [B, 2*n_blocks, N+1]: slot 2h + fam holds family fam, hypothesis h
        mixed = lv1.transpose(1, 2).reshape(B, 2 * n_blocks, N + 1)
        packed = pack_tlwes_blocks(mixed, 2 * n_blocks, pksk, params,
                                   basebit=pksk_basebit, t=pksk_t)  # [B,2,N]
        tr2 = blind_rotate(ct_sel, packed, ck, params)        # one lane a pair
        out0 = _trlwe.sample_extract(tr2, 0)
        out1 = _trlwe.sample_extract(tr2, N // (2 * n_blocks))
        return identity_key_switch(torch.stack([out0, out1], dim=1),
                                   ck.ksk1, params)           # [B, 2, n0+1]

    packed = pack_tlwes_blocks(lv1, n_blocks, pksk, params,
                               basebit=pksk_basebit, t=pksk_t)  # [B,F,2,N]
    sel_rep = ct_sel.repeat_interleave(F, dim=0)              # [B*F, n0+1]
    tr2 = blind_rotate(sel_rep, packed.reshape(B * F, 2, N), ck, params)
    out = identity_key_switch(_trlwe.sample_extract(tr2, 0), ck.ksk1, params)
    return out.reshape(B, F, -1)


def bootstrap_lut_bivariate(ct_x: torch.Tensor, ct_y: torch.Tensor,
                            f2: Callable[[int, int], int], ck: CloudKey,
                            pksk: torch.Tensor, y_modulus: int = 16,
                            out_modulus: int = 16) -> torch.Tensor:
    """Bivariate PBS: out = f2(x, y) mod out_modulus for two
    modulus-16-encoded inputs (ct_y at y_modulus, a power of two 2..16): the
    tree PBS with x as its input and y as its selector, one hypothesis
    table per y value (2 blind-rotation lanes per input).  Returns carrier
    [B, n0+1] at the modulus-16 codec."""
    if out_modulus > 16:
        raise ValueError(f"bivariate output modulus <= 16, got {out_modulus}")
    params = ck.params
    gen = Generator.new(16, params)
    tvs = np.zeros((1, y_modulus, 2, params.N),
                   np.int32 if params.torus_bits == 32 else np.int64)
    for h in range(y_modulus):
        tvs[0, h] = gen.generate_lookup_table(
            lambda x, h=h: f2(x, h) % out_modulus).poly
    return tree_pbs(ct_x, ct_y, tvs, y_modulus, ck, pksk)[:, 0]


def bootstrap_multi_lut(ct_batch: torch.Tensor, luts, message_modulus: int,
                        ck: CloudKey) -> torch.Tensor:
    """K LUTs of the same inputs for one blind rotation.

    ct_batch: carrier [B, n0+1] (PBS codec, modulus m); luts: K
    LookupTables or [2, N] tables (Generator-built, power-of-two m).
    Returns carrier [K, B, n0+1], row k encrypting f_k(message):
    decrypt-equivalent to K bootstrap_lut calls (exactly so at alpha = 0)
    at ~1/K the blind-rotation cost; a table over the key's ||q||_1 budget
    takes its own rotation lane (``_route_tables``)."""
    params = ck.params
    K, B, N = len(luts), ct_batch.shape[0], params.N
    outs = _route_tables(ct_batch, luts, message_modulus, ck).transpose(0, 1)
    lv1 = _trlwe.sample_extract(outs.reshape(K * B, 2, N), 0)
    return identity_key_switch(lv1, ck.ksk1, params).reshape(K, B, -1)
