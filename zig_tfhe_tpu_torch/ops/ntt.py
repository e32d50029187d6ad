"""Matmul-form negacyclic NTT engine — the external product of the port.

Counterpart of zig_tfhe_tpu/ops/ntt.py (read its module docstring for the
design and the exactness proofs, which carry over unchanged).  The host
plan (primes, psi-twisted matrices, CRT constants) is a copy of the JAX
package's; a cloud key's NTT residues therefore load into the port
unchanged.  The torch ops below keep the JAX formulas operation for
operation, so every stage is bit-equal to the reference on equal inputs:

  * forward NTT: int8-limb matmuls against static [N, N] matrices
    (``matmul_i8``) + float-assisted Barrett;
  * pointwise external product and the NTT-domain X^t rotation: int32
    elementwise work with the reference's overflow bounds;
  * inverse NTT + CRT lift: the ``concat`` form (one [2N, N] contraction
    per output limb matrix).  Inside the blind rotation this step is the
    hand-written CUDA kernel ops/cuda/ntt_inverse.py; the function here is
    its plain version and serves ``rotate_via_ntt``.

The TPU-only operand layouts of the JAX package (``i16cast``, ``pack32``,
``split4``, half-width psi rows) and its ``ZTFHE_*`` switches are not
ported: the port runs the JAX defaults (``concat``, full psi rows).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from zig_tfhe_tpu_torch.ops.poly import matmul_i8
from zig_tfhe_tpu_torch.params import SecurityParams
from zig_tfhe_tpu_torch.utils.torus import carrier_dtype, i32_to_i8_limbs


# ---------------------------------------------------------------------------
# Prime / root machinery (host-side, exact Python ints) — copied verbatim
# ---------------------------------------------------------------------------


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for q in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % q == 0:
            return n == q
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@functools.lru_cache(maxsize=None)
def ntt_primes(two_n: int, max_p: int = 63000) -> tuple:
    """All primes p ≡ 1 (mod 2N) with p <= max_p, ascending (the cap keeps
    the residue int8 limb split in range: |barrett output| <= 32639)."""
    return tuple(p for p in range(two_n + 1, max_p + 1, two_n) if _is_prime(p))


def _primitive_2n_root(p: int, two_n: int) -> int:
    """psi with psi^(2N) = 1 and psi^N = -1 mod p."""
    for g in range(2, p):
        psi = pow(g, (p - 1) // two_n, p)
        if pow(psi, two_n // 2, p) == p - 1:
            return psi
    raise ValueError(f"no primitive {two_n}-th root mod {p}")


def _center(a: np.ndarray, p: int) -> np.ndarray:
    """Centered representative in [-p//2, p//2]."""
    return ((a % p) + p // 2) % p - p // 2


def _i8_split(a: np.ndarray):
    """int array (|a| <= 32639) -> (lo, hi) int8 with a == lo + 256*hi."""
    lo = ((a + 128) % 256 - 128).astype(np.int64)
    hi = (a - lo) >> 8
    assert np.all(np.abs(hi) <= 127), np.abs(hi).max()
    return lo.astype(np.int8), hi.astype(np.int8)


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NTTPlan:
    """Static per-(N, bound) transform data (host numpy).

      fwd_lo/hi[i]:     int8 [N, N]   psi-twisted forward NTT matrix limbs
      inv_cat_lo/hi[i]: int8 [2N, N]  limbs of [Minv ; 256*Minv mod p]
      rot[i]:           int16 [2N, N] centered psi^{t(2k+1)} diagonals
      rot_merged:       int16 [2N, n_primes*N] (per-prime tables on lanes)
      crt_e[i]:         int32   e_p mod 2^32 (CRT idempotent)
      crt_theta[i]:     float32 e_p / P
      p_mod:            int32   P mod 2^32
      crt_e64, p_mod64: the same mod 2^64 as int64 bit patterns (the
                        64-bit torus's lift)
    """

    N: int
    primes: tuple
    fwd_lo: tuple
    fwd_hi: tuple
    inv_cat_lo: tuple
    inv_cat_hi: tuple
    rot: tuple
    rot_merged: np.ndarray
    crt_e: tuple
    crt_theta: tuple
    p_mod: int
    crt_e64: tuple = ()
    p_mod64: int = 0

    def __hash__(self):
        return hash((self.N, self.primes))

    def __eq__(self, other):
        if not isinstance(other, NTTPlan):
            return NotImplemented
        return (self.N, self.primes) == (other.N, other.primes)

    @property
    def n_primes(self) -> int:
        return len(self.primes)

    def row_group(self, p: int) -> int:
        """Rows safely accumulated unreduced: group * (0.55p * p/2) < 2^31."""
        return max(1, (2**31 - 1) // (math.ceil(0.55 * p) * (p // 2) + 1))


@functools.lru_cache(maxsize=None)
def make_plan(N: int, bound_bits: int) -> NTTPlan:
    """Plan whose prime product P > 2^(bound_bits + 2) (largest primes
    first; the +2 keeps the CRT f32 rounding margin >= 1/4)."""
    two_n = 2 * N
    avail = ntt_primes(two_n)[::-1]
    primes, logp = [], 0.0
    for p in avail:
        primes.append(p)
        logp += math.log2(p)
        if logp > bound_bits + 2:
            break
    else:
        raise ValueError(
            f"not enough NTT primes for N={N}, bound 2^{bound_bits}")
    primes.sort()
    if primes[0] < 7680:
        raise ValueError(
            f"plan prime {primes[0]} < 7680 breaks the 0.55p barrett "
            f"envelope (N={N}, bound 2^{bound_bits})")

    fwd_lo, fwd_hi, inv_cat_lo, inv_cat_hi, rot = [], [], [], [], []
    crt_e, crt_e64, crt_theta = [], [], []
    P = 1
    for p in primes:
        P *= p
    for p in primes:
        psi = _primitive_2n_root(p, two_n)
        psi_pow = np.ones(two_n, dtype=object)
        for i in range(1, two_n):
            psi_pow[i] = psi_pow[i - 1] * psi % p
        j = np.arange(N)
        k = np.arange(N)
        fwd = psi_pow[(j[:, None] * (2 * k[None, :] + 1)) % two_n].astype(np.int64)
        n_inv = pow(N, p - 2, p)
        # inv[k, n] = N^-1 * psi^{-n(2k+1)}  (rows k frequency, cols n time)
        inv = (psi_pow[(-(j[None, :] * (2 * k[:, None] + 1)))
                       % two_n].astype(np.int64) * n_inv) % p
        t = np.arange(two_n)
        rot_t = psi_pow[(t[:, None] * (2 * k[None, :] + 1)) % two_n].astype(np.int64)

        flo, fhi = _i8_split(_center(fwd, p))
        fwd_lo.append(flo)
        fwd_hi.append(fhi)
        inv_cat = np.concatenate([_center(inv, p), _center(inv * 256, p)], 0)
        clo, chi = _i8_split(inv_cat)
        inv_cat_lo.append(clo)
        inv_cat_hi.append(chi)
        rot.append(_center(rot_t, p).astype(np.int16))

        pp = P // p
        e = pp * pow(pp, p - 2, p)  # e ≡ 1 mod p, ≡ 0 mod others
        crt_e.append(np.int32(np.uint32(e % (1 << 32)).view(np.int32)))
        crt_e64.append(np.int64(np.uint64(e % (1 << 64)).view(np.int64)))
        crt_theta.append(np.float32(e / P))

    return NTTPlan(
        N=N, primes=tuple(primes),
        fwd_lo=tuple(fwd_lo), fwd_hi=tuple(fwd_hi),
        inv_cat_lo=tuple(inv_cat_lo), inv_cat_hi=tuple(inv_cat_hi),
        rot=tuple(rot), rot_merged=np.concatenate(rot, axis=1),
        crt_e=tuple(crt_e), crt_theta=tuple(crt_theta),
        p_mod=int(np.uint32(P % (1 << 32)).view(np.int32)),
        crt_e64=tuple(crt_e64),
        p_mod64=int(np.uint64(P % (1 << 64)).view(np.int64)),
    )


def plan_for_params(params: SecurityParams, drop_bits: int = 0,
                    group: int = 1, levels: int | None = None,
                    bgbit: int | None = None,
                    pseudorandom_key: bool = False) -> NTTPlan:
    """Plan covering one external product + NTT-domain rotation (the JAX
    package's bound: worst case, or the Hoeffding tail bound for
    pseudorandom keys and engine gadgets — ops/ntt.py:plan_for_params).
    Split-ring sets (N > 1024) transform on the N/2 plan under the same
    bound: each output coefficient of a half-product pair still sums N
    true products (ops/split_ring.py)."""
    e = params.bgbit if bgbit is None else bgbit
    la, lb = norm_levels(params, levels, bgbit=e)
    digit_bound = 1 << (e - 1)
    mult = 3 ** group - 1
    key_bound = 1 << (params.torus_bits - 1 - drop_bits)
    bound = mult * (la + lb) * params.N * digit_bound * key_bound
    bits = bound.bit_length()
    if pseudorandom_key or e != params.bgbit:
        tau = (math.sqrt(2 * math.log(2) * 129
                         * mult * (la + lb) * params.N)
               * digit_bound * key_bound)
        bits = min(bits, math.ceil(math.log2(tau)))
    return make_plan(params.N // 2 if params.split_ring else params.N, bits)


def norm_levels(params: SecurityParams, levels,
                bgbit: int | None = None) -> tuple[int, int]:
    """Normalize a decomposition-level spec to (a_levels, b_levels)."""
    l_max = (params.L if bgbit in (None, params.bgbit)
             else params.torus_bits // bgbit)
    if levels is None:
        return l_max, l_max
    if isinstance(levels, tuple):
        la, lb = levels
    else:
        la = lb = int(levels)
    assert 1 <= la <= l_max and 1 <= lb <= l_max, (la, lb, l_max)
    return la, lb


def default_group(params: SecurityParams) -> int:
    """Default multi-bit blind-rotation group: 3 for the boolean sets at
    N >= 1024, 2 otherwise (ops/ntt.py:default_group)."""
    if params.split_ring:
        return 2
    if params.bgbit == 6 and params.L == 3 and params.N >= 1024:
        return 3
    return 2


def default_engine_gadget(params: SecurityParams,
                          group: int = 2) -> tuple[int, tuple[int, int]]:
    """(bgbit_e, (la, lb)) — the gadget the NTT blind rotation runs:
    Bg_e = 2^7 (group >= 3) or 2^8 with (2, 2) levels for the boolean sets,
    the parameter gadget otherwise (ops/ntt.py:default_engine_gadget).
    A split-ring set whose digit is wider than one int8 limb (the JAX
    package has none) takes the one-limb gadget Bg_e = 2^8 instead: a-side
    levels covering at least the parameter gadget's L * bgbit bits, b-side
    levels the 12 bits of ``default_decomp_levels``; the split step's
    kernel takes one-limb digits only (ops/cuda/split_step.py)."""
    if params.bgbit == 6 and params.L == 3 and params.N >= 1024:
        return (7 if group >= 3 else 8), (2, 2)
    if params.split_ring and params.bgbit > 8:
        return 8, (-(-params.L * params.bgbit // 8), -(-12 // 8))
    return params.bgbit, default_decomp_levels(params)


def engine_digit_limbs(bgbit: int) -> int:
    """int8 limbs per engine-gadget digit."""
    return -(-bgbit // 8)


def default_decomp_levels(params: SecurityParams) -> tuple[int, int]:
    """(L, b-levels with >= 12 bits of precision) — the approximate
    asymmetric gadget (ops/ntt.py:default_decomp_levels)."""
    return (params.L, min(params.L, max(1, -(-12 // params.bgbit))))


def default_drop_bits(params: SecurityParams, group: int = 1,
                      bgbit: int | None = None) -> int:
    """BSK rounding bits for the NTT engine (ops/ntt.py:default_drop_bits;
    5 for the 128-bit default group 3 at Bg_e = 2^7, 0 for N < 1024, 32
    on the split-ring sets, whose scan then runs on int32 hi planes)."""
    if params.N < 1024:
        return 0
    if params.split_ring:
        return 32
    base = {1: 12, 2: 13, 3: 12, 4: 12}[group]
    return max(0, base - (params.bgbit if bgbit is None else bgbit))


# ---------------------------------------------------------------------------
# Device copies of the plan tables, one per (plan, device)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanTables:
    fwd_lo: torch.Tensor       # int8 [P, N, N]
    fwd_hi: torch.Tensor
    inv_cat_lo: torch.Tensor   # int8 [P, 2N, N]
    inv_cat_hi: torch.Tensor
    rot_merged: torch.Tensor   # int16 [2N, P*N]


@functools.lru_cache(maxsize=None)
def plan_tables(plan: NTTPlan, device: torch.device) -> PlanTables:
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return PlanTables(
        fwd_lo=dev(np.stack(plan.fwd_lo)), fwd_hi=dev(np.stack(plan.fwd_hi)),
        inv_cat_lo=dev(np.stack(plan.inv_cat_lo)),
        inv_cat_hi=dev(np.stack(plan.inv_cat_hi)),
        rot_merged=dev(plan.rot_merged))


# ---------------------------------------------------------------------------
# Modular primitives (int32 / f32 elementwise)
# ---------------------------------------------------------------------------


def barrett_reduce(v: torch.Tensor, p: int) -> torch.Tensor:
    """r ≡ v (mod p) with |r| <= p/2 + 3*2^-24*|v|, for any int32 v.

    q = round(f32(v) * f32(1/p)), half to even like ``jnp.round``; the
    f32 constant is np.float32(1/p), as in the JAX package."""
    q = torch.round(v.to(torch.float32) * float(np.float32(1.0 / p)))
    return v - q.to(torch.int32) * p


def _limb_pair_combine(lo, hi, p: int, N: int, in_bound: int):
    """Exact (lo_dot + 256*hi_dot) mod p with int32-safe intermediates."""
    hi_max = p // 512 + 1
    if N * in_bound * (128 + 256 * hi_max) < 2**31:
        return barrett_reduce(lo + (hi << 8), p)
    return barrett_reduce(
        barrett_reduce(lo, p) + barrett_reduce(hi, p) * 256, p)


def top_limb_bound(digit_bound: int, digit_limbs: int) -> int:
    """Top-limb magnitude bound of multi-limb digits (ops/ntt.py)."""
    if digit_limbs == 1:
        return digit_bound
    return min(128, (digit_bound >> (8 * (digit_limbs - 1))) + 1)


def ntt_forward(digits: torch.Tensor, plan: NTTPlan, digit_limbs: int = 1,
                digit_bound: int = 128) -> list:
    """Forward NTT of small signed polys.

    digits: int32/int8 [..., N] with |digits| < 2^(8*digit_limbs - 1); the
    top limb is bounded by digit_bound.  Returns a list per prime of int32
    [..., N] centered residues (|.| <= p(1/2 + 2^-6))."""
    if digit_limbs == 1:
        return ntt_forward_limbs([digits.to(torch.int8)], plan, digit_bound)
    limbs = i32_to_i8_limbs(digits, digit_limbs)       # [..., N, n_dl]
    return ntt_forward_limbs([limbs[..., i] for i in range(digit_limbs)],
                             plan, digit_bound)


def ntt_forward_limbs(d8, plan: NTTPlan, top_bound: int) -> list:
    """``ntt_forward`` of digits given as their int8 limbs, little-endian
    (d8[l]: int8 [..., N]; every limb but the top one bounded by 128, the
    top one by ``top_bound``): per prime, each limb's matmul pair and
    ``_limb_pair_combine``, joined by Horner from the top limb down."""
    bounds = [128] * (len(d8) - 1) + [top_bound]
    tabs = plan_tables(plan, d8[0].device)
    out = []
    for i, p in enumerate(plan.primes):
        r = None
        for dl in reversed(range(len(d8))):
            lo = matmul_i8(d8[dl], tabs.fwd_lo[i])
            hi = matmul_i8(d8[dl], tabs.fwd_hi[i])
            yr = _limb_pair_combine(lo, hi, p, plan.N, bounds[dl])
            r = yr if r is None else barrett_reduce(r * 256 + yr, p)
        out.append(r)
    return out


def residue_limbs(v: torch.Tensor):
    """Centered residue -> (lo, hi) int8 limb planes with v == lo + 256*hi.
    Requires |v| <= 32639 (barrett outputs of plan primes satisfy it)."""
    v = v.to(torch.int32)
    lo = ((v + 128) & 255) - 128
    hi = (v - lo) >> 8
    return lo.to(torch.int8), hi.to(torch.int8)


def ntt_inverse_to_crt(res_list, plan: NTTPlan, width: int = 32) -> torch.Tensor:
    """Inverse NTT per prime + exact CRT lift mod 2^width.

    res_list: per prime, int16/int32 [..., N] centered residues
    (|.| <= 0.55p).  Returns the carrier (int32, int64 at width 64) [..., N]
    == the centered-exact convolution mod 2^width, provided its true
    magnitude is < P/4."""
    return crt_combine(ntt_inverse_residues(res_list, plan), plan, width)


def finish_int64(v_hat, acc: torch.Tensor, plan: NTTPlan,
                 drop_bits: int) -> torch.Tensor:
    """acc + (CRT(invNTT(v)) << drop) mod 2^64 on an int64 accumulator:
    K1's int64 variant (ops/cuda/ntt_inverse.py), plain PyTorch ops on any
    device (the JAX package runs it as XLA ops, with no Pallas kernel)."""
    delta = ntt_inverse_to_crt(v_hat, plan, 64)
    return acc + (delta << drop_bits if drop_bits else delta)


def ntt_inverse_residues(res_list, plan: NTTPlan) -> list:
    """Inverse NTT per prime, before the CRT lift: per prime int32 [..., N]
    centered residues x_p.  The ``concat`` form: [lo | hi] limbs @ limbs
    of [Minv ; 256*Minv mod p] (the Pallas step kernel's
    ``_inverse_residues``)."""
    tabs = plan_tables(plan, res_list[0].device)
    xs = []
    for i, p in enumerate(plan.primes):
        lo8, hi8 = residue_limbs(res_list[i])
        limbs = torch.cat([lo8, hi8], dim=-1)                    # [.., 2N]
        z_lo = matmul_i8(limbs, tabs.inv_cat_lo[i])              # <= 2^25
        z_hi = matmul_i8(limbs, tabs.inv_cat_hi[i])
        y = z_lo + barrett_reduce(z_hi, p) * 256                 # <= 2^25.1
        xs.append(barrett_reduce(y, p))
    return xs


def crt_combine(xs, plan: NTTPlan, width: int = 32) -> torch.Tensor:
    """Centered-exact CRT: x mod 2^width from centered residues.

    m = round(sum x_p * e_p / P) with the f32 terms added in prime order;
    valid because |x| < P/4 and the f32 error is < 2^-6."""
    frac = sum(x.to(torch.float32) * float(t)
               for x, t in zip(xs, plan.crt_theta))
    m = torch.round(frac).to(torch.int32)
    if carrier_dtype(width) == torch.int64:
        out = sum(x.to(torch.int64) * int(e) for x, e in zip(xs, plan.crt_e64))
        return out - m.to(torch.int64) * plan.p_mod64
    out = sum(x * int(e) for x, e in zip(xs, plan.crt_e))
    return out - m * plan.p_mod


# ---------------------------------------------------------------------------
# Key material in NTT residue form
# ---------------------------------------------------------------------------


def to_ntt_form(polys: torch.Tensor, plan: NTTPlan, drop_bits: int = 0,
                width: int = 32) -> torch.Tensor:
    """Torus polys [..., N] (carriers at ``width``) -> int16 [n_primes,
    ..., N] residues.

    drop_bits > 0 rounds the polys to their top (width - drop_bits) bits
    first; callers scale the convolution back by 2^drop_bits."""
    x = polys.to(carrier_dtype(width))
    if drop_bits:
        x = (x + (1 << (drop_bits - 1))) >> drop_bits
    res = ntt_forward(x, plan, digit_limbs=width // 8, digit_bound=128)
    out = []
    for r, p in zip(res, plan.primes):
        # final centered reduce to |.| <= p/2 so int16 storage is canonical
        r = r - p * (r > p // 2).to(torch.int32)
        r = r + p * (r < -(p // 2)).to(torch.int32)
        out.append(r.to(torch.int16))
    return torch.stack(out)


def pointwise_extprod(d_hat, key_hat: torch.Tensor, plan: NTTPlan,
                      reduce_output: bool = True) -> list:
    """sum over rows of d_hat[..., R, N] * key_hat[prime][R, C, N] -> per
    prime int32 [..., C, N] residues, exact mod p.

    d_hat: per prime int32 [..., R, N] (<= 0.52p); key_hat: int16
    [n_primes, R, C, N] (<= p/2).  Rows accumulate unreduced in groups of
    ``plan.row_group(p)``.  ``reduce_output=False`` (the rotate-combine
    fold) returns |u| <= p + 768 (two group partials) unreduced."""
    outs = []
    R = key_hat.shape[1]
    for i, p in enumerate(plan.primes):
        g = plan.row_group(p)
        kh = key_hat[i].to(torch.int32)                  # [R, C, N]
        d = d_hat[i].to(torch.int32).unsqueeze(-2)        # [..., R, 1, N]
        parts = []
        for r0 in range(0, R, g):
            part = sum(d[..., r, :, :] * kh[r]
                       for r in range(r0, min(r0 + g, R)))
            parts.append(barrett_reduce(part, p))         # each <= p/2 + 384
        while len(parts) > 2:                             # rare (small primes)
            parts = [barrett_reduce(parts[0] + parts[1], p)] + parts[2:]
        acc = parts[0] if len(parts) == 1 else parts[0] + parts[1]
        if reduce_output and len(parts) > 1:
            acc = barrett_reduce(acc, p)
        outs.append(acc)
    return outs


def rot_rows(t: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    """psi rows for rotation amounts t: int32 [T, n_primes*N]."""
    merged = plan_tables(plan, t.device).rot_merged
    return merged[t.long()].to(torch.int32)


def _bcast(e: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[B, N] diagonal -> [B, 1, ..., N] broadcastable against ``like``."""
    while e.dim() < like.dim():
        e = e.unsqueeze(1)
    return e


def rotate_combine_multi(us, ts, plan: NTTPlan, u_wide: bool = False) -> list:
    """Multi-bit combiner: sum over nonempty subsets S of
    prod_{i in S}(psi^{t_i} - 1) * u_S.

    us: 2^g - 1 per-prime residue lists, indexed by subset mask m - 1;
    each u int32 [B, ..., N] with |.| <= 0.55p, or <= p + 768 with u_wide
    (the pointwise fold).  ts: g int32 [B] rotation amounts.  Returns
    per-prime int32 residues (|.| <= 0.52p).  Overflow accounting as in
    ops/ntt.py:rotate_combine_multi: narrow terms reduce in pairs, wide
    terms one by one; subset diagonals build by binary DP."""
    g = len(ts)
    N = plan.N
    t_cat = torch.cat([t & (2 * N - 1) for t in ts])
    B = ts[0].shape[0]
    rows_all = rot_rows(t_cat, plan)
    outs = []
    for i, p in enumerate(plan.primes):
        raw = rows_all[:, i * N:(i + 1) * N]
        d = {}
        for j in range(g):
            d[1 << j] = raw[j * B:(j + 1) * B] - 1    # |.| <= p/2 + 1
        for m in range(1, 1 << g):
            if m & (m - 1):                           # >= 2 bits set
                low = m & -m
                d[m] = barrett_reduce(d[m ^ low] * d[low], p)
        terms = []
        for m in range(1, 1 << g):
            u = us[m - 1][i].to(torch.int32)
            terms.append((_bcast(d[m], u), u))
        partials = []
        stride = 1 if u_wide else 2
        for a in range(0, len(terms), stride):
            part = terms[a][0] * terms[a][1]
            if stride == 2 and a + 1 < len(terms):
                part = part + terms[a + 1][0] * terms[a + 1][1]
            partials.append(barrett_reduce(part, p))
        outs.append(barrett_reduce(sum(partials), p))
    return outs


def rotate_diag(res_list, t: torch.Tensor, plan: NTTPlan,
                minus_one: bool = True) -> list:
    """Multiply NTT residues by the diagonal of X^t (optionally X^t - 1).

    res_list: per prime int16/int32 [B, ..., N] (wide fold outputs
    accepted); t: int32 [B].  Returns per-prime int32 residues
    (<= 0.52p)."""
    N = plan.N
    rows_all = rot_rows(t & (2 * N - 1), plan)       # X^(2N) == X^0
    outs = []
    for i, p in enumerate(plan.primes):
        row = rows_all[:, i * N:(i + 1) * N]
        if minus_one:
            row = row - 1                              # |.| <= p/2 + 1
        v = res_list[i].to(torch.int32)
        outs.append(barrett_reduce(v * _bcast(row, v), p))
    return outs
