"""Encrypted radix integer arithmetic on programmable bootstraps.

Counterpart of zig_tfhe_tpu/models/integer.py: multi-digit homomorphic
add/sub/mul/divmod, comparisons (eq/lt and friends), mux/min/max, bitwise
and/or/xor, plain and encrypted-amount shifts, the bridge to the boolean
gates, and the operator-overloaded handles ``FheUint`` and ``FheInt``, all
built from the LUT machinery of models/lut.py.  On equal keys and
ciphertexts every function returns the JAX package's bits.

Representation: little-endian base-8 digits, each digit a PBS message with
modulus M = 16.  The factor-2 headroom makes every intermediate fit the
message space exactly (a digit add is digit + digit + carry <= M - 1; a
digit product x*y is read from the packing w = x + 8*bit_k(y) <= M - 1).

Every round is ONE batched bootstrap over all lanes of all batch elements:
per-lane test vectors gathered from the LUT bank, which lives on the
ciphertexts' device (``_bank``: built once per parameter set and device, so
a round copies no table from the host); rounds that apply several LUTs to
the same input are multi-value bootstraps (one blind rotation for all of
them); the tree-PBS digit multiplier runs when the cloud key holds its
packing key.  On a uint key every rotation is 410 (uint4) steps of K2 then
K1.

Not ported: the JAX package's ``_bucket`` / ``_pad_to_bucket`` padding and
the knee chunking of ``_bootstrap_lut_bucketed`` (TPU compile-cache and
knee workarounds; lanes are independent, so any batching gives the same
bits), and the ``ZTFHE_NO_MULTIVALUE`` switch (multi-value is always on).
Both torus widths run: the carriers follow the ciphertexts (int64 on the
64-bit sets, radix base 8 / M = 16 at both widths).  A multi-value round
whose factored table exceeds the key's ||q||_1 budget (finite only on the
64-bit sets) is demoted to one blind-rotation lane per table, as the JAX
package's ``_pbs_mv_groups`` does.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from zig_tfhe_tpu_torch import tlwe as _tlwe
from zig_tfhe_tpu_torch import trlwe as _trlwe
from zig_tfhe_tpu_torch.key import CloudKey
from zig_tfhe_tpu_torch.models import lut as L
from zig_tfhe_tpu_torch.ops.blind_rotate import blind_rotate
from zig_tfhe_tpu_torch.ops.keyswitch import identity_key_switch
from zig_tfhe_tpu_torch.ops.packing_keyswitch import default_packing_gadget
from zig_tfhe_tpu_torch.params import SecurityParams
from zig_tfhe_tpu_torch.utils.torus import (carrier_dtype, carrier_width,
                                            torus_constant_w)

BASE = 8          # radix of the encrypted integers (32-bit sets)
M = 16            # PBS message modulus per digit (headroom factor 2)


def radix_spec(width: int) -> tuple[int, int, int]:
    """(base_bits, base, message_modulus) for a torus width: base 8 / M = 16
    at both widths (the JAX package's docstring carries the refutation of
    base-16 digits on the 64-bit sets)."""
    del width
    return (3, 8, 16)


def _spec_params(params: SecurityParams) -> tuple[int, int, int]:
    return radix_spec(params.torus_bits)


def _spec_like(x: torch.Tensor) -> tuple[int, int, int]:
    """Spec from a ciphertext's carrier dtype."""
    return radix_spec(carrier_width(x))


# ---------------------------------------------------------------------------
# LUT bank (static per parameter set)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _luts(params: SecurityParams) -> dict:
    """The LUT bank, {name: LookupTable}, parametric in the set's radix
    spec (58 tables at base 8).  Names keep the JAX package's base-8
    spellings ("eq8", "x8", "div8", "sign7", "bit{k}"...): the digits 8/7
    in a name mean "the base" / "base - 1"."""
    bb, base, m = _spec_params(params)
    sbit = bb - 1                 # sign-bit index within a digit
    gen = L.Generator.new(m, params)
    bank = {
        "mod": gen.generate_lookup_table(lambda t: t % base),
        "div": gen.generate_lookup_table(lambda t: t // base),
        # div at the base-x packing scale (division's select bit)
        "div8": gen.generate_lookup_table(lambda t: base * (t // base)),
    }
    for k in range(bb):  # base = 2^bb bit-planes
        # base*bit directly, so the packing add never scales a ciphertext
        bank[f"bit{k}"] = gen.generate_lookup_table(
            lambda y, k=k: base * ((y >> k) & 1))
        # unit-scale bits (shift-in during division)
        bank[f"ubit{k}"] = gen.generate_lookup_table(
            lambda y, k=k: ((y % base) >> k) & 1)
        # w = x + base*b packs (x, b); the LUT returns x*b*2^k split base-B
        bank[f"pp{k}lo"] = gen.generate_lookup_table(
            lambda w, k=k: ((w % base) * (w // base) << k) % base)
        bank[f"pp{k}hi"] = gen.generate_lookup_table(
            lambda w, k=k: ((w % base) * (w // base) << k) // base)
        # bitwise ops on w = x + base*bit_k(y): x's k-th bit with y's
        bank[f"and{k}"] = gen.generate_lookup_table(
            lambda w, k=k: (((w % base) >> k) & 1 & (w // base)) << k)
        bank[f"or{k}"] = gen.generate_lookup_table(
            lambda w, k=k: ((((w % base) >> k) & 1) | (w // base)) << k)
        bank[f"xor{k}"] = gen.generate_lookup_table(
            lambda w, k=k: ((((w % base) >> k) & 1) ^ (w // base)) << k)
    # gates <-> integer bridge: the k-th digit bit at the boolean gate codec
    # (+-1/8), so outputs feed models/gates directly
    for k in range(bb):
        bank[f"boolbit{k}"] = gen.generate_lookup_table_full(
            lambda t, k=k: torus_constant_w(
                0.125 if ((t % base) >> k) & 1 else -0.125,
                params.torus_bits))
    # comparisons / selection
    bank["eq8"] = gen.generate_lookup_table(lambda t: 1 if t == base else 0)
    bank["iszero"] = gen.generate_lookup_table(lambda t: 1 if t == 0 else 0)
    bank["x8"] = gen.generate_lookup_table(lambda t: base * (t & 1))
    # two's complement: sign-bit bias flip for ordered compares, sign
    # digit/boundary fill for arithmetic right shift
    bank["flipsign"] = gen.generate_lookup_table(
        lambda t: (t % base) ^ (base // 2))
    bank["sign7"] = gen.generate_lookup_table(
        lambda t: (base - 1) * ((t % base) >> sbit))
    bank["sign1"] = gen.generate_lookup_table(lambda t: (t % base) >> sbit)
    # signed overflow on packed v = sa + 2*sb + 4*sr: operands agree in
    # sign and the result sign differs
    bank["sovf"] = gen.generate_lookup_table(
        lambda v: 1 if ((v & 1) == ((v >> 1) & 1)
                        and ((v >> 2) & 1) != (v & 1)) else 0)
    # plain-constant digit products
    for c in range(2, base):
        bank[f"mulc{c}lo"] = gen.generate_lookup_table(
            lambda t, c=c: ((t % base) * c) % base)
        bank[f"mulc{c}hi"] = gen.generate_lookup_table(
            lambda t, c=c: ((t % base) * c) // base)
    # sub-digit shifts (r in [1, bb); digit-aligned shifts need no LUT)
    for r in range(1, bb):
        bank[f"signfill{r}"] = gen.generate_lookup_table(
            lambda t, r=r: (base - (1 << (bb - r))) * ((t % base) >> sbit))
        bank[f"masklow{r}"] = gen.generate_lookup_table(
            lambda t, r=r: (t % base) & ((1 << r) - 1))
        bank[f"shl{r}lo"] = gen.generate_lookup_table(
            lambda t, r=r: ((t % base) << r) % base)
        bank[f"shl{r}hi"] = gen.generate_lookup_table(
            lambda t, r=r: ((t % base) << r) // base)
        bank[f"shr{r}"] = gen.generate_lookup_table(
            lambda t, r=r: (t % base) >> r)
        bank[f"low{r}"] = gen.generate_lookup_table(
            lambda t, r=r: ((t % base) & ((1 << r) - 1)) << (bb - r))
    return bank


@functools.lru_cache(maxsize=None)
def _bank(params: SecurityParams, device: torch.device):
    """The LUT bank on ``device``: ({name: row}, carrier [T, 2, N]), built
    once per (parameter set, device)."""
    bank = _luts(params)
    rows = {n: i for i, n in enumerate(bank)}
    tables = torch.from_numpy(np.stack([t.poly for t in bank.values()]))
    return rows, tables.to(device)


def _lane_tables(table_names, repeat: int, ck: CloudKey,
                 device: torch.device) -> torch.Tensor:
    """Per-lane test vectors carrier [len(table_names) * repeat, 2, N]: lane
    l * repeat + b takes table_names[l], gathered from the device bank."""
    rows, tables = _bank(ck.params, device)
    idx = torch.tensor([rows[n] for n in table_names], device=device)
    return tables.index_select(0, idx.repeat_interleave(repeat))


def _pbs(cts, table_names, ck: CloudKey):
    """One batched heterogeneous bootstrap: lane i of ``cts`` [B, n0+1]
    gets the LUT named table_names[i] (a single shared name is allowed)."""
    if isinstance(table_names, str):
        rows, tables = _bank(ck.params, cts.device)
        return L.bootstrap_lut(cts, tables[rows[table_names]], ck)
    return L.bootstrap_lut(cts, _lane_tables(table_names, 1, ck, cts.device),
                           ck)


def _pbs_rows(rows, table_names, ck: CloudKey):
    """Batched multi-lane bootstrap: rows [L, ..., n0+1], one LUT per lane
    broadcast over the batch dims.  Returns [L, ..., n0+1]; the lanes run
    flattened as l * B + b, one bootstrap for all of them."""
    lanes, batch, n1 = rows.shape[0], rows.shape[1:-1], rows.shape[-1]
    B = math.prod(batch)
    flat = rows.reshape(lanes * B, n1)
    tv = _lane_tables(table_names, B, ck, rows.device)          # [L*B, 2, N]
    out = L.bootstrap_lut(flat, tv, ck)
    return out.reshape((lanes,) + batch + (n1,))


@functools.lru_cache(maxsize=None)
def _factored(params: SecurityParams, name: str):
    return L.factor_lut(_luts(params)[name], _spec_params(params)[2])


def _pbs_mv(ct, table_names, ck: CloudKey):
    """K LUTs of the SAME input for one blind rotation (multi-value
    bootstrap, models/lut.py:bootstrap_multi_lut): ct [..., n0+1] ->
    [K, ..., n0+1]."""
    batch, n1 = ct.shape[:-1], ct.shape[-1]
    B = math.prod(batch)
    bank = _luts(ck.params)
    out = L.bootstrap_multi_lut(ct.reshape(B, n1),
                                [bank[n] for n in table_names],
                                _spec_params(ck.params)[2], ck)
    return out.reshape((len(table_names),) + batch + (n1,))


def _pbs_mv_groups(rows, name_groups, ck: CloudKey):
    """Grouped multi-value bootstrap: rows [G, ..., n0+1]; group g's input
    feeds the K LUTs named in name_groups[g].  ONE blind rotation over the
    flattened G*B batch (shared T0 testvec), then per-group factored
    applies.  Returns [G, K, ..., n0+1] (K equal across groups)."""
    G = rows.shape[0]
    K = len(name_groups[0])
    assert all(len(g) == K for g in name_groups), name_groups
    params = ck.params
    # a table over the key's ||q||_1 budget (finite on the 64-bit sets)
    # demotes the whole call to one rotation lane per table
    budget = L.mid_norm1_budget(ck)
    if any(_factored(params, n)[2] > budget for g in name_groups for n in g):
        out = _pbs_rows(rows.repeat_interleave(K, dim=0),
                        [n for g in name_groups for n in g], ck)
        return out.reshape((G, K) + rows.shape[1:])
    batch, n1 = rows.shape[1:-1], rows.shape[-1]
    B = math.prod(batch)
    N = params.N
    flat = rows.reshape(G * B, n1)
    base = L._multi_lut_base_on(_spec_params(params)[2], N, params.torus_bits,
                                rows.device)
    acc = blind_rotate(flat, base, ck, params).reshape(G, B, 2, N)
    outs = torch.stack([
        torch.stack([L.apply_factored(acc[g], *_factored(params, n)[:2])
                     for n in name_groups[g]])
        for g in range(G)])                                   # [G, K, B, 2, N]
    lv1 = _trlwe.sample_extract(outs.reshape(G * K * B, 2, N), 0)
    out = identity_key_switch(lv1, ck.ksk1, params)
    return out.reshape((G, K) + batch + (n1,))


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------


def encrypt_radix(gen: torch.Generator, value, n_digits: int, alpha: float,
                  sk: torch.Tensor, width: int = 32) -> torch.Tensor:
    """Encrypt value(s) as n_digits little-endian radix digits (base 8,
    M = 16) on the generator's device.

    value: Python int or int array [...].  Returns the width's carrier
    [..., n_digits, n0+1].  Digits are extracted in host int64, so values
    beyond 2^31 encode correctly."""
    bb, base, m = radix_spec(width)
    v = np.asarray(value, np.int64)
    shifts = bb * np.arange(n_digits, dtype=np.int64)
    digits = torch.from_numpy((v[..., None] >> shifts) & (base - 1))
    return _tlwe.encrypt_message(gen, digits, m, alpha, sk, width)


def decrypt_radix(ct_digits: torch.Tensor, sk: torch.Tensor):
    """[..., D, n0+1] -> int or int64 array [...]."""
    w = carrier_width(ct_digits)
    bb, base, m = radix_spec(w)
    msgs = _tlwe.decrypt_message(ct_digits, m, sk, w).cpu().numpy() % base
    D = msgs.shape[-1]
    weights = 1 << (bb * np.arange(D, dtype=np.int64))
    out = (msgs.astype(np.int64) * weights).sum(axis=-1)
    return int(out) if out.ndim == 0 else out


def _zeros_like_digit(d):
    return torch.zeros_like(d)


def _trivial_digit(value: int, like: torch.Tensor) -> torch.Tensor:
    """Noiseless (a = 0) ciphertext of ``value`` at the PBS codec scale
    1/(2M), shaped like the digit ciphertext ``like`` [..., n0+1]."""
    w = carrier_width(like)
    m = radix_spec(w)[2]
    assert 0 <= value < m, value
    z = torch.zeros_like(like)
    z[..., -1] = ((1 << w) // (2 * m)) * value
    return z


def _trivial_radix(value: int, D: int, like_digits: torch.Tensor):
    """Noiseless D-digit radix encoding of a non-negative Python int,
    batch-shaped like ``like_digits`` [..., Dl, n0+1].  Digits are
    extracted with Python ints, so constants of any width work."""
    w = carrier_width(like_digits)
    bb, base, m = radix_spec(w)
    enc = [((1 << w) // (2 * m)) * ((value >> (bb * i)) & (base - 1))
           for i in range(D)]                                 # PBS codec
    ct = torch.zeros(like_digits.shape[:-2] + (D, like_digits.shape[-1]),
                     dtype=like_digits.dtype, device=like_digits.device)
    ct[..., -1] = torch.tensor(enc, dtype=ct.dtype, device=ct.device)
    return ct


def _set_digit(digits: torch.Tensor, i: int, d: torch.Tensor) -> torch.Tensor:
    """A copy of ``digits`` [..., D, n0+1] with digit i replaced by d (the
    out-of-place ``.at[..., i, :].set`` of the JAX package)."""
    out = digits.clone()
    out[..., i, :] = d
    return out


# ---------------------------------------------------------------------------
# Addition
# ---------------------------------------------------------------------------


def radix_add(a_digits, b_digits, ck: CloudKey):
    """Exact homomorphic addition: [..., D, n0+1] x2 -> [..., D+1, n0+1].
    Per digit one multi-value rotation over the whole batch: sum = t mod 8,
    carry = t div 8 with t = a + b + carry <= 15."""
    D = a_digits.shape[-2]
    carry = _zeros_like_digit(a_digits[..., 0, :])
    out = []
    for i in range(D):
        t = a_digits[..., i, :] + b_digits[..., i, :] + carry
        both = _pbs_mv(t, ("mod", "div"), ck)    # 1 rotation, 2 LUTs
        out.append(both[0])
        carry = both[1]
    out.append(carry)
    return torch.stack(out, dim=-2)


# ---------------------------------------------------------------------------
# Subtraction / comparison / selection
# ---------------------------------------------------------------------------


def radix_sub(a_digits, b_digits, ck: CloudKey, emit_ge8: bool = False):
    """Exact homomorphic subtraction with borrow chain: (diff [..., D,
    n0+1], borrow [..., n0+1]), a - b = diff - borrow * 8^D.

    Per digit t = a_i - b_i - borrow + B in [0, 2B-1]; diff_i = t mod B and
    the next borrow is 1 - (t div B), a linear flip.  emit_ge8=True adds a
    div8 LUT to the last digit's rotation and returns (diff, borrow, ge8),
    ge8 = B*(a >= b), the pre-scaled select bit radix_select(sel8=)
    takes."""
    D = a_digits.shape[-2]
    assert b_digits.shape[-2] == D, (a_digits.shape, b_digits.shape)
    base = _spec_like(a_digits)[1]
    eight = _trivial_digit(base, a_digits[..., 0, :])
    one = _trivial_digit(1, a_digits[..., 0, :])
    borrow = _zeros_like_digit(a_digits[..., 0, :])
    out = []
    ge8 = None
    for i in range(D):
        t = a_digits[..., i, :] - b_digits[..., i, :] - borrow + eight
        names = ("mod", "div", "div8") if (emit_ge8 and i == D - 1) \
            else ("mod", "div")
        res = _pbs_mv(t, names, ck)              # 1 rotation, 2-3 LUTs
        out.append(res[0])
        borrow = one - res[1]
        if len(res) == 3:
            ge8 = res[2]
    diff = torch.stack(out, dim=-2)
    return (diff, borrow, ge8) if emit_ge8 else (diff, borrow)


def radix_lt(a_digits, b_digits, ck: CloudKey):
    """Encrypted (a < b) bit [..., n0+1] (message 0/1): the final borrow
    of the subtraction chain."""
    return radix_sub(a_digits, b_digits, ck)[1]


def _and_reduce_bits(bits, ck: CloudKey):
    """AND of K encrypted 0/1 bits [K, ..., n0+1] -> [..., n0+1]: chunks of
    <= M-1 bits sum into one message, then iszero(k - sum) in one batched
    rotation per tree level."""
    cap = _spec_like(bits)[2] - 1
    while bits.shape[0] > 1:
        K = bits.shape[0]
        rows = []
        for i in range(0, K, cap):
            c = bits[i:i + cap]
            # dtype= keeps the carrier (torch sums int32 to int64)
            rows.append(_trivial_digit(c.shape[0], c[0])
                        - c.sum(dim=0, dtype=c.dtype))
        bits = _pbs_rows(torch.stack(rows), ("iszero",) * len(rows), ck)
    return bits[0]


def radix_eq(a_digits, b_digits, ck: CloudKey):
    """Encrypted (a == b) bit [..., n0+1] (message 0/1): per-digit equality
    bits eq8(a_i - b_i + B) in one rotation, then an AND tree."""
    D = a_digits.shape[-2]
    eight = _trivial_digit(_spec_like(a_digits)[1], a_digits[..., 0, :])
    t = a_digits - b_digits + eight[..., None, :]
    bits = _pbs_rows(t.movedim(-2, 0), ("eq8",) * D, ck)
    return _and_reduce_bits(bits, ck)


def radix_select(sel, a_digits, b_digits, ck: CloudKey, *, sel8=None):
    """Encrypted mux: sel (0/1 message ct [..., n0+1]) ? a : b.

    One rotation refreshes sel into its 8x form (x8), then every digit of
    both operands packs w = d + 8*s / w = d + 8*(1-s) and one batched pp0lo
    rotation over 2D lanes returns d*s / d*(1-s); the sum is exact.  A
    caller holding the pre-scaled bit passes it as sel8 (sel is ignored)."""
    D = a_digits.shape[-2]
    assert b_digits.shape[-2] == D
    s8 = _pbs_mv(sel, ("x8",), ck)[0] if sel8 is None else sel8
    not8 = _trivial_digit(_spec_like(s8)[1], s8) - s8
    wa = a_digits.movedim(-2, 0) + s8
    wb = b_digits.movedim(-2, 0) + not8
    parts = _pbs_rows(torch.cat([wa, wb]), ("pp0lo",) * (2 * D), ck)
    return (parts[:D] + parts[D:]).movedim(0, -2)


def radix_lt_signed(a_digits, b_digits, ck: CloudKey):
    """Encrypted signed (a < b) on two's-complement radix arrays of equal
    width: one 2-lane flipsign rotation biases both sign digits, then the
    unsigned borrow chain."""
    tops = torch.stack([a_digits[..., -1, :], b_digits[..., -1, :]])
    flipped = _pbs_rows(tops, ("flipsign", "flipsign"), ck)
    return radix_lt(_set_digit(a_digits, -1, flipped[0]),
                    _set_digit(b_digits, -1, flipped[1]), ck)


def radix_asr(a_digits, s: int, ck: CloudKey):
    """Arithmetic (sign-filling) right shift by a PLAIN amount s >= 0 on a
    two's-complement radix array; keeps the width D.  One rotation derives
    the sign digit (sign7) and the boundary fill from the top digit; the
    rest is radix_shr and linear adds on disjoint bits."""
    assert s >= 0
    if s == 0:
        return a_digits
    D = a_digits.shape[-2]
    q, r = divmod(s, _spec_like(a_digits)[0])
    top = a_digits[..., -1, :]
    if q >= D:
        sign7 = _pbs_mv(top, ("sign7",), ck)[0]
        return sign7[..., None, :].expand(
            a_digits.shape[:-2] + (D, top.shape[-1])).contiguous()
    names = ("sign7", f"signfill{r}") if r else ("sign7",)
    fills = _pbs_mv(top, names, ck)
    sh = radix_shr(a_digits, s, ck)                  # [..., D - q, n1]
    if r:
        sh = _set_digit(sh, -1, sh[..., -1, :] + fills[1])
    if q:
        ext = fills[0][..., None, :].expand(sh.shape[:-2] + (q, sh.shape[-1]))
        sh = torch.cat([sh, ext], dim=-2)
    return sh


def radix_min(a_digits, b_digits, ck: CloudKey):
    """Encrypted elementwise min (borrow chain + select)."""
    return radix_select(radix_lt(a_digits, b_digits, ck),
                        a_digits, b_digits, ck)


def radix_max(a_digits, b_digits, ck: CloudKey):
    return radix_select(radix_lt(a_digits, b_digits, ck),
                        b_digits, a_digits, ck)


# ---------------------------------------------------------------------------
# Bitwise ops / shifts
# ---------------------------------------------------------------------------


def radix_bitwise(a_digits, b_digits, op: str, ck: CloudKey):
    """Bitwise and/or/xor of two radix integers (equal widths), 2
    rotations: b's bit-planes (multi-value, base-x scaled), then one
    rotation over bb*D packed lanes w_k = a_i + B*bit_k(b_i) with the
    {op}{k} LUTs; the outputs occupy disjoint bits, so they sum exactly."""
    assert op in ("and", "or", "xor"), op
    bb = _spec_like(a_digits)[0]
    D = a_digits.shape[-2]
    assert b_digits.shape[-2] == D
    bits8 = _pbs_mv(b_digits.movedim(-2, 0),
                    tuple(f"bit{k}" for k in range(bb)), ck)  # [bb, D, ..]
    w = a_digits.movedim(-2, 0)[None] + bits8
    names = tuple(f"{op}{k}" for k in range(bb) for _ in range(D))
    parts = _pbs_rows(w.reshape((bb * D,) + w.shape[2:]), names, ck)
    out = parts.reshape((bb, D) + parts.shape[1:]).sum(dim=0,
                                                       dtype=parts.dtype)
    return out.movedim(0, -2)


def radix_shl(a_digits, s: int, ck: CloudKey):
    """Left shift by a PLAIN amount s >= 0; widens to hold every bit
    ([..., D + ceil(s/bb), n0+1]).  The digit-aligned part prepends zero
    digits; the remainder r is one batched rotation (shl{r}lo/hi)."""
    assert s >= 0
    q, r = divmod(s, _spec_like(a_digits)[0])
    D = a_digits.shape[-2]
    zero = _zeros_like_digit(a_digits[..., 0, :])[..., None, :]
    if r:
        rows = a_digits.movedim(-2, 0)
        names = tuple(f"shl{r}lo" for _ in range(D)) + \
            tuple(f"shl{r}hi" for _ in range(D))
        parts = _pbs_rows(torch.cat([rows, rows]), names, ck)
        lo = parts[:D].movedim(0, -2)                         # [..., D, n1]
        hi = parts[D:].movedim(0, -2)
        a_digits = torch.cat([lo, zero], dim=-2) + \
            torch.cat([zero, hi], dim=-2)                     # [..., D+1, n1]
    return torch.cat([zero] * q + [a_digits], dim=-2) if q else a_digits


def radix_shr(a_digits, s: int, ck: CloudKey):
    """Logical right shift by a PLAIN amount s >= 0 ([..., max(D-q, 1),
    n0+1]).  The digit-aligned part drops digits; the remainder r is one
    batched rotation (shr{r} of d_i + low{r} of d_{i+1})."""
    assert s >= 0
    q, r = divmod(s, _spec_like(a_digits)[0])
    D = a_digits.shape[-2]
    if q >= D:
        return _zeros_like_digit(a_digits[..., 0, :])[..., None, :]
    a_digits = a_digits[..., q:, :]
    if r:
        D = a_digits.shape[-2]
        rows = a_digits.movedim(-2, 0)
        names = tuple(f"shr{r}" for _ in range(D)) + \
            tuple(f"low{r}" for _ in range(D))
        parts = _pbs_rows(torch.cat([rows, rows]), names, ck)
        down = parts[:D].movedim(0, -2)
        up = parts[D:].movedim(0, -2)     # bits of d_{i+1} moving down
        zero = _zeros_like_digit(a_digits[..., 0, :])[..., None, :]
        a_digits = down + torch.cat([up[..., 1:, :], zero], dim=-2)
    return a_digits


# ---------------------------------------------------------------------------
# Multiplication
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _digit_mul_tvs(params: SecurityParams) -> np.ndarray:
    """Tree-PBS tables of the bivariate digit multiplier: carrier [2, B, 2,
    N]; [fam, h] is (x*h) mod B (fam 0) / (x*h) div B (fam 1) over the
    modulus-M input grid."""
    bb, base, m = _spec_params(params)
    gen = L.Generator.new(m, params)
    tvs = np.zeros((2, base, 2, params.N),
                   np.int32 if params.torus_bits == 32 else np.int64)
    for h in range(base):
        tvs[0, h] = gen.generate_lookup_table(
            lambda x, h=h: ((x % base) * h) % base).poly
        tvs[1, h] = gen.generate_lookup_table(
            lambda x, h=h: ((x % base) * h) // base).poly
    tvs.setflags(write=False)           # cached: callers must not mutate
    return tvs


def digit_mul(x_ct, y_ct, ck: CloudKey):
    """Exact product of two encrypted digits (< 8): returns (lo, hi).

    With a packing key on the cloud key this is a bivariate tree PBS
    (models/lut.py:tree_pbs): one multi-value rotation of x against the 16
    hypothesis tables, one select rotation over y.  Without one, the
    classic 5-round path: bits of y (1 rotation), the partial products of
    the w = x + 8*b packings (one grouped rotation), two carry
    normalizations, one high-digit refresh."""
    if ck.pksk is not None:
        # the embedded packing key must follow the set's default gadget:
        # a key built at another basebit with the same t has the right row
        # count but would decode garbage
        p = ck.params
        want = default_packing_gadget(p)
        declared = ck.pksk_gadget
        if declared is not None and tuple(declared) != want:
            raise ValueError(
                f"cloud key's packing key was built at (basebit, t) = "
                f"{tuple(declared)} but the parameter set's default "
                f"packing gadget is {want}: custom-gadget "
                "packing keys must be used via models/lut.py:tree_pbs "
                "with explicit pksk_basebit/pksk_t, not attached to the "
                "cloud key")
        if ck.pksk.shape[0] != p.n1 * want[1]:
            raise ValueError(
                f"cloud key's packing key has {ck.pksk.shape[0]} rows, "
                f"expected n1*t = {p.n1 * want[1]}: custom-gadget "
                "packing keys must be used via models/lut.py:tree_pbs "
                "with explicit pksk_basebit/pksk_t, not attached to the "
                "cloud key")
        batch, n1 = x_ct.shape[:-1], x_ct.shape[-1]
        B = math.prod(batch)
        out = L.tree_pbs(x_ct.reshape(B, n1), y_ct.reshape(B, n1),
                         _digit_mul_tvs(p), _spec_params(p)[2], ck, ck.pksk)
        return (out[:, 0].reshape(batch + (n1,)),
                out[:, 1].reshape(batch + (n1,)))
    bb = _spec_params(ck.params)[0]
    x, y = x_ct, y_ct                                   # [..., n0+1]
    bits8 = _pbs_mv(y, tuple(f"bit{k}" for k in range(bb)),
                    ck)                                 # 1 rotation, bb LUTs
    w = x[None] + bits8                                 # w_k = x + B*y_k
    parts = _pbs_mv_groups(                             # 1 rotation
        w, tuple((f"pp{k}lo", f"pp{k}hi") for k in range(bb)),
        ck)                                             # [bb, 2, ..., n0+1]
    hi_parts = parts[0, 1]
    for k in range(1, bb):
        # sum_k floor((B-1) 2^k / B) = B - 1 - bb, + the bb-1 carries < B
        hi_parts = hi_parts + parts[k, 1]
    t = parts[0, 0]
    for k in range(1, bb):
        # lo_k <= B - 1 each: the pairwise sum <= 2B - 2 = M - 2 fits
        s = _pbs_mv(t + parts[k, 0], ("mod", "div"), ck)
        t = s[0]
        hi_parts = hi_parts + s[1]
    hi = _pbs_rows(hi_parts[None], ("mod",), ck)[0]
    return t, hi


def radix_scale(a_digits, y_ct, ck: CloudKey):
    """[..., D, n0+1] x digit [..., n0+1] -> [..., D+1, n0+1]: all D digit
    products as ONE batched digit_mul, then one addition."""
    D = a_digits.shape[-2]
    a_rows = a_digits.movedim(-2, 0)                     # [D, ..., n0+1]
    y_rows = y_ct[None].expand(a_rows.shape)
    lo, hi = digit_mul(a_rows, y_rows, ck)               # [D, ..., n0+1]
    z = _zeros_like_digit(lo[0])[None]
    row_lo = torch.cat([lo, z]).movedim(0, -2)
    row_hi = torch.cat([z, hi]).movedim(0, -2)
    return radix_add(row_lo, row_hi, ck)[..., : D + 1, :]


def radix_scale_plain(a_digits, c: int, ck: CloudKey):
    """[..., D, n0+1] times a PLAIN digit c in [0, B) -> [..., D+1, n0+1]:
    one batched mulc{c}lo/hi rotation over 2D lanes, then one addition."""
    D = a_digits.shape[-2]
    zero = _zeros_like_digit(a_digits[..., 0, :])[..., None, :]
    if c == 0:
        return torch.cat([zero] * (D + 1), dim=-2)
    if c == 1:
        return torch.cat([a_digits, zero], dim=-2)
    rows = a_digits.movedim(-2, 0)
    names = tuple(f"mulc{c}lo" for _ in range(D)) + \
        tuple(f"mulc{c}hi" for _ in range(D))
    parts = _pbs_rows(torch.cat([rows, rows]), names, ck)
    lo = parts[:D].movedim(0, -2)
    hi = parts[D:].movedim(0, -2)
    row_lo = torch.cat([lo, zero], dim=-2)
    row_hi = torch.cat([zero, hi], dim=-2)
    return radix_add(row_lo, row_hi, ck)[..., : D + 1, :]


def radix_mul_plain(a_digits, v: int, ck: CloudKey):
    """[..., D, n0+1] times a PLAIN non-negative int -> the widened exact
    product: schoolbook over v's radix digits, zero digits skipped, powers
    of two through the shift path."""
    assert v >= 0
    bb, base, _ = _spec_like(a_digits)
    D = a_digits.shape[-2]
    if v == 0:
        return _zeros_like_digit(a_digits[..., 0, :])[..., None, :]
    if v & (v - 1) == 0:                       # power of two -> shl
        return radix_shl(a_digits, v.bit_length() - 1, ck)
    Dv = max(1, -(-v.bit_length() // bb))
    W = D + Dv
    zero = _zeros_like_digit(a_digits[..., 0, :])[..., None, :]

    def at_width(x):
        pad = W - x.shape[-2]
        return torch.cat([x] + [zero] * pad, dim=-2) if pad else x

    acc = None
    for j in range(Dv):
        c = (v >> (bb * j)) & (base - 1)
        if c == 0:
            continue
        row = radix_scale_plain(a_digits, c, ck)           # [..., D+1]
        padded = at_width(torch.cat([zero] * j + [row], dim=-2))
        acc = padded if acc is None else \
            radix_add(acc, padded, ck)[..., :W, :]
    return acc


def radix_mask_low(a_digits, nbits: int, ck: CloudKey):
    """Keep the low ``nbits`` of a radix value (x & (2^nbits - 1)): digit
    drops are free, the boundary digit costs one masklow rotation.  Width
    shrinks to ceil(nbits/bb) (min 1)."""
    assert nbits >= 0
    if nbits == 0:
        return _zeros_like_digit(a_digits[..., 0, :])[..., None, :]
    q, r = divmod(nbits, _spec_like(a_digits)[0])
    if r == 0:
        return a_digits[..., :q, :]
    kept = a_digits[..., : q + 1, :]
    top = _pbs_rows(kept[..., -1, :][None], (f"masklow{r}",), ck)[0]
    return _set_digit(kept, -1, top)


def radix_mul(a_digits, b_digits, ck: CloudKey):
    """Full product: [..., Da, n0+1] x [..., Db, n0+1] -> [..., Da+Db,
    n0+1] (exact schoolbook over batched rows)."""
    Da, Db = a_digits.shape[-2], b_digits.shape[-2]
    zero = _zeros_like_digit(a_digits[..., 0, :])[..., None, :]
    acc = torch.cat([zero] * (Da + Db), dim=-2)
    for j in range(Db):
        row = radix_scale(a_digits, b_digits[..., j, :], ck)  # [..., Da+1]
        padded = torch.cat([zero] * j + [row] + [zero] * (Db - 1 - j), dim=-2)
        acc = radix_add(acc, padded, ck)[..., : Da + Db, :]
    return acc


# ---------------------------------------------------------------------------
# The bridge to the boolean gates
# ---------------------------------------------------------------------------


def to_bools(digits, ck: CloudKey):
    """Radix digits -> boolean-codec bits: [..., D, n0+1] -> [..., bb*D,
    n0+1] TLWE ciphertexts at the gate codec (+-1/8), little-endian, which
    models/gates and models/scheduler take as they are.  One batched
    rotation of bb boolbit lanes per digit."""
    bb = _spec_like(digits)[0]
    D = digits.shape[-2]
    rows = digits.movedim(-2, 0).repeat_interleave(bb, dim=0)  # [bb*D, ...]
    names = tuple(f"boolbit{k}" for _ in range(D) for k in range(bb))
    return _pbs_rows(rows, names, ck).movedim(0, -2)


def from_bools(bits, ck: CloudKey):
    """Boolean-codec bits -> radix digits: [..., nb, n0+1] (+-1/8 codec,
    little-endian) -> [..., ceil(nb/bb), n0+1] PBS-codec digits.

    One batched rotation: lane bb*j+k bootstraps with the CONSTANT testvec
    2^k/(4M), so the bit's sign selects -+2^k/(4M); adding the trivial
    offset 2^k/(4M) gives bit*2^k at the digit codec, and each digit is
    the exact sum of its <= bb disjoint bits."""
    bb, _, m = _spec_params(ck.params)
    w = ck.params.torus_bits
    nb = bits.shape[-2]
    D = -(-nb // bb)
    rows = bits.movedim(-2, 0)                             # [nb, ..., n1]
    batch, n1 = rows.shape[1:-1], rows.shape[-1]
    B = math.prod(batch)
    flat = rows.reshape(nb * B, n1)
    offs = torch.tensor([((1 << w) // (4 * m)) << (i % bb) for i in range(nb)],
                        dtype=carrier_dtype(w), device=bits.device)
    tv = torch.zeros((nb * B, 2, ck.params.N), dtype=carrier_dtype(w),
                     device=bits.device)
    tv[:, 1, :] = offs.repeat_interleave(B)[:, None]       # lane i*B+b
    out = L.bootstrap_lut(flat, tv, ck).reshape((nb,) + batch + (n1,))
    out[..., -1] += offs.reshape((nb,) + (1,) * len(batch))  # a fresh tensor
    ds = [sum(out[bb * j + k] for k in range(bb) if bb * j + k < nb)
          for j in range(D)]
    return torch.stack(ds).movedim(0, -2)


# ---------------------------------------------------------------------------
# Encrypted-amount (barrel) shifts
# ---------------------------------------------------------------------------


def _barrel_shift(a_digits, y_digits, ck: CloudKey, shift_fn):
    """Barrel shifter core at fixed width D: amounts >= bb*D shift
    everything into the fill.  One multi-value rotation extracts all bits
    of y in their base-x packing form; each bit k muxes x against
    shift_fn(x, 2^k) through the pre-scaled select (sel8)."""
    bb = _spec_like(a_digits)[0]
    D = a_digits.shape[-2]
    Dy = y_digits.shape[-2]
    bits8 = _pbs_mv(y_digits.movedim(-2, 0),
                    tuple(f"bit{k}" for k in range(bb)),
                    ck)                                # [bb, Dy, ..., n1]
    x = a_digits
    for k in range(bb * Dy):
        s8 = bits8[k % bb, k // bb]
        shifted = shift_fn(x, min(1 << k, bb * D), ck)
        x = radix_select(None, shifted, x, ck, sel8=s8)
    return x


def _shl_fixed(x, s, ck):
    D = x.shape[-2]
    return radix_shl(x, s, ck)[..., :D, :]


def _shr_fixed(x, s, ck):
    D = x.shape[-2]
    sh = radix_shr(x, s, ck)
    pad = D - sh.shape[-2]
    if pad:
        zero = _zeros_like_digit(x[..., 0, :])[..., None, :]
        sh = torch.cat([sh] + [zero] * pad, dim=-2)
    return sh


def radix_shl_enc(a_digits, y_digits, ck: CloudKey):
    """Left shift by an ENCRYPTED amount y (wraps mod 8^D)."""
    return _barrel_shift(a_digits, y_digits, ck, _shl_fixed)


def radix_shr_enc(a_digits, y_digits, ck: CloudKey):
    """Logical right shift by an ENCRYPTED amount."""
    return _barrel_shift(a_digits, y_digits, ck, _shr_fixed)


def radix_asr_enc(a_digits, y_digits, ck: CloudKey):
    """ARITHMETIC (sign-filling) right shift by an ENCRYPTED amount
    (two's-complement digits; y is an unsigned radix amount)."""
    return _barrel_shift(a_digits, y_digits, ck, radix_asr)


# ---------------------------------------------------------------------------
# Division
# ---------------------------------------------------------------------------


def radix_divmod(n_digits, m_digits, ck: CloudKey):
    """Exact unsigned division: (quotient [..., Dn, n0+1], remainder [...,
    Dm, n0+1]) by restoring shift-subtract over encrypted bits.

    Per quotient bit (bb*Dn in all): shift the running remainder left one
    bit (1 rotation), shift in the next numerator bit (linear; all
    numerator bits come from ONE multi-value rotation up front),
    trial-subtract the divisor (Dm+1 rotations, the last one also giving
    the select bit) and keep either result by encrypted mux (1 rotation).
    Quotient digits reassemble as sum_k 2^k b_k with one final batched mod
    refresh.  Division by an encrypted zero gives an all-ones quotient
    (no borrow ever fires) and an unspecified remainder."""
    bb = _spec_like(n_digits)[0]
    Dn, Dm = n_digits.shape[-2], m_digits.shape[-2]
    Dr = Dm + 1            # remainder width: R < 2*divisor <= B^(Dm+1)
    zero = _zeros_like_digit(n_digits[..., 0, :])
    n1 = zero.shape[-1]
    m_ext = torch.cat(
        [m_digits, zero[..., None, :].expand(m_digits.shape[:-2] + (1, n1))],
        dim=-2)
    ubits = _pbs_mv(n_digits.movedim(-2, 0),
                    tuple(f"ubit{k}" for k in range(bb)),
                    ck)                                     # [bb, Dn, ...]
    one = _trivial_digit(1, zero)
    R = zero[..., None, :].expand(zero.shape[:-1] + (Dr, n1))
    q_bits = [None] * (bb * Dn)
    for i in range(bb * Dn - 1, -1, -1):
        R = radix_shl(R, 1, ck)[..., :Dr, :]      # top stays 0
        R = _set_digit(R, 0, R[..., 0, :] + ubits[i % bb, i // bb])
        diff, borrow, ge8 = radix_sub(R, m_ext, ck, emit_ge8=True)
        q_bits[i] = one - borrow                  # R >= divisor
        R = radix_select(None, diff, R, ck, sel8=ge8)
    qd = [sum((1 << k) * q_bits[bb * j + k] for k in range(bb))
          for j in range(Dn)]
    q = _pbs_rows(torch.stack(qd), ("mod",) * Dn, ck)
    return q.movedim(0, -2), R[..., :Dm, :]


# ---------------------------------------------------------------------------
# High-level encrypted-integer handles
# ---------------------------------------------------------------------------


class _FheOpsMixin:
    """Operator wiring shared by FheUint/FheInt.

    Subclasses provide ``_aligned(other) -> (a_digits, b_digits) | None``
    (None: a foreign type; rich comparisons return NotImplemented, so
    Python falls back to identity) and ``_lt_digits`` (the unsigned or
    sign-biased borrow chain).  Comparisons return an encrypted 0/1 bit as
    a 1-digit handle; defining __eq__ makes the handles unhashable, and
    __bool__ raises: an encrypted comparison has no Python truth value."""

    __slots__ = ()
    __hash__ = None

    def _aligned(self, other):
        raise NotImplementedError

    _lt_digits = None        # staticmethod set by subclasses

    def _aligned_req(self, other):
        pair = self._aligned(other)
        if pair is None:
            raise TypeError(f"cannot combine {type(self).__name__} with "
                            f"{type(other).__name__}")
        return pair

    def __bool__(self):
        raise TypeError(
            f"{type(self).__name__} comparisons are encrypted bits with no "
            "Python truth value; decrypt() the result instead")

    def _bit(self, ct):
        return type(self)(ct[..., None, :], self.ck)

    def _flip(self, ct):
        return self._bit(_trivial_digit(1, ct) - ct)

    def __eq__(self, other):
        pair = self._aligned(other)
        if pair is None:
            return NotImplemented
        return self._bit(radix_eq(*pair, self.ck))

    def __ne__(self, other):
        pair = self._aligned(other)
        if pair is None:
            return NotImplemented
        return self._flip(radix_eq(*pair, self.ck))

    def __lt__(self, other):
        pair = self._aligned(other)
        if pair is None:
            return NotImplemented
        return self._bit(self._lt_digits(*pair, self.ck))

    def __gt__(self, other):
        pair = self._aligned(other)
        if pair is None:
            return NotImplemented
        a, b = pair
        return self._bit(self._lt_digits(b, a, self.ck))

    def __le__(self, other):
        pair = self._aligned(other)
        if pair is None:
            return NotImplemented
        a, b = pair
        return self._flip(self._lt_digits(b, a, self.ck))

    def __ge__(self, other):
        pair = self._aligned(other)
        if pair is None:
            return NotImplemented
        return self._flip(self._lt_digits(*pair, self.ck))

    def _bitwise(self, other, op):
        a, b = self._aligned_req(other)
        return type(self)(radix_bitwise(a, b, op, self.ck), self.ck)

    def __and__(self, other):
        return self._bitwise(other, "and")

    def __or__(self, other):
        return self._bitwise(other, "or")

    def __xor__(self, other):
        return self._bitwise(other, "xor")

    __rand__, __ror__, __rxor__ = __and__, __or__, __xor__

    def min(self, other):
        a, b = self._aligned_req(other)
        return type(self)(radix_select(self._lt_digits(a, b, self.ck),
                                       a, b, self.ck), self.ck)

    def max(self, other):
        a, b = self._aligned_req(other)
        return type(self)(radix_select(self._lt_digits(a, b, self.ck),
                                       b, a, self.ck), self.ck)


class FheUint(_FheOpsMixin):
    """Operator-overloaded encrypted unsigned integer.

    An immutable handle over the radix machinery: ``digits`` is the carrier
    [..., D, n0+1] little-endian base-8 ciphertext tensor and ``ck`` the
    evaluation key.  ``+ - * // % & | ^ << >>`` and the six comparisons
    work homomorphically: add/mul widen to the exact result, sub wraps mod
    8^D, comparisons return an encrypted 0/1 bit (a 1-digit FheUint usable
    with ``.select(a, b)``); mixed widths are allowed, and plain ints are
    encrypted trivially, so ``x + 3`` and ``x < 100`` work."""

    __slots__ = ("digits", "ck")

    def __init__(self, digits, ck: CloudKey):
        self.digits = digits
        self.ck = ck

    @classmethod
    def encrypt(cls, gen: torch.Generator, value, n_digits: int, sk,
                ck: CloudKey, alpha: float | None = None) -> "FheUint":
        """Encrypt on the generator's device (alpha: the set's lv0 noise
        unless given)."""
        a = ck.params.tlwe_lv0.alpha if alpha is None else alpha
        return cls(encrypt_radix(gen, value, n_digits, a, sk.key_lv0,
                                 ck.params.torus_bits), ck)

    def _coerce(self, other) -> "FheUint":
        if isinstance(other, FheUint):
            return other
        v = int(other)
        if v < 0:
            raise ValueError(f"FheUint is unsigned, got {v}")
        bb = _spec_like(self.digits)[0]
        D = max(1, -(-v.bit_length() // bb))
        return FheUint(_trivial_radix(v, D, self.digits), self.ck)

    @property
    def n_digits(self) -> int:
        return self.digits.shape[-2]

    def __add__(self, other):
        o = self._coerce(other)
        return FheUint(radix_add(*_pad_to_match(self.digits, o.digits),
                                 self.ck), self.ck)

    __radd__ = __add__

    def __mul__(self, other):
        if not isinstance(other, FheUint):
            v = int(other)
            if v < 0:
                raise ValueError(f"FheUint is unsigned, got {v}")
            # plain constant: known digits need no bit extraction
            return FheUint(radix_mul_plain(self.digits, v, self.ck), self.ck)
        return FheUint(radix_mul(self.digits, other.digits, self.ck),
                       self.ck)

    __rmul__ = __mul__

    def __floordiv__(self, other):
        return self.__divmod__(other)[0]

    def __mod__(self, other):
        return self.__divmod__(other)[1]

    def __divmod__(self, other):
        if not isinstance(other, FheUint):
            v = int(other)
            if v > 0 and v & (v - 1) == 0:     # power of two: shift + mask
                k = v.bit_length() - 1
                return (FheUint(radix_shr(self.digits, k, self.ck), self.ck),
                        FheUint(radix_mask_low(self.digits, k, self.ck),
                                self.ck))
        o = self._coerce(other)
        q, r = radix_divmod(self.digits, o.digits, self.ck)
        return FheUint(q, self.ck), FheUint(r, self.ck)

    def __rfloordiv__(self, other):
        return self._coerce(other).__floordiv__(self)

    def __rmod__(self, other):
        return self._coerce(other).__mod__(self)

    def __rdivmod__(self, other):
        return self._coerce(other).__divmod__(self)

    def overflowing_add(self, other):
        """(wrapping sum at the common width, encrypted carry-out bit)."""
        a, b = _pad_to_match(self.digits, self._coerce(other).digits)
        wide = radix_add(a, b, self.ck)
        return (FheUint(wide[..., :-1, :], self.ck),
                self._bit(wide[..., -1, :]))

    def overflowing_sub(self, other):
        """(wrapping difference, encrypted borrow bit = self < other)."""
        a, b = _pad_to_match(self.digits, self._coerce(other).digits)
        diff, borrow = radix_sub(a, b, self.ck)
        return FheUint(diff, self.ck), self._bit(borrow)

    def __sub__(self, other):
        """Wrapping difference mod 8^D; ``a < b`` is the underflow bit."""
        a, b = _pad_to_match(self.digits, self._coerce(other).digits)
        return FheUint(radix_sub(a, b, self.ck)[0], self.ck)

    def __rsub__(self, other):
        return self._coerce(other).__sub__(self)

    # comparisons/bitwise/min/max come from _FheOpsMixin via _aligned
    def _aligned(self, other):
        if not isinstance(other, (FheUint, int, np.integer)):
            return None
        return _pad_to_match(self.digits, self._coerce(other).digits)

    _lt_digits = staticmethod(radix_lt)

    def __lshift__(self, s):
        """Plain amounts widen to hold every bit; an encrypted amount
        (FheUint or FheInt digits, read unsigned) keeps the width."""
        if isinstance(s, (FheUint, FheInt)):
            return FheUint(radix_shl_enc(self.digits, s.digits, self.ck),
                           self.ck)
        return FheUint(radix_shl(self.digits, int(s), self.ck), self.ck)

    def __rshift__(self, s):
        if isinstance(s, (FheUint, FheInt)):
            return FheUint(radix_shr_enc(self.digits, s.digits, self.ck),
                           self.ck)
        return FheUint(radix_shr(self.digits, int(s), self.ck), self.ck)

    def select(self, if_true, if_false) -> "FheUint":
        """self is an encrypted 0/1 bit: if_true where 1 else if_false."""
        a, b = _pad_to_match(self._coerce(if_true).digits,
                             self._coerce(if_false).digits)
        return FheUint(radix_select(self.digits[..., 0, :], a, b, self.ck),
                       self.ck)

    def decrypt(self, sk):
        return decrypt_radix(self.digits, sk.key_lv0)


class FheInt(_FheOpsMixin):
    """Operator-overloaded encrypted SIGNED integer (two's complement).

    The radix machinery of FheUint at fixed width: every binary op aligns
    to the widest operand's D digits (a narrower ciphertext sign-extends
    with one sign7 rotation, plain ints encode trivially) and wraps mod
    8^D.  Comparisons are signed; ``>>`` is arithmetic.  Value range
    [-8^D/2, 8^D/2)."""

    __slots__ = ("digits", "ck")

    def __init__(self, digits, ck: CloudKey):
        self.digits = digits
        self.ck = ck

    @classmethod
    def encrypt(cls, gen: torch.Generator, value, n_digits: int, sk,
                ck: CloudKey, alpha: float | None = None) -> "FheInt":
        a = ck.params.tlwe_lv0.alpha if alpha is None else alpha
        bb = _spec_params(ck.params)[0]
        v = np.asarray(value, np.int64)
        half = (1 << (bb * n_digits)) // 2
        if ((v < -half) | (v >= half)).any():
            raise ValueError(f"{value} out of range for {n_digits} digits "
                             f"[{-half}, {half})")
        enc_v = np.mod(v, 1 << (bb * n_digits))
        return cls(encrypt_radix(gen, enc_v, n_digits, a, sk.key_lv0,
                                 ck.params.torus_bits), ck)

    @property
    def n_digits(self) -> int:
        return self.digits.shape[-2]

    def _at_width(self, x, D: int):
        """x (FheInt or plain int) as a digits tensor of width exactly D."""
        if isinstance(x, FheInt):
            extra = D - x.n_digits
            assert extra >= 0, (D, x.n_digits)
            if extra == 0:
                return x.digits
            sign7 = _pbs_mv(x.digits[..., -1, :], ("sign7",), self.ck)[0]
            ext = sign7[..., None, :].expand(
                x.digits.shape[:-2] + (extra, sign7.shape[-1]))
            return torch.cat([x.digits, ext], dim=-2)
        v = int(x)
        bb = _spec_like(self.digits)[0]
        half = (1 << (bb * D)) // 2
        if not -half <= v < half:
            raise ValueError(f"constant {v} out of range for {D} digits")
        return _trivial_radix(v % (1 << (bb * D)), D, self.digits)

    def _align(self, other):
        bb = _spec_like(self.digits)[0]
        if isinstance(other, FheInt):
            D = max(self.n_digits, other.n_digits)
        else:
            D = max(self.n_digits,
                    -(-(int(other).bit_length() + 1) // bb), 1)
        return self._at_width(self, D), self._at_width(other, D), D

    def __add__(self, other):
        a, b, D = self._align(other)
        return FheInt(radix_add(a, b, self.ck)[..., :D, :], self.ck)

    __radd__ = __add__

    def __sub__(self, other):
        a, b, _ = self._align(other)
        return FheInt(radix_sub(a, b, self.ck)[0], self.ck)

    def __rsub__(self, other):
        a, b, _ = self._align(other)
        return FheInt(radix_sub(b, a, self.ck)[0], self.ck)

    def __neg__(self):
        return self.__rsub__(0)

    def overflowing_add(self, other):
        """(wrapping sum, encrypted SIGNED-overflow bit): overflow iff the
        operands agree in sign and the result's sign differs.  One batched
        sign1 extraction of the three top digits, one packed sovf round on
        v = sa + 2*sb + 4*sr."""
        a, b, D = self._align(other)
        r = radix_add(a, b, self.ck)[..., :D, :]
        tops = torch.stack([a[..., -1, :], b[..., -1, :], r[..., -1, :]])
        s = _pbs_rows(tops, ("sign1",) * 3, self.ck)
        v = s[0] + 2 * s[1] + 4 * s[2]
        ovf = _pbs_rows(v[None], ("sovf",), self.ck)[0]
        return FheInt(r, self.ck), self._bit(ovf)

    def abs(self) -> "FheInt":
        """|self| (INT_MIN wraps to itself, as in two's complement)."""
        neg = self < 0
        return neg.select(-self, self)

    def div_rem(self, other) -> tuple["FheInt", "FheInt"]:
        """TRUNCATING signed division (C semantics, not Python floor): the
        quotient rounds toward zero, the remainder takes the dividend's
        sign.  |a| divmod |b| on the unsigned machinery, then two
        encrypted sign fixes."""
        a, b, _ = self._align(other)
        fa, fb = FheInt(a, self.ck), FheInt(b, self.ck)
        sa, sb = fa < 0, fb < 0
        abs_a, abs_b = sa.select(-fa, fa), sb.select(-fb, fb)
        q, r = radix_divmod(abs_a.digits, abs_b.digits, self.ck)
        qsign = sa != sb                           # signs differ -> negate q
        fq, fr = FheInt(q, self.ck), FheInt(r, self.ck)
        return qsign.select(-fq, fq), sa.select(-fr, fr)

    def __mul__(self, other):
        if not isinstance(other, FheInt):
            # plain constant on the raw representation (exact mod 8^D), the
            # sign fixed by one negation
            v = int(other)
            D = self.n_digits
            if v == 0:
                return FheInt(_trivial_radix(0, D, self.digits), self.ck)
            out = radix_mul_plain(self.digits, abs(v), self.ck)[..., :D, :]
            f = FheInt(out, self.ck)
            return -f if v < 0 else f
        a, b, D = self._align(other)
        return FheInt(radix_mul(a, b, self.ck)[..., :D, :], self.ck)

    __rmul__ = __mul__

    # comparisons/bitwise/min/max come from _FheOpsMixin via _aligned
    def _aligned(self, other):
        if not isinstance(other, (FheInt, int, np.integer)):
            return None
        a, b, _ = self._align(other)
        return a, b

    _lt_digits = staticmethod(radix_lt_signed)

    def __lshift__(self, s):
        """Wrapping left shift; a plain amount or an encrypted one
        (FheUint/FheInt digits, read unsigned)."""
        if isinstance(s, (FheInt, FheUint)):
            return FheInt(radix_shl_enc(self.digits, s.digits, self.ck),
                          self.ck)
        D = self.n_digits
        return FheInt(radix_shl(self.digits, int(s), self.ck)[..., :D, :],
                      self.ck)

    def __rshift__(self, s):
        """Arithmetic right shift (sign-filling), plain or encrypted
        amount."""
        if isinstance(s, (FheInt, FheUint)):
            return FheInt(radix_asr_enc(self.digits, s.digits, self.ck),
                          self.ck)
        return FheInt(radix_asr(self.digits, int(s), self.ck), self.ck)

    def select(self, if_true, if_false) -> "FheInt":
        """self is an encrypted 0/1 bit: if_true where 1 else if_false.  At
        least one branch must be a ciphertext (a plain-int branch encodes
        at the other's width)."""
        anchor = if_true if isinstance(if_true, FheInt) else if_false
        if not isinstance(anchor, FheInt):
            raise ValueError("select needs at least one ciphertext branch")
        if anchor is if_true:
            a, b, _ = anchor._align(if_false)
        else:
            b, a, _ = anchor._align(if_true)
        return FheInt(radix_select(self.digits[..., 0, :], a, b, self.ck),
                      self.ck)

    def decrypt(self, sk):
        raw = decrypt_radix(self.digits, sk.key_lv0)
        mod = 1 << (_spec_like(self.digits)[0] * self.n_digits)
        if isinstance(raw, (int, np.integer)):
            return int(raw - mod) if raw >= mod // 2 else int(raw)
        return np.where(raw >= mod // 2, raw - mod, raw)


def _pad_to_match(a, b):
    """Zero-pad the narrower radix tensor (most-significant end) so both
    have equal digit counts (a trivial zero digit encrypts 0 exactly)."""
    Da, Db = a.shape[-2], b.shape[-2]
    if Da == Db:
        return a, b

    def pad(x, extra):
        z = x.new_zeros(x.shape[:-2] + (extra, x.shape[-1]))
        return torch.cat([x, z], dim=-2)

    return (a, pad(b, Da - Db)) if Da > Db else (pad(a, Db - Da), b)
