"""Gadget and key-switch digit decomposition as vectorized carrier ops,
and every digit format the blind rotation hands between its stages.

Counterpart of zig_tfhe_tpu/ops/decomposition.py (trgsw.zig:193-219 and
the signed key-switch digits of the one-matmul key switch):

    tmp    = x + offset                       (wrapping)
    dig_i  = ((tmp >>u (w-(i+1)*bgbit)) & (Bg-1)) - Bg/2   in [-Bg/2, Bg/2)

on int32 (w = 32) or int64 (w = 64) carriers; the digits are int32 at
either width.

The blind rotation's formats (the JAX package's ops/blind_rotate.py and
ops/split_ring.py hold them): ``modswitch``; an accumulator's digit rows
(``decompose_rows``, a ``RowGadget``) and the split ring's hi-plane
half-rows (``rows_hi32``, a ``HalfRowGadget``), and the int8 planes the
step kernels read of either (``digit_planes``: one plane a row of
one-limb digits, a plane a limb of wider ones).  A gadget holds the
numbers a kernel that writes its planes takes (ops/cuda/ntt_inverse.py);
its ``rows`` and ``planes`` methods give the same digits in plain
PyTorch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from zig_tfhe_tpu_torch.ops.ntt import engine_digit_limbs, norm_levels
from zig_tfhe_tpu_torch.params import SecurityParams
from zig_tfhe_tpu_torch.utils.torus import (i32_to_i8_limbs, require_width,
                                            shift_right_logical, to_carrier,
                                            to_i32)


def gadget_offset(bgbit: int, n_terms: int, width: int = 32) -> int:
    """sum_{i=1..n_terms} (Bg/2) * 2^(width - i*bgbit), mod 2^width."""
    off, half = 0, 1 << (bgbit - 1)
    for i in range(n_terms):
        sh = width - (i + 1) * bgbit
        if sh < 0:
            break
        off = (off + half * (1 << sh)) % (1 << width)
    return off


def gadget_base(params: SecurityParams, levels: int | None = None,
                bgbit: int | None = None,
                center: bool = False) -> tuple[int, int, int]:
    """(bgbit, levels, offset mod 2^w) that ``gadget_decompose`` runs
    with these arguments."""
    w = params.torus_bits
    if bgbit is None or bgbit == params.bgbit:
        bgbit, L = params.bgbit, params.L
        offset = params.decomposition_offset
        if center and levels in (None, L) and L * bgbit < w:
            offset = (offset + (1 << (w - L * bgbit - 1))) % (1 << w)
    else:
        L = w // bgbit
        offset = gadget_offset(bgbit, L, w)
    levels = L if levels is None else levels
    assert 1 <= levels <= L, (levels, L)
    return bgbit, levels, offset


def gadget_decompose(x: torch.Tensor, params: SecurityParams,
                     level_axis: int = -1, levels: int | None = None,
                     bgbit: int | None = None,
                     center: bool = False) -> torch.Tensor:
    """Signed gadget digits (int32) of torus carriers, stacked on
    ``level_axis`` (-1: [..., L]; -2: [..., L, last]).

    levels < L selects the approximate decomposition (top digits only);
    bgbit overrides the base (ENGINE gadget, offset over all
    floor(32/bgbit) terms); center=True adds the half-grid term that makes
    the full-L parameter-base reconstruction round to nearest
    (ops/decomposition.py:gadget_decompose documents all three)."""
    w = params.torus_bits
    require_width(w)
    bgbit, levels, offset = gadget_base(params, levels, bgbit, center)
    mask = (1 << bgbit) - 1
    half = 1 << (bgbit - 1)
    tmp = x + to_carrier(offset, w)
    digs = [((shift_right_logical(tmp, w - (i + 1) * bgbit) & mask)
             - half).to(torch.int32) for i in range(levels)]
    return torch.stack(digs, dim=level_axis)


def ks_decompose(a: torch.Tensor, basebit: int, t: int,
                 width: int = 32) -> torch.Tensor:
    """Signed key-switch digits of carriers at ``width``: int32 [..., t] in
    [-B/2, B/2), with sum_j d_j * 2^(w-(j+1)*basebit) == a rounded to
    basebit*t bits."""
    require_width(width)
    mask = (1 << basebit) - 1
    half = 1 << (basebit - 1)
    prec = 1 << (width - (1 + basebit * t))
    balance = 0
    for j in range(t):
        balance += (1 << (basebit - 1)) * (1 << (width - (j + 1) * basebit))
    a_bar = a + to_carrier((prec + balance) % (1 << width), width)
    digs = [((shift_right_logical(a_bar, width - (j + 1) * basebit) & mask)
             - half).to(torch.int32) for j in range(t)]
    return torch.stack(digs, dim=-1)


def modswitch(x: torch.Tensor, params: SecurityParams) -> torch.Tensor:
    """Torus carrier -> [0, 2N] rotation amount, int32 at every width
    (trgsw.zig:297,312): (x + 2^(w-nbit-2)) >>u (w-nbit-1)."""
    w = params.torus_bits
    rounded = x + to_carrier(1 << (w - params.nbit - 2), w)
    return shift_right_logical(rounded, w - params.nbit - 1).to(torch.int32)


def decompose_rows(ct: torch.Tensor, params: SecurityParams, levels=None,
                   bgbit: int | None = None) -> torch.Tensor:
    """[..., 2, N] -> signed digit rows [..., la+lb, N] (a-levels then
    b-levels, the decompositionIntoStorage row order)."""
    la, lb = norm_levels(params, levels, bgbit=bgbit)
    if la == lb:
        digs = gadget_decompose(ct, params, level_axis=-2, levels=la,
                                bgbit=bgbit, center=True)  # [..., 2, la, N]
        return digs.reshape(*digs.shape[:-3], 2 * la, params.N)
    da = gadget_decompose(ct[..., 0, :], params, level_axis=-2, levels=la,
                          bgbit=bgbit, center=True)
    db = gadget_decompose(ct[..., 1, :], params, level_axis=-2, levels=lb,
                          bgbit=bgbit, center=True)
    return torch.cat([da, db], dim=-2)


def digit_planes(rows: torch.Tensor, digit_limbs: int) -> torch.Tensor:
    """Gadget digit rows int32 [B, R, N] (``decompose_rows``) -> the step
    kernels' int8 limb planes [B, R * n_dl, N], plane r * n_dl + l holding
    limb l of row r (utils/torus.py:i32_to_i8_limbs, little-endian)."""
    if digit_limbs == 1:
        return rows.to(torch.int8)
    B, R, N = rows.shape
    limbs = i32_to_i8_limbs(rows, digit_limbs)            # [B, R, N, n_dl]
    return limbs.movedim(-1, -2).reshape(B, R * digit_limbs, N).contiguous()


class _Gadget(NamedTuple):
    params: SecurityParams
    bits: int
    levels: tuple
    offsets: tuple

    def planes(self, acc: torch.Tensor) -> torch.Tensor:
        """The int8 planes a step kernel reads of ``rows(acc)``: int8
        [B, R * n_dl, N], n_dl = ``engine_digit_limbs(bits)``."""
        return digit_planes(self.rows(acc), engine_digit_limbs(self.bits))


class RowGadget(_Gadget):
    """The decomposition ``decompose_rows(ct, params, levels, bgbit)``
    runs: base 2^bits, ``levels`` (la, lb) and each component's offset
    mod 2^w (``gadget_decompose`` with center=True at that component's
    levels), the numbers a kernel that writes these rows takes."""

    def rows(self, acc: torch.Tensor) -> torch.Tensor:
        """The digit rows of ``acc`` [B, 2, N]: int32 [B, la + lb, N]."""
        return decompose_rows(acc, self.params, self.levels, bgbit=self.bits)


@functools.lru_cache(maxsize=None)
def row_gadget(params: SecurityParams, levels=None,
               bgbit: int | None = None) -> RowGadget:
    """``RowGadget`` of ``decompose_rows`` with these arguments."""
    la, lb = norm_levels(params, levels, bgbit=bgbit)
    sides = [gadget_base(params, lv, bgbit, center=True) for lv in (la, lb)]
    return RowGadget(params, sides[0][0], (la, lb),
                     tuple(off for _, _, off in sides))


def hi32_planes(params: SecurityParams, drop_bits: int, e: int,
                levels) -> bool:
    """True when the split ring's scan runs on int32 hi planes: the 64-bit
    torus, drop >= 32 (every step's delta a multiple of 2^32) and no digit
    shift reading below bit 32 (ops/split_ring.py carries an offset's low
    word in the accumulator)."""
    return (params.torus_bits == 64 and drop_bits >= 32
            and params.torus_bits - max(levels) * e >= 32)


def hi32_viable(params: SecurityParams, drop_bits: int, e: int,
                levels) -> bool:
    """The JAX package's hi-plane condition: ``hi32_planes`` and no offset
    bit below 32 (its scan carries no low word; a key at another gadget
    runs its generic int64 scan)."""
    return (hi32_planes(params, drop_bits, e, levels)
            and all(off % (1 << 32) == 0
                    for off in row_gadget(params, levels, e).offsets))


def rows_hi32(acc_hi: torch.Tensor, params: SecurityParams, e: int,
              levels) -> torch.Tensor:
    """Hi-plane gadget decomposition: int32 [B, 2, 2, Nh] -> digit rows
    int32 [B, 2R, Nh] in (r, q_in) order (the ``decompose_rows`` + split
    key layout, ops/split_ring.py:fold_key_split); digit-exact against the
    64-bit decomposition under the ``hi32_planes`` conditions, the
    offsets' low words carried in the accumulator."""
    la, lb = levels
    off_a, off_b = row_gadget(params, levels, e).offsets
    mask, half = (1 << e) - 1, 1 << (e - 1)

    def digs(x, off, lv):    # [B, 2, Nh] -> [B, lv, 2, Nh]
        # shifts 32 - (i+1) e, made on the device: no host copy to wait for
        sh = torch.arange(32 - e, 32 - (lv + 1) * e, -e, dtype=torch.int32,
                          device=x.device).view(lv, 1, 1)
        # the arithmetic shift's sign bits lie above the mask: the logical
        # shift's digits
        return (((x + to_i32(off >> 32))[:, None] >> sh) & mask) - half

    r = torch.cat([digs(acc_hi[:, 0], off_a, la), digs(acc_hi[:, 1], off_b, lb)],
                  dim=1)                                      # [B, R, 2, Nh]
    return r.reshape(r.shape[0], 2 * (la + lb), r.shape[-1])


class HalfRowGadget(_Gadget):
    """The split ring's hi-plane decomposition (``rows_hi32(acc_hi,
    params, bits, levels)``) as a kernel writes it on the split views:
    base 2^bits, ``levels`` (la, lb) and the hi word of each component's
    offset mod 2^32 (its low word is carried in the accumulator)."""

    def rows(self, acc: torch.Tensor) -> torch.Tensor:
        """The half-rows of hi planes ``acc`` [B, 2, 2, Nh], or of their
        split views [2B, 2, Nh] (rows (b, c)): int32 [B, 2(la + lb), Nh]."""
        return rows_hi32(acc.reshape(-1, 2, 2, acc.shape[-1]), self.params,
                         self.bits, self.levels)


@functools.lru_cache(maxsize=None)
def half_row_gadget(params: SecurityParams, e: int, levels) -> HalfRowGadget:
    """The ``HalfRowGadget`` of ``rows_hi32(., params, e, levels)``."""
    return HalfRowGadget(params, e, tuple(levels), tuple(
        off >> 32 for off in row_gadget(params, levels, e).offsets))
