"""Gadget and key-switch digit decomposition as vectorized int32 ops.

Counterpart of zig_tfhe_tpu/ops/decomposition.py (trgsw.zig:193-219 and
the signed key-switch digits of the one-matmul key switch):

    tmp    = x + offset                       (wrapping)
    dig_i  = ((tmp >>u (32-(i+1)*bgbit)) & (Bg-1)) - Bg/2   in [-Bg/2, Bg/2)
"""

from __future__ import annotations

import torch

from zig_tfhe_tpu_torch.params import SecurityParams
from zig_tfhe_tpu_torch.utils.torus import (require_width, shift_right_logical,
                                            to_carrier)


def gadget_offset(bgbit: int, n_terms: int, width: int = 32) -> int:
    """sum_{i=1..n_terms} (Bg/2) * 2^(width - i*bgbit), mod 2^width."""
    off, half = 0, 1 << (bgbit - 1)
    for i in range(n_terms):
        sh = width - (i + 1) * bgbit
        if sh < 0:
            break
        off = (off + half * (1 << sh)) % (1 << width)
    return off


def gadget_decompose(x: torch.Tensor, params: SecurityParams,
                     level_axis: int = -1, levels: int | None = None,
                     bgbit: int | None = None,
                     center: bool = False) -> torch.Tensor:
    """Signed gadget digits of int32 torus values, stacked on
    ``level_axis`` (-1: [..., L]; -2: [..., L, last]).

    levels < L selects the approximate decomposition (top digits only);
    bgbit overrides the base (ENGINE gadget, offset over all
    floor(32/bgbit) terms); center=True adds the half-grid term that makes
    the full-L parameter-base reconstruction round to nearest
    (ops/decomposition.py:gadget_decompose documents all three)."""
    w = params.torus_bits
    require_width(w)
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
    mask = (1 << bgbit) - 1
    half = 1 << (bgbit - 1)
    tmp = x + to_carrier(offset, w)
    digs = [(shift_right_logical(tmp, w - (i + 1) * bgbit) & mask) - half
            for i in range(levels)]
    return torch.stack(digs, dim=level_axis)


def ks_decompose(a: torch.Tensor, basebit: int, t: int,
                 width: int = 32) -> torch.Tensor:
    """Signed key-switch digits: int32 [..., t] in [-B/2, B/2), with
    sum_j d_j * 2^(32-(j+1)*basebit) == a rounded to basebit*t bits."""
    require_width(width)
    mask = (1 << basebit) - 1
    half = 1 << (basebit - 1)
    prec = 1 << (width - (1 + basebit * t))
    balance = 0
    for j in range(t):
        balance += (1 << (basebit - 1)) * (1 << (width - (j + 1) * basebit))
    a_bar = a + to_carrier((prec + balance) % (1 << width), width)
    digs = [(shift_right_logical(a_bar, width - (j + 1) * basebit) & mask)
            - half for j in range(t)]
    return torch.stack(digs, dim=-1)
