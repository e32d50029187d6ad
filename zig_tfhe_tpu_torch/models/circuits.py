"""Encrypted integer circuits: bit codecs, adders.

Counterpart of zig_tfhe_tpu/models/circuits.py.  bit_utils parity
(bit_utils.zig:16-76): little-endian bit <-> int codecs and "AsBits"
encryption of u8/u16/u32/u64 values.  The circuits mirror
examples/add_two_numbers.zig (full adder, ripple-carry add), batch-first:
the width-W stage-1 gates of an adder run as one batched bootstrap, and the
Kogge-Stone adder spends batch width to cut sequential bootstrap rounds
(log-depth carries; the reference evaluates strictly sequentially).
"""

from __future__ import annotations

import numpy as np
import torch

from zig_tfhe_tpu_torch import tlwe as _tlwe
from zig_tfhe_tpu_torch.key import CloudKey, SecretKey
from zig_tfhe_tpu_torch.models import gates as G


def to_bits(value: int, width: int) -> np.ndarray:
    """Little-endian bits of ``value`` (bit_utils.zig:57-66)."""
    return np.array([(value >> i) & 1 for i in range(width)], bool)


def from_bits(bits) -> int:
    """Little-endian bits -> int (bit_utils.zig:16-23)."""
    return int(sum((1 << i) for i, b in enumerate(np.asarray(bits)) if b))


def encrypt_bits(gen: torch.Generator, value: int, width: int,
                 sk: SecretKey, params) -> torch.Tensor:
    """Encrypt an integer as ``width`` TLWE bools [width, n0+1] on the
    generator's device (bit_utils.zig:32-52)."""
    return _tlwe.encrypt_bool(gen, to_bits(value, width),
                              params.tlwe_lv0.alpha, sk.key_lv0,
                              width=params.torus_bits)


def decrypt_bits(cts: torch.Tensor, sk: SecretKey) -> int:
    return from_bits(_tlwe.decrypt_bool(cts, sk.key_lv0).cpu().numpy())


class AsBits:
    """bit_utils.zig:32-76 parity: typed bit views of unsigned integers."""

    def __init__(self, width: int):
        self.width = width

    def to_bits(self, value: int) -> np.ndarray:
        return to_bits(value, self.width)

    def encrypt(self, gen: torch.Generator, value: int, sk: SecretKey,
                params) -> torch.Tensor:
        return encrypt_bits(gen, value, self.width, sk, params)


U8AsBits = AsBits(8)
U16AsBits = AsBits(16)
U32AsBits = AsBits(32)
U64AsBits = AsBits(64)


def full_adder(a, b, c, ck: CloudKey):
    """One-bit full adder (add_two_numbers.zig:24-47), 3 bootstrap rounds
    (5 gates; the two gates of each of rounds 1-2 share a batch).

    Round 1: x = a XOR b, g = a AND b.  Round 2: sum = x XOR c, t = x AND c.
    Round 3: carry = g OR t.  a, b, c: [B, n0+1].  Returns (sum, carry).
    """
    x, g = G.gate_pair(("xor", "and"), (a, a), (b, b), ck)
    s, t = G.gate_pair(("xor", "and"), (x, x), (c, c), ck)
    return s, G.gate("or", g, t, ck)


def ripple_carry_add(a_bits, b_bits, cin, ck: CloudKey):
    """W-bit ripple-carry adder (add_two_numbers.zig:51-73), batch-first.

    a_bits, b_bits: [W, n0+1]; cin: [1, n0+1].  Stage 1 computes all W
    XORs and W ANDs in one batched bootstrap; the carry chain then takes 2
    bootstrap rounds per bit.  Returns (sum_bits [W, n0+1], carry).
    """
    W = a_bits.shape[0]
    x, g = G.gate_pair(("xor", "and"), (a_bits, a_bits), (b_bits, b_bits), ck)
    sums = []
    carry = cin
    for i in range(W):
        st = G.gate_pair(("xor", "and"),
                         (x[i:i + 1], x[i:i + 1]), (carry, carry), ck)
        sums.append(st[0])
        carry = G.gate("or", g[i:i + 1], st[1], ck)
    return torch.cat(sums), carry


def kogge_stone_add(a_bits, b_bits, ck: CloudKey):
    """W-bit carry-lookahead (Kogge-Stone) adder: ~2*log2(W)+2 bootstrap
    rounds, each one wide batched bootstrap.

    Carry recurrences: (g, p) span composition
        G[i:j] = g_i OR (p_i AND g_j),  P[i:j] = p_i AND p_j
    in log2(W) doubling rounds.  a_bits, b_bits: [W, ..., n0+1] (extra
    dims are a batch of clients).  Returns (sum_bits, carry_out [1, ...]).
    """
    W = a_bits.shape[0]
    p, g = G.gate_pair(("xor", "and"), (a_bits, a_bits), (b_bits, b_bits), ck)
    p0 = p
    lane = torch.arange(W, device=a_bits.device).reshape(
        W, *(1,) * (a_bits.dim() - 1))
    dist = 1
    while dist < W:
        # every round runs at full width W, as in the JAX package (lanes
        # i < dist compute a discarded gate and keep their value)
        g_shift = torch.cat([g[:dist], g[:-dist]])      # g[i - dist]
        p_shift = torch.cat([p[:dist], p[:-dist]])
        tp = G.gate_pair(("and", "and"), (p, p), (g_shift, p_shift), ck)
        cand_g = G.gate("or", g, tp[0], ck)
        keep = lane >= dist
        g = torch.where(keep, cand_g, g)
        p = torch.where(keep, tp[1], p)
        dist *= 2
    # the carry into bit i is G[0:i-1]; sum_i = p0_i XOR carry_in_i
    zero = G.constant(False, ck.params, batch=(1, *a_bits.shape[1:-1]),
                      device=a_bits.device)
    sums = G.gate("xor", p0, torch.cat([zero, g[:-1]]), ck)
    return sums, g[-1:]
