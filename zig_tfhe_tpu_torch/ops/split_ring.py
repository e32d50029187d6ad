"""Even/odd split-ring engine: N = 2048 negacyclic arithmetic on the
N = 1024 NTT plan, for the 64-bit torus sets (docs/TORUS64.md §4).

Counterpart of zig_tfhe_tpu/ops/split_ring.py.  No prime p ≡ 1 (mod 4096)
below the int8 residue-limb cap gives enough CRT product for a direct
N = 2048 transform, so Z[X]/(X^2048+1) is taken as pairs over Y = X^2:

    a(X) = a_e(Y) + X * a_o(Y),   a_e, a_o ∈ Z[Y]/(Y^1024+1),

and one ring product becomes four N/2 products,

    c_e = a_e b_e + Y * (a_o b_o)        c_o = a_e b_o + a_o b_e,

with multiply-by-Y the static NTT diagonal psi^(2k+1).  The external
product is one pointwise contraction by flattening (row, input parity)
into 2R rows and (component, output parity) into 4 planes, the Y-twist
folded into the key planes at keygen (``fold_key_split``).  X^t rotations
(t = 2u + r) keep or swap the parities with one psi-row gather.

The scan (``blind_rotate_split``).  With the key rounded by drop >= 32
bits every step's delta is a multiple of 2^32, so the accumulator's low
word never changes; when also every digit shift sits at or above bit 32
(``_hi32_planes``), the whole step is a function of the int32 hi planes
once each decomposition offset's low word is added to the accumulator
before the scan (and taken off after it; the set's own gadget at
128bit_t64 and tiny_split has none, the engine gadget 2^8 of tfhers_2_2
has): decompose at width 32 (``_rows_hi32``), forward NTT, the folded
pointwise sums, the parity combine, and the finish
acc_hi + (CRT(invNTT(v)) << (drop - 32)) mod 2^32.
At group 2 with one-limb digits (every split set's defaults) the middle of
the step is K2s (ops/cuda/split_step.py:split_step_fused, a hand kernel
for Hopper: forward NTT, pointwise sums and combine in one launch, the
residues written as int8 limb planes [P, B, 2(c), 2(q), 2(limb), Nh]) and
the finish is K1 (ops/cuda/ntt_inverse.py:ntt_inverse_to_crt_acc) on the
views [P, 2B, 2, 2, Nh] and [2B, 2, Nh], rows (b, c, q).  That loop is
fused as the 32-bit engine's: step 0 decomposes the set-up's accumulator
(``_rows_hi32``), and from then on K1 of step s also writes the int8
half-rows of the accumulator it makes (at ``half_row_gadget``) into the
buffer that K2s of step s read, for K2s of step s + 1; the last step
writes none.  So a hi-plane step is one K2s and one K1 launch on CUDA
tensors, and ``fused_steps`` of span ``blind_rotate.steps`` reads G - 1
(0 on every other split path).  K2s's plain version is the prime-batched
chain below (``_forward``, ``_pointwise``, ``rotate_combine_multi_split``;
the primes on a leading axis with their constants broadcast,
``_barrett``), which the JAX package runs in XLA (no Pallas kernel covers
the split step).  Group 1 and group 3 keys run that
chain on either device, and their hi-plane finish is K1 on the int32
residues.  The decomposition and the combine are the JAX formulas element
for element (bit-equal residues); the forward NTT takes the two-Barrett
limb combine for every prime and the pointwise sums reduce in groups of
the plan's smallest row group, so their residues equal the JAX package's
mod p within the same bounds, and the CRT lift makes the accumulator
bit-equal (as K2's residues are to the JAX package's XLA step).  The low
word is re-attached once after the scan.  The generic scan (int64
accumulator, reached by a configuration whose drop is below 32 or whose
digits read bits below 32) runs the plain chain and finishes with K1's
int64 variant, plain PyTorch ops on either device (``finish_int64``).
The path is chosen from the key's configuration before any launch.  The
JAX package's ``ZTFHE_SPLIT_HI32`` switch is not ported.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from zig_tfhe_tpu_torch.ops import ntt as _ntt
from zig_tfhe_tpu_torch.ops.blind_rotate import _decompose_to_rows, modswitch
from zig_tfhe_tpu_torch.ops.cuda import split_step as _k2s
from zig_tfhe_tpu_torch.ops.cuda.ntt_inverse import (HalfRowGadget,
                                                     ntt_inverse_to_crt_acc)
from zig_tfhe_tpu_torch.ops.decomposition import gadget_offset
from zig_tfhe_tpu_torch.ops.poly import matmul_i8, negacyclic_rotate
from zig_tfhe_tpu_torch.params import SecurityParams
from zig_tfhe_tpu_torch.utils import profiling
from zig_tfhe_tpu_torch.utils.torus import shift_right_logical, to_i32


def split(x: torch.Tensor) -> torch.Tensor:
    """[..., N] -> [..., 2, N/2]: (even-index, odd-index) coefficient
    halves, a(X) = a_e(X^2) + X * a_o(X^2)."""
    return torch.stack([x[..., 0::2], x[..., 1::2]], dim=-2)


def unsplit(x: torch.Tensor) -> torch.Tensor:
    """[..., 2, N/2] -> [..., N]: the inverse of ``split``."""
    out = torch.stack([x[..., 0, :], x[..., 1, :]], dim=-1)
    return out.reshape(*x.shape[:-2], 2 * x.shape[-1])


@dataclasses.dataclass(frozen=True)
class _Tables:
    fwd_lo: torch.Tensor      # int8 [Nh, P*Nh]: the forward matrices side by side
    fwd_hi: torch.Tensor
    p: torch.Tensor           # int32 [P]
    inv: torch.Tensor         # float32 [P]: np.float32(1/p), as barrett_reduce
    psi1: torch.Tensor        # int32 [P, Nh]: psi^(2k+1), multiply-by-Y


@functools.lru_cache(maxsize=None)
def _tables(plan: _ntt.NTTPlan, device: torch.device) -> _Tables:
    """The prime-batched step's constants on ``device``, once per plan."""
    tabs = _ntt.plan_tables(plan, device)
    P, N = plan.n_primes, plan.N

    def side_by_side(m):
        return m.permute(1, 0, 2).reshape(N, P * N).contiguous()

    return _Tables(
        fwd_lo=side_by_side(tabs.fwd_lo), fwd_hi=side_by_side(tabs.fwd_hi),
        p=torch.tensor(plan.primes, dtype=torch.int32, device=device),
        inv=torch.tensor([np.float32(1.0 / p) for p in plan.primes],
                         dtype=torch.float32, device=device),
        psi1=torch.from_numpy(np.stack([r[1] for r in plan.rot])
                              .astype(np.int32)).to(device))


def _barrett(v: torch.Tensor, tb: _Tables) -> torch.Tensor:
    """ops/ntt.py:barrett_reduce of every prime at once: v int32 [P, ...],
    prime i's elements reduced by p_i with the same f32 arithmetic."""
    shape = (-1,) + (1,) * (v.dim() - 1)
    q = torch.round(v * tb.inv.view(shape)).to(torch.int32)
    return v - q * tb.p.view(shape)


def _forward(rows: torch.Tensor, plan: _ntt.NTTPlan) -> torch.Tensor:
    """Forward NTT of one-limb digit rows int32 [B, 2R, Nh] (|d| <= 128) on
    every prime at once: two ``_int_mm`` against the side-by-side matrices
    and the two-Barrett limb combine.  Returns int32 [P, B, 2R, Nh], each
    residue congruent to ops/ntt.py:ntt_forward's, |.| <= 0.52p."""
    B, R2, Nh = rows.shape
    tb = _tables(plan, rows.device)
    d8 = rows.reshape(B * R2, Nh).to(torch.int8)

    def reduced(m):          # |lo|, |hi| <= Nh * 128 * 128 = 2^24
        y = matmul_i8(d8, m).view(B, R2, plan.n_primes, Nh).permute(2, 0, 1, 3)
        return _barrett(y, tb)

    return _barrett(reduced(tb.fwd_lo) + reduced(tb.fwd_hi) * 256,
                    tb).contiguous()


def _pointwise(d_hat: torch.Tensor, key: torch.Tensor,
               plan: _ntt.NTTPlan) -> torch.Tensor:
    """sum over rows of d_hat[P, B, 2R, Nh] * key[P, 2R, 4, Nh] on every
    prime at once -> int32 [P, B, 4, Nh], |.| <= 0.55p: rows summed in
    groups of the plan's smallest ``row_group`` (int32-exact for every
    prime), each group Barrett-reduced, the group sums reduced once."""
    tb = _tables(plan, d_hat.device)
    P, B, R2, Nh = d_hat.shape
    g = _k2s.row_group(plan)
    prod = d_hat[:, :, :, None, :] * key.to(torch.int32)[:, None]
    if R2 % g:
        prod = torch.cat([prod, prod.new_zeros(P, B, g - R2 % g, 4, Nh)], 2)
    part = _barrett(prod.reshape(P, B, -1, g, 4, Nh).sum(3, dtype=torch.int32),
                    tb)                                       # each <= p/2 + 384
    return _barrett(part.sum(2, dtype=torch.int32), tb)


def fold_key_split(res_e: torch.Tensor, res_o: torch.Tensor,
                   plan: _ntt.NTTPlan) -> torch.Tensor:
    """Fold the Y-twist into split-key NTT planes.

    res_e/res_o: int16 [P, ..., R, 2, Nh] residues of the even/odd key
    halves (``to_ntt_form``).  Returns int16 [..., P, 2R, 4, Nh], row
    r' = 2r + q_in, plane c' = 2c + q_out:

        K[(r,0),(c,0)] = k_e[r,c]      K[(r,1),(c,0)] = psi1 * k_o[r,c]
        K[(r,0),(c,1)] = k_o[r,c]      K[(r,1),(c,1)] = k_e[r,c]
    """
    outs = []
    for i, p in enumerate(plan.primes):
        psi1 = _tables(plan, res_e.device).psi1[i]            # [Nh]
        ke = res_e[i].to(torch.int32)                         # [..., R, 2, Nh]
        ko = res_o[i].to(torch.int32)
        # |psi1 * ko| <= (p/2)^2 < 2^30: one product + barrett, then a
        # centred reduce to |.| <= p/2 for canonical int16 storage
        koy = _ntt.barrett_reduce(psi1 * ko, p)
        koy = koy - p * (koy > p // 2).to(torch.int32)
        koy = koy + p * (koy < -(p // 2)).to(torch.int32)
        q0 = torch.stack([ke, ko], dim=-2)                    # [.., R, 2c, 2q, Nh]
        q1 = torch.stack([koy, ke], dim=-2)
        k4 = torch.stack([q0, q1], dim=-4)                    # [.., R, 2qi, 2c, 2q, Nh]
        sh = k4.shape
        outs.append(k4.reshape(*sh[:-5], sh[-5] * 2, 4, sh[-1]).to(torch.int16))
    return torch.stack(outs, dim=-4)


def rotate_minus1_split(us, t: torch.Tensor, plan: _ntt.NTTPlan) -> torch.Tensor:
    """(X^t - 1) * u in the split NTT domain, t in [0, 4 Nh).

    us: the per-prime residues int32 [P, B, 4, Nh], plane 2c + q (the pointwise output under the ``fold_key_split``
    layout), |.| <= 0.55p.  Returns int32 [P, B, 2(c), 2(q), Nh], |.| <=
    0.52p.  t = 2u + r: X^t (e, o) = r ? (Y^(u+1) o, Y^u e) : (Y^u e, Y^u
    o), one psi-row gather for Y^u and the +1 folded into the operand (psi1
    * u_o).  Every prime at once, the JAX formulas element for element."""
    Nh, P = plan.N, plan.n_primes
    tb = _tables(plan, t.device)
    t = t & (4 * Nh - 1)
    r = (t & 1)[None, :, None, None] != 0                     # [1, B, 1, 1]
    row = _ntt._rot_rows(t >> 1, plan).view(-1, P, Nh).transpose(0, 1)[:, :, None]
    ue, uo = us[:, :, 0::2], us[:, :, 1::2]                   # [P, B, 2, Nh]
    m_o = _barrett(tb.psi1[:, None, None] * uo, tb)           # psi1 * u_o
    sel_e = torch.where(r, m_o, ue)
    sel_o = torch.where(r, ue, uo)
    ve = _barrett(row * sel_e - ue, tb)
    vo = _barrett(row * sel_o - uo, tb)
    return torch.stack([ve, vo], dim=-2)


def rotate_combine_multi_split(us, ts, plan: _ntt.NTTPlan) -> torch.Tensor:
    """Multi-bit combiner in the split domain: sum over nonempty subsets S
    of prod_{i in S} (X^{t_i} - 1) * u_S.

    us: 2^g - 1 per-prime residue stacks (subset mask m - 1), each int32
    [P, B, 4, Nh] in the (component, parity) plane layout, |.| <= 0.55p; ts: g int32 [B] in [0, 4 Nh).  Returns
    int32 [P, B, 2, 2, Nh], |.| <= 0.52p.  Every operator is the split-NTT
    pair (x, y) = (f_e_hat, f_o_hat); products follow the Y-twisted rule
    (x1 x2 + psi1 y1 y2, x1 y2 + y1 x2), X^t - 1 is (row_u - 1, 0) at even
    t and (-1, row_u) at odd t, and the subset pairs build by the binary DP
    of the direct engine.  Every prime at once, the JAX formulas element
    for element; the overflow accounting (every product int32-safe with
    one inner barrett on the y-side) is the JAX package's docstring's."""
    g = len(ts)
    Nh, P = plan.N, plan.n_primes
    t_all = [t & (4 * Nh - 1) for t in ts]
    B = t_all[0].shape[0]
    tb = _tables(plan, t_all[0].device)
    rows = _ntt._rot_rows(torch.cat([t >> 1 for t in t_all]), plan)
    rows = rows.view(g, B, P, Nh).permute(2, 0, 1, 3)          # [P, g, B, Nh]
    psi1 = tb.psi1[:, None]                                   # [P, 1, Nh]
    d = {}
    for j in range(g):
        odd = (t_all[j] & 1)[None, :, None] != 0              # [1, B, 1]
        row = rows[:, j]                                      # [P, B, Nh]
        d[1 << j] = (torch.where(odd, -1, row - 1), torch.where(odd, row, 0))
    for m in range(1, 1 << g):
        if m & (m - 1):
            low = m & -m
            x1, y1 = d[m ^ low]
            x2, y2 = d[low]
            w = _barrett(y1 * y2, tb)
            d[m] = (_barrett(x1 * x2 + psi1 * w, tb),
                    _barrett(x1 * y2 + y1 * x2, tb))
    psi1 = psi1[:, None]                                      # [P, 1, 1, Nh]
    ves, vos = [], []
    for m in range(1, 1 << g):
        ue, uo = us[m - 1][:, :, 0::2], us[m - 1][:, :, 1::2]
        x, y = d[m]
        xb, yb = x[:, :, None], y[:, :, None]
        we = _barrett(yb * uo, tb)
        ves.append(_barrett(xb * ue + psi1 * we, tb))
        vos.append(_barrett(xb * uo + yb * ue, tb))
    acc_e = _barrett(sum(ves), tb)
    acc_o = _barrett(sum(vos), tb)
    return torch.stack([acc_e, acc_o], dim=-2)                # [P, B, 2, 2, Nh]


def gen_bootstrapping_key_ntt_split(gen: torch.Generator, values: torch.Tensor,
                                    sk_poly: torch.Tensor,
                                    params: SecurityParams, drop: int,
                                    group: int, levels: tuple[int, int],
                                    bgbit: int) -> torch.Tensor:
    """Split-engine BSK in folded split-NTT form.

    values: the TRGSW plaintexts, s0 itself (group 1, [n0]) or the subset
    products of each g-bit key group ([(2^g - 1) G], mask-major per group).
    Returns int16 [n0, P, 2R, 4, Nh] (group 1) or [G, 2^g - 1, P, 2R, 4, Nh].
    Encryption runs in the full X-ring (the exact int64 binary product);
    only the residues are taken half-wise on the N/2 plan."""
    from zig_tfhe_tpu_torch import trgsw as _trgsw

    la, lb = levels
    plan = _ntt.plan_for_params(params, drop, group, levels, bgbit=bgbit,
                                pseudorandom_key=True)
    trgsw_ct = _trgsw.encrypt_gadget_rows(gen, values, params.bsk_alpha,
                                          sk_poly, params, bgbit, la, lb)
    halves = split(trgsw_ct)                                  # [V, R, 2, 2, Nh]
    w = params.torus_bits
    res_e = _ntt.to_ntt_form(halves[..., 0, :], plan, drop, width=w)
    res_o = _ntt.to_ntt_form(halves[..., 1, :], plan, drop, width=w)
    folded = fold_key_split(res_e, res_o, plan)               # [V, P, 2R, 4, Nh]
    if group > 1:
        return folded.reshape(-(-params.n0 // group), (1 << group) - 1,
                              plan.n_primes, 2 * (la + lb), 4, params.N // 2)
    return folded


# ---------------------------------------------------------------------------
# The hi-plane (int32) scan
# ---------------------------------------------------------------------------


def _hi32_offsets(params: SecurityParams, e: int, levels) -> tuple[int, int]:
    """The full-width decomposition offsets of ``_decompose_to_rows``
    (gadget_decompose with center=True), per component (a, b), as Python
    ints mod 2^w."""
    w = params.torus_bits

    def off_for(lv):
        if e == params.bgbit:
            off = params.decomposition_offset
            if lv == params.L and params.L * e < w:
                off = (off + (1 << (w - params.L * e - 1))) % (1 << w)
            return off
        return gadget_offset(e, w // e, w)

    return off_for(levels[0]), off_for(levels[1])


def _hi32_planes(params: SecurityParams, drop_bits: int, e: int,
                 levels) -> bool:
    """True when the scan runs on int32 hi planes: the 64-bit torus, drop
    >= 32 (every step's delta a multiple of 2^32) and no digit shift
    reading below bit 32.  An offset's bits below 32 are added to the
    accumulator's scan-invariant low word before the scan, so that their
    carry sits in the hi planes, and taken off after it."""
    return (params.torus_bits == 64 and drop_bits >= 32
            and params.torus_bits - max(levels) * e >= 32)


def _hi32_viable(params: SecurityParams, drop_bits: int, e: int,
                 levels) -> bool:
    """The JAX package's hi-plane condition: ``_hi32_planes`` and no offset
    bit below 32 (its scan carries no low word; a key at another gadget
    runs its generic int64 scan)."""
    if not _hi32_planes(params, drop_bits, e, levels):
        return False
    off_a, off_b = _hi32_offsets(params, e, levels)
    return off_a % (1 << 32) == 0 and off_b % (1 << 32) == 0


def _rows_hi32(acc_hi: torch.Tensor, params: SecurityParams, e: int,
               levels) -> torch.Tensor:
    """Hi-plane gadget decomposition: int32 [B, 2, 2, Nh] -> digit rows
    int32 [B, 2R, Nh] in (r, q_in) order (the ``_decompose_to_rows`` +
    ``fold_key_split`` layout); digit-exact against the 64-bit
    decomposition under the ``_hi32_planes`` conditions, the offsets' low
    words carried in the accumulator."""
    la, lb = levels
    off_a, off_b = _hi32_offsets(params, e, levels)
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


@functools.lru_cache(maxsize=None)
def half_row_gadget(params: SecurityParams, e: int, levels) -> HalfRowGadget:
    """The ``HalfRowGadget`` of ``_rows_hi32(., params, e, levels)``: the
    numbers K1 takes to write the hi-plane half-rows."""
    return HalfRowGadget(params, e, tuple(levels), tuple(
        off >> 32 for off in _hi32_offsets(params, e, levels)))


def finish_int64(v_hat, acc: torch.Tensor, plan: _ntt.NTTPlan,
                 drop_bits: int) -> torch.Tensor:
    """acc + (CRT(invNTT(v)) << drop) mod 2^64 on an int64 accumulator:
    K1's int64 variant, plain PyTorch ops on any device (the JAX package
    runs it as XLA ops, with no Pallas kernel)."""
    delta = _ntt.ntt_inverse_to_crt(v_hat, plan, 64)
    return acc + (delta << drop_bits if drop_bits else delta)


def blind_rotate_split(tlwe_batch: torch.Tensor, testvec: torch.Tensor,
                       bsk_split: torch.Tensor, params: SecurityParams,
                       drop_bits: int, group: int = 1, levels=None,
                       bgbit: int | None = None) -> torch.Tensor:
    """Blind rotation over the split ring (N > 1024, 64-bit torus).

    tlwe_batch: int64 [B, n0+1]; testvec: int64 [2, N] or [B, 2, N];
    bsk_split: int16 [n0, P, 2R, 4, Nh] (group 1) or [G, 2^g - 1, P, 2R, 4,
    Nh].  Returns int64 [B, 2, N].

    The initial X^(-b) rotation is a coefficient-domain gather on the int64
    testvec (a full-torus NTT rotation would need |conv| <= 2^75, past the
    plan pool); the hi-plane scan then carries its int32 hi planes and
    re-attaches the scan-invariant low word at the end."""
    e = params.bgbit if bgbit is None else bgbit
    rows_ax = bsk_split.shape[2] if group == 1 else bsk_split.shape[3]
    if levels is None:
        levels = rows_ax // 4
    levels = _ntt.norm_levels(params, levels, bgbit=e)
    n_rows = levels[0] + levels[1]
    if 2 * n_rows != rows_ax:
        raise ValueError(f"levels {levels} do not match the split key's "
                         f"{rows_ax} half-rows")
    plan = _ntt.plan_for_params(params, drop_bits, group, levels, bgbit=e,
                                pseudorandom_key=True)
    key_primes = bsk_split.shape[1] if group == 1 else bsk_split.shape[2]
    if key_primes != plan.n_primes:
        raise ValueError(
            f"split BSK holds {key_primes} CRT prime planes but the plan "
            f"selects {plan.n_primes}: the key was generated under another "
            "plan bound")
    n0, N = params.n0, params.N
    Nh = N // 2
    B = tlwe_batch.shape[0]
    e_limbs = _ntt.engine_digit_limbs(e)
    dbound = _ntt.top_limb_bound(1 << (e - 1), e_limbs)

    b_tilda = 2 * N - modswitch(tlwe_batch[:, n0], params)   # [B] in [1, 2N]
    if testvec.dim() == 2:
        testvec = testvec[None]
    hi32 = _hi32_planes(params, drop_bits, e, levels)
    acc = split(negacyclic_rotate(testvec.expand(B, 2, N), b_tilda))
    if hi32:
        # the low word is scan-invariant (every delta is a multiple of
        # 2^32): carry the int32 hi planes only, with each component's
        # offset below bit 32 added first (none on the set's own gadget)
        low = [off % (1 << 32) for off in _hi32_offsets(params, e, levels)]
        for c in (0, 1):
            if low[c]:
                acc[:, c] += low[c]
        acc_lo = acc & 0xFFFFFFFF
        acc = (acc >> 32).to(torch.int32)
    t_cols = modswitch(tlwe_batch[:, :n0].T, params)          # [n0, B] int32

    def fwd(acc):
        if hi32:
            rows = _rows_hi32(acc, params, e, levels)         # [B, 2R, Nh]
        else:
            rows = _decompose_to_rows(acc.reshape(B, 2, N), params, levels,
                                      bgbit=e).reshape(B, 2 * n_rows, Nh)
        if e_limbs == 1:
            return _forward(rows, plan)                       # [P, B, 2R, Nh]
        return torch.stack(_ntt.ntt_forward(rows, plan, e_limbs, dbound))

    # group 2 with one-limb digits on the hi planes: K2s, and K1 writes the
    # next step's half-rows into the buffer K2s has just read (stream
    # order), so only step 0 decomposes
    fused = _k2s.supports(group, e_limbs, hi32)
    gadget = half_row_gadget(params, e, levels) if fused else None

    def finish(acc, v, digits=None):
        # v int32 [P, B, 2, 2, Nh] or int8 [P, B, 2, 2, 2, Nh]
        if hi32:
            out = ntt_inverse_to_crt_acc(
                v.reshape(plan.n_primes, 2 * B, *v.shape[3:]),
                acc.reshape(2 * B, 2, Nh), plan, drop_bits - 32,
                digits=digits, gadget=gadget)
            return out.reshape(B, 2, 2, Nh)
        return finish_int64(v, acc, plan, drop_bits)

    if group == 1:
        with profiling.span("blind_rotate.steps", device=acc.device,
                            steps=n0, fused_steps=0):
            for i in range(n0):
                u = _pointwise(fwd(acc), bsk_split[i], plan)
                acc = finish(acc, rotate_minus1_split(u, t_cols[i], plan))
    else:
        G = bsk_split.shape[0]
        if n0 < group * G:            # ragged n0: a = 0 is the identity rotation
            t_cols = torch.cat([t_cols, t_cols.new_zeros(group * G - n0, B)])
        t_grps = t_cols.reshape(G, group, B)
        with profiling.span("blind_rotate.steps", device=acc.device,
                            steps=G, fused_steps=G - 1 if fused else 0):
            rows = None
            for s in range(G):
                if fused:
                    if rows is None:
                        rows = _rows_hi32(acc, params, e, levels).to(torch.int8)
                    acc = finish(acc, _k2s.split_step_fused(
                        rows, bsk_split[s], t_grps[s], plan, e),
                        rows if s < G - 1 else None)
                    continue
                d_hat = fwd(acc)
                us = [_pointwise(d_hat, bsk_split[s, m], plan)
                      for m in range((1 << group) - 1)]
                acc = finish(acc, rotate_combine_multi_split(
                    us, [t_grps[s, j] for j in range(group)], plan))
    if hi32:
        acc = (acc.to(torch.int64) << 32) + acc_lo
        for c in (0, 1):
            if low[c]:
                acc[:, c] -= low[c]
    return unsplit(acc)
