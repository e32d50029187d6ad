"""Blind rotation on the matmul-NTT engine.

Counterpart of zig_tfhe_tpu/ops/blind_rotate_ntt.py.  Per step:

    digits = gadget_decompose(acc)                 # coefficient domain
    d_hat  = NTT(digits)                           # int8 matmuls
    u_hat  = sum_rows d_hat * BSK_hat[i]           # pointwise modmul
    v_hat  = (psi^t - 1) * u_hat                   # NTT-domain X^t rotation
    acc   += CRT(invNTT(v_hat)) << drop_bits       # K1

``lax.scan`` becomes a Python loop over the steps (234 at the 128-bit
default, group 3).  At multi-bit groups 2 and 3 with one-limb engine
digits (every boolean key), and at group 2 with 2-3-limb engine digits
(every uint key: Bg_e 2^10 to 2^23), a step is decompose -> limb planes
(``digit_planes``; the digits themselves for one limb) -> the fused step
core ops/cuda/ntt_step.py:ntt_step_fused (K2: forward NTT, pointwise
products and subset combine) -> ops/cuda/ntt_inverse.py:
ntt_inverse_to_crt_acc (K1).  Each is the hand-written kernel on CUDA
tensors and its plain version on CPU tensors.  At group 2 K2 follows the
JAX package's Pallas step kernel (``ZTFHE_PALLAS=1``), at group 3 its XLA
``step_multi``; at group 2 the accumulator is also bit-equal to the JAX
package's default XLA step (``step2``, which the JAX package runs for the
uint keys), whose residues differ only by multiples of p.  Group 1,
groups above 3 and group 3 with multi-limb digits run the plain ops of
the JAX package's XLA step (the pointwise/rotate barrett fold for
one-limb digits) and then K1.  The path is chosen from the key's
configuration before any launch.

The 64-bit torus: a split-ring set (N > 1024) runs
ops/split_ring.py:blind_rotate_split, whose hi-plane step finishes on
K1.  The direct engine at width 64 (TEST_TINY64, N = 64) runs the plain
ops at every group and finishes with K1's int64 variant
(split_ring.py:finish_int64), plain PyTorch ops on the card as on the CPU.
"""

from __future__ import annotations

import torch

from zig_tfhe_tpu_torch.ops import ntt as _ntt
from zig_tfhe_tpu_torch.ops.blind_rotate import _decompose_to_rows, modswitch
from zig_tfhe_tpu_torch.ops.cuda.ntt_inverse import ntt_inverse_to_crt_acc
from zig_tfhe_tpu_torch.ops.cuda.ntt_step import (digit_planes,
                                                  ntt_step_fused, supports)
from zig_tfhe_tpu_torch.ops.split_ring import blind_rotate_split, finish_int64
from zig_tfhe_tpu_torch.params import SecurityParams
from zig_tfhe_tpu_torch.utils import profiling


def rotate_via_ntt(polys: torch.Tensor, t: torch.Tensor,
                   plan: _ntt.NTTPlan, width: int = 32) -> torch.Tensor:
    """Exact negacyclic X^t rotation of full-torus polys (carriers at
    ``width``) through the NTT.  polys: [B or 1, ..., N] (batch axis
    leading); t: int32 [B]."""
    p_hat = _ntt.ntt_forward(polys, plan, digit_limbs=width // 8,
                             digit_bound=128)
    r_hat = _ntt.rotate_diag(p_hat, t, plan, minus_one=False)
    return _ntt.ntt_inverse_to_crt(r_hat, plan, width)


def blind_rotate_ntt(tlwe_batch: torch.Tensor, testvec: torch.Tensor,
                     bsk_ntt: torch.Tensor, params: SecurityParams,
                     drop_bits: int, group: int = 1, levels=None,
                     bgbit: int | None = None) -> torch.Tensor:
    """tlwe_batch carrier [B, n0+1]; testvec carrier [2, N] or [B, 2, N];
    bsk_ntt int16 [n0, P, la+lb, 2, N] (group 1) or
    [G, 2^g-1, P, la+lb, 2, N] (multi-bit, G = ceil(n0/g)), or the split
    key's [.., P, 2R, 4, N/2] on a split-ring set.  Returns carrier
    [B, 2, N].  (bgbit, levels) is the key's engine gadget (None: the
    parameter base / levels read off the key's row axis)."""
    if params.split_ring:
        return blind_rotate_split(tlwe_batch, testvec, bsk_ntt, params,
                                  drop_bits, group=group, levels=levels,
                                  bgbit=bgbit)
    w = params.torus_bits
    e = params.bgbit if bgbit is None else bgbit
    row_axis = 2 if group == 1 else 3
    if levels is None:
        levels = bsk_ntt.shape[row_axis] // 2
    levels = _ntt.norm_levels(params, levels, bgbit=e)
    if levels[0] + levels[1] != bsk_ntt.shape[row_axis]:
        raise ValueError(f"levels {levels} do not match the key's "
                         f"{bsk_ntt.shape[row_axis]} gadget rows")
    plan = _ntt.plan_for_params(params, drop_bits, group, levels, bgbit=e,
                                pseudorandom_key=True)
    key_primes = bsk_ntt.shape[row_axis - 1]
    if key_primes != plan.n_primes:
        raise ValueError(
            f"BSK holds {key_primes} CRT prime planes but the plan selects "
            f"{plan.n_primes}: the key was generated under another plan bound")
    n0, N = params.n0, params.N
    B = tlwe_batch.shape[0]
    e_limbs = _ntt.engine_digit_limbs(e)
    dbound = _ntt.top_limb_bound(1 << (e - 1), e_limbs)
    fold = e_limbs == 1

    b_tilda = 2 * N - modswitch(tlwe_batch[:, n0], params)
    if testvec.dim() == 2:
        testvec = testvec[None]          # [1, 2, N] broadcasts against [B]
    acc = rotate_via_ntt(testvec, b_tilda, plan, w)
    if acc.shape[0] != B:
        acc = acc.expand(B, 2, N).contiguous()
    a_cols = tlwe_batch[:, :n0].T        # [n0, B]

    def fwd(acc):
        rows = _decompose_to_rows(acc, params, levels, bgbit=e)
        return _ntt.ntt_forward(rows, plan, e_limbs, dbound)

    def finish(acc, v_hat):
        if w == 64:
            return finish_int64(v_hat, acc, plan, drop_bits)
        return ntt_inverse_to_crt_acc(torch.stack(v_hat), acc, plan, drop_bits)

    if group == 1:
        with profiling.span("blind_rotate.steps", device=acc.device,
                            steps=n0):
            for i in range(n0):
                t = modswitch(a_cols[i], params)
                u_hat = _ntt.pointwise_extprod(fwd(acc), bsk_ntt[i], plan,
                                               reduce_output=False)
                acc = finish(acc, _ntt.rotate_diag(u_hat, t, plan))
        return acc

    G = bsk_ntt.shape[0]
    if n0 < group * G:                   # ragged n0: pad a = 0 (no rotation)
        a_cols = torch.cat([a_cols, a_cols.new_zeros(group * G - n0, B)])
    a_groups = a_cols.reshape(G, group, B)
    if w == 32 and supports(group, e_limbs):
        ts = modswitch(a_groups, params)     # every step's rotations at once
        with profiling.span("blind_rotate.steps", device=acc.device,
                            steps=G):
            for s in range(G):
                digits = _decompose_to_rows(acc, params, levels, bgbit=e)
                v = ntt_step_fused(digit_planes(digits, e_limbs), bsk_ntt[s],
                                   ts[s], plan, e)
                acc = ntt_inverse_to_crt_acc(v, acc, plan, drop_bits)
        return acc
    with profiling.span("blind_rotate.steps", device=acc.device, steps=G):
        for s in range(G):
            ts = [modswitch(a_groups[s, j], params) for j in range(group)]
            d_hat = fwd(acc)
            us = [_ntt.pointwise_extprod(d_hat, bsk_ntt[s, m], plan,
                                         reduce_output=not fold)
                  for m in range((1 << group) - 1)]
            acc = finish(acc, _ntt.rotate_combine_multi(us, ts, plan,
                                                        u_wide=fold))
    return acc
