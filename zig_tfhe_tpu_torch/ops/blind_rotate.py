"""Blind rotation entry point, the Toeplitz engine and their helpers.

Counterpart of zig_tfhe_tpu/ops/blind_rotate.py.  ``blind_rotate`` picks
the engine by the key's form, as the JAX package's default does: the
matmul NTT (ops/blind_rotate_ntt.py) when the key holds ``bsk_ntt``, else
the Toeplitz engine on the key's ``bsk_ext_limbs``.  The Toeplitz engine
(``blind_rotate_toeplitz``) is the reference's CMux loop with its exact
gadget and per-bit key: each of the n0 steps rotates the accumulator by
X^a, decomposes the difference and adds its external product with
BSK[i], one int8 contraction per key limb against the negacyclic
circulants of the key's rows.  On CUDA tensors that contraction is the
hand-written kernel ops/cuda/extprod.py:extprod_matmul (K3), once per
digit limb; on CPU tensors its plain version.  The JAX package's two
Toeplitz engines, "xla" (circulants through HBM) and "pallas" (K3's TPU
original), give the same bits as this one path.
"""

from __future__ import annotations

import torch

from zig_tfhe_tpu_torch.ops.decomposition import gadget_decompose
from zig_tfhe_tpu_torch.ops.ntt import norm_levels
from zig_tfhe_tpu_torch.ops.poly import negacyclic_rotate
from zig_tfhe_tpu_torch.params import SecurityParams
from zig_tfhe_tpu_torch.utils import profiling
from zig_tfhe_tpu_torch.utils.torus import (carrier_dtype, i32_to_i8_limbs,
                                            shift_right_logical, to_carrier)


def _decompose_to_rows(ct: torch.Tensor, params: SecurityParams, levels=None,
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


def modswitch(x: torch.Tensor, params: SecurityParams) -> torch.Tensor:
    """Torus carrier -> [0, 2N] rotation amount, int32 at every width
    (trgsw.zig:297,312): (x + 2^(w-nbit-2)) >>u (w-nbit-1)."""
    w = params.torus_bits
    rounded = x + to_carrier(1 << (w - params.nbit - 2), w)
    return shift_right_logical(rounded, w - params.nbit - 1).to(torch.int32)


def _digit_limbs(ct: torch.Tensor, params: SecurityParams) -> torch.Tensor:
    """[..., 2, N] -> the gadget digits' int8 limbs [..., 2L*N, digit_limbs]
    (a-levels then b-levels, each [N])."""
    rows = _decompose_to_rows(ct, params)        # [..., 2L, N]
    d = rows.reshape(*rows.shape[:-2], 2 * params.L * params.N)
    return i32_to_i8_limbs(d, params.digit_limbs)


def external_product(ext_limbs: torch.Tensor, ct: torch.Tensor,
                     params: SecurityParams) -> torch.Tensor:
    """TRGSW (ext-limb form, int8 [n_klimbs, 2L, 2, 2N]) x TRLWE batch
    int32 [B, 2, N] -> TRLWE batch, exact mod 2^32
    (externalProductWithFft, trgsw.zig:111-154, with matmuls in place of
    FFT/MAC/IFFT): one K3 call (ops/cuda/extprod.py) per digit limb, each
    partial shifted by 8*dl."""
    from zig_tfhe_tpu_torch.ops.cuda.extprod import extprod_matmul

    d_limbs = _digit_limbs(ct, params)
    out = None
    for dl in range(params.digit_limbs):
        part = extprod_matmul(d_limbs[..., dl], ext_limbs, params)
        out = part if out is None else out + (part << 8 * dl)
    return out.reshape(*ct.shape[:-2], 2, params.N)


def cmux(ext_limbs: torch.Tensor, ct0: torch.Tensor, ct1: torch.Tensor,
         params: SecurityParams) -> torch.Tensor:
    """ct0 + ExtProd(cond, ct1 - ct0): cond == 0 -> ct0, cond == 1 -> ct1
    (trgsw.zig:260-284)."""
    return ct0 + external_product(ext_limbs, ct1 - ct0, params)


def blind_rotate(tlwe_batch: torch.Tensor, testvec: torch.Tensor, ck,
                 params: SecurityParams) -> torch.Tensor:
    """Blind rotation of a batch of TLWE lv0 ciphertexts.

    tlwe_batch: carrier [B, n0+1] (int32, int64 on the 64-bit torus);
    testvec: carrier [2, N] (shared) or [B, 2, N] (per lane); ck: CloudKey.
    Returns carrier [B, 2, N].  The NTT engine runs when the key holds
    ``bsk_ntt``, else the Toeplitz engine."""
    from zig_tfhe_tpu_torch.ops.blind_rotate_ntt import blind_rotate_ntt

    want = carrier_dtype(params.torus_bits)
    if tlwe_batch.dtype != want:
        # a width-mismatched ciphertext would modswitch garbage silently
        raise TypeError(
            f"ciphertext dtype {tlwe_batch.dtype} does not match the "
            f"{params.torus_bits}-bit torus carrier {want}: encrypt with "
            f"width={params.torus_bits}")
    if ck.bsk_ntt is not None:
        return blind_rotate_ntt(tlwe_batch, testvec, ck.bsk_ntt, params,
                                ck.bsk_ntt_drop, group=ck.bsk_group,
                                levels=ck.bsk_levels, bgbit=ck.bsk_bgbit)
    return blind_rotate_toeplitz(tlwe_batch, testvec, ck.bsk_ext_limbs, params)


def blind_rotate_toeplitz(tlwe_batch: torch.Tensor, testvec: torch.Tensor,
                          bsk_ext_limbs: torch.Tensor,
                          params: SecurityParams) -> torch.Tensor:
    """The Toeplitz engine (blindRotate, trgsw.zig:290-333): rotate the
    testvec by -b, then fold in each of the n0 LWE coefficients with a
    CMux against BSK[i] (int8 [n0, n_kl, 2L, 2, 2N]); ``lax.scan`` becomes
    a Python loop.  Returns int32 [B, 2, N]."""
    n0, N = params.n0, params.N
    B = tlwe_batch.shape[0]
    b_tilda = 2 * N - modswitch(tlwe_batch[:, n0], params)     # in [1, 2N]
    if testvec.dim() == 2:
        testvec = testvec.expand(B, *testvec.shape)
    acc = negacyclic_rotate(testvec, b_tilda)
    a_cols = tlwe_batch[:, :n0].T                               # [n0, B]
    with profiling.span("blind_rotate.steps", device=acc.device, steps=n0):
        for i in range(n0):
            rotated = negacyclic_rotate(acc, modswitch(a_cols[i], params))
            acc = cmux(bsk_ext_limbs[i], acc, rotated, params)
    return acc
