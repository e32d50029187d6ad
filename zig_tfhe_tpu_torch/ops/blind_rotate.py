"""Blind rotation entry point and its coefficient-domain helpers.

Counterpart of zig_tfhe_tpu/ops/blind_rotate.py.  The port has one engine,
the matmul NTT (ops/blind_rotate_ntt.py), which is also the JAX package's
default; the Toeplitz oracle engines are a later slice.
"""

from __future__ import annotations

import torch

from zig_tfhe_tpu_torch.ops.decomposition import gadget_decompose
from zig_tfhe_tpu_torch.ops.ntt import norm_levels
from zig_tfhe_tpu_torch.params import SecurityParams
from zig_tfhe_tpu_torch.utils.torus import shift_right_logical, to_carrier


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
    """Torus carrier -> [0, 2N] rotation amount, int32 (trgsw.zig:297,312):
    (x + 2^(w-nbit-2)) >>u (w-nbit-1)."""
    w = params.torus_bits
    rounded = x + to_carrier(1 << (w - params.nbit - 2), w)
    return shift_right_logical(rounded, w - params.nbit - 1)


def blind_rotate(tlwe_batch: torch.Tensor, testvec: torch.Tensor, ck,
                 params: SecurityParams) -> torch.Tensor:
    """Blind rotation of a batch of TLWE lv0 ciphertexts.

    tlwe_batch: int32 [B, n0+1]; testvec: int32 [2, N] (shared) or
    [B, 2, N] (per lane); ck: CloudKey.  Returns int32 [B, 2, N]."""
    from zig_tfhe_tpu_torch.ops.blind_rotate_ntt import blind_rotate_ntt

    if tlwe_batch.dtype != torch.int32:
        raise TypeError(
            f"ciphertext dtype {tlwe_batch.dtype} does not match the 32-bit "
            "torus carrier torch.int32")
    return blind_rotate_ntt(tlwe_batch, testvec, ck.bsk_ntt, params,
                            ck.bsk_ntt_drop, group=ck.bsk_group,
                            levels=ck.bsk_levels, bgbit=ck.bsk_bgbit)
