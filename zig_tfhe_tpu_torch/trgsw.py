"""TRGSW gadget rows — the bootstrapping key's plaintext layout.

Counterpart of zig_tfhe_tpu/trgsw.py (trgsw.zig:16-72).  Row i of an
engine-gadget TRGSW is TRLWE(p * Bg_e^-(i+1)) added into a[0] (rows
0..la-1) or into b[0] (rows la..la+lb-1).

The Toeplitz engine's key form is the **negacyclic-extension int8-limb
form** ``ext_limbs`` int8 [..., n_klimbs, 2L, 2, 2N]: ext = [p, -p] of
each TRGSW row, recoded into signed 8-bit limbs (``to_ext_limbs``).
"""

from __future__ import annotations

import numpy as np
import torch

from zig_tfhe_tpu_torch import trlwe as _trlwe
from zig_tfhe_tpu_torch.ops.poly import negacyclic_extend, toeplitz_from_ext
from zig_tfhe_tpu_torch.params import SecurityParams
from zig_tfhe_tpu_torch.utils.torus import (carrier_dtype, i32_to_i8_limbs,
                                            to_carrier)

N_KLIMBS = 4  # full 32-bit torus => 4 signed 8-bit limbs


def gadget_scales(bgbit: int, count: int, width: int = 32) -> np.ndarray:
    """h_i = torus(Bg^-(i+1)) = 2^(width-(i+1)*bgbit), int32 (int64 at
    width 64) [count]."""
    return np.array(
        [to_carrier(1 << (width - (i + 1) * bgbit), width)
         if (i + 1) * bgbit < width
         else 1 if (i + 1) * bgbit == width else 0
         for i in range(count)],
        dtype=np.int32 if carrier_dtype(width) == torch.int32 else np.int64,
    )


def encrypt_torus(gen: torch.Generator, p: torch.Tensor, alpha: float,
                  sk_poly: torch.Tensor, params: SecurityParams) -> torch.Tensor:
    """TRGSW-encrypt small integers ``p`` (int32 [...]) with the
    parameter-set gadget (trgsw.zig:35-71).  Returns int32 [..., 2L, 2, N]."""
    return encrypt_gadget_rows(gen, p, alpha, sk_poly, params, params.bgbit,
                               params.L, params.L)


def encrypt_gadget_rows(gen: torch.Generator, p: torch.Tensor, alpha: float,
                        sk_poly: torch.Tensor, params: SecurityParams,
                        bgbit: int, la: int, lb: int) -> torch.Tensor:
    """TRGSW-style gadget rows of small integers ``p`` (int32 [...]) with an
    engine gadget base Bg_e = 2^bgbit.  Returns carrier [..., la+lb, 2, N]
    at the set's width."""
    p = torch.as_tensor(p, dtype=torch.int32, device=gen.device)
    zeros = torch.zeros((*p.shape, la + lb, params.N),
                        dtype=carrier_dtype(params.torus_bits),
                        device=gen.device)
    ct = _trlwe.encrypt_torus(gen, zeros, alpha, sk_poly,
                              width=params.torus_bits)   # [..., la+lb, 2, N]
    h = torch.from_numpy(gadget_scales(bgbit, max(la, lb),
                                       params.torus_bits)).to(gen.device)
    ct[..., 0:la, _trlwe.A, 0] += p[..., None] * h[:la]
    ct[..., la:la + lb, _trlwe.B, 0] += p[..., None] * h[:lb]
    return ct


def to_ext_limbs(trgsw_ct: torch.Tensor, n_klimbs: int = N_KLIMBS) -> torch.Tensor:
    """TRGSW int32 [..., 2L, 2, N] -> int8 [..., n_klimbs, 2L, 2, 2N], the
    Toeplitz engine's static operand (the analog of TRGSWLv1FFT.new,
    trgsw.zig:81-91).

    n_klimbs < 4 rounds each value to its top 8*n_klimbs bits,
    (ext + 2^(8*drop-1)) >> 8*drop with an arithmetic shift and a wrapping
    add; the external product then starts the key-limb shifts at
    8*drop, drop = 4 - n_klimbs."""
    drop = N_KLIMBS - n_klimbs
    ext = negacyclic_extend(trgsw_ct)                 # [..., 2L, 2, 2N]
    if drop:
        ext = (ext + (1 << (8 * drop - 1))) >> (8 * drop)
    limbs = i32_to_i8_limbs(ext, n_klimbs)            # [..., 2L, 2, 2N, n_kl]
    return limbs.movedim(-1, -4).contiguous()


def trgsw_matrices(ext_limbs: torch.Tensor,
                   params: SecurityParams) -> torch.Tensor:
    """ext-limb TRGSW int8 [n_klimbs, 2L, 2, 2N] -> the matmul operands
    int8 [n_klimbs, 2L*N, 2N] (the negacyclic circulant per row and
    component; the JAX package's ops/blind_rotate.py:_trgsw_matrices)."""
    T = toeplitz_from_ext(ext_limbs)             # [kl, 2L, 2, N(k), N(n)]
    T = T.movedim(-2, -3)                        # [kl, 2L, N(k), 2, N(n)]
    return T.reshape(T.shape[0], 2 * params.L * params.N, 2 * params.N)
