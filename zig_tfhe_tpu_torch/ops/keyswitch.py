"""Identity key switching as one int8-limb matrix product.

Counterpart of zig_tfhe_tpu/ops/keyswitch.py: the digits are decomposed
signed in [-B/2, B/2), so the whole key switch is
``out = (0.., b) - D @ KSK1`` with D [B, N1*t] and KSK1 [N1*t, n0+1] at the
carrier width, run exactly through ``small_matmul_torus`` (4 int8
``_int_mm`` passes, 8 against the int64 key on the 64-bit torus).
"""

from __future__ import annotations

import torch

from zig_tfhe_tpu_torch.ops.decomposition import ks_decompose
from zig_tfhe_tpu_torch.ops.poly import small_matmul_torus
from zig_tfhe_tpu_torch.params import SecurityParams
from zig_tfhe_tpu_torch.utils.torus import carrier_dtype, to_carrier


def ks_plaintexts(key_from: torch.Tensor, basebit: int, t: int,
                  width: int = 32) -> torch.Tensor:
    """Carrier [n, t] plaintexts ``key_from[i] * 2^(w-(j+1)*basebit)`` —
    the row encoding every key-switch key matches."""
    dtype = carrier_dtype(width)
    shifts = torch.tensor([to_carrier(1 << (width - (j + 1) * basebit), width)
                           for j in range(t)], dtype=dtype,
                          device=key_from.device)
    return key_from.to(dtype)[:, None] * shifts[None, :]


def key_switch_matmul(ct: torch.Tensor, ksk1: torch.Tensor, basebit: int,
                      t: int, width: int = 32) -> torch.Tensor:
    """Digit-decompose + matmul key switch.

    ct: carrier [..., n_from+1]; ksk1: carrier [n_from*t, n_to+1], row
    (i*t + j) encrypting key_from[i] * 2^(w-(j+1)*basebit) under key_to.
    Returns carrier [..., n_to+1]."""
    n_from = ct.shape[-1] - 1
    digits = ks_decompose(ct[..., :n_from], basebit, t, width)  # [.., n_from, t]
    d = digits.reshape(*digits.shape[:-2], n_from * t)
    out = -small_matmul_torus(d, ksk1, 1 << (basebit - 1), width)
    out[..., -1] += ct[..., n_from]
    return out


def identity_key_switch(tlwe_lv1: torch.Tensor, ksk1: torch.Tensor,
                        params: SecurityParams) -> torch.Tensor:
    """TLWE lv1 -> lv0 under the lv0 key (trgsw.zig:471-502 semantics)."""
    return key_switch_matmul(tlwe_lv1, ksk1, params.basebit, params.iks_t,
                             params.torus_bits)
