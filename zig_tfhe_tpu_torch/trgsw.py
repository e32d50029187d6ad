"""TRGSW gadget rows — the bootstrapping key's plaintext layout.

Counterpart of zig_tfhe_tpu/trgsw.py (trgsw.zig:16-72).  Row i of an
engine-gadget TRGSW is TRLWE(p * Bg_e^-(i+1)) added into a[0] (rows
0..la-1) or into b[0] (rows la..la+lb-1).
"""

from __future__ import annotations

import numpy as np
import torch

from zig_tfhe_tpu_torch import trlwe as _trlwe
from zig_tfhe_tpu_torch.params import SecurityParams
from zig_tfhe_tpu_torch.utils.torus import require_width, to_carrier


def gadget_scales(bgbit: int, count: int, width: int = 32) -> np.ndarray:
    """h_i = torus(Bg^-(i+1)) = 2^(width-(i+1)*bgbit), int32 [count]."""
    require_width(width)
    return np.array(
        [to_carrier(1 << (width - (i + 1) * bgbit), width)
         if (i + 1) * bgbit < width
         else 1 if (i + 1) * bgbit == width else 0
         for i in range(count)],
        dtype=np.int32,
    )


def encrypt_gadget_rows(gen: torch.Generator, p: torch.Tensor, alpha: float,
                        sk_poly: torch.Tensor, params: SecurityParams,
                        bgbit: int, la: int, lb: int) -> torch.Tensor:
    """TRGSW-style gadget rows of small integers ``p`` (int32 [...]) with an
    engine gadget base Bg_e = 2^bgbit.  Returns int32 [..., la+lb, 2, N]."""
    p = torch.as_tensor(p, dtype=torch.int32, device=gen.device)
    zeros = torch.zeros((*p.shape, la + lb, params.N), dtype=torch.int32,
                        device=gen.device)
    ct = _trlwe.encrypt_torus(gen, zeros, alpha, sk_poly,
                              width=params.torus_bits)   # [..., la+lb, 2, N]
    h = torch.from_numpy(gadget_scales(bgbit, max(la, lb),
                                       params.torus_bits)).to(gen.device)
    ct[..., 0:la, _trlwe.A, 0] += p[..., None] * h[:la]
    ct[..., la:la + lb, _trlwe.B, 0] += p[..., None] * h[:lb]
    return ct
