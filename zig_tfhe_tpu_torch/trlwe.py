"""TRLWE ring ciphertexts, batch-first.

Counterpart of zig_tfhe_tpu/trlwe.py.  A TRLWE ciphertext is int32
``[..., 2, N]`` — index 0 is the mask polynomial ``a``, index 1 the body
``b`` (trlwe.zig:15-18); ``b = a * s + noise + mu`` with an exact
negacyclic product.  Sample extraction (trlwe.zig:146-180) is a flip-gather.
"""

from __future__ import annotations

import numpy as np
import torch

from zig_tfhe_tpu_torch.ops.poly import negacyclic_polymul_binary
from zig_tfhe_tpu_torch.utils import rng as _rng

A, B = 0, 1  # component indices on axis -2


def encrypt_torus(gen: torch.Generator, mu: torch.Tensor, alpha: float,
                  sk_poly: torch.Tensor, width: int = 32) -> torch.Tensor:
    """Encrypt int32 torus polynomial plaintexts ``mu`` [..., N].
    Returns int32 [..., 2, N] on the generator's device."""
    mu = torch.as_tensor(mu, dtype=torch.int32, device=gen.device)
    a = _rng.uniform_torus(gen, mu.shape, width)
    noise = _rng.gaussian_torus(gen, mu.shape, alpha, width)
    b = negacyclic_polymul_binary(a, sk_poly) + noise + mu
    return torch.stack([a, b], dim=-2)


def sample_extract(ct: torch.Tensor, k: int = 0) -> torch.Tensor:
    """TLWE(lv1) sample at coefficient ``k`` (trlwe.zig:146-162):
    p[i] = a[k-i] for i <= k else -a[N+k-i];  b = b_poly[k].
    Returns int32 [..., N+1]."""
    N = ct.shape[-1]
    i = np.arange(N)
    src = torch.from_numpy(np.where(i <= k, k - i, N + k - i)).to(ct.device)
    sign = torch.from_numpy(np.where(i <= k, 1, -1).astype(np.int32)).to(ct.device)
    p = ct[..., A, :][..., src] * sign
    return torch.cat([p, ct[..., B, k:k + 1]], dim=-1)
