"""TRLWE ring ciphertexts, batch-first.

Counterpart of zig_tfhe_tpu/trlwe.py.  A TRLWE ciphertext is a carrier
``[..., 2, N]`` (int32, or int64 on the 64-bit torus) — index 0 is the
mask polynomial ``a``, index 1 the body ``b`` (trlwe.zig:15-18);
``b = a * s + noise + mu`` with an exact negacyclic product.  Sample
extraction (trlwe.zig:146-180) is a flip-gather.
"""

from __future__ import annotations

import numpy as np
import torch

from zig_tfhe_tpu_torch.ops.poly import negacyclic_polymul_binary
from zig_tfhe_tpu_torch.utils import rng as _rng
from zig_tfhe_tpu_torch.utils.torus import (carrier_dtype, to_carrier,
                                            torus_constant_w)

A, B = 0, 1  # component indices on axis -2


def encrypt_torus(gen: torch.Generator, mu: torch.Tensor, alpha: float,
                  sk_poly: torch.Tensor, width: int = 32) -> torch.Tensor:
    """Encrypt torus polynomial plaintexts ``mu`` [..., N] (carriers at
    ``width``).  Returns carrier [..., 2, N] on the generator's device."""
    mu = torch.as_tensor(mu, dtype=carrier_dtype(width), device=gen.device)
    a = _rng.uniform_torus(gen, mu.shape, width)
    noise = _rng.gaussian_torus(gen, mu.shape, alpha, width)
    b = negacyclic_polymul_binary(a, sk_poly) + noise + mu
    return torch.stack([a, b], dim=-2)


def encrypt_bool(gen: torch.Generator, bits, alpha: float,
                 sk_poly: torch.Tensor) -> torch.Tensor:
    """Encrypt boolean polynomials as +-1/8 per coefficient
    (trlwe.zig:67-82).  Returns int32 [..., 2, N]."""
    bits = torch.as_tensor(bits, dtype=torch.bool, device=gen.device)
    mu = torch.where(bits, to_carrier(torus_constant_w(0.125, 32), 32),
                     to_carrier(torus_constant_w(-0.125, 32), 32))
    return encrypt_torus(gen, mu.to(torch.int32), alpha, sk_poly)


def phase(ct: torch.Tensor, sk_poly: torch.Tensor) -> torch.Tensor:
    """b - a*s, carrier [..., N] (exact)."""
    return ct[..., B, :] - negacyclic_polymul_binary(ct[..., A, :], sk_poly)


def decrypt_bool(ct: torch.Tensor, sk_poly: torch.Tensor) -> torch.Tensor:
    return phase(ct, sk_poly) >= 0


def sample_extract(ct: torch.Tensor, k: int = 0) -> torch.Tensor:
    """TLWE(lv1) sample at coefficient ``k`` (trlwe.zig:146-162):
    p[i] = a[k-i] for i <= k else -a[N+k-i];  b = b_poly[k].
    Returns carrier [..., N+1]."""
    return sample_extract_lv0_shaped(ct, ct.shape[-1], k)


def sample_extract_lv0_shaped(ct: torch.Tensor, n0: int,
                              k: int = 0) -> torch.Tensor:
    """The reference's sampleExtractIndex2 (trlwe.zig:165-180): the extract
    at ``k`` keeping only the first n0 mask coefficients, a sample under
    (a truncation of) the lv1 key, as bootstrapWithoutKeySwitch
    (vanilla.zig:58-69) returns it.  Returns carrier [..., n0+1].

    Needs n0 <= N: a degree-N ring sample determines only N mask
    coefficients, so the uint5-uint8 sets (n0 > N) raise ValueError."""
    N = ct.shape[-1]
    if n0 > N:
        raise ValueError(
            f"sample_extract_lv0_shaped needs n0 <= N, got n0={n0} > N={N}")
    i = np.arange(n0)
    src = torch.from_numpy(np.where(i <= k, k - i, N + k - i)).to(ct.device)
    sign = torch.from_numpy(np.where(i <= k, 1, -1).astype(np.int32))
    p = ct[..., A, :][..., src] * sign.to(ct.device)
    return torch.cat([p, ct[..., B, k:k + 1]], dim=-1)
