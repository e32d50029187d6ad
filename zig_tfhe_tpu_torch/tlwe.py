"""TLWE ciphertexts, batch-first.

Counterpart of zig_tfhe_tpu/tlwe.py.  A TLWE ciphertext is int32
``[..., n+1]``: the mask ``a`` in the first n slots and the body ``b`` last
(tlwe.zig:11-14).  Boolean encoding is +-1/8 (tlwe.zig:52-55).
"""

from __future__ import annotations

import torch

from zig_tfhe_tpu_torch.utils import rng as _rng
from zig_tfhe_tpu_torch.utils.torus import to_carrier, torus_constant_w

BOOL_MU = 0.125  # tlwe.zig:53


def _inner_product_binary(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """<a, s> mod 2^32 for binary s.  ``torch.sum`` of int32 returns int64;
    the cast back keeps the low 32 bits, which is the wrap."""
    return (a * s.to(a.dtype)).sum(-1).to(torch.int32)


def encrypt_torus(gen: torch.Generator, mu: torch.Tensor, alpha: float,
                  sk: torch.Tensor, width: int = 32) -> torch.Tensor:
    """Encrypt int32 torus plaintexts ``mu`` [...] under binary key ``sk``:
    b = <a, s> + gaussian(alpha) + mu, a uniform (tlwe.zig:34-49).
    Returns int32 [..., n+1] on the generator's device."""
    mu = torch.as_tensor(mu, dtype=torch.int32, device=gen.device)
    n = sk.shape[-1]
    a = _rng.uniform_torus(gen, (*mu.shape, n), width)
    noise = _rng.gaussian_torus(gen, mu.shape, alpha, width)
    b = _inner_product_binary(a, sk) + noise + mu
    return torch.cat([a, b[..., None]], dim=-1)


def encrypt_bool(gen: torch.Generator, bits, alpha: float, sk: torch.Tensor,
                 width: int = 32) -> torch.Tensor:
    """Encrypt booleans as +-1/8 (tlwe.zig:52-55)."""
    bits = torch.as_tensor(bits, dtype=torch.bool, device=gen.device)
    mu = torch.where(bits, to_carrier(torus_constant_w(BOOL_MU, width), width),
                     to_carrier(torus_constant_w(-BOOL_MU, width), width))
    return encrypt_torus(gen, mu.to(torch.int32), alpha, sk, width)


def phase(ct: torch.Tensor, sk: torch.Tensor) -> torch.Tensor:
    """b - <a, s> (the noisy plaintext), int32 [...]."""
    n = sk.shape[-1]
    return ct[..., n] - _inner_product_binary(ct[..., :n], sk)


def decrypt_bool(ct: torch.Tensor, sk: torch.Tensor) -> torch.Tensor:
    """Sign test on the phase (tlwe.zig:58-68)."""
    return phase(ct, sk) >= 0


# Linear homomorphic ops (tlwe.zig:119-239) — int32 wrap == u32 wrap.

def add(x, y):
    return x + y


def sub(x, y):
    return x - y


def neg(x):
    return -x


def add_mul(x, y, multiplier: int):
    return x + y * multiplier


def sub_mul(x, y, multiplier: int):
    return x - y * multiplier


def add_to_b(ct: torch.Tensor, const_torus: int, n: int) -> torch.Tensor:
    """ct with ``const_torus`` added to the body only (gate bias)."""
    out = ct.clone()
    out[..., n] += to_carrier(const_torus, 32)
    return out
