"""Seeded randomness for encryption, from an explicit ``torch.Generator``.

Counterpart of zig_tfhe_tpu/utils/rng.py.  Every draw takes the generator
and lands on the generator's device, so the same seed on the same device
gives the same keys and ciphertexts.  The bitstream differs from
``jax.random`` by design: the two packages agree on decrypted values, not on
ciphertext bits.

Noise model: ``round(normal() * alpha * 2^32)`` added mod 2^32, computed in
float32 as in the JAX package (every 32-bit set's stddev alpha*2^32 is far
below f32's exact-integer range).
"""

from __future__ import annotations

import torch

from zig_tfhe_tpu_torch.utils.torus import require_width


def uniform_torus(gen: torch.Generator, shape, width: int = 32) -> torch.Tensor:
    """Uniform torus elements as int32 bit patterns."""
    require_width(width)
    u = torch.randint(0, 1 << 32, tuple(shape), dtype=torch.int64,
                      generator=gen, device=gen.device)
    return u.to(torch.int32)   # int64 -> int32 keeps the low 32 bits


def uniform_binary(gen: torch.Generator, shape) -> torch.Tensor:
    """Uniform {0,1} secret-key bits as int32 (key.zig:49-54)."""
    return torch.randint(0, 2, tuple(shape), dtype=torch.int32,
                         generator=gen, device=gen.device)


def gaussian_torus(gen: torch.Generator, shape, alpha: float,
                   width: int = 32) -> torch.Tensor:
    """Gaussian torus noise with stddev ``alpha`` (of the torus), int32.
    alpha == 0 yields exactly zero noise."""
    require_width(width)
    if alpha == 0.0:
        return torch.zeros(tuple(shape), dtype=torch.int32, device=gen.device)
    n = torch.randn(tuple(shape), dtype=torch.float32, generator=gen,
                    device=gen.device)
    return torch.round(n * float(alpha * float(1 << width))).to(torch.int32)
