"""Seeded randomness for encryption, from an explicit ``torch.Generator``.

Counterpart of zig_tfhe_tpu/utils/rng.py.  Every draw takes the generator
and lands on the generator's device, so the same seed on the same device
gives the same keys and ciphertexts.  The bitstream differs from
``jax.random`` by design: the two packages agree on decrypted values, not on
ciphertext bits.

Noise model: ``round(normal() * alpha * 2^w)`` added mod 2^w, computed in
float32 as in the JAX package (at width 32 every set's stddev is far below
f32's exact-integer range; at width 64 large stddevs quantize to f32 ulps,
a relative 2^-24 perturbation of each sample).
"""

from __future__ import annotations

import torch

from zig_tfhe_tpu_torch.utils.torus import carrier_dtype


def _uniform32(gen: torch.Generator, shape) -> torch.Tensor:
    """Uniform 32-bit patterns in [0, 2^32) as int64."""
    return torch.randint(0, 1 << 32, tuple(shape), dtype=torch.int64,
                         generator=gen, device=gen.device)


def uniform_torus(gen: torch.Generator, shape, width: int = 32) -> torch.Tensor:
    """Uniform torus elements as int32 (width 32) or int64 (width 64) bit
    patterns.  ``torch.randint`` cannot span 2^64, so a 64-bit element is
    two 32-bit draws, the high half first."""
    if carrier_dtype(width) == torch.int64:
        hi = _uniform32(gen, shape)
        return (hi << 32) | _uniform32(gen, shape)
    return _uniform32(gen, shape).to(torch.int32)   # keeps the low 32 bits


def uniform_binary(gen: torch.Generator, shape) -> torch.Tensor:
    """Uniform {0,1} secret-key bits as int32 (key.zig:49-54)."""
    return torch.randint(0, 2, tuple(shape), dtype=torch.int32,
                         generator=gen, device=gen.device)


def gaussian_torus(gen: torch.Generator, shape, alpha: float,
                   width: int = 32) -> torch.Tensor:
    """Gaussian torus noise with stddev ``alpha`` (of the torus) as the
    width's carrier.  alpha == 0 yields exactly zero noise."""
    dtype = carrier_dtype(width)
    if alpha == 0.0:
        return torch.zeros(tuple(shape), dtype=dtype, device=gen.device)
    n = torch.randn(tuple(shape), dtype=torch.float32, generator=gen,
                    device=gen.device)
    return torch.round(n * float(alpha * float(1 << width))).to(dtype)
