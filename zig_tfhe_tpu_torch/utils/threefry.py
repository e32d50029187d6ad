"""Threefry-2x32 random bits, equal to ``jax.random.bits`` for a raw key.

The seeded ciphertexts of the JAX package (zig_tfhe_tpu/tlwe.py:
encrypt_torus_seeded / expand_seeded) publish a threefry key's data,
uint32 [2], and derive the mask from it as ``jax.random.bits(key, shape,
uint32)``.  To read and write those files the port reproduces that draw
bit for bit, as jax 0.9 computes it with ``jax_threefry_partitionable``
set (its default, jax/_src/prng.py:_threefry_random_bits_partitionable):

  * element e of the row-major flattened shape takes its index as the
    counter pair (hi, lo) = (e >> 32, e & 0xffffffff) (``iota_2x32_shape``);
  * the pair is hashed by Threefry-2x32 with 20 rounds under the key
    (k1, k2): rotations (13, 15, 26, 6) and (17, 29, 16, 24) in turn, the
    key schedule (k1, k2, k1 ^ k2 ^ 0x1BD11BDA) injected after every four
    rounds with the injection count added to the second word
    (prng.py:_threefry2x32_lowering);
  * the uint32 draw is the XOR of the two output words.

The arithmetic runs as elementwise torch ops on int64 tensors that hold
uint32 values, each sum masked back to 32 bits, on the device of the
result, so a batch's mask is expanded where the batch lives.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k1: int, k2: int, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter words x0, x1 (int64 tensors
    holding uint32 values) under the key (k1, k2).  Returns the two output
    words, int64 holding uint32."""
    ks = (k1 & _M32, k2 & _M32, (k1 ^ k2 ^ _PARITY) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def random_bits32(key_data, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bits(jax.random.wrap_key_data(key_data), shape,
    jnp.uint32)`` as int32 bit patterns (the torus carrier), on ``device``.

    key_data: the two uint32 words of a threefry key (a sequence, numpy
    array or tensor)."""
    words = (key_data.flatten().tolist() if isinstance(key_data, torch.Tensor)
             else np.asarray(key_data).ravel().tolist())
    k1, k2 = (int(k) & _M32 for k in words)
    shape = tuple(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(k1, k2, idx >> 32, idx & _M32)
    return (b0 ^ b1).to(torch.int32).reshape(shape)  # keeps the low 32 bits
