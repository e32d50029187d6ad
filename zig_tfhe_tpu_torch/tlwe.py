"""TLWE ciphertexts, batch-first.

Counterpart of zig_tfhe_tpu/tlwe.py.  A TLWE ciphertext is a carrier
``[..., n+1]`` (int32 on the 32-bit torus, int64 on the 64-bit one): the
mask ``a`` in the first n slots and the body ``b`` last (tlwe.zig:11-14).
Boolean encoding is +-1/8 (tlwe.zig:52-55); the PBS message codec puts
message x of modulus m at x/(2m) (tlwe.zig:74-117).
"""

from __future__ import annotations

import numpy as np
import torch

from zig_tfhe_tpu_torch.utils import rng as _rng
from zig_tfhe_tpu_torch.utils import threefry as _threefry
from zig_tfhe_tpu_torch.utils.torus import (carrier_dtype, carrier_width,
                                            f64_to_torus, to_carrier,
                                            torus_constant_w)

BOOL_MU = 0.125  # tlwe.zig:53


def _inner_product_binary(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """<a, s> mod 2^w for binary s.  ``torch.sum`` of int32 returns int64;
    the cast back keeps the low 32 bits, which is the wrap (int64 sums wrap
    mod 2^64 themselves)."""
    return (a * s.to(a.dtype)).sum(-1).to(a.dtype)


def encrypt_from_draws(a: torch.Tensor, noise: torch.Tensor, mu: torch.Tensor,
                       sk: torch.Tensor) -> torch.Tensor:
    """The deterministic core of an encryption: the body <a, s> + noise +
    mu of the mask ``a`` [..., n] and the drawn noise [...] (carriers).
    Returns carrier [...]."""
    return _inner_product_binary(a, sk) + noise + mu


def encrypt_torus(gen: torch.Generator, mu: torch.Tensor, alpha: float,
                  sk: torch.Tensor, width: int = 32) -> torch.Tensor:
    """Encrypt torus plaintexts ``mu`` [...] (carriers at ``width``) under
    binary key ``sk``: b = <a, s> + gaussian(alpha) + mu, a uniform
    (tlwe.zig:34-49).  Returns carrier [..., n+1] on the generator's
    device."""
    mu = torch.as_tensor(mu, dtype=carrier_dtype(width), device=gen.device)
    n = sk.shape[-1]
    a = _rng.uniform_torus(gen, (*mu.shape, n), width)
    noise = _rng.gaussian_torus(gen, mu.shape, alpha, width)
    return torch.cat([a, encrypt_from_draws(a, noise, mu, sk)[..., None]],
                     dim=-1)


def require_seeded_width(width: int) -> None:
    """Raise ValueError unless ``width`` is 32 (seeded ciphertexts)."""
    if width != 32:
        raise ValueError(
            "seeded ciphertexts are 32-bit only: the JAX package's width-64 "
            "seeded files do not round-trip (its save_seeded_ciphertext "
            "views an int64 body as uint32 [2x] and load_seeded_ciphertext "
            "reads it back as int32), so the port does not copy that format")


def encrypt_torus_seeded(gen: torch.Generator, mu: torch.Tensor, alpha: float,
                         sk: torch.Tensor, width: int = 32):
    """Seeded (compressed) encryption: returns ``(mask_seed, b)``, with
    ``mask_seed`` the two words of a threefry key as numpy uint32 [2] and
    ``b`` int32 [...] on the generator's device.  The wire form is (n+1)x
    smaller than the ciphertext, which ``expand_seeded(mask_seed, b, n)``
    rebuilds exactly; the mask is the JAX package's draw from that key
    (utils/threefry.py), so the two packages' seeded files cross.

    SECURITY: only the MASK seed is returned/published — the mask ``a`` is
    public in any LWE ciphertext, so a seed that derives ``a`` and nothing
    else reveals nothing extra (under the PRF assumption on threefry).
    The noise is drawn from ``gen``, apart from the seed, and must stay
    secret: publishing the randomness that drew it would let anyone
    recompute the Gaussian noise and solve ``b - noise - mu = <a, s>`` for
    the secret key.  Width 32 only (ValueError otherwise)."""
    require_seeded_width(width)
    mu = torch.as_tensor(mu, dtype=torch.int32, device=gen.device)
    words = torch.randint(0, 1 << 32, (2,), dtype=torch.int64, generator=gen,
                          device=gen.device)
    mask_seed = words.cpu().numpy().astype(np.uint32)
    a = _threefry.random_bits32(mask_seed, (*mu.shape, sk.shape[-1]),
                                gen.device)
    noise = _rng.gaussian_torus(gen, mu.shape, alpha, width)
    return mask_seed, encrypt_from_draws(a, noise, mu, sk)


def expand_seeded(mask_seed, b: torch.Tensor, n: int,
                  width: int = 32) -> torch.Tensor:
    """(mask_seed, b) -> the ciphertext int32 [..., n+1] on b's device (see
    encrypt_torus_seeded; ``mask_seed`` is the published threefry key data,
    uint32 [2]).  Width 32 only (ValueError otherwise)."""
    require_seeded_width(width)
    b = torch.as_tensor(b, dtype=torch.int32)
    a = _threefry.random_bits32(mask_seed, (*b.shape, n), b.device)
    return torch.cat([a, b[..., None]], dim=-1)


def encrypt_bool(gen: torch.Generator, bits, alpha: float, sk: torch.Tensor,
                 width: int = 32) -> torch.Tensor:
    """Encrypt booleans as +-1/8 (tlwe.zig:52-55)."""
    mu = bool_mu(bits, width, gen.device)
    return encrypt_torus(gen, mu, alpha, sk, width)


def encrypt_bool_seeded(gen: torch.Generator, bits, alpha: float,
                        sk: torch.Tensor, width: int = 32):
    """Seeded-form boolean encryption (see encrypt_torus_seeded)."""
    mu = bool_mu(bits, width, gen.device)
    return encrypt_torus_seeded(gen, mu, alpha, sk, width)


def bool_mu(bits, width: int = 32, device=None) -> torch.Tensor:
    """The +-1/8 plaintexts of booleans, carriers at ``width`` on
    ``device``."""
    bits = torch.as_tensor(bits, dtype=torch.bool, device=device)
    return torch.where(
        bits, to_carrier(torus_constant_w(BOOL_MU, width), width),
        to_carrier(torus_constant_w(-BOOL_MU, width), width))


def phase(ct: torch.Tensor, sk: torch.Tensor) -> torch.Tensor:
    """b - <a, s> (the noisy plaintext), carrier [...]."""
    n = sk.shape[-1]
    return ct[..., n] - _inner_product_binary(ct[..., :n], sk)


def decrypt_bool(ct: torch.Tensor, sk: torch.Tensor) -> torch.Tensor:
    """Sign test on the phase (tlwe.zig:58-68)."""
    return phase(ct, sk) >= 0


def encrypt_message(gen: torch.Generator, message, message_modulus: int,
                    alpha: float, sk: torch.Tensor,
                    width: int = 32) -> torch.Tensor:
    """PBS codec encrypt: msg * 1/(2m) on the torus (tlwe.zig:74-88).
    Returns carrier [..., n+1] on the generator's device."""
    message = torch.as_tensor(message, device=gen.device).long() % message_modulus
    mu = torch.from_numpy(_encode_message_table(message_modulus, width))
    return encrypt_torus(gen, mu.to(gen.device)[message], alpha, sk, width)


def _encode_message_table(message_modulus: int, width: int = 32) -> np.ndarray:
    """Torus encodings of all messages in [0, m): trunc(x/(2m) * 2^w)."""
    return f64_to_torus(np.arange(message_modulus)
                        * (1.0 / (2.0 * message_modulus)), width)


def decrypt_message(ct: torch.Tensor, message_modulus: int, sk: torch.Tensor,
                    width: int = 32) -> torch.Tensor:
    """PBS codec decrypt with +0.5 rounding (tlwe.zig:100-117), in float32
    at width 32 and float64 at width 64, as the JAX package computes it:
    int32 [...] in [0, m)."""
    ph = phase(ct, sk)
    fdt = torch.float32 if carrier_dtype(width) == torch.int32 else torch.float64
    two_w = float(1 << width)
    f = ph.to(fdt)
    f = torch.where(ph < 0, f + two_w, f) / two_w
    m = torch.floor(f * (2.0 * message_modulus) + 0.5).to(torch.int32)
    return m % message_modulus


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
    out[..., n] += to_carrier(const_torus, carrier_width(ct))
    return out
