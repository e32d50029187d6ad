"""LWE proxy re-encryption: public keys, re-encryption keys, re-encrypt.

Counterpart of zig_tfhe_tpu/models/proxy_reenc.py (proxy_reenc.zig:38-306).
A public key is a bank of zero encryptions under a lv0 key
(proxy_reenc.zig:47-75); public-key encryption is a random {+1: 1/4,
-1: 1/4, 0: 1/2} subset sum of the bank plus the plaintext and fresh noise
(83-113); a re-encryption key is a key-switching key from the delegator's
lv0 key to the delegatee's, made from the delegatee's PUBLIC key
(asymmetric, 134-192) or secret key (symmetric, 198-255); re-encryption is
a key switch (267-306): one ``ops/keyswitch.py:key_switch_matmul``, so
multi-hop chains compose.  The subset sum is ``small_matmul_torus`` on the
signs (int8 limbs on ``torch._int_mm``: size * 127 < 2^31).  32-bit torus
only, as in the JAX package.

Each keygen and encryption is a drawing wrapper around a deterministic
core that takes its draws as tensors (``pk_encrypt_from_draws``,
``sym_key_core``, ``asym_key_core``): fed the JAX package's draws, a core
returns the JAX package's key bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from zig_tfhe_tpu_torch import tlwe as _tlwe
from zig_tfhe_tpu_torch.ops.keyswitch import key_switch_matmul, ks_plaintexts
from zig_tfhe_tpu_torch.ops.poly import small_matmul_torus
from zig_tfhe_tpu_torch.params import SecurityParams
from zig_tfhe_tpu_torch.utils import rng as _rng


def _width32(params: SecurityParams) -> None:
    if params.torus_bits != 32:
        raise ValueError(f"proxy re-encryption is 32-bit only ({params.name} "
                         f"is a {params.torus_bits}-bit set)")


def draw_signs(gen: torch.Generator, shape) -> torch.Tensor:
    """Subset-sum coefficients int32 ``shape``: a draw r in [0, 4) maps
    0 -> +1, 1 -> -1, else 0 (proxy_reenc.zig:83-113)."""
    r = torch.randint(0, 4, tuple(shape), generator=gen, device=gen.device)
    return torch.where(r == 0, 1, torch.where(r == 1, -1, 0)).to(torch.int32)


def pk_encrypt_from_draws(bank: torch.Tensor, mu: torch.Tensor,
                          signs: torch.Tensor,
                          noise: torch.Tensor) -> torch.Tensor:
    """sum_i signs[..., i] * bank[i] with mu + noise added to the body.
    bank int32 [size, n0+1], signs int32 [..., size], mu and noise int32
    [...].  Returns int32 [..., n0+1]."""
    out = small_matmul_torus(signs, bank, 1)
    out[..., -1] += mu + noise
    return out


def sym_key_core(key_from: torch.Tensor, key_to: torch.Tensor,
                 masks: torch.Tensor, noise: torch.Tensor, basebit: int,
                 t: int) -> torch.Tensor:
    """Rows (i*t + j) = TLWE_to(key_from[i] * 2^(32-(j+1)*basebit)) from the
    drawn masks int32 [n_from, t, n_to] and noise [n_from, t].  Returns
    int32 [n_from*t, n_to+1]."""
    mu = ks_plaintexts(key_from, basebit, t)
    body = _tlwe.encrypt_from_draws(masks, noise, mu, key_to)
    return torch.cat([masks, body[..., None]], dim=-1).reshape(
        key_from.shape[0] * t, -1)


def asym_key_core(key_from: torch.Tensor, bank: torch.Tensor,
                  signs: torch.Tensor, noise: torch.Tensor, basebit: int,
                  t: int) -> torch.Tensor:
    """The re-encryption key's rows as public-key encryptions under the
    bank int32 [size, n_to+1], from the drawn signs [n_from, t, size] and
    noise [n_from, t].  Returns int32 [n_from*t, n_to+1]."""
    mu = ks_plaintexts(key_from, basebit, t)
    return pk_encrypt_from_draws(bank, mu, signs, noise).reshape(
        key_from.shape[0] * t, -1)


class PublicKeyLv0(nn.Module):
    """Bank of zero encryptions under a lv0 secret key
    (proxy_reenc.zig:38-75): ``encryptions`` int32 [size, n0+1]."""

    def __init__(self, encryptions: torch.Tensor):
        super().__init__()
        self.register_buffer("encryptions", encryptions)

    @classmethod
    def generate(cls, gen: torch.Generator, secret_key_lv0: torch.Tensor,
                 params: SecurityParams, size: int | None = None,
                 alpha: float | None = None) -> "PublicKeyLv0":
        """``size`` zero encryptions (default 2 n0) at ``alpha`` (default
        the lv0 noise), on the generator's device."""
        _width32(params)
        size = 2 * params.n0 if size is None else size
        alpha = params.tlwe_lv0.alpha if alpha is None else alpha
        zeros = torch.zeros((size,), dtype=torch.int32, device=gen.device)
        return cls(_tlwe.encrypt_torus(gen, zeros, alpha, secret_key_lv0))

    @classmethod
    def from_numpy(cls, encryptions, device="cuda") -> "PublicKeyLv0":
        return cls(torch.from_numpy(np.array(encryptions, np.int32))
                   .to(device))

    def encrypt_torus(self, gen: torch.Generator, mu,
                      alpha: float) -> torch.Tensor:
        """Public-key encrypt torus plaintexts ``mu`` (int32 [...]):
        the subset sum of the bank with mu and fresh noise on the body.
        Returns int32 [..., n0+1] on the generator's device."""
        mu = torch.as_tensor(mu, dtype=torch.int32, device=gen.device)
        signs = draw_signs(gen, (*mu.shape, self.encryptions.shape[0]))
        noise = _rng.gaussian_torus(gen, mu.shape, float(alpha))
        return pk_encrypt_from_draws(self.encryptions, mu, signs, noise)

    def encrypt_bool(self, gen: torch.Generator, bits,
                     alpha: float) -> torch.Tensor:
        """Public-key encrypt booleans as +-1/8."""
        return self.encrypt_torus(gen, _tlwe.bool_mu(bits, 32, gen.device),
                                  alpha)


class ProxyReencryptionKey(nn.Module):
    """Signed-digit re-encryption key: row (i*t + j) of ``key_encryptions``
    int32 [n_from*t, n_to+1] encrypts key_from[i] * 2^(32-(j+1)*basebit)
    under the delegatee's key."""

    def __init__(self, key_encryptions: torch.Tensor, basebit: int, t: int):
        super().__init__()
        self.register_buffer("key_encryptions", key_encryptions)
        self.basebit = basebit
        self.t = t

    @property
    def base(self) -> int:
        return 1 << self.basebit

    @classmethod
    def from_numpy(cls, key_encryptions, basebit: int, t: int,
                   device="cuda") -> "ProxyReencryptionKey":
        return cls(torch.from_numpy(np.array(key_encryptions, np.int32))
                   .to(device), basebit, t)

    @classmethod
    def new_symmetric(cls, gen: torch.Generator, key_from: torch.Tensor,
                      key_to: torch.Tensor, params: SecurityParams,
                      alpha: float | None = None, basebit: int | None = None,
                      t: int | None = None) -> "ProxyReencryptionKey":
        """Both secret keys available (proxy_reenc.zig:198-255).  basebit,
        t and alpha default to the set's key switch (basebit, iks_t,
        ksk_alpha)."""
        _width32(params)
        basebit = params.basebit if basebit is None else basebit
        t = params.iks_t if t is None else t
        alpha = params.ksk_alpha if alpha is None else alpha
        shape = (key_from.shape[0], t)
        masks = _rng.uniform_torus(gen, (*shape, key_to.shape[0]))
        noise = _rng.gaussian_torus(gen, shape, float(alpha))
        return cls(sym_key_core(key_from, key_to, masks, noise, basebit, t),
                   basebit, t)

    @classmethod
    def new_asymmetric(cls, gen: torch.Generator, key_from: torch.Tensor,
                       public_key_to: PublicKeyLv0, params: SecurityParams,
                       alpha: float | None = None, basebit: int | None = None,
                       t: int | None = None) -> "ProxyReencryptionKey":
        """The delegatee contributes only a PUBLIC key
        (proxy_reenc.zig:134-192); defaults as in new_symmetric."""
        _width32(params)
        basebit = params.basebit if basebit is None else basebit
        t = params.iks_t if t is None else t
        alpha = params.ksk_alpha if alpha is None else alpha
        bank = public_key_to.encryptions
        shape = (key_from.shape[0], t)
        signs = draw_signs(gen, (*shape, bank.shape[0]))
        noise = _rng.gaussian_torus(gen, shape, float(alpha))
        return cls(asym_key_core(key_from, bank, signs, noise, basebit, t),
                   basebit, t)


def reencrypt(ct: torch.Tensor,
              reenc_key: ProxyReencryptionKey) -> torch.Tensor:
    """Re-encrypt TLWE lv0 ciphertexts int32 [..., n0+1] to the delegatee's
    key (proxy_reenc.zig:267-306)."""
    return key_switch_matmul(ct, reenc_key.key_encryptions, reenc_key.basebit,
                             reenc_key.t)
