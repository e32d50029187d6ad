"""Key generation: secret keys and the cloud (evaluation) key.

Counterpart of zig_tfhe_tpu/key.py.  Both keys are ``nn.Module``s whose
arrays are registered buffers, so ``.to(device)`` moves a key.  Generation
runs on the device of the ``torch.Generator`` it is given.  The cloud key
holds the signed-digit key-switching key and one or both bootstrapping-key
forms: the NTT engine's (the multi-bit subset-product BSK of the JAX
package, in CRT residue form) and the Toeplitz engine's (a per-bit TRGSW
at the parameter-set gadget, in ext-limb form).  Its layouts equal the JAX
package's, so a JAX-made key carries over with ``CloudKey.from_numpy`` or
utils/serialization.py:load_cloud_key.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from zig_tfhe_tpu_torch import tlwe as _tlwe
from zig_tfhe_tpu_torch import trgsw as _trgsw
from zig_tfhe_tpu_torch.ops import ntt as _ntt
from zig_tfhe_tpu_torch.ops.keyswitch import ks_plaintexts
from zig_tfhe_tpu_torch.params import SecurityParams
from zig_tfhe_tpu_torch.utils import rng as _rng
from zig_tfhe_tpu_torch.utils.torus import (require_width, to_carrier,
                                            torus_constant_w)


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)  # a copy


class SecretKey(nn.Module):
    """Binary secret keys for lv0 and lv1 (key.zig:34-58):
    key_lv0 int32 [n0], key_lv1 int32 [N], values in {0, 1}."""

    def __init__(self, key_lv0: torch.Tensor, key_lv1: torch.Tensor):
        super().__init__()
        self.register_buffer("key_lv0", key_lv0)
        self.register_buffer("key_lv1", key_lv1)

    @classmethod
    def generate(cls, gen: torch.Generator,
                 params: SecurityParams) -> "SecretKey":
        return cls(_rng.uniform_binary(gen, (params.n0,)),
                   _rng.uniform_binary(gen, (params.n1,)))

    @classmethod
    def from_numpy(cls, key_lv0, key_lv1, device="cuda") -> "SecretKey":
        return cls(_tensor(key_lv0, np.int32, device),
                   _tensor(key_lv1, np.int32, device))


class CloudKey(nn.Module):
    """Evaluation key (key.zig:61-77):

    testvec: int32 [2, N]           (a = 0, b = 1/8; key.zig:134-145)
    ksk1:    int32 [N*t, n0+1]      (signed-digit key-switching key)
    bsk_ntt: int16 [ceil(n0/g), 2^g - 1, P, la+lb, 2, N] (group g > 1) or
             [n0, P, la+lb, 2, N] (group 1): TRGSW rows of the secret-bit
             subset products in NTT residue form, rounded by bsk_ntt_drop
             bits, at the engine gadget (bsk_bgbit, bsk_levels); or None.
    bsk_ext_limbs: int8 [n0, n_klimbs, 2L, 2, 2N]: TRGSW(s0[i]) in ext-limb
             form, the Toeplitz engine's key (trgsw.py:to_ext_limbs); or
             None.
    bsk_group, bsk_levels and bsk_bgbit describe bsk_ntt (1, None and None
    when the key has none, as in the JAX package).
    """

    def __init__(self, testvec: torch.Tensor, ksk1: torch.Tensor,
                 bsk_ntt: torch.Tensor | None, params: SecurityParams, *,
                 bsk_ntt_drop: int, bsk_group: int,
                 bsk_levels: tuple | None, bsk_bgbit: int | None,
                 bsk_ext_limbs: torch.Tensor | None = None):
        super().__init__()
        require_width(params.torus_bits)
        if bsk_ntt is None and bsk_ext_limbs is None:
            raise ValueError("the key has no bootstrapping key (neither "
                             "bsk_ntt nor bsk_ext_limbs)")
        self.register_buffer("testvec", testvec)
        self.register_buffer("ksk1", ksk1)
        self.register_buffer("bsk_ntt", bsk_ntt)
        self.register_buffer("bsk_ext_limbs", bsk_ext_limbs)
        self.params = params
        self.bsk_ntt_drop = bsk_ntt_drop
        self.bsk_group = bsk_group
        self.bsk_levels = tuple(bsk_levels) if bsk_levels is not None else None
        self.bsk_bgbit = bsk_bgbit

    @classmethod
    def generate(cls, gen: torch.Generator, secret_key: SecretKey,
                 params: SecurityParams, engines=("ntt",),
                 group: int | None = None, decomp_levels=None,
                 engine_bgbit: int | None = None) -> "CloudKey":
        """Generate on the generator's device.

        ``engines`` selects the bootstrapping-key forms to make, "ntt"
        and/or "toeplitz" (32-bit torus only); each form draws its own
        randomness, so the two encryptions share no masks.  The NTT knobs
        resolve as in the JAX package's CloudKey.generate (ops/ntt.py:
        default_group, default_engine_gadget, default_drop_bits): with
        neither ``decomp_levels`` nor ``engine_bgbit``, the engine default
        (group 3, Bg_e = 2^7 with (2, 2) levels and drop 5 at
        SECURITY_128_BIT); ``decomp_levels`` alone keeps the parameter base
        (the approximate gadget on the reference's Bg: ``group=2,
        decomp_levels=(3, 2)`` at 128-bit is Bg_e = 2^6, (3, 2), drop 7);
        ``engine_bgbit`` alone takes every level at that base.  group > 1
        publishes TRGSWs of secret-bit subset products (BMMP16-style); see
        the JAX package's CloudKey.generate for the security note.  The
        Toeplitz key is the reference's per-bit BSK."""
        if params.torus_bits != 32 and "toeplitz" in engines:
            raise ValueError(
                "the Toeplitz engine is 32-bit-only (ext-limb key form); "
                "64-bit-torus sets use engines=('ntt',)")
        require_width(params.torus_bits)
        if group is None:
            group = _ntt.default_group(params)
        bgbit, levels = engine_bgbit, decomp_levels
        if bgbit is None:
            if levels is None:
                bgbit, levels = _ntt.default_engine_gadget(params, group)
            else:
                bgbit = params.bgbit
        levels = _ntt.norm_levels(params, levels, bgbit=bgbit)
        drop = _ntt.default_drop_bits(params, group, bgbit)
        ksk1 = gen_key_switching_key(gen, secret_key, params)
        with_ntt = "ntt" in engines
        bsk = (gen_bootstrapping_key_ntt(gen, secret_key, params, drop, group,
                                         levels, bgbit) if with_ntt else None)
        bsk_ext = (gen_bootstrapping_key(gen, secret_key, params)
                   if "toeplitz" in engines else None)
        return cls(gen_testvec(params, gen.device), ksk1, bsk, params,
                   bsk_ntt_drop=drop, bsk_group=group if with_ntt else 1,
                   bsk_levels=levels if with_ntt else None,
                   bsk_bgbit=bgbit if with_ntt else None,
                   bsk_ext_limbs=bsk_ext)

    @classmethod
    def from_numpy(cls, arrays, params: SecurityParams, *, bsk_ntt_drop: int,
                   bsk_group: int, bsk_levels, bsk_bgbit,
                   device="cuda") -> "CloudKey":
        """Build from a JAX key's arrays (numpy ``testvec``, ``ksk1`` and
        at least one of ``bsk_ntt``, ``bsk_ext_limbs``) and its static
        fields."""
        bsk_ntt, bsk_ext = arrays.get("bsk_ntt"), arrays.get("bsk_ext_limbs")
        return cls(_tensor(arrays["testvec"], np.int32, device),
                   _tensor(arrays["ksk1"], np.int32, device),
                   None if bsk_ntt is None
                   else _tensor(bsk_ntt, np.int16, device), params,
                   bsk_ntt_drop=bsk_ntt_drop, bsk_group=bsk_group,
                   bsk_levels=bsk_levels, bsk_bgbit=bsk_bgbit,
                   bsk_ext_limbs=None if bsk_ext is None
                   else _tensor(bsk_ext, np.int8, device))


def gen_testvec(params: SecurityParams, device="cuda") -> torch.Tensor:
    """Trivial TRLWE with b == 1/8 everywhere (key.zig:134-145)."""
    w = params.torus_bits
    tv = torch.zeros((2, params.N), dtype=torch.int32, device=device)
    tv[1] = to_carrier(torus_constant_w(0.125, w), w)
    return tv


def gen_key_switching_key(gen: torch.Generator, secret_key: SecretKey,
                          params: SecurityParams) -> torch.Tensor:
    """KSK1[i*t+j] = TLWE_lv0(s1[i] * 2^(32-(j+1)*basebit)), noise ksk_alpha:
    one batched TLWE encrypt (ops/keyswitch.py:ks_plaintexts rows)."""
    mu = ks_plaintexts(secret_key.key_lv1, params.basebit, params.iks_t,
                       params.torus_bits)
    ct = _tlwe.encrypt_torus(gen, mu, params.ksk_alpha, secret_key.key_lv0,
                             width=params.torus_bits)
    return ct.reshape(params.n1 * params.iks_t, params.n0 + 1)


def gen_bootstrapping_key(gen: torch.Generator, secret_key: SecretKey,
                          params: SecurityParams) -> torch.Tensor:
    """BSK[i] = TRGSW(s0[i]) under the lv1 key at the parameter-set gadget,
    in ext-limb form (key.zig:175-212): int8 [n0, 4, 2L, 2, 2N]."""
    trgsw_ct = _trgsw.encrypt_torus(gen, secret_key.key_lv0, params.bsk_alpha,
                                    secret_key.key_lv1, params)
    return _trgsw.to_ext_limbs(trgsw_ct)


def gen_bootstrapping_key_ntt(gen: torch.Generator, secret_key: SecretKey,
                              params: SecurityParams, drop: int, group: int,
                              levels: tuple[int, int],
                              bgbit: int) -> torch.Tensor:
    """BSK in NTT residue form (the engine's key).

    group 1: TRGSW(s[i]) per coefficient -> int16 [n0, P, la+lb, 2, N].
    group g > 1: per coefficient group, TRGSW of the product of every
    nonempty subset of its g secret bits (mask bit i <-> coefficient i,
    the order ops/ntt.py:rotate_combine_multi expects) -> int16
    [G, 2^g - 1, P, la+lb, 2, N], G = ceil(n0/g); ragged n0 is padded with
    zero key bits (TRGSW(0) is a CMux no-op)."""
    if params.split_ring:
        raise NotImplementedError("split-ring keys are not ported yet")
    s = secret_key.key_lv0
    if group == 1:
        values = s
    else:
        G = -(-params.n0 // group)
        s_pad = torch.cat([s, s.new_zeros(group * G - params.n0)])
        bits = [s_pad[i::group] for i in range(group)]           # each [G]
        subset_vals = []
        for m in range(1, 1 << group):
            v = None
            for i in range(group):
                if m >> i & 1:
                    v = bits[i] if v is None else v * bits[i]
            subset_vals.append(v)
        values = torch.stack(subset_vals, dim=1).reshape(-1)     # [G*(2^g-1)]
    la, lb = levels
    plan = _ntt.plan_for_params(params, drop, group, levels, bgbit=bgbit,
                                pseudorandom_key=True)
    trgsw_ct = _trgsw.encrypt_gadget_rows(
        gen, values, params.bsk_alpha, secret_key.key_lv1, params, bgbit,
        la, lb)
    res = _ntt.to_ntt_form(trgsw_ct, plan, drop).movedim(0, 1).contiguous()
    if group > 1:
        res = res.reshape(-1, (1 << group) - 1, plan.n_primes, la + lb, 2,
                          params.N)
    return res
