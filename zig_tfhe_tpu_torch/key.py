"""Key generation: secret keys and the cloud (evaluation) key.

Counterpart of zig_tfhe_tpu/key.py.  Both keys are ``nn.Module``s whose
arrays are registered buffers, so ``.to(device)`` moves a key.  Generation
runs on the device of the ``torch.Generator`` it is given.  The cloud key
holds the signed-digit key-switching key, one or both bootstrapping-key
forms: the NTT engine's (the multi-bit subset-product BSK of the JAX
package, in CRT residue form) and the Toeplitz engine's (a per-bit TRGSW
at the parameter-set gadget, in ext-limb form), and for the uint sets the
TLWE -> TRLWE packing key that the tree PBS of models/lut.py runs on.  Its
layouts equal the JAX package's, so a JAX-made key carries over with
``CloudKey.from_numpy`` or utils/serialization.py:load_cloud_key.  On the
64-bit torus the torus arrays (testvec, ksk1, pksk) are int64 and a
split-ring set's (N > 1024) NTT key is the folded split form of
ops/split_ring.py.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from zig_tfhe_tpu_torch import tlwe as _tlwe
from zig_tfhe_tpu_torch import trgsw as _trgsw
from zig_tfhe_tpu_torch.ops import ntt as _ntt
from zig_tfhe_tpu_torch.ops.keyswitch import ks_plaintexts
from zig_tfhe_tpu_torch.ops.packing_keyswitch import (default_packing_gadget,
                                                      gen_packing_ksk)
from zig_tfhe_tpu_torch.ops.split_ring import gen_bootstrapping_key_ntt_split
from zig_tfhe_tpu_torch.params import SecurityParams
from zig_tfhe_tpu_torch.utils import rng as _rng
from zig_tfhe_tpu_torch.utils.torus import (carrier_dtype, require_width,
                                            to_carrier, torus_constant_w)


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

    testvec: carrier [2, N]         (a = 0, b = 1/8; key.zig:134-145)
    ksk1:    carrier [N*t, n0+1]    (signed-digit key-switching key)
    bsk_ntt: int16 [ceil(n0/g), 2^g - 1, P, la+lb, 2, N] (group g > 1) or
             [n0, P, la+lb, 2, N] (group 1): TRGSW rows of the secret-bit
             subset products in NTT residue form, rounded by bsk_ntt_drop
             bits, at the engine gadget (bsk_bgbit, bsk_levels); on a
             split-ring set [.., P, 2(la+lb), 4, N/2] (the folded split
             form, ops/split_ring.py:fold_key_split); or None.
    bsk_ext_limbs: int8 [n0, n_klimbs, 2L, 2, 2N]: TRGSW(s0[i]) in ext-limb
             form, the Toeplitz engine's key (trgsw.py:to_ext_limbs); or
             None.
    pksk:    carrier [n1*t, 2, N]: the TLWE -> TRLWE packing key-switch key
             (ops/packing_keyswitch.py:gen_packing_ksk), or None.
    bsk_group, bsk_levels and bsk_bgbit describe bsk_ntt (1, None and None
    when the key has none, as in the JAX package); pksk_gadget is the
    (basebit, t) the packing key was built at (None without one).  The
    carrier is int32 on the 32-bit torus and int64 on the 64-bit one.
    """

    def __init__(self, testvec: torch.Tensor, ksk1: torch.Tensor,
                 bsk_ntt: torch.Tensor | None, params: SecurityParams, *,
                 bsk_ntt_drop: int, bsk_group: int,
                 bsk_levels: tuple | None, bsk_bgbit: int | None,
                 bsk_ext_limbs: torch.Tensor | None = None,
                 pksk: torch.Tensor | None = None,
                 pksk_gadget: tuple | None = None):
        super().__init__()
        require_width(params.torus_bits)
        if bsk_ntt is None and bsk_ext_limbs is None:
            raise ValueError("the key has no bootstrapping key (neither "
                             "bsk_ntt nor bsk_ext_limbs)")
        self.register_buffer("testvec", testvec)
        self.register_buffer("ksk1", ksk1)
        self.register_buffer("bsk_ntt", bsk_ntt)
        self.register_buffer("bsk_ext_limbs", bsk_ext_limbs)
        self.register_buffer("pksk", pksk)
        self.pksk_gadget = tuple(pksk_gadget) if pksk_gadget is not None else None
        self.params = params
        self.bsk_ntt_drop = bsk_ntt_drop
        self.bsk_group = bsk_group
        self.bsk_levels = tuple(bsk_levels) if bsk_levels is not None else None
        self.bsk_bgbit = bsk_bgbit

    @classmethod
    def generate(cls, gen: torch.Generator, secret_key: SecretKey,
                 params: SecurityParams, engines=("ntt",),
                 group: int | None = None, decomp_levels=None,
                 engine_bgbit: int | None = None,
                 packing_key: bool | None = None) -> "CloudKey":
        """Generate on the generator's device.

        ``engines`` selects the bootstrapping-key forms to make, "ntt"
        and/or "toeplitz" (32-bit torus only); each form draws its own
        randomness, so the two encryptions share no masks.  The NTT knobs
        resolve as in the JAX package's CloudKey.generate (ops/ntt.py:
        default_group, default_engine_gadget, default_drop_bits): with
        neither ``decomp_levels`` nor ``engine_bgbit``, the engine default
        (group 3, Bg_e = 2^7 with (2, 2) levels and drop 5 at
        SECURITY_128_BIT; group 2, Bg_e = 2^8 with (3, 2) levels and drop
        32 at SECURITY_128_BIT_T64); ``decomp_levels`` alone keeps the
        parameter base (the approximate gadget on the reference's Bg:
        ``group=2, decomp_levels=(3, 2)`` at 128-bit is Bg_e = 2^6, (3, 2),
        drop 7);
        ``engine_bgbit`` alone takes every level at that base.  group > 1
        publishes TRGSWs of secret-bit subset products (BMMP16-style); see
        the JAX package's CloudKey.generate for the security note.  The
        Toeplitz key is the reference's per-bit BSK.  ``packing_key``
        (default: ``default_packing_key(params)``, True for the uint sets
        and the 64-bit sets) adds the packing key at
        ``default_packing_gadget(params)``, drawn last."""
        if params.torus_bits != 32 and "toeplitz" in engines:
            raise ValueError(
                "the Toeplitz engine is 32-bit-only (ext-limb key form); "
                "64-bit-torus sets use engines=('ntt',)")
        require_width(params.torus_bits)
        group, bgbit, levels = _engine_knobs(params, group, decomp_levels,
                                             engine_bgbit)
        drop = _ntt.default_drop_bits(params, group, bgbit)
        ksk1 = gen_key_switching_key(gen, secret_key, params)
        with_ntt = "ntt" in engines
        bsk = (gen_bootstrapping_key_ntt(gen, secret_key, params, drop, group,
                                         levels, bgbit) if with_ntt else None)
        bsk_ext = (gen_bootstrapping_key(gen, secret_key, params)
                   if "toeplitz" in engines else None)
        if packing_key is None:
            packing_key = default_packing_key(params)
        pksk = (gen_packing_ksk(gen, secret_key.key_lv1, params)
                if packing_key else None)
        return cls(gen_testvec(params, gen.device), ksk1, bsk, params,
                   bsk_ntt_drop=drop, bsk_group=group if with_ntt else 1,
                   bsk_levels=levels if with_ntt else None,
                   bsk_bgbit=bgbit if with_ntt else None,
                   bsk_ext_limbs=bsk_ext, pksk=pksk,
                   pksk_gadget=(default_packing_gadget(params)
                                if pksk is not None else None))

    @classmethod
    def generate_no_ksk(cls, params: SecurityParams, engines=("ntt",),
                        group: int | None = 1, decomp_levels=None,
                        engine_bgbit: int | None = None,
                        ntt_drop: int | None = None,
                        device="cuda") -> "CloudKey":
        """A key of the real shapes with an all-zero bootstrapping key and
        a zero key-switching key (key.zig:80-100): a fixture for timing the
        gate path without keygen, whose outputs decrypt to nothing.  The
        NTT knobs resolve as in ``generate``; ``group=None`` takes the
        set's default group (1 unless given, as in the JAX package) and
        ``ntt_drop`` overrides the default drop bits.  No packing key."""
        require_width(params.torus_bits)
        group, bgbit, levels = _engine_knobs(params, group, decomp_levels,
                                             engine_bgbit)
        if ntt_drop is None:
            ntt_drop = _ntt.default_drop_bits(params, group, bgbit)
        with_ntt = "ntt" in engines
        bsk = None
        if with_ntt:
            la, lb = levels
            plan = _ntt.plan_for_params(params, ntt_drop, group, levels,
                                        bgbit=bgbit, pseudorandom_key=True)
            if params.split_ring:   # the folded split form
                tail = (plan.n_primes, 2 * (la + lb), 4, params.N // 2)
            else:
                tail = (plan.n_primes, la + lb, 2, params.N)
            lead = ((params.n0,) if group == 1
                    else (-(-params.n0 // group), (1 << group) - 1))
            bsk = torch.zeros(lead + tail, dtype=torch.int16, device=device)
        bsk_ext = (torch.zeros((params.n0, _trgsw.N_KLIMBS, 2 * params.L, 2,
                                2 * params.N), dtype=torch.int8, device=device)
                   if "toeplitz" in engines else None)
        ksk1 = torch.zeros((params.n1 * params.iks_t, params.n0 + 1),
                           dtype=carrier_dtype(params.torus_bits),
                           device=device)
        return cls(gen_testvec(params, device), ksk1, bsk, params,
                   bsk_ntt_drop=ntt_drop, bsk_group=group if with_ntt else 1,
                   bsk_levels=levels if with_ntt else None,
                   bsk_bgbit=bgbit if with_ntt else None,
                   bsk_ext_limbs=bsk_ext)

    @classmethod
    def from_numpy(cls, arrays, params: SecurityParams, *, bsk_ntt_drop: int,
                   bsk_group: int, bsk_levels, bsk_bgbit,
                   pksk_gadget=None, device="cuda") -> "CloudKey":
        """Build from a JAX key's arrays (numpy ``testvec``, ``ksk1``, at
        least one of ``bsk_ntt``, ``bsk_ext_limbs``, and ``pksk`` where the
        key has one) and its static fields.  The torus arrays keep the
        set's carrier (int64 on the 64-bit torus)."""
        bsk_ntt, bsk_ext = arrays.get("bsk_ntt"), arrays.get("bsk_ext_limbs")
        pksk = arrays.get("pksk")
        cdt = np.int32 if params.torus_bits == 32 else np.int64
        return cls(_tensor(arrays["testvec"], cdt, device),
                   _tensor(arrays["ksk1"], cdt, device),
                   None if bsk_ntt is None
                   else _tensor(bsk_ntt, np.int16, device), params,
                   bsk_ntt_drop=bsk_ntt_drop, bsk_group=bsk_group,
                   bsk_levels=bsk_levels, bsk_bgbit=bsk_bgbit,
                   bsk_ext_limbs=None if bsk_ext is None
                   else _tensor(bsk_ext, np.int8, device),
                   pksk=None if pksk is None else _tensor(pksk, cdt, device),
                   pksk_gadget=pksk_gadget)


def _engine_knobs(params: SecurityParams, group, levels, bgbit):
    """(group, Bg_e bits, levels) of the NTT key as the JAX package's
    CloudKey.generate resolves them (ops/ntt.py: default_group,
    default_engine_gadget, norm_levels)."""
    if group is None:
        group = _ntt.default_group(params)
    if bgbit is None:
        if levels is None:
            bgbit, levels = _ntt.default_engine_gadget(params, group)
        else:
            bgbit = params.bgbit
    return group, bgbit, _ntt.norm_levels(params, levels, bgbit=bgbit)


def default_packing_key(params: SecurityParams) -> bool:
    """Whether CloudKey.generate builds the packing key by default (the JAX
    package's rule): for the multi-bit message sets (uint1-8 and
    tiny_uint), whose radix and bivariate LUTs run the tree PBS on it, and
    for the 64-bit sets, where the radix tree PBS is the only exact route
    to m >= 64 LUTs and the integer layer's digit multiplier rides it."""
    return (params.name.startswith("uint") or params.name == "tiny_uint"
            or params.torus_bits == 64)


def gen_testvec(params: SecurityParams, device="cuda") -> torch.Tensor:
    """Trivial TRLWE with b == 1/8 everywhere (key.zig:134-145), at the
    set's carrier (int64 b == 2^61 on the 64-bit torus)."""
    w = params.torus_bits
    tv = torch.zeros((2, params.N), dtype=carrier_dtype(w), device=device)
    tv[1] = to_carrier(torus_constant_w(0.125, w), w)
    return tv


def gen_key_switching_key(gen: torch.Generator, secret_key: SecretKey,
                          params: SecurityParams) -> torch.Tensor:
    """KSK1[i*t+j] = TLWE_lv0(s1[i] * 2^(w-(j+1)*basebit)), noise ksk_alpha:
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
    zero key bits (TRGSW(0) is a CMux no-op).  A split-ring set gets the
    folded split form instead (ops/split_ring.py:
    gen_bootstrapping_key_ntt_split): [G, 2^g - 1, P, 2(la+lb), 4, N/2]."""
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
    if params.split_ring:
        return gen_bootstrapping_key_ntt_split(
            gen, values, secret_key.key_lv1, params, drop, group, levels, bgbit)
    la, lb = levels
    plan = _ntt.plan_for_params(params, drop, group, levels, bgbit=bgbit,
                                pseudorandom_key=True)
    trgsw_ct = _trgsw.encrypt_gadget_rows(
        gen, values, params.bsk_alpha, secret_key.key_lv1, params, bgbit,
        la, lb)
    res = _ntt.to_ntt_form(trgsw_ct, plan, drop,
                           width=params.torus_bits).movedim(0, 1).contiguous()
    if group > 1:
        res = res.reshape(-1, (1 << group) - 1, plan.n_primes, la + lb, 2,
                          params.N)
    return res
