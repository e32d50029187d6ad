"""TLWE -> TRLWE packing key switch (the tree-PBS enabler).

Counterpart of zig_tfhe_tpu/ops/packing_keyswitch.py, at both torus
widths.
Packing K TLWE(lv1) samples into one TRLWE, sample k's message on
coefficient k*delta, lets an encrypted small-modulus index select among
K encrypted values with one blind rotation (models/lut.py:tree_pbs): the
route to message moduli beyond the N = 1024 modswitch capacity.

The pack is one exact int8-limb contraction (``small_matmul_torus``, as
the identity key switch runs it) plus K static negacyclic rotations; the
block spread is one NTT round trip on the bound-41 plan against a static
window polynomial at width 32, and log2(delta) static rotate-adds at width
64 (where delta * 2^63 overruns every CRT pool), plain PyTorch as the JAX
package leaves it to XLA.

Security note: the packing key encrypts lv1-key digit multiples under the
lv1 key itself, the standard LWE-to-RLWE packing assumption (the JAX
package's module docstring and docs/NOISE.md).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zig_tfhe_tpu_torch import trlwe as _trlwe
from zig_tfhe_tpu_torch.ops import ntt as _ntt
from zig_tfhe_tpu_torch.ops.decomposition import ks_decompose
from zig_tfhe_tpu_torch.ops.keyswitch import ks_plaintexts
from zig_tfhe_tpu_torch.ops.poly import negacyclic_rotate, small_matmul_torus
from zig_tfhe_tpu_torch.params import SecurityParams
from zig_tfhe_tpu_torch.utils.torus import (carrier_dtype, carrier_width,
                                            require_width)


def default_packing_gadget(params: SecurityParams) -> tuple:
    """(basebit, t) the packing key is built at when callers pass None: the
    parameter set's (basebit, iks_t) on the 32-bit torus, (8, 3) on the
    64-bit one (24 bits of decomposition in a quarter of the lv1 -> lv0
    gadget's rows; the JAX package's docstring derives the noise)."""
    require_width(params.torus_bits)
    if params.torus_bits == 32:
        return (params.basebit, params.iks_t)
    return (8, 3)


def gen_packing_ksk(gen: torch.Generator, secret_key_lv1: torch.Tensor,
                    params: SecurityParams, basebit: int | None = None,
                    t: int | None = None,
                    alpha: float | None = None) -> torch.Tensor:
    """Packing key-switch key: carrier [n1*t, 2, N] on the generator's
    device.

    Row (i*t + j) is a TRLWE encryption under the lv1 key of the constant
    polynomial ``s1[i] * 2^(w-(j+1)*basebit)`` (ops/keyswitch.py:
    ks_plaintexts lifted to ring ciphertexts), at the lv1 noise
    (params.bsk_alpha) unless ``alpha`` is given."""
    db, dt_ = default_packing_gadget(params)
    basebit = db if basebit is None else basebit
    t = dt_ if t is None else t
    alpha = params.bsk_alpha if alpha is None else alpha
    n1, N = params.n1, params.N
    vals = ks_plaintexts(secret_key_lv1, basebit, t, params.torus_bits)
    mu = torch.zeros((n1, t, N), dtype=carrier_dtype(params.torus_bits),
                     device=gen.device)
    mu[:, :, 0] = vals.to(gen.device)
    ct = _trlwe.encrypt_torus(gen, mu, float(alpha), secret_key_lv1,
                              width=params.torus_bits)
    return ct.reshape(n1 * t, 2, N)


def packing_key_switch(tlwes: torch.Tensor, pksk: torch.Tensor, basebit: int,
                       t: int, delta: int) -> torch.Tensor:
    """Pack TLWE(lv1) samples k onto coefficients k*delta of one TRLWE.

    tlwes: carrier [..., K, n1+1]; pksk: carrier [n1*t, 2, N] of the same
    width.  Returns carrier [..., 2, N] whose phase is sum_k message_k
    X^(k*delta) (+ key-switch noise): out = sum_k X^(k*delta) ((0, b_k) -
    sum_ij digit_kij PKSK[ij])."""
    width = carrier_width(tlwes)
    if pksk.dtype != tlwes.dtype:
        raise TypeError(f"samples {tlwes.dtype} and packing key {pksk.dtype} "
                        "are carriers of different widths")
    n1 = tlwes.shape[-1] - 1
    N = pksk.shape[-1]
    K = tlwes.shape[-2]
    digits = ks_decompose(tlwes[..., :n1], basebit, t,
                          width)                            # [..., K, n1, t]
    d = digits.reshape(*digits.shape[:-2], n1 * t)
    u = small_matmul_torus(d, pksk.reshape(n1 * t, 2 * N), 1 << (basebit - 1),
                           width)
    base = -u.reshape(*u.shape[:-1], 2, N)                  # [..., K, 2, N]
    base[..., 1, 0] += tlwes[..., n1]
    out = None
    for k in range(K):
        term = negacyclic_rotate(base[..., k, :, :], (k * delta) % (2 * N))
        out = term if out is None else out + term
    return out


@functools.lru_cache(maxsize=None)
def _window_poly(N: int, delta: int) -> np.ndarray:
    """W(X) = X^(-delta/2) (1 + X + ... + X^(delta-1)) as centred int8
    negacyclic coefficients: +1 on [0, delta/2), -1 on [N - delta/2, N)."""
    w = np.zeros(N, np.int8)
    w[: delta // 2] = 1
    w[N - delta // 2:] = -1
    return w


def spread_blocks(packed: torch.Tensor, delta: int,
                  params: SecurityParams) -> torch.Tensor:
    """Multiply a packed TRLWE by the centred block window W(X): each point
    mass at k*delta becomes a constant block of width delta centred on
    k*delta, the bin structure of a Generator testvec.  Width 32: exact mod
    2^32 by one NTT round trip (|true convolution| <= delta * 2^31 <= 2^40
    at delta <= N/2, under P/4 of the bound-41 plan).  Width 64: the
    geometric sum by doubling, S_2k = S_k + X^k S_k, then one centring
    rotation X^(-delta/2): static rotations and wrapping adds, exact mod
    2^64."""
    if delta & (delta - 1) or not 2 <= delta <= params.N // 2:
        raise ValueError(f"block width {delta} must be a power of two in "
                         f"[2, N/2 = {params.N // 2}]")
    if params.torus_bits == 64:
        out, k = packed, 1
        while k < delta:
            out = out + negacyclic_rotate(out, k)
            k *= 2
        return negacyclic_rotate(out, 2 * params.N - delta // 2)
    plan = _ntt.make_plan(params.N, 41)
    w = torch.from_numpy(_window_poly(params.N, delta)).to(packed.device)
    p_hat = _ntt.ntt_forward(packed, plan, digit_limbs=4, digit_bound=128)
    w_hat = _ntt.ntt_forward(w, plan, digit_limbs=1, digit_bound=1)
    v_hat = [_ntt.barrett_reduce(p_hat[i] * w_hat[i], p)
             for i, p in enumerate(plan.primes)]
    return _ntt.ntt_inverse_to_crt(v_hat, plan)


def pack_tlwes_blocks(tlwes: torch.Tensor, m_hi: int, pksk: torch.Tensor,
                      params: SecurityParams, basebit: int | None = None,
                      t: int | None = None) -> torch.Tensor:
    """Pack K = m_hi TLWE(lv1) samples into a blind-rotation testvec:
    sample k's message fills the delta = N/m_hi coefficient block centred
    on k*delta.  tlwes: carrier [..., m_hi, n1+1] -> carrier [..., 2, N], a
    (noisy) TRLWE usable as a per-lane testvec over a modulus-m_hi input."""
    db, dt_ = default_packing_gadget(params)
    basebit = db if basebit is None else basebit
    t = dt_ if t is None else t
    N = params.N
    if N % m_hi:
        raise ValueError(f"{m_hi} blocks do not divide N = {N}")
    delta = N // m_hi
    packed = packing_key_switch(tlwes, pksk, basebit, t, delta)
    return spread_blocks(packed, delta, params)
