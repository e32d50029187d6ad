"""Homomorphic boolean gates, batch-first.

Counterpart of zig_tfhe_tpu/models/gates.py.  Every two-input gate is a
linear combination plus a bias constant followed by one bootstrap
(gates.zig:25-152); ``apply_gates`` evaluates a heterogeneous batch (lane i
runs gate ``gate_ids[i]``) through one shared bootstrap.

Gate algebra (coeff_a, coeff_b, bias as a fraction of the torus):
  NAND (-1,-1,+1/8)  OR  (+1,+1,+1/8)  AND (+1,+1,-1/8)  XOR (+1,+2,+1/4)
  XNOR (-1,-2,-1/4)  NOR (-1,-1,-1/8)  ANDNY(-1,+1,-1/8) ANDYN(+1,-1,-1/8)
  ORNY (-1,+1,+1/8)  ORYN (+1,-1,+1/8)
NOT/COPY/CONSTANT are bootstrap-free (gates.zig:132-151).

The JAX package pads each bootstrap batch to its TPU-measured tiling
knees; padded lanes are independent and sliced away, so the port runs the
batch as given and the outputs are the same.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zig_tfhe_tpu_torch import bootstrap as _bootstrap
from zig_tfhe_tpu_torch.key import CloudKey
from zig_tfhe_tpu_torch.ops.keyswitch import identity_key_switch
from zig_tfhe_tpu_torch.utils import profiling
from zig_tfhe_tpu_torch.utils.torus import (carrier_dtype, f64_to_torus,
                                            to_carrier, torus_constant_w)

# gate id -> (coeff_a, coeff_b, bias_fraction)
GATE_DEFS = {
    "nand":  (-1, -1,  0.125),
    "or":    (+1, +1,  0.125),
    "and":   (+1, +1, -0.125),
    "xor":   (+1, +2,  0.25),
    # the balanced XNOR -a-2b-1/4 (the reference's xnorGate computes
    # NOT(XNOR); zig_tfhe_tpu/models/gates.py explains)
    "xnor":  (-1, -2, -0.25),
    "nor":   (-1, -1, -0.125),
    "andny": (-1, +1, -0.125),
    "andyn": (+1, -1, -0.125),
    "orny":  (-1, +1,  0.125),
    "oryn":  (+1, -1,  0.125),
}
GATE_NAMES = tuple(GATE_DEFS)
GATE_IDS = {name: i for i, name in enumerate(GATE_NAMES)}

_COEFF_A = np.array([GATE_DEFS[g][0] for g in GATE_NAMES], np.int32)
_COEFF_B = np.array([GATE_DEFS[g][1] for g in GATE_NAMES], np.int32)
_BIAS = np.array([int(np.uint32(f64_to_torus(GATE_DEFS[g][2])))
                  for g in GATE_NAMES], np.uint32).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _bias_table(width: int) -> np.ndarray:
    """Gate bias constants at the carrier width (== _BIAS at width 32)."""
    if width == 32:
        return _BIAS
    return np.array([to_carrier(torus_constant_w(GATE_DEFS[g][2], width),
                                width) for g in GATE_NAMES], np.int64)


def _bootstrap_batch(combo: torch.Tensor, ck: CloudKey,
                     to_lv1: bool = False) -> torch.Tensor:
    """Bootstrap a linear combo of any batch shape [..., n0+1]."""
    fn = _bootstrap.bootstrap_to_lv1 if to_lv1 else _bootstrap.bootstrap
    out = fn(combo.reshape(-1, combo.shape[-1]), ck)
    return out.reshape(*combo.shape[:-1], out.shape[-1])


def _linear_combo(ca: int, cb: int, bias: int, a: torch.Tensor,
                  b: torch.Tensor, n0: int) -> torch.Tensor:
    out = ca * a + cb * b
    out[..., n0] += bias
    return out


def gate(name: str, a: torch.Tensor, b: torch.Tensor,
         ck: CloudKey) -> torch.Tensor:
    """Evaluate one gate type over a batch: a, b carriers [..., n0+1]."""
    ca, cb, frac = GATE_DEFS[name]
    w = ck.params.torus_bits
    combo = _linear_combo(ca, cb, to_carrier(torus_constant_w(frac, w), w),
                          a, b, ck.params.n0)
    return _bootstrap_batch(combo, ck)


def apply_gates(gate_ids, a: torch.Tensor, b: torch.Tensor,
                ck: CloudKey) -> torch.Tensor:
    """Heterogeneous gate batch: lane i evaluates GATE_NAMES[gate_ids[i]].

    gate_ids: int [B]; a, b: carriers [B, n0+1].  One shared bootstrap.
    Extra trailing batch dims on a/b broadcast against gate_ids from the
    left (ids [W] with a [W, B, n0+1] applies id w to every lane of row w).
    """
    with profiling.span("gates.apply", device=a.device):
        gate_ids = torch.as_tensor(gate_ids, device=a.device).long()
        extra = a.dim() - 1 - gate_ids.dim()

        def table(t):
            return torch.from_numpy(t).to(a.device)[gate_ids]

        ca = table(_COEFF_A).reshape(*gate_ids.shape, *(1,) * (extra + 1))
        cb = table(_COEFF_B).reshape(*gate_ids.shape, *(1,) * (extra + 1))
        bias = table(_bias_table(ck.params.torus_bits)).reshape(
            *gate_ids.shape, *(1,) * extra)
        combo = ca * a + cb * b
        combo[..., ck.params.n0] += bias
        return _bootstrap_batch(combo, ck)


# Named wrappers (free-function parity with gates.zig:157-238).
nand = functools.partial(gate, "nand")
or_ = functools.partial(gate, "or")
and_ = functools.partial(gate, "and")
xor = functools.partial(gate, "xor")
xnor = functools.partial(gate, "xnor")
nor = functools.partial(gate, "nor")
andny = functools.partial(gate, "andny")
andyn = functools.partial(gate, "andyn")
orny = functools.partial(gate, "orny")
oryn = functools.partial(gate, "oryn")


def not_(a: torch.Tensor) -> torch.Tensor:
    """Bootstrap-free NOT (gates.zig:132-135)."""
    return -a


def copy(a: torch.Tensor) -> torch.Tensor:
    """Bootstrap-free COPY (gates.zig:138-141)."""
    return a


def constant(value: bool, params, batch=(), device="cuda") -> torch.Tensor:
    """Trivial (noiseless) ciphertext of a constant (gates.zig:144-151),
    including the reference's false-encoding ``1 -% mu``."""
    w = params.torus_bits
    mu = torus_constant_w(0.125, w)
    val = mu if value else (1 - mu) % (1 << w)
    ct = torch.zeros((*batch, params.n0 + 1), dtype=carrier_dtype(w),
                     device=device)
    ct[..., params.n0] = to_carrier(val, w)
    return ct


def mux_naive(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              ck: CloudKey) -> torch.Tensor:
    """(a ? b : c) as OR(AND(a, b), AND(NOT a, c)): 3 bootstraps
    (gates.zig:124-129), the two ANDs in one shared batch."""
    both = gate_pair(("and", "andny"), (a, a), (b, c), ck)
    return gate("or", both[0], both[1], ck)


def gate_pair(names, lhs_pair, rhs_pair, ck: CloudKey) -> torch.Tensor:
    """Two (possibly different) gate types in one shared bootstrap.

    names: 2 gate names; lhs_pair, rhs_pair: 2 tensors [B, ..., n0+1] each.
    Returns carrier [2, B, ..., n0+1]."""
    B = lhs_pair[0].shape[0]
    ids = torch.tensor([GATE_IDS[names[0]], GATE_IDS[names[1]]],
                       device=lhs_pair[0].device).repeat_interleave(B)
    res = apply_gates(ids, torch.cat(tuple(lhs_pair)),
                      torch.cat(tuple(rhs_pair)), ck)
    return res.reshape(2, B, *res.shape[1:])


def mux(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        ck: CloudKey) -> torch.Tensor:
    """Homomorphic MUX (a ? b : c): 2 blind rotations + 1 key switch.

    u1 = BR(a AND b), u2 = BR((NOT a) AND c), both left at lv1;
    out = KS(u1 + u2 + 1/8)."""
    n0 = ck.params.n0
    w = ck.params.torus_bits
    bias = to_carrier(torus_constant_w(-0.125, w), w)
    stacked = torch.cat([_linear_combo(1, 1, bias, a, b, n0),
                         _linear_combo(-1, 1, bias, a, c, n0)])
    lv1 = _bootstrap_batch(stacked, ck, to_lv1=True)
    half = lv1.shape[0] // 2
    u = lv1[:half] + lv1[half:]
    u[..., ck.params.n1] += to_carrier(torus_constant_w(0.125, w), w)
    return identity_key_switch(u, ck.ksk1, ck.params)
