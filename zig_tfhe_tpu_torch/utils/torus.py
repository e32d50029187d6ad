"""Discretized-torus numerics on torch carriers.

Counterpart of zig_tfhe_tpu/utils/torus.py.  Torus elements are carried as
``torch.int32`` on the 32-bit torus and ``torch.int64`` on the 64-bit torus
(the N = 2048 sets, docs/TORUS64.md): two's-complement add, sub and mul wrap
exactly like the reference's unsigned wrapping ops (tlwe.zig:120-239).
torch has no usable unsigned arithmetic on the CPU (``+`` and ``>>`` raise
on uint32), so the logical shift is emulated on the signed carrier.

Host-side codecs (numpy / Python ints) are the same as the JAX package's:
f64ToTorus is ``trunc(clamp(mod(d,1)*2^32, 0, 2^32-1))`` (utils.zig:28-33);
at width 64 the codecs run in Python ints, as the JAX package's do (a
float64 times 2^64 would lose the low bits of the carrier).
"""

from __future__ import annotations

import numpy as np
import torch

_TWO32 = float(1 << 32)


def require_width(bits: int) -> None:
    """The torus widths the port runs: 32 and 64."""
    if bits not in (32, 64):
        raise ValueError(f"torus width {bits}: the port runs 32 and 64 bits")


def carrier_dtype(bits: int) -> torch.dtype:
    """torch dtype of a torus carrier at the given width."""
    require_width(bits)
    return torch.int32 if bits == 32 else torch.int64


def carrier_width(x: torch.Tensor) -> int:
    """The torus width a carrier tensor holds (int64: 64, else 32)."""
    return 64 if x.dtype == torch.int64 else 32


def f64_to_torus(d, width: int = 32) -> np.ndarray:
    """Host-side exact conversion of a float (or array) to torus carriers:
    int32 at width 32, int64 at width 64 (each element through
    ``torus_constant_w``, as the JAX package's 64-bit codec encodes)."""
    if width == 64:
        d = np.asarray(d, dtype=np.float64)
        return np.array([to_carrier(torus_constant_w(float(x), 64), 64)
                         for x in d.ravel()], np.int64).reshape(d.shape)
    d = np.asarray(d, dtype=np.float64)
    t = np.clip(np.mod(d, 1.0) * _TWO32, 0.0, float((1 << 32) - 1))
    return np.uint32(np.trunc(t)).astype(np.int32)


def torus_constant(d: float) -> int:
    """Python-int (unsigned) torus encoding of a float constant."""
    return int(f64_to_torus(float(d)).astype(np.uint32))


def to_i32(x: int) -> int:
    """Wrap a Python int into the int32 range (mod 2^32)."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def torus_constant_w(d: float, bits: int) -> int:
    """Python-int torus encoding of a float constant at width ``bits``:
    wrap into [0, 1), scale by 2^bits, truncate (dyadic constants encode
    exactly)."""
    require_width(bits)
    if bits == 32:
        return torus_constant(d)
    t = int((float(d) % 1.0) * float(1 << bits))
    return min(max(t, 0), (1 << bits) - 1)


def to_carrier(x: int, bits: int) -> int:
    """Wrap a Python int into the carrier bit pattern (mod 2^bits), as a
    signed Python int."""
    require_width(bits)
    if bits == 32:
        return to_i32(x)
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >= 1 << 63 else x


def shift_right_logical(x: torch.Tensor, amount: int) -> torch.Tensor:
    """Logical (zero-fill) right shift of int32 or int64 carriers.

    The arithmetic shift sign-extends; masking the top ``amount`` bits
    back to zero gives the unsigned shift."""
    if amount == 0:
        return x
    return (x >> amount) & ((1 << (carrier_width(x) - amount)) - 1)


def i32_to_i8_limbs(x: torch.Tensor, n_limbs: int = 4) -> torch.Tensor:
    """Recode int32 (n_limbs <= 4) or int64 (n_limbs <= 8) carriers into
    ``n_limbs`` signed int8 limbs, little-endian: value == sum_k limbs[k] *
    2^(8k) (mod 2^(8*n_limbs)), each limb in [-128, 127].  Stacks limbs on
    a new trailing axis."""
    limbs = []
    r = x
    for k in range(n_limbs):
        lo = ((r + 128) & 255) - 128  # centered remainder in [-128, 127]
        limbs.append(lo.to(torch.int8))
        if k + 1 < n_limbs:
            r = (r - lo) >> 8          # exact division: (r - lo) % 256 == 0
    return torch.stack(limbs, dim=-1)


def i8_limbs_combine(parts, shifts, width: int = 32) -> torch.Tensor:
    """sum_i parts[i] << shifts[i] (mod 2^width) of int32 partial results;
    width 64 lifts each partial onto int64 before its shift."""
    dtype = carrier_dtype(width)
    out = None
    for p, s in zip(parts, shifts):
        assert s < width, f"shift >= {width} is a wasted matmul pass"
        p = p.to(dtype)
        term = p << s if s else p
        out = term if out is None else out + term
    return out
