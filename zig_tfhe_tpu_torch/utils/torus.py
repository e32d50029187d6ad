"""Discretized-torus numerics on torch carriers.

Counterpart of zig_tfhe_tpu/utils/torus.py.  Torus elements are 32-bit
integers carried as ``torch.int32``: two's-complement add, sub and mul wrap
exactly like the reference's ``u32`` wrapping ops (tlwe.zig:120-239).  torch
has no usable ``uint32`` arithmetic on the CPU (``+`` and ``>>`` raise), so
the logical shift is emulated on int32.

Host-side codecs (numpy / Python ints) are the same as the JAX package's:
f64ToTorus is ``trunc(clamp(mod(d,1)*2^32, 0, 2^32-1))`` (utils.zig:28-33).
"""

from __future__ import annotations

import numpy as np
import torch

_TWO32 = float(1 << 32)


def require_width(bits: int) -> None:
    """The port runs the 32-bit torus only; width 64 is slice 4."""
    if bits != 32:
        raise NotImplementedError(
            f"the PyTorch port supports the 32-bit torus only (got {bits}); "
            f"the 64-bit torus comes with slice 4")


def f64_to_torus(d) -> np.ndarray:
    """Host-side exact conversion of a float (or array) to torus int32."""
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
    """Python-int torus encoding of a float constant at width ``bits``."""
    require_width(bits)
    return torus_constant(d)


def to_carrier(x: int, bits: int) -> int:
    """Wrap a Python int into the carrier bit pattern (mod 2^bits)."""
    require_width(bits)
    return to_i32(x)


def shift_right_logical(x: torch.Tensor, amount: int) -> torch.Tensor:
    """Logical (zero-fill) right shift of int32 carriers.

    The arithmetic shift sign-extends; masking the top ``amount`` bits
    back to zero gives the u32 shift."""
    if amount == 0:
        return x
    return (x >> amount) & ((1 << (32 - amount)) - 1)


def i32_to_i8_limbs(x: torch.Tensor, n_limbs: int = 4) -> torch.Tensor:
    """Recode int32 carriers into ``n_limbs`` signed int8 limbs,
    little-endian: value == sum_k limbs[k] * 2^(8k) (mod 2^(8*n_limbs)),
    each limb in [-128, 127].  Stacks limbs on a new trailing axis."""
    limbs = []
    r = x
    for k in range(n_limbs):
        lo = ((r + 128) & 255) - 128  # centered remainder in [-128, 127]
        limbs.append(lo.to(torch.int8))
        if k + 1 < n_limbs:
            r = (r - lo) >> 8          # exact division: (r - lo) % 256 == 0
    return torch.stack(limbs, dim=-1)


def i8_limbs_combine(parts, shifts, width: int = 32) -> torch.Tensor:
    """sum_i parts[i] << shifts[i] (mod 2^32) of int32 partial results."""
    require_width(width)
    out = None
    for p, s in zip(parts, shifts):
        assert s < width, f"shift >= {width} is a wasted matmul pass"
        term = p << s if s else p
        out = term if out is None else out + term
    return out
