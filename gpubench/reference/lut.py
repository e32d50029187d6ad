"""The plain reference of a programmable bootstrap batch: what each output
lane must decrypt to, and how far its phase lies from the plaintext it
encodes.

Plain NumPy with uint64 arithmetic.  It imports nothing of the program
under test and takes nothing the program made but the output ciphertexts:
the benchmark hands it the secret key it drew from the seed, and the inputs
and function ids it drew from the seed.

A message x of Z_m (m a power of two, 2^b) is encoded on the torus of 2^w
with the scale 1/(2m) of the reference TFHE library's codec
(lut/encoder.zig): encode(x) = x 2^w / (2m), and a phase decodes to
round(phase 2m / 2^w) mod m, halves rounded up.  The functions Z_m -> Z_m
below are those a lane may carry, by name; ``message`` and ``carry`` are
the message and carry extraction of tfhe-rs's shortint layer (the low and
high b/2 bits).
"""

from __future__ import annotations

import numpy as np

from gpubench.reference.gates import phases


def _half(m: int) -> int:
    return (m.bit_length() - 1) // 2


# name -> f(x, m) on Python or NumPy integers in [0, m), values in [0, m)
FUNCTIONS = {
    "identity": lambda x, m: x % m,
    "negate": lambda x, m: (-x) % m,
    "square": lambda x, m: (x * x) % m,
    "double": lambda x, m: (2 * x) % m,
    "message": lambda x, m: x % (1 << _half(m)),
    "carry": lambda x, m: x >> _half(m),
    "msb": lambda x, m: (x >= m // 2) * 1,
}
FUNCTION_NAMES = tuple(FUNCTIONS)


def check_modulus(m: int) -> int:
    """``m`` if it is a power of two of at least 2, else ValueError."""
    if m < 2 or m & (m - 1):
        raise ValueError(f"message modulus {m}: a power of two of at least 2")
    return m


def expected(functions, fn_ids, x, m: int) -> np.ndarray:
    """f(x) for lanes of function ids (indices into ``functions``, names of
    ``FUNCTIONS``) and inputs in [0, m)."""
    fn_ids, x = np.asarray(fn_ids), np.asarray(x, dtype=np.int64)
    out = np.empty(x.shape, dtype=np.int64)
    for i, name in enumerate(functions):
        sel = fn_ids == i
        out[sel] = FUNCTIONS[name](x[sel], m)
    return out


def judge(ct, key_bits, width: int, want, m: int) -> dict:
    """Judge output ciphertexts [rows, n + 1] against the messages of Z_m
    they must decrypt to: ``wrong`` counts the lanes whose phase decodes to
    another message, and ``noise_sd`` is the root mean square of the
    phase's signed distance from encode(want), as a fraction of the
    torus."""
    check_modulus(m)
    shift = width - m.bit_length()          # encode(x) = x << shift
    want = np.asarray(want, dtype=np.int64).reshape(-1).astype(np.uint64)
    ph = phases(ct, key_bits, width)
    mask = np.uint64((1 << width) - 1)
    u = ph.view(np.uint64) & mask           # the phase in [0, 2^w)
    # round(u / 2^shift) mod m; at width 64 the sum wraps mod 2^64, a
    # multiple of m 2^shift, which leaves the residue mod m as it is
    got = ((u + np.uint64(1 << (shift - 1))) >> np.uint64(shift)) % np.uint64(m)
    d = (u - (want << np.uint64(shift))) & mask
    if width == 32:
        signed = d.astype(np.int64)
        err = np.where(signed >= 1 << 31, signed - (1 << 32), signed) / 2.0 ** 32
    else:
        err = d.view(np.int64).astype(np.float64) / 2.0 ** 64
    return {"lanes": int(want.size), "wrong": int(np.count_nonzero(got != want)),
            "noise_sd": float(np.sqrt(np.mean(err * err))),
            "noise_max": float(np.max(np.abs(err)))}
