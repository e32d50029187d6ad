"""The plain reference of a bootstrapped gate batch: what each output lane
must decrypt to, and how far its phase lies from the plaintext it encodes.

Plain NumPy.  It imports nothing of the program under test and takes
nothing the program made: the benchmark hands it the secret key it drew
from the seed, the plaintext bits and gate ids it drew from the seed, and
the output ciphertexts, which it only judges.

A boolean is encoded on the torus of 2^w as +1/8 (true) or -1/8 (false),
and decrypts by the sign of the phase b - <a, s> (the reference TFHE
library's tlwe.zig).  The ten gates are the truth tables below, in the
order of their ids.
"""

from __future__ import annotations

import numpy as np

GATE_NAMES = ("nand", "or", "and", "xor", "xnor", "nor", "andny", "andyn",
              "orny", "oryn")

# TRUTH[g, x, y]: the output of gate g on inputs x, y
TRUTH = np.array([
    [[1, 1], [1, 0]],   # nand
    [[0, 1], [1, 1]],   # or
    [[0, 0], [0, 1]],   # and
    [[0, 1], [1, 0]],   # xor
    [[1, 0], [0, 1]],   # xnor
    [[1, 0], [0, 0]],   # nor
    [[0, 1], [0, 0]],   # andny: (not x) and y
    [[0, 0], [1, 0]],   # andyn: x and not y
    [[1, 1], [0, 1]],   # orny: (not x) or y
    [[1, 0], [1, 1]],   # oryn: x or not y
], dtype=bool)

_BLOCK = 1 << 14   # rows a block: [rows, n + 1] as uint64 stays near 100 MB


def expected_bits(gate_ids, x, y) -> np.ndarray:
    """The truth tables' outputs for lanes of gate ids and input bits."""
    return TRUTH[np.asarray(gate_ids), np.asarray(x, dtype=np.intp),
                 np.asarray(y, dtype=np.intp)]


def phases(ct, key_bits, width: int) -> np.ndarray:
    """b - <a, s> mod 2^width of ciphertexts [rows, n + 1] (int32 or int64,
    two's complement) under the binary key [n], as signed int64 when width
    is 32 and as uint64 when width is 64."""
    ct = np.asarray(ct)
    s = np.asarray(key_bits, dtype=np.uint64)
    n = s.shape[0]
    if ct.shape[-1] != n + 1:
        raise ValueError(f"ciphertexts of {ct.shape[-1]} words under a key "
                         f"of {n} bits")
    out = np.empty(ct.shape[0], dtype=np.uint64)
    for i in range(0, ct.shape[0], _BLOCK):
        blk = ct[i:i + _BLOCK].astype(np.int64).view(np.uint64)
        dot = (blk[:, :n] * s).sum(axis=1, dtype=np.uint64)
        out[i:i + _BLOCK] = blk[:, n] - dot
    if width == 32:
        low = (out & np.uint64(0xFFFFFFFF)).astype(np.int64)
        return np.where(low >= 1 << 31, low - (1 << 32), low)
    if width != 64:
        raise ValueError(f"torus width {width}")
    return out


def judge(ct, key_bits, width: int, want) -> dict:
    """Judge output ciphertexts [rows, n + 1] against the bits they must
    decrypt to: ``wrong`` counts the lanes whose phase has the other sign,
    and ``noise_sd`` is the root mean square of the phase's distance from
    the encoding of the wanted bit (+-1/8), as a fraction of the torus."""
    want = np.asarray(want, dtype=bool).reshape(-1)
    ph = phases(ct, key_bits, width)
    mu = np.where(want, 1 << (width - 3), -(1 << (width - 3)))
    if width == 32:
        got = ph >= 0
        err = (ph - mu + (1 << 31)) % (1 << 32) - (1 << 31)
        err = err.astype(np.float64) / 2.0 ** 32
    else:
        signed = ph.view(np.int64)
        got = signed >= 0
        err = (ph - mu.astype(np.int64).view(np.uint64)).view(np.int64)
        err = err.astype(np.float64) / 2.0 ** 64
    return {"lanes": int(want.size), "wrong": int(np.count_nonzero(got != want)),
            "noise_sd": float(np.sqrt(np.mean(err * err))),
            "noise_max": float(np.max(np.abs(err)))}
