"""A plain programmable bootstrap on the 64-bit torus, one test vector a
lane, at a configuration's own gadgets: the textbook semantics that a
64-bit LUT configuration's cell (``configs/t64s.json``, tfhe-rs's shortint
PBS on its default key) runs, for the tests that hold the program to it.

Plain PyTorch on int64 tensors, whose products and sums wrap mod 2^64 as
the torus does.  It imports nothing of the program under test and takes
nothing the program made but its inputs: the secret keys, the ciphertexts
and the test vectors.  Its steps are ``reference/bootstrap64.py``'s, at the
configuration's own gadgets (tfhe-rs's PBS 2^23 x 1 and key switch 2^3 x 5
at t64s): the keys (``make_keys``: one TRGSW a bit of the lv0 key, and a
key-switching key of one LWE row a lv1 bit, level and digit value), the
per-bit CMux blind rotation (``blind_rotate``: acc + ExtProd(C_i, X^(a_i)
acc - acc)) of each lane's own test vector [B, 2, N], the sample
extraction at coefficient 0 and the key switch to the lv0 key.  The
program's multi-bit NTT key, its split ring and its kernels are nowhere
here.

Where it departs from tfhe-rs: the order is bootstrap then key switch (lv0
in, lv0 out), where tfhe-rs's KS_PBS keeps a block under the large key
between operations and switches first.  A block's PBS is the same work
either way: one key switch and one blind rotation.  Sizes are a
configuration's; the noise deviations are torus fractions (0 makes the
pipeline deterministic).
"""

from __future__ import annotations

import torch

from gpubench.reference import bootstrap64 as _b64
from gpubench.reference import pbs32 as _pbs32

make_keys = _b64.make_keys
# lv0 ciphertexts [B, n0 + 1] and test vectors [B, 2, N] (or one [2, N],
# which it expands over the lanes) -> [B, 2, N]: lane i a TRLWE encryption
# of X^(-phase_i) tv[i], the phase rounded to a multiple of 1/(2N)
blind_rotate = _b64.blind_rotate
sample_extract = _pbs32.sample_extract     # any width: [B, 2, N] -> [B, N + 1]
key_switch = _b64.key_switch


def bootstrap_lut(ct: torch.Tensor, tv: torch.Tensor, keys: dict,
                  cfg: dict) -> torch.Tensor:
    """Lane i of lv0 ciphertexts [B, n0 + 1] through its own test vector
    tv[i] ([B, 2, N]): the blind rotation, the sample extraction and the
    key switch.  Returns int64 [B, n0 + 1]."""
    return key_switch(sample_extract(blind_rotate(ct, tv, keys, cfg)),
                      keys, cfg)
