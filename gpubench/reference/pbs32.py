"""A plain programmable bootstrap on the 32-bit torus, one test vector a
lane, at a configuration's own gadgets: the textbook semantics that a
32-bit LUT configuration's cell (``configs/uint4.json``) runs, for the
tests that hold the program to it.

Plain PyTorch on int64 tensors.  It imports nothing of the program under
test and takes nothing the program made but its inputs: the secret keys,
the ciphertexts and the test vectors.  It makes its own keys, as a
textbook does, from the secret keys at the configuration's own gadgets
(``bg_bits`` x ``levels``, key switch ``ks_base_bits`` x ``ks_levels``)
and noises (the program's multi-bit NTT key, its kernels and its digit
formats are nowhere here):

* the bootstrapping key: one TRGSW a bit of the lv0 key, rows (a-levels,
  then b-levels) of TRLWE encryptions of zero plus the bit times
  2^(32 - j bg) on one component;
* the key-switching key: for every lv1 key bit, level j and unsigned digit
  d of base 2^ks_base_bits, an LWE encryption under the lv0 key of
  d s_i 2^(32 - j ks_base_bits).

A bootstrap (``bootstrap_lut``) is the blind rotation of each lane's own
test vector [B, 2, N] by per-bit CMux (acc + ExtProd(C_i, X^(a_i) acc -
acc)), the sample extraction at coefficient 0 and the key switch to the
lv0 key.

**The lift.**  The steps are ``reference/bootstrap64.py``'s, run on the
32-bit torus lifted by 2^32: a value v mod 2^32 is held as v 2^32 mod
2^64 (``lift``), and the top 32 bits of a result are the 32-bit result
(``lower``).  The lift is exact here, step by step:

* sums, negations, negacyclic rotations and products by integers (the
  digits, the key bits) of lifted values are lifted values, since
  k (v 2^32) = (k v mod 2^32) 2^32 mod 2^64;
* the rounding of a phase to a multiple of 1/(2N) adds 2^(63 - log2 2N)
  and shifts by 64 - log2 2N + 1 (54 at N = 1024): both at bit 32 or
  above, so it reads v's 32-bit rounding (add 2^21, shift by 22);
* the gadget decomposition adds an offset whose lowest bit is
  2^(63 - L bg) (2^41 at 2^22 x 1) and reads digits from bit 64 - j bg
  (42): at bit 32 or above when L bg <= 31, so the digits are v's own;
* the key switch adds 2^(63 - t bb) (2^48 at 2^5 x 3) and reads digits
  from bit 64 - j bb (59, 54, 49): v's own when t bb <= 31;
* the keys' gadget factors 2^(64 - j bg) and 2^(64 - j bb) are the lifts
  of 2^(32 - j bg) and 2^(32 - j bb) for j bits <= 32, and their masks
  and noises are drawn on the 32-bit torus (``_uniform``, ``_noise``) and
  lifted.

``make_keys`` refuses gadgets past these limits, so the module computes
the 32-bit textbook bootstrap exactly, with ``bootstrap64.py`` unchanged.
Sizes are a configuration's; the noise deviations are torus fractions (0
makes the pipeline deterministic).  Ciphertexts, test vectors and results
are 32-bit torus values held in int32 or int64 tensors.
"""

from __future__ import annotations

import torch

from gpubench.reference import bootstrap64 as _b64

WIDTH = 32


def lift(x: torch.Tensor) -> torch.Tensor:
    """32-bit torus values (any integer dtype) -> int64 v 2^32 mod 2^64."""
    return x.to(torch.int64) << WIDTH


def lower(x: torch.Tensor) -> torch.Tensor:
    """Lifted values -> the 32-bit torus values, int32."""
    return (x >> WIDTH).to(torch.int32)


def _uniform(gen: torch.Generator, shape) -> torch.Tensor:
    """Uniform 32-bit torus values, lifted."""
    return lift(torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                              dtype=torch.int64))


def _noise(gen: torch.Generator, shape, alpha: float) -> torch.Tensor:
    """Rounded Gaussian of deviation ``alpha`` on the 32-bit torus, lifted."""
    if alpha == 0:
        return torch.zeros(shape, dtype=torch.int64)
    e = torch.randn(shape, generator=gen, dtype=torch.float64) * alpha
    return lift(torch.round(e * 2.0 ** WIDTH).to(torch.int64))


def make_keys(gen: torch.Generator, s0: torch.Tensor, s1: torch.Tensor,
              cfg: dict) -> dict:
    """The lifted bootstrapping key [n0, 2L, 2, N] and key-switching key
    [N, ks_levels, 2^ks_base_bits, n0 + 1] under the binary keys s0 [n0]
    and s1 [N] (int64 0/1), at ``cfg``'s gadgets and noises."""
    n0, N, L, bg = cfg["n0"], cfg["N"], cfg["levels"], cfg["bg_bits"]
    t, bb = cfg["ks_levels"], cfg["ks_base_bits"]
    if cfg["torus_bits"] != WIDTH or L * bg > 31 or t * bb > 31:
        raise ValueError(f"the lift is exact on the 32-bit torus with L bg "
                         f"and t bb at most 31, not {cfg['torus_bits']} bits, "
                         f"{L} x {bg}, {t} x {bb}")
    s0, s1 = s0.to(torch.int64), s1.to(torch.int64)
    rows = n0 * 2 * L
    a = _uniform(gen, (rows, N))
    b = a @ _b64.negacyclic_matrix(s1) + _noise(gen, (rows, N),
                                                 cfg["glwe_alpha"])
    bsk = torch.stack([a, b], dim=1).view(n0, 2 * L, 2, N)
    for j in range(L):
        g = _b64.torus(2.0 ** (-(j + 1) * bg))
        bsk[:, j, 0, 0] += s0 * g             # a-levels: the bit on the mask
        bsk[:, L + j, 1, 0] += s0 * g         # b-levels: the bit on the body
    base = 1 << bb
    a = _uniform(gen, (N, t, base, n0))
    msg = (s1[:, None, None] * torch.arange(base)[None, None, :]
           * torch.tensor([_b64.torus(2.0 ** (-(j + 1) * bb))
                           for j in range(t)])[None, :, None])
    b = (a * s0).sum(-1) + msg + _noise(gen, (N, t, base), cfg["lwe_alpha"])
    return {"bsk": bsk, "ksk": torch.cat([a, b[..., None]], dim=-1)}


def blind_rotate(ct: torch.Tensor, tv: torch.Tensor, keys: dict,
                 cfg: dict) -> torch.Tensor:
    """lv0 ciphertexts [B, n0 + 1] and test vectors [B, 2, N] (or one
    [2, N]) -> int32 [B, 2, N]: a TRLWE encryption of X^(-phase) tv, the
    phase rounded to a multiple of 1/(2N), by per-bit CMux."""
    B, N = ct.shape[0], cfg["N"]
    tv = lift(tv).expand(B, 2, N)
    return lower(_b64.blind_rotate(lift(ct), tv, keys, cfg))


def sample_extract(acc: torch.Tensor) -> torch.Tensor:
    """[B, 2, N] -> lv1 [B, N + 1]: the LWE of the phase's coefficient 0."""
    B, _, N = acc.shape
    lv1 = torch.empty(B, N + 1, dtype=acc.dtype)
    lv1[:, 0] = acc[:, 0, 0]
    lv1[:, 1:N] = -acc[:, 0, 1:].flip(-1)
    lv1[:, N] = acc[:, 1, 0]
    return lv1


def key_switch(ct: torch.Tensor, keys: dict, cfg: dict) -> torch.Tensor:
    """lv1 [B, N + 1] -> int32 lv0 [B, n0 + 1]."""
    return lower(_b64.key_switch(lift(ct), keys, cfg))


def bootstrap_lut(ct: torch.Tensor, tv: torch.Tensor, keys: dict,
                  cfg: dict) -> torch.Tensor:
    """Lane i of lv0 ciphertexts [B, n0 + 1] through its own test vector
    tv[i] ([B, 2, N]): the blind rotation, the sample extraction and the
    key switch.  Returns int32 [B, n0 + 1]."""
    return key_switch(sample_extract(blind_rotate(ct, tv, keys, cfg)),
                      keys, cfg)
