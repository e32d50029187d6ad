"""A plain gate bootstrap on the 64-bit torus, at a configuration's own
gadgets: the textbook semantics that a split-ring configuration's cell
(``configs/t64.json``) runs, for the tests that hold the program to it.

Plain PyTorch on int64 tensors, whose products and sums wrap mod 2^64 as
the torus does.  It imports nothing of the program under test and takes
nothing the program made but its inputs: the secret keys and the
ciphertexts.  It makes its own keys, as a textbook does (the program's key
form, its NTT, its split ring and its kernels are nowhere here):

* the bootstrapping key: one TRGSW a bit of the lv0 key, at the
  configuration's own gadget (``bg_bits`` x ``levels``: tfhe-rs's 2^23 x 1
  at t64), rows (a-levels, then b-levels) of TRLWE encryptions of zero plus
  the bit times 2^(64 - j bg) on one component;
* the key-switching key: for every lv1 key bit, level j of
  ``ks_levels`` and unsigned digit d of base 2^``ks_base_bits``, an LWE
  encryption under the lv0 key of d * s_i * 2^(64 - j basebit).

A gate (``apply_gates``) is the textbook linear combination of its two
inputs and a bias (TFHE's gate algebra), a blind rotation of the constant
1/8 test vector by per-bit CMux (``blind_rotate``: acc + ExtProd(C_i,
X^(a_i) acc - acc), negacyclic products as schoolbook int64 matrix
products; it takes any test vector), the sample
extraction at coefficient 0, and the key switch to the lv0 key.  The
order is bootstrap then key switch, as the program's gates run.  Sizes are
a configuration's; the noise deviations are torus fractions (0 makes the
pipeline deterministic).
"""

from __future__ import annotations

import torch

# (coeff_a, coeff_b, bias as a torus fraction) of TFHE's gate algebra, in
# the order of reference/gates.py's GATE_NAMES
GATES = (
    (-1, -1, 1 / 8),    # nand
    (1, 1, 1 / 8),      # or
    (1, 1, -1 / 8),     # and
    (2, 2, 1 / 4),      # xor: 2(a + b) + 1/4
    (-2, -2, -1 / 4),   # xnor
    (-1, -1, -1 / 8),   # nor
    (-1, 1, -1 / 8),    # andny
    (1, -1, -1 / 8),    # andyn
    (-1, 1, 1 / 8),     # orny
    (1, -1, 1 / 8),     # oryn
)


def i64(v: int) -> int:
    """An integer mod 2^64 as the int64 value of its two's complement."""
    v %= 1 << 64
    return v - (1 << 64) if v >= 1 << 63 else v


def torus(frac: float) -> int:
    """A dyadic torus fraction as an int64 value mod 2^64."""
    return i64(round(frac * 2.0 ** 64))


def _uniform(gen: torch.Generator, shape) -> torch.Tensor:
    """Uniform int64 (two 32-bit halves)."""
    hi = torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                       dtype=torch.int64)
    lo = torch.randint(0, 2 ** 32, shape, generator=gen, dtype=torch.int64)
    return (hi << 32) + lo


def _noise(gen: torch.Generator, shape, alpha: float) -> torch.Tensor:
    """Rounded Gaussian of deviation ``alpha`` (a torus fraction)."""
    if alpha == 0:
        return torch.zeros(shape, dtype=torch.int64)
    e = torch.randn(shape, generator=gen, dtype=torch.float64) * alpha
    return torch.round(e * 2.0 ** 64).to(torch.int64)


def negacyclic_matrix(k: torch.Tensor) -> torch.Tensor:
    """[..., N] -> [..., N, N]: row i is X^i k mod X^N + 1, so that a row
    vector of coefficients d times it is the product d(X) k(X)."""
    N = k.shape[-1]
    i = torch.arange(N)[:, None]
    j = torch.arange(N)[None, :]
    m = k[..., (j - i) % N]
    return torch.where(j >= i, m, -m)


def rotate(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """X^t p mod X^N + 1 for polynomials [B, ..., N] and amounts t [B] in
    [0, 2N)."""
    N = p.shape[-1]
    src = torch.arange(N)[None, :] - t[:, None]          # [B, N], > -2N
    sign = torch.where((src < 0) & (src >= -N), -1, 1)   # X^N = -1
    idx = src % N
    shape = (p.shape[0],) + (1,) * (p.dim() - 2) + (N,)
    idx = idx.view(shape).expand(p.shape)
    return torch.gather(p, -1, idx) * sign.view(shape)


def decompose(x: torch.Tensor, bits: int, levels: int) -> torch.Tensor:
    """Signed gadget digits of int64 x, rounded to ``levels`` digits of
    ``bits``: [..., N] -> [..., levels, N], each in [-2^(bits-1),
    2^(bits-1)), sum_j d_j 2^(64 - j bits) the nearest such value to x."""
    half = 1 << (bits - 1)
    off = 1 << (64 - levels * bits - 1) if levels * bits < 64 else 0
    for j in range(1, levels + 1):
        off += half << (64 - j * bits)
    y = x + i64(off)
    mask = (1 << bits) - 1
    return torch.stack([((y >> (64 - j * bits)) & mask) - half
                        for j in range(1, levels + 1)], dim=-2)


def trlwe_zero(gen, s1: torch.Tensor, rows: int, alpha: float) -> torch.Tensor:
    """``rows`` TRLWE encryptions of zero under the lv1 key: [rows, 2, N]
    (mask a, body b = a s + e)."""
    N = s1.shape[0]
    a = _uniform(gen, (rows, N))
    b = a @ negacyclic_matrix(s1) + _noise(gen, (rows, N), alpha)
    return torch.stack([a, b], dim=1)


def make_keys(gen: torch.Generator, s0: torch.Tensor, s1: torch.Tensor,
              cfg: dict) -> dict:
    """The bootstrapping key [n0, 2L, 2, N] and the key-switching key
    [N, ks_levels, 2^ks_base_bits, n0 + 1] under the binary keys s0 [n0]
    and s1 [N] (int64 0/1), at ``cfg``'s gadgets and noises."""
    n0, N, L, bg = cfg["n0"], cfg["N"], cfg["levels"], cfg["bg_bits"]
    bsk = trlwe_zero(gen, s1, n0 * 2 * L, cfg["glwe_alpha"]).view(
        n0, 2 * L, 2, N)
    for j in range(L):
        g = torus(2.0 ** (-(j + 1) * bg))
        bsk[:, j, 0, 0] += s0 * g             # a-levels: the bit on the mask
        bsk[:, L + j, 1, 0] += s0 * g         # b-levels: the bit on the body
    t, base = cfg["ks_levels"], 1 << cfg["ks_base_bits"]
    a = _uniform(gen, (N, t, base, n0))
    msg = (s1[:, None, None] * torch.arange(base)[None, None, :]
           * torch.tensor([torus(2.0 ** (-(j + 1) * cfg["ks_base_bits"]))
                           for j in range(t)])[None, :, None])
    b = (a * s0).sum(-1) + msg + _noise(gen, (N, t, base), cfg["lwe_alpha"])
    return {"bsk": bsk, "ksk": torch.cat([a, b[..., None]], dim=-1)}


def _modswitch(x: torch.Tensor, N: int) -> torch.Tensor:
    """Round a torus value to a multiple of 1/(2N): [0, 2N)."""
    sh = 64 - (2 * N).bit_length() + 1
    return ((x + (1 << (sh - 1))) >> sh) & (2 * N - 1)


def blind_rotate(ct: torch.Tensor, tv: torch.Tensor, keys: dict,
                 cfg: dict) -> torch.Tensor:
    """lv0 ciphertexts [B, n0 + 1] and a test vector [2, N] -> [B, 2, N]:
    a TRLWE encryption of X^(-phase) tv, the phase rounded to a multiple
    of 1/(2N), by per-bit CMux."""
    n0, N, L, bg = cfg["n0"], cfg["N"], cfg["levels"], cfg["bg_bits"]
    B = ct.shape[0]
    acc = rotate(tv.expand(B, 2, N), (2 * N - _modswitch(ct[:, n0], N)) % (2 * N))
    a = _modswitch(ct[:, :n0], N)
    for i in range(n0):
        diff = rotate(acc, a[:, i]) - acc                      # [B, 2, N]
        d = decompose(diff, bg, L).reshape(B, 2 * L * N)       # rows (c, j)
        m = negacyclic_matrix(keys["bsk"][i])                  # [2L, 2, N, N]
        m = m.permute(0, 2, 1, 3).reshape(2 * L * N, 2 * N)
        acc = acc + (d @ m).view(B, 2, N)
    return acc


def bootstrap(ct: torch.Tensor, keys: dict, cfg: dict) -> torch.Tensor:
    """lv0 ciphertexts [B, n0 + 1] -> lv1 [B, N + 1]: the sign of the
    phase as +-1/8 (the constant 1/8 test vector)."""
    N = cfg["N"]
    B = ct.shape[0]
    tv = torch.zeros(2, N, dtype=torch.int64)
    tv[1] = torus(1 / 8)
    acc = blind_rotate(ct, tv, keys, cfg)
    lv1 = torch.empty(B, N + 1, dtype=torch.int64)
    lv1[:, 0] = acc[:, 0, 0]
    lv1[:, 1:N] = -acc[:, 0, 1:].flip(-1)
    lv1[:, N] = acc[:, 1, 0]
    return lv1


def key_switch(ct: torch.Tensor, keys: dict, cfg: dict) -> torch.Tensor:
    """lv1 [B, N + 1] -> lv0 [B, n0 + 1]: the mask rounded to
    ks_levels x ks_base_bits bits, its unsigned digits selecting the key
    rows that are subtracted from (0, b)."""
    N, t, bb = cfg["N"], cfg["ks_levels"], cfg["ks_base_bits"]
    x = ct[:, :N] + (1 << (64 - t * bb - 1))
    d = torch.stack([(x >> (64 - (j + 1) * bb)) & ((1 << bb) - 1)
                     for j in range(t)], dim=-1)               # [B, N, t]
    ksk = keys["ksk"]                                     # [N, t, base, n0+1]
    rows = ksk[torch.arange(N)[None, :, None],
               torch.arange(t)[None, None, :], d]          # [B, N, t, n0+1]
    out = -rows.sum(dim=(1, 2))
    out[:, -1] += ct[:, N]
    return out


def apply_gates(gate_ids: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                keys: dict, cfg: dict) -> torch.Tensor:
    """Lane i evaluates gate ``gate_ids[i]`` on lv0 ciphertexts a[i], b[i]
    [B, n0 + 1]: the linear combination, the bootstrap, the key switch."""
    ca = torch.tensor([g[0] for g in GATES])[gate_ids][:, None]
    cb = torch.tensor([g[1] for g in GATES])[gate_ids][:, None]
    combo = ca * a + cb * b
    combo[:, -1] += torch.tensor([torus(g[2]) for g in GATES])[gate_ids]
    return key_switch(bootstrap(combo, keys, cfg), keys, cfg)
