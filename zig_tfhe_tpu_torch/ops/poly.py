"""Exact polynomial and matrix arithmetic in signed int8 limbs.

Counterpart of zig_tfhe_tpu/ops/poly.py.  Products mod 2^32 run as
int8 x int8 -> int32 matrix products (``torch._int_mm``) over signed 8-bit
limb recodings (utils/torus.py:i32_to_i8_limbs); limb pairs whose combined
shift is >= 32 vanish mod 2^32 and are skipped.  CUDA has no int32
``matmul``, so every integer contraction in the port goes through
``matmul_i8``.

Negacyclic convolution (X^N = -1): with ext(b) = [b, -b] (length 2N),
``out = a @ T(b)`` where T(b)[k, n] = ext(b)[(n - k) mod 2N].  The
Toeplitz engine (ops/blind_rotate.py) contracts gadget digits against the
circulants of the bootstrapping key's rows this way.

Oracle: ``negacyclic_polymul_naive`` is the O(N^2) schoolbook used by tests.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from zig_tfhe_tpu_torch.utils.torus import i32_to_i8_limbs, i8_limbs_combine


def matmul_i8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 [..., K] x int8 [K, M] -> int32 [..., M].

    ``torch._int_mm`` on CUDA (cuBLASLt) takes only more than 16 rows and
    K, M multiples of 8, and on an H100 cuBLASLt refused 17- to 40-row
    products with M = 64 unless the row count was a multiple of 32; so
    rows are zero-padded to a multiple of 32 and K, M to multiples of 8,
    and the result is sliced back (zero rows and columns add nothing).
    The padding is applied on every device so the CPU tests run the same
    code."""
    lead, K = a.shape[:-1], a.shape[-1]
    M = b.shape[-1]
    a2 = a.reshape(-1, K)
    rows = a2.shape[0]
    pad_k, pad_m, pad_r = -K % 8, -M % 8, -rows % 32
    if pad_k or pad_r:
        a2 = F.pad(a2, (0, pad_k, 0, pad_r))
    if pad_k or pad_m:
        b = F.pad(b, (0, pad_m, 0, pad_k))
    out = torch._int_mm(a2.contiguous(), b.contiguous())
    if pad_r or pad_m:
        out = out[:rows, :M]
    return out.reshape(*lead, M)


def _limb_count_for_bound(bound: int) -> int:
    """Signed int8 limbs needed to represent values in [-bound, bound]."""
    k = 1
    while not (-(1 << (8 * k - 1)) <= -bound and bound < (1 << (8 * k - 1))):
        k += 1
    return k


def small_matmul_torus(small: torch.Tensor, torus_mat: torch.Tensor,
                       small_bound: int, width: int = 32) -> torch.Tensor:
    """Exact ``small @ torus_mat`` mod 2^32 via int8 limb matmuls.

    small: int32 [..., K] with |values| <= small_bound; torus_mat: int32
    [K, M] full-range torus values.  Each int8 x int8 partial accumulates
    in int32, so K * min(small_bound, 127) * 127 must stay < 2^31 (true for
    every key-switch shape: K = N*iks_t <= 12288)."""
    n_dl = _limb_count_for_bound(small_bound)
    n_kl = width // 8
    d_limbs = i32_to_i8_limbs(small, n_dl)      # [..., K, n_dl]
    k_limbs = i32_to_i8_limbs(torus_mat, n_kl)  # [K, M, n_kl]
    parts, shifts = [], []
    for dl in range(n_dl):
        for kl in range(n_kl):
            sh = 8 * (dl + kl)
            if sh >= width:
                continue  # vanishes mod 2^width
            parts.append(matmul_i8(d_limbs[..., dl], k_limbs[..., kl]))
            shifts.append(sh)
    return i8_limbs_combine(parts, shifts, width)


@functools.lru_cache(maxsize=None)
def _toeplitz_index(N: int) -> np.ndarray:
    """Static gather index: IDX[k, n] = (n - k) mod 2N, shape [N, N]."""
    n = np.arange(N)[None, :]
    k = np.arange(N)[:, None]
    return (n - k) % (2 * N)


def negacyclic_extend(p: torch.Tensor) -> torch.Tensor:
    """[..., N] -> [..., 2N] with ext = [p, -p]."""
    return torch.cat([p, -p], dim=-1)


def toeplitz_from_ext(ext: torch.Tensor) -> torch.Tensor:
    """Circulant rows T[..., k, n] = ext[..., (n-k) mod 2N] of a [..., 2N]
    extension, [..., N, N].  One static-index gather: the JAX package
    builds the same bits by log2 N doubling rolls, a TPU workaround."""
    idx = torch.from_numpy(_toeplitz_index(ext.shape[-1] // 2)).to(ext.device)
    return ext[..., idx]


def toeplitz(p: torch.Tensor) -> torch.Tensor:
    """Negacyclic circulant T(p)[..., k, n] = ext(p)[..., (n-k) mod 2N],
    ext(p) = [p, -p]."""
    return toeplitz_from_ext(negacyclic_extend(p))


def negacyclic_rotate(p: torch.Tensor, k) -> torch.Tensor:
    """Multiply by X^k (negacyclic rotation), k in [0, 2N] mod 2N:
    out[..., n] = ext(p)[..., (n - k) mod 2N], the polyMulWithXK of
    trgsw.zig:442-466 for every k in [0, 2N].

    p: int32 [..., N]; k: an int, or an int32 tensor that is a scalar or
    matches p's leading batch dims (one amount per batch element)."""
    N = p.shape[-1]
    ext = negacyclic_extend(p)
    k = torch.as_tensor(k, dtype=torch.int64, device=p.device)
    idx = (torch.arange(N, device=p.device) - k[..., None]) % (2 * N)
    if k.dim() == 0:
        return ext[..., idx]
    idx = idx.reshape(*k.shape, *(1,) * (ext.dim() - k.dim() - 1), N)
    return torch.gather(ext, -1, idx.expand(*ext.shape[:-1], N))


def negacyclic_polymul_binary(a_torus: torch.Tensor,
                              s_binary: torch.Tensor) -> torch.Tensor:
    """Exact a * s mod 2^32 for int32 ``a`` [..., N] and binary s [N].

    ``a`` is split into 4 int8 limbs, each contracted against the
    {0, 1, -1} int8 Toeplitz of s in int32 (|partial| <= 128*N < 2^31)
    and combined mod 2^32 — the JAX package's int64-carrier form, which is
    the only exact integer product CUDA offers."""
    T8 = toeplitz(s_binary.to(torch.int8))          # {0, 1, -1}
    a_limbs = i32_to_i8_limbs(a_torus, 4)           # [..., N, 4]
    parts = [matmul_i8(a_limbs[..., l], T8) for l in range(4)]
    return i8_limbs_combine(parts, [0, 8, 16, 24])


def negacyclic_polymul_naive(a, b) -> np.ndarray:
    """Schoolbook negacyclic product mod 2^32 in Python ints (test oracle,
    fft.zig:695-714).  Inputs int32 arrays [N]; returns int32 [N]."""
    a = np.asarray(a).astype(object)
    b = np.asarray(b).astype(object)
    N = a.shape[-1]
    out = np.zeros(N, dtype=object)
    for k in range(N):
        for j in range(N):
            if k + j < N:
                out[k + j] += a[k] * b[j]
            else:
                out[k + j - N] -= a[k] * b[j]
    out = np.array([int(v) & 0xFFFFFFFF for v in out], dtype=np.uint32)
    return out.astype(np.int32)
