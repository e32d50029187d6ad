"""The Toeplitz engine's external-product contraction for one digit limb,
hand-written in CUDA C++ for Hopper.

Replaces zig_tfhe_tpu/ops/pallas/extprod.py:extprod_matmul_pallas:

    out[b, o*N + n] = sum_kl 2^(8*(kl+drop)) *
                      sum_j sum_k d[b, j*N + k] * ext[kl, j, o, (n - k) mod 2N]

mod 2^32, drop = 4 - n_kl: the digits against the negacyclic circulant
of every row of one BSK entry, per key limb, the key limbs' partials
shifted and summed.  The source is zig_tfhe_tpu_torch/csrc/extprod.cu (its
header gives the bound on the card and the design); ops/cuda/_build.py
compiles it at first use and binds it with ``ctypes``.

``extprod_matmul`` launches the kernel for CUDA tensors (or raises) and
runs the plain PyTorch version, ``extprod_matmul_reference``, for CPU
tensors only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from zig_tfhe_tpu_torch.ops.cuda import _build
from zig_tfhe_tpu_torch.ops.poly import matmul_i8
from zig_tfhe_tpu_torch.params import SecurityParams
from zig_tfhe_tpu_torch.trgsw import N_KLIMBS, trgsw_matrices

SOURCE = _build.CSRC / "extprod.cu"
_COL_TILE = 64      # N must be a multiple of the kernel's column tile
_MAX_N = 1024       # the kernel's shared memory is sized for N <= 1024


def extprod_matmul_reference(digit_limb: torch.Tensor,
                             bsk_ext_limbs: torch.Tensor,
                             params: SecurityParams) -> torch.Tensor:
    """Plain PyTorch version: the JAX package's XLA formulation, the
    circulants built in memory (``trgsw_matrices``) and one ``matmul_i8``
    per key limb."""
    mats = trgsw_matrices(bsk_ext_limbs, params)
    drop = N_KLIMBS - mats.shape[0]
    out = None
    for kl in range(mats.shape[0]):
        part = matmul_i8(digit_limb, mats[kl]) << 8 * (kl + drop)
        out = part if out is None else out + part
    return out


def _check(digit_limb: torch.Tensor, bsk_ext_limbs: torch.Tensor,
           params: SecurityParams) -> None:
    if digit_limb.dtype != torch.int8 or bsk_ext_limbs.dtype != torch.int8:
        raise TypeError("the kernel takes int8 digit limbs and int8 key limbs "
                        f"(got {digit_limb.dtype}, {bsk_ext_limbs.dtype})")
    N, L = params.N, params.L
    n_kl = bsk_ext_limbs.shape[0] if bsk_ext_limbs.dim() else 0
    if (digit_limb.dim() != 2 or digit_limb.shape[1] != 2 * L * N
            or tuple(bsk_ext_limbs.shape[1:]) != (2 * L, 2, 2 * N)
            or not 1 <= n_kl <= N_KLIMBS):
        raise ValueError(
            f"shapes {tuple(digit_limb.shape)}, {tuple(bsk_ext_limbs.shape)} "
            f"do not match [B, 2L*N={2 * L * N}] and [1..4, 2L={2 * L}, 2, "
            f"2N={2 * N}]")
    # one key limb's partial must be exact in int32: |digit limb| is at
    # most Bg/2 for one-limb digits, else 128; key limbs are >= -128
    d_max = 1 << (params.bgbit - 1) if params.digit_limbs == 1 else 128
    if 2 * L * N * d_max * 128 >= 1 << 31:
        raise ValueError(f"2L*N*{d_max}*128 >= 2^31: a key limb's partial "
                         "would overflow int32")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.ztfhe_extprod_matmul.argtypes = [p, p, p, i, i, i, i, p]
    lib.ztfhe_extprod_matmul.restype = i
    return lib


def extprod_matmul(digit_limb: torch.Tensor, bsk_ext_limbs: torch.Tensor,
                   params: SecurityParams) -> torch.Tensor:
    """One digit limb's external-product contraction.

    digit_limb: int8 [B, 2L*N]; bsk_ext_limbs: int8 [n_kl, 2L, 2, 2N], one
    step of the key.  Returns int32 [B, 2N], exact mod 2^32.  Any B.  CUDA
    tensors launch the kernel (and count the launch in
    ``extprod_matmul.launches``); CPU tensors run the plain version."""
    _check(digit_limb, bsk_ext_limbs, params)
    if digit_limb.device.type == "cpu" and bsk_ext_limbs.device.type == "cpu":
        return extprod_matmul_reference(digit_limb, bsk_ext_limbs, params)
    dev = digit_limb.device
    if dev.type != "cuda" or bsk_ext_limbs.device != dev:
        raise ValueError(f"tensors on {digit_limb.device} and "
                         f"{bsk_ext_limbs.device}: both must be on the same "
                         "CUDA device")
    N, L = params.N, params.L
    if N % _COL_TILE or N > _MAX_N:
        raise ValueError(f"kernel takes N % {_COL_TILE} == 0 and N <= "
                         f"{_MAX_N} (got N={N})")
    digit_limb = digit_limb.contiguous()
    bsk_ext_limbs = bsk_ext_limbs.contiguous()
    if digit_limb.data_ptr() % 16 or bsk_ext_limbs.data_ptr() % 16:
        raise ValueError("kernel operands must be 16-byte aligned")
    B = digit_limb.shape[0]
    out = torch.empty((B, 2 * N), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    lib = _library()
    err = lib.ztfhe_extprod_matmul(
        digit_limb.data_ptr(), bsk_ext_limbs.data_ptr(), out.data_ptr(), B,
        2 * L, N, bsk_ext_limbs.shape[0],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "extprod_matmul")
    extprod_matmul.launches += 1
    return out


extprod_matmul.launches = 0
