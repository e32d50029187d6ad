"""Inverse NTT + CRT lift + accumulator add: the blind-rotation step's
finishing kernel, hand-written in CUDA C++ for Hopper.

Replaces zig_tfhe_tpu/ops/pallas/ntt_inverse.py:ntt_inverse_to_crt_pallas.
The source is zig_tfhe_tpu_torch/csrc/ntt_inverse.cu (its header gives the
bound on the card and the design); ops/cuda/_build.py compiles it at first
use and binds it with ``ctypes``.

The residues pass from K2 (ops/cuda/ntt_step.py) to this kernel as int8
limb planes [P, B, 2, 2, N] (``split_limbs``: v == lo + 256 * hi, every
|v| <= 32,639 by construction, ops/ntt.py), which is the kernel's A operand
as it stands and half the bytes of int32 residues.  Both functions below
also take int32 residues [P, B, 2, N] and split them first.

Both also write, where given a ``digits`` buffer and a gadget
(ops/decomposition.py), the next step's digit planes of the accumulator
they return, ``gadget.planes(out)``: at a ``RowGadget`` the planes int8
[B, (la + lb) n_dl, N] that K2 reads (n_dl = 1 at Bg_e <= 2^8: the
rows themselves; 2 or 3 limb planes a row at Bg_e 2^9 to 2^24, the uint
keys), at a ``HalfRowGadget`` on the split ring's views (accumulator [2B,
2, N/2], rows (b, c, q)) the hi-plane half-rows int8 [B, 2(la + lb), N/2]
that K2s reads.  On the card each is an instance of the kernel that
computes them in its final epilogue from the values it stores
(csrc/ntt_inverse.cu).

``ntt_inverse_to_crt_acc`` launches the kernel for CUDA tensors (or
raises) and runs the plain PyTorch version,
``ntt_inverse_to_crt_acc_reference``, for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from zig_tfhe_tpu_torch.ops.cuda import _build
from zig_tfhe_tpu_torch.ops.decomposition import HalfRowGadget, RowGadget
from zig_tfhe_tpu_torch.ops.ntt import (NTTPlan, engine_digit_limbs,
                                        ntt_inverse_to_crt)

SOURCE = _build.CSRC / "ntt_inverse.cu"
_MAX_PRIMES = 8     # kMaxPrimes in the source
_COL_TILE = 64      # N must be a multiple of the kernel's widest tile
_MAX_LIMBS = 3      # kLimbRows's digits: Bg_e <= 2^24


def split_limbs(v: torch.Tensor) -> torch.Tensor:
    """int32 residues [..., N] with |v| <= 32,639 -> int8 limb planes
    [..., 2, N]: lo in [-128, 128), hi = (v - lo) >> 8, v == lo + 256 hi."""
    lo = ((v + 128) & 255) - 128
    return torch.stack([lo, (v - lo) >> 8], dim=-2).to(torch.int8)


def join_limbs(v8: torch.Tensor) -> torch.Tensor:
    """The inverse of ``split_limbs``: int8 [..., 2, N] -> int32 [..., N]."""
    v = v8.to(torch.int32)
    return v[..., 0, :] + (v[..., 1, :] << 8)


def ntt_inverse_to_crt_acc_reference(v_stack: torch.Tensor, acc: torch.Tensor,
                                     plan: NTTPlan, drop: int,
                                     digits: torch.Tensor | None = None,
                                     gadget: RowGadget | HalfRowGadget
                                     | None = None) -> torch.Tensor:
    """Plain PyTorch version: acc + (ntt_inverse_to_crt(v) << drop), the
    JAX package's XLA formulation of the same step (blind_rotate_ntt.py
    finish).  v_stack: int8 limb planes [P, B, 2, 2, N] or int32 residues
    [P, B, 2, N].  With ``digits`` also writes the output's gadget digit
    planes there, ``gadget.planes(out)``: int8 [B, (la + lb) n_dl, N] at a
    ``RowGadget``, [B / 2, 2(la + lb), N] at a ``HalfRowGadget``."""
    if v_stack.dtype == torch.int8:
        v_stack = join_limbs(v_stack)
    delta = ntt_inverse_to_crt(list(v_stack), plan)
    if drop:
        delta = delta << drop
    out = acc + delta
    if digits is not None:
        digits.copy_(gadget.planes(out))
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.ztfhe_ntt_inverse_crt_acc.argtypes = [p, p, p, p, p, p, p, p, p,
                                              i, i, i, i, i, p]
    lib.ztfhe_ntt_inverse_crt_acc.restype = i
    for entry in (lib.ztfhe_ntt_inverse_crt_acc_digits,
                  lib.ztfhe_ntt_inverse_crt_acc_half_rows):
        entry.argtypes = [p] * 9 + [i] * 5 + [p] + [i] * 5 + [p]
        entry.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _digit_scalars(gadget: RowGadget | HalfRowGadget) -> tuple:
    """The digit entry point's scalars, passed by value: both offsets as
    signed 32-bit ints, bits, la, lb."""
    offs = tuple(o - (1 << 32) if o >= 1 << 31 else o for o in gadget.offsets)
    return (*offs, gadget.bits, *gadget.levels)


@dataclasses.dataclass(frozen=True)
class _KernelTables:
    m_lo: torch.Tensor          # int8 [P, N, 2N]: inv_cat_lo transposed
    m_hi: torch.Tensor
    primes: np.ndarray          # host scalars, passed by value
    crt_e: np.ndarray
    inv_p: np.ndarray
    theta: np.ndarray

    @functools.cached_property
    def scalar_ptrs(self) -> tuple:
        """The four host arrays as ctypes pointers (made once: the launch
        path is host-bound at small batches)."""
        return tuple(a.ctypes.data_as(ctypes.c_void_p)
                     for a in (self.primes, self.crt_e, self.inv_p, self.theta))


@functools.lru_cache(maxsize=None)
def _kernel_tables(plan: NTTPlan, device: torch.device) -> _KernelTables:
    def t(mats):
        m = np.ascontiguousarray(np.stack(mats).transpose(0, 2, 1))
        return torch.from_numpy(m).to(device)

    return _KernelTables(
        m_lo=t(plan.inv_cat_lo), m_hi=t(plan.inv_cat_hi),
        primes=np.array(plan.primes, np.int32),
        crt_e=np.array(plan.crt_e, np.int32),
        inv_p=np.array([np.float32(1.0 / p) for p in plan.primes], np.float32),
        theta=np.array(plan.crt_theta, np.float32))


def _require_digits(digits: torch.Tensor,
                    gadget: RowGadget | HalfRowGadget | None,
                    acc: torch.Tensor) -> None:
    half = isinstance(gadget, HalfRowGadget)
    if not (half or isinstance(gadget, RowGadget)):
        raise ValueError("digits need the RowGadget or HalfRowGadget they "
                         "are written at")
    width = 64 if half else 32
    n_dl = engine_digit_limbs(gadget.bits)
    if n_dl > (1 if half else _MAX_LIMBS) or gadget.params.torus_bits != width:
        raise NotImplementedError(
            f"the kernel writes one-limb digits (Bg_e <= 2^8) of the 64-bit "
            f"torus's hi planes, or 1-{_MAX_LIMBS} limbs (Bg_e <= 2^24) of "
            f"the 32-bit torus, not Bg_e = 2^{gadget.bits} at width "
            f"{gadget.params.torus_bits} ({type(gadget).__name__})")
    rows, N = acc.shape[0], acc.shape[-1]
    shape = ((rows // 2, 2 * sum(gadget.levels), N) if half
             else (rows, sum(gadget.levels) * n_dl, N))
    if (digits.dtype != torch.int8 or tuple(digits.shape) != shape
            or (half and rows % 2) or not digits.is_contiguous()
            or digits.device != acc.device):
        raise ValueError(
            f"digits {digits.dtype} {tuple(digits.shape)} on {digits.device} "
            f"are not a contiguous int8 {shape} on {acc.device}")


def ntt_inverse_to_crt_acc(v_stack: torch.Tensor, acc: torch.Tensor,
                           plan: NTTPlan, drop: int,
                           digits: torch.Tensor | None = None,
                           gadget: RowGadget | HalfRowGadget | None = None
                           ) -> torch.Tensor:
    """acc + (CRT(invNTT(v)) << drop) mod 2^32.

    v_stack: the per-prime residues (|.| <= 0.55p), as int8 limb planes
    [P, B, 2, 2, N] (K2's output) or as int32 [P, B, 2, N], which is split
    here; acc: int32 [B, 2, N].  Any B.  With ``digits``, a contiguous
    int8 buffer, and its gadget (Bg_e <= 2^24 on the 32-bit torus, <= 2^8
    on the hi planes), also writes the planes the module docstring gives
    there.  CUDA tensors launch the kernel (and count the launch in
    ``ntt_inverse_to_crt_acc.launches``, and one that wrote digits also in
    ``.digit_launches``); CPU tensors run the plain version."""
    if (v_stack.dtype not in (torch.int32, torch.int8)
            or acc.dtype != torch.int32):
        raise NotImplementedError(
            "the kernel takes int32 residues or their int8 limb planes and "
            "an int32 accumulator (the split-ring scan's are its int32 hi "
            "planes; an int64 accumulator's finish is the plain "
            f"ops/ntt.py:finish_int64) (got {v_stack.dtype}, {acc.dtype})")
    if digits is not None:
        _require_digits(digits, gadget, acc)
    if v_stack.device.type == "cpu" and acc.device.type == "cpu":
        return ntt_inverse_to_crt_acc_reference(v_stack, acc, plan, drop,
                                                digits, gadget)
    if v_stack.device.type != "cuda" or acc.device != v_stack.device:
        raise ValueError(f"tensors on {v_stack.device} and {acc.device}: "
                         "both must be on the same CUDA device")
    P, N = plan.n_primes, plan.N
    B = acc.shape[0]
    v_shape = (P, B, 2, N) if v_stack.dtype == torch.int32 else (P, B, 2, 2, N)
    if tuple(v_stack.shape) != v_shape or tuple(acc.shape) != (B, 2, N):
        raise ValueError(f"shapes {tuple(v_stack.shape)}, {tuple(acc.shape)} "
                         f"do not match [P={P}, B, 2, (2,) N={N}] and [B, 2, N]")
    if P > _MAX_PRIMES or N % _COL_TILE:
        raise ValueError(f"kernel takes <= {_MAX_PRIMES} primes and N % "
                         f"{_COL_TILE} == 0 (plan has {P} primes, N={N})")
    if not 0 <= drop < 32:
        raise ValueError(f"drop {drop} outside [0, 32)")
    if v_stack.dtype == torch.int32:
        v_stack = split_limbs(v_stack)
    v_stack = v_stack.contiguous()
    acc = acc.contiguous()
    if (v_stack.data_ptr() % 16 or acc.data_ptr() % 16
            or (digits is not None and digits.data_ptr() % 16)):
        raise ValueError("kernel operands must be 16-byte aligned")
    tabs = _kernel_tables(plan, v_stack.device)
    out = torch.empty_like(acc)
    lib = _library()
    args = (v_stack.data_ptr(), acc.data_ptr(), out.data_ptr(),
            tabs.m_lo.data_ptr(), tabs.m_hi.data_ptr(), *tabs.scalar_ptrs,
            plan.p_mod, P, 2 * B, N, drop)
    stream = torch.cuda.current_stream(v_stack.device).cuda_stream
    if digits is None:
        err = lib.ztfhe_ntt_inverse_crt_acc(*args, stream)
    else:
        entry = (lib.ztfhe_ntt_inverse_crt_acc_half_rows
                 if isinstance(gadget, HalfRowGadget)
                 else lib.ztfhe_ntt_inverse_crt_acc_digits)
        err = entry(*args, digits.data_ptr(), *_digit_scalars(gadget), stream)
    _build.check(lib, err, "ntt_inverse_crt_acc")
    ntt_inverse_to_crt_acc.launches += 1
    if digits is not None:
        ntt_inverse_to_crt_acc.digit_launches += 1
    return out


ntt_inverse_to_crt_acc.launches = 0
ntt_inverse_to_crt_acc.digit_launches = 0
