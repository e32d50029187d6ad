"""Inverse NTT + CRT lift + accumulator add: the blind-rotation step's
finishing kernel, hand-written in CUDA C++ for Hopper.

Replaces zig_tfhe_tpu/ops/pallas/ntt_inverse.py:ntt_inverse_to_crt_pallas.
The source is zig_tfhe_tpu_torch/csrc/ntt_inverse.cu (its header gives the
bound on the card and the design).  It is compiled at first use with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
cached in zig_tfhe_tpu_torch/_build/ under the hash of the source and the
flags, and bound with ``ctypes``.

``ntt_inverse_to_crt_acc`` launches the kernel for CUDA tensors (or
raises) and runs the plain PyTorch version,
``ntt_inverse_to_crt_acc_reference``, for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from zig_tfhe_tpu_torch.ops.ntt import NTTPlan, ntt_inverse_to_crt

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "ntt_inverse.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
_MAX_PRIMES = 8     # kMaxPrimes in the source
_COL_TILE = 64      # N must be a multiple of the kernel's BN and BK


def ntt_inverse_to_crt_acc_reference(v_stack: torch.Tensor, acc: torch.Tensor,
                                     plan: NTTPlan, drop: int) -> torch.Tensor:
    """Plain PyTorch version: acc + (ntt_inverse_to_crt(v) << drop), the
    JAX package's XLA formulation of the same step (blind_rotate_ntt.py
    finish)."""
    delta = ntt_inverse_to_crt(list(v_stack), plan)
    if drop:
        delta = delta << drop
    return acc + delta


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = shutil.which("nvcc") or (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None)
    if not nvcc or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build zig_tfhe_tpu_torch/csrc/ntt_inverse.cu")
    return nvcc


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"ntt_inverse_{digest}.so"


def build() -> Path:
    """Compile the kernel's shared library (always; atomic replace)."""
    so = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, so)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed building {SOURCE}:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    so = library_path()
    if not so.exists():
        build()
    lib = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.ztfhe_ntt_inverse_crt_acc.argtypes = [p, p, p, p, p, p, p, p, p,
                                              i, i, i, i, i, p]
    lib.ztfhe_ntt_inverse_crt_acc.restype = i
    lib.ztfhe_cuda_error_string.argtypes = [i]
    lib.ztfhe_cuda_error_string.restype = ctypes.c_char_p
    return lib


@dataclasses.dataclass(frozen=True)
class _KernelTables:
    m_lo: torch.Tensor          # int8 [P, N, 2N]: inv_cat_lo transposed
    m_hi: torch.Tensor
    primes: np.ndarray          # host scalars, passed by value
    crt_e: np.ndarray
    inv_p: np.ndarray
    theta: np.ndarray


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


def ntt_inverse_to_crt_acc(v_stack: torch.Tensor, acc: torch.Tensor,
                           plan: NTTPlan, drop: int) -> torch.Tensor:
    """acc + (CRT(invNTT(v)) << drop) mod 2^32.

    v_stack: int32 [P, B, 2, N] per-prime residues (|.| <= 0.55p);
    acc: int32 [B, 2, N].  Any B.  CUDA tensors launch the kernel (and
    count the launch in ``ntt_inverse_to_crt_acc.launches``); CPU tensors
    run the plain version."""
    if v_stack.dtype != torch.int32 or acc.dtype != torch.int32:
        raise NotImplementedError(
            "the kernel takes int32 residues and the 32-bit torus only "
            f"(got {v_stack.dtype}, {acc.dtype})")
    if v_stack.device.type == "cpu" and acc.device.type == "cpu":
        return ntt_inverse_to_crt_acc_reference(v_stack, acc, plan, drop)
    if v_stack.device.type != "cuda" or acc.device != v_stack.device:
        raise ValueError(f"tensors on {v_stack.device} and {acc.device}: "
                         "both must be on the same CUDA device")
    P, N = plan.n_primes, plan.N
    B = acc.shape[0]
    if (tuple(v_stack.shape) != (P, B, 2, N)
            or tuple(acc.shape) != (B, 2, N)):
        raise ValueError(f"shapes {tuple(v_stack.shape)}, {tuple(acc.shape)} "
                         f"do not match [P={P}, B, 2, N={N}] and [B, 2, N]")
    if P > _MAX_PRIMES or N % _COL_TILE:
        raise ValueError(f"kernel takes <= {_MAX_PRIMES} primes and N % "
                         f"{_COL_TILE} == 0 (plan has {P} primes, N={N})")
    if not 0 <= drop < 32:
        raise ValueError(f"drop {drop} outside [0, 32)")
    v_stack = v_stack.contiguous()
    acc = acc.contiguous()
    if v_stack.data_ptr() % 16 or acc.data_ptr() % 16:
        raise ValueError("kernel operands must be 16-byte aligned")
    tabs = _kernel_tables(plan, v_stack.device)
    out = torch.empty_like(acc)
    lib = _library()

    def ptr(a: np.ndarray):
        return a.ctypes.data_as(ctypes.c_void_p)

    err = lib.ztfhe_ntt_inverse_crt_acc(
        v_stack.data_ptr(), acc.data_ptr(), out.data_ptr(),
        tabs.m_lo.data_ptr(), tabs.m_hi.data_ptr(), ptr(tabs.primes),
        ptr(tabs.crt_e), ptr(tabs.inv_p), ptr(tabs.theta), plan.p_mod, P,
        2 * B, N, drop, torch.cuda.current_stream(v_stack.device).cuda_stream)
    if err:
        raise RuntimeError("ntt_inverse_crt_acc launch failed: "
                           + lib.ztfhe_cuda_error_string(err).decode())
    ntt_inverse_to_crt_acc.launches += 1
    return out


ntt_inverse_to_crt_acc.launches = 0
