"""The fused blind-rotation step core: gadget digits -> per-prime residues,
hand-written in CUDA C++ for Hopper.

Replaces zig_tfhe_tpu/ops/pallas/ntt_step.py:ntt_step_fused_pallas (forward
NTT, the pointwise external products against the step's BSK residues and
the multi-bit rotation combine) and widens it from group 2 to group 3, the
128-bit key default.  The inverse NTT, the CRT lift and the accumulator add
that the TPU kernel's caller ran after it stay in K1
(ops/cuda/ntt_inverse.py), so one step is two launches:
``ntt_step_fused`` then ``ntt_inverse_to_crt_acc``.  The source is
zig_tfhe_tpu_torch/csrc/ntt_step.cu (its header gives the bound on the card
and the design); ops/cuda/_build.py compiles it at first use.

The residues follow, at each group, the JAX code that runs there, so that
they (and not only the accumulator) are bit-equal to the JAX package's:

  * group 2: the Pallas kernel's own arithmetic
    (ntt_step.py:_fwd_pointwise_rotate): one row group for every prime,
    ``min(row_group(p))``, a final Barrett on every pointwise sum, and the
    combine barrett(barrett(d1*u1 + d2*u2) + barrett(d12*u12));
  * group 3: the XLA ``step_multi`` fold (blind_rotate_ntt.py:189-206):
    ``pointwise_extprod(reduce_output=False)`` with per-prime row groups,
    then ``rotate_combine_multi(u_wide=True)``.

The forward NTT's limb combine takes ``_limb_pair_combine``'s branch: the
single add at Bg_e <= 2^7, reduce-then-combine at 2^8.

``ntt_step_fused`` launches the kernel for CUDA tensors (or raises) and
runs the plain PyTorch version, ``ntt_step_fused_reference``, for CPU
tensors only.  Both take groups 2 and 3 with one-limb engine digits
(Bg_e <= 2^8) on the 32-bit torus, and raise ``NotImplementedError`` for
anything else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from zig_tfhe_tpu_torch.ops import ntt as _ntt
from zig_tfhe_tpu_torch.ops.cuda import _build

SOURCE = _build.CSRC / "ntt_step.cu"
GROUPS = (2, 3)
_MAX_PRIMES = 8     # kMaxPrimes in the source
_MAX_ROWS = 10      # kMaxRows in the source: (5, 5) levels at Bg_e = 2^6
_COL_TILE = 64      # N must be a multiple of the kernel's BN and BK


def _require_supported(digits: torch.Tensor, bsk_step: torch.Tensor,
                       ts: torch.Tensor, bgbit: int) -> None:
    group = ts.shape[0]
    if group not in GROUPS:
        raise NotImplementedError(
            f"the fused step takes multi-bit groups {GROUPS}, not {group}")
    if _ntt.engine_digit_limbs(bgbit) != 1:
        raise NotImplementedError(
            f"the fused step takes one-limb engine digits (Bg_e <= 2^8), "
            f"not Bg_e = 2^{bgbit}")
    if (digits.dtype != torch.int8 or bsk_step.dtype != torch.int16
            or ts.dtype != torch.int32):
        raise NotImplementedError(
            "the fused step takes int8 digits, int16 key residues and int32 "
            f"rotations of the 32-bit torus (got {digits.dtype}, "
            f"{bsk_step.dtype}, {ts.dtype})")


def row_groups(plan: _ntt.NTTPlan, group: int) -> tuple:
    """Rows summed unreduced in the pointwise stage, per prime: one group
    for every prime at group 2 (the Pallas kernel, ntt_step.py:253), each
    prime's own ``row_group`` at group 3 (``pointwise_extprod``)."""
    groups = tuple(plan.row_group(p) for p in plan.primes)
    return (min(groups),) * len(groups) if group == 2 else groups


def _pointwise_combine2(d_hat, bsk_step: torch.Tensor, ts: torch.Tensor,
                        plan: _ntt.NTTPlan) -> list:
    """Group 2 after the forward NTT, in the Pallas kernel's arithmetic
    (ntt_step.py:_fwd_pointwise_rotate)."""
    N = plan.N
    B = ts.shape[1]
    rows = _ntt._rot_rows(torch.cat([ts[0], ts[1]]) & (2 * N - 1), plan)
    R = bsk_step.shape[2]
    rg = row_groups(plan, 2)[0]
    out = []
    for i, p in enumerate(plan.primes):
        def bar(x, p=p):
            return _ntt.barrett_reduce(x, p)

        d = d_hat[i].unsqueeze(-2)                          # [B, R, 1, N]
        us = []
        for j in range(3):
            kh = bsk_step[j, i].to(torch.int32)             # [R, 2, N]
            acc = None
            for r0 in range(0, R, rg):
                part = bar(sum(d[:, r] * kh[r]
                               for r in range(r0, min(r0 + rg, R))))
                acc = part if acc is None else acc + part
            us.append(bar(acc))                             # [B, 2, N]
        raw = rows[:, i * N:(i + 1) * N]
        d1 = (raw[:B] - 1).unsqueeze(1)                     # [B, 1, N]
        d2 = (raw[B:] - 1).unsqueeze(1)
        d12 = bar(d1 * d2)
        out.append(bar(bar(d1 * us[0] + d2 * us[1]) + bar(d12 * us[2])))
    return out


def ntt_step_fused_reference(digits: torch.Tensor, bsk_step: torch.Tensor,
                             ts: torch.Tensor, plan: _ntt.NTTPlan,
                             bgbit: int) -> torch.Tensor:
    """Plain PyTorch version of the fused step core.

    digits: int8 [B, R, N] gadget digits of the accumulator (Bg_e =
    2^bgbit); bsk_step: int16 [2^g - 1, P, R, 2, N], one step of the key's
    ``bsk_ntt``; ts: int32 [g, B] rotation amounts in [0, 2N].  Returns
    int32 [P, B, 2, N] residues with |v| <= 0.55p (K1's input)."""
    _require_supported(digits, bsk_step, ts, bgbit)
    d_hat = _ntt.ntt_forward(digits, plan, 1, 1 << (bgbit - 1))
    if ts.shape[0] == 2:
        return torch.stack(_pointwise_combine2(d_hat, bsk_step, ts, plan))
    us = [_ntt.pointwise_extprod(d_hat, bsk_step[m], plan, reduce_output=False)
          for m in range(bsk_step.shape[0])]
    return torch.stack(_ntt.rotate_combine_multi(us, list(ts), plan,
                                                 u_wide=True))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.ztfhe_ntt_step_fused.argtypes = [p] * 11 + [i] * 5 + [p]
    lib.ztfhe_ntt_step_fused.restype = i
    return lib


@dataclasses.dataclass(frozen=True)
class _DeviceTables:
    fwd_lo_t: torch.Tensor      # int8 [P, N, N]: fwd_lo transposed
    fwd_hi_t: torch.Tensor
    rot: torch.Tensor           # int16 [P, 2N, N] psi^{t(2k+1)} rows


@functools.lru_cache(maxsize=None)
def _device_tables(plan: _ntt.NTTPlan, device: torch.device) -> _DeviceTables:
    def dev(mats, transpose):
        m = np.stack(mats)
        if transpose:
            m = m.transpose(0, 2, 1)
        return torch.from_numpy(np.ascontiguousarray(m)).to(device)

    return _DeviceTables(fwd_lo_t=dev(plan.fwd_lo, True),
                         fwd_hi_t=dev(plan.fwd_hi, True),
                         rot=dev(plan.rot, False))


@functools.lru_cache(maxsize=None)
def _host_scalars(plan: _ntt.NTTPlan, group: int, bgbit: int):
    """Per-prime scalars passed by value: p, f32 1/p, the pointwise row
    group and whether the forward limb combine is the single add
    (``_limb_pair_combine``'s test at the digit bound Bg_e/2)."""
    bound = 1 << (bgbit - 1)
    single = [int(plan.N * bound * (128 + 256 * (p // 512 + 1)) < 2**31)
              for p in plan.primes]
    return (np.array(plan.primes, np.int32),
            np.array([np.float32(1.0 / p) for p in plan.primes], np.float32),
            np.array(row_groups(plan, group), np.int32),
            np.array(single, np.int32))


def ntt_step_fused(digits: torch.Tensor, bsk_step: torch.Tensor,
                   ts: torch.Tensor, plan: _ntt.NTTPlan,
                   bgbit: int) -> torch.Tensor:
    """Digits -> per-prime residues v int32 [P, B, 2, N] of one multi-bit
    blind-rotation step (arguments as ``ntt_step_fused_reference``).  Any
    B.  CUDA tensors launch the kernel (and count the launch in
    ``ntt_step_fused.launches``); CPU tensors run the plain version."""
    _require_supported(digits, bsk_step, ts, bgbit)
    tensors = (digits, bsk_step, ts)
    if all(t.device.type == "cpu" for t in tensors):
        return ntt_step_fused_reference(digits, bsk_step, ts, plan, bgbit)
    dev = digits.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on {[str(t.device) for t in tensors]}: "
                         "all must be on the same CUDA device")
    group = ts.shape[0]
    P, N = plan.n_primes, plan.N
    B, R = digits.shape[0], digits.shape[1]
    if (tuple(digits.shape) != (B, R, N)
            or tuple(bsk_step.shape) != ((1 << group) - 1, P, R, 2, N)
            or tuple(ts.shape) != (group, B)):
        raise ValueError(
            f"shapes {tuple(digits.shape)}, {tuple(bsk_step.shape)}, "
            f"{tuple(ts.shape)} do not match [B, R, N={N}], "
            f"[2^g-1, P={P}, R, 2, N] and [g, B]")
    if P > _MAX_PRIMES or R > _MAX_ROWS or N % _COL_TILE:
        raise ValueError(f"kernel takes <= {_MAX_PRIMES} primes, <= "
                         f"{_MAX_ROWS} gadget rows and N % {_COL_TILE} == 0 "
                         f"(got {P} primes, R={R}, N={N})")
    digits, bsk_step, ts = (t.contiguous() for t in tensors)
    if digits.data_ptr() % 16 or bsk_step.data_ptr() % 16:
        raise ValueError("kernel operands must be 16-byte aligned")
    tabs = _device_tables(plan, dev)
    primes, inv_p, groups, single = _host_scalars(plan, group, bgbit)
    v = torch.empty((P, B, 2, N), dtype=torch.int32, device=dev)
    lib = _library()

    def ptr(a: np.ndarray):
        return a.ctypes.data_as(ctypes.c_void_p)

    err = lib.ztfhe_ntt_step_fused(
        digits.data_ptr(), bsk_step.data_ptr(), ts.data_ptr(),
        tabs.fwd_lo_t.data_ptr(), tabs.fwd_hi_t.data_ptr(),
        tabs.rot.data_ptr(), v.data_ptr(), ptr(primes), ptr(inv_p),
        ptr(groups), ptr(single), P, group, B, R, N,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "ntt_step_fused")
    ntt_step_fused.launches += 1
    return v


ntt_step_fused.launches = 0
