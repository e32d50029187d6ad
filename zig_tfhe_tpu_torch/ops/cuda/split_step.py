"""K2s: the split-ring blind-rotation step core (the 64-bit torus's N =
2048 step on the N/2 plan), hand-written in CUDA C++ for Hopper.

The function of K2 (zig_tfhe_tpu/ops/pallas/ntt_step.py:
ntt_step_fused_pallas: digits -> forward NTT -> pointwise products with the
step's key residues -> multi-bit rotation combine -> residues) at the
split-ring shape of ops/split_ring.py: 2R half-rows a batch element, the
folded key's 4 output planes, the Y-twisted combine
(``rotate_combine_multi_split``).  The JAX package runs this step in XLA
and has no Pallas kernel for it.  One hi-plane step of
``blind_rotate_split`` is the decompose (``_rows_hi32``), this kernel, then
K1 (ops/cuda/ntt_inverse.py), which takes the residues as the int8 limb
planes this kernel writes ([P, B, 2(c), 2(q), 2(limb), N/2], viewed as
[P, 2B, 2, 2, N/2] rows (b, c)).  The source is
zig_tfhe_tpu_torch/csrc/split_step.cu (its header gives the bound on the
card and the design); ops/cuda/_build.py compiles it at first use.  Its
Barrett rounds by an f32 add of 1.5 * 2^23 instead of the f32 -> int32
conversion, which is exact for primes of at least 2^11 (``MIN_PRIME``; the
wrapper refuses a plan with a smaller one); ``barrett_mismatches`` runs
the kernel's own Barrett against the plain form over a range of int32 on
the card (all 2^32 by default), and ``barrett_reference`` is the plain
form in numpy.

Its plain version, ``split_step_fused_reference``, is the chain the scan
ran before the kernel existed: ``_forward`` -> ``_pointwise`` per subset
-> ``rotate_combine_multi_split`` -> ``split_limbs``, whose residues the
CRT lift of K1 turns into the JAX package's accumulator bit for bit (the
residues themselves are only congruent mod p to the JAX package's).  The
kernel places every reduction where that chain does, and is held equal to
it bit for bit.

``split_step_fused`` launches the kernel for CUDA tensors (or raises) and
runs the plain version for CPU tensors only.  It takes group 2 with
one-limb engine digits (Bg_e <= 2^8) on the hi-plane scan: the defaults of
every split-ring set.  ``supports`` is the routing test of
``blind_rotate_split``; group 1 and group 3 split keys, multi-limb digits
and the generic int64 scan stay on the plain ops (they raise
``NotImplementedError`` here).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from zig_tfhe_tpu_torch.ops import ntt as _ntt
from zig_tfhe_tpu_torch.ops.cuda import _build
from zig_tfhe_tpu_torch.ops.cuda.ntt_inverse import split_limbs
from zig_tfhe_tpu_torch.ops.cuda.ntt_step import _device_tables, _host_scalar_ptrs

SOURCE = _build.CSRC / "split_step.cu"
GROUP = 2
_MAX_PRIMES = 8     # kMaxPrimes in the source
_MAX_ROWS = 10      # kMaxRows in the source: half-rows 2R a batch element
_COL_TILE = 128     # N/2 must be a multiple of the kernel's stage depth
MIN_PRIME = 1 << 11  # kMinPrime: the kernel's Barrett rounds exactly above it


def supports(group: int, digit_limbs: int, hi32: bool) -> bool:
    """Whether K2s takes a split key's step: group 2, one-limb engine
    digits, on the int32 hi-plane scan (``split_ring._hi32_viable``)."""
    return group == GROUP and digit_limbs == 1 and hi32


def _require_supported(digits: torch.Tensor, bsk_step: torch.Tensor,
                       ts: torch.Tensor, plan: _ntt.NTTPlan,
                       bgbit: int) -> None:
    group = ts.shape[0] if ts.dim() == 2 else None
    if group != GROUP:
        raise NotImplementedError(
            f"the split step takes multi-bit group {GROUP}, not {group}: "
            "group 1 and group 3 split keys stay on the plain ops")
    if _ntt.engine_digit_limbs(bgbit) != 1:
        raise NotImplementedError(
            f"the split step takes one-limb engine digits (Bg_e <= 2^8), not "
            f"Bg_e = 2^{bgbit}: multi-limb split digits stay on the plain ops")
    if (digits.dtype != torch.int8 or bsk_step.dtype != torch.int16
            or ts.dtype != torch.int32):
        raise NotImplementedError(
            "the split step takes int8 hi-plane digits, int16 key residues "
            f"and int32 rotations (got {digits.dtype}, {bsk_step.dtype}, "
            f"{ts.dtype})")
    P, N = plan.n_primes, plan.N
    B = digits.shape[0] if digits.dim() == 3 else -1
    R2 = bsk_step.shape[2] if bsk_step.dim() == 5 else -1
    if (tuple(digits.shape) != (B, R2, N)
            or tuple(bsk_step.shape) != ((1 << GROUP) - 1, P, R2, 4, N)
            or tuple(ts.shape) != (GROUP, B)):
        raise ValueError(
            f"shapes {tuple(digits.shape)}, {tuple(bsk_step.shape)}, "
            f"{tuple(ts.shape)} do not match [B, 2R, N/2={N}], [3, P={P}, "
            "2R, 4, N/2] and [2, B]")


def row_group(plan: _ntt.NTTPlan) -> int:
    """Rows summed unreduced in the pointwise sums: the plan's smallest
    ``row_group`` (int32-exact for every prime), as ``_pointwise``."""
    return min(plan.row_group(p) for p in plan.primes)


def split_step_fused_reference(digits: torch.Tensor, bsk_step: torch.Tensor,
                               ts: torch.Tensor, plan: _ntt.NTTPlan,
                               bgbit: int) -> torch.Tensor:
    """Plain PyTorch version of the split step core.

    digits: int8 [B, 2R, N/2], the hi-plane gadget digits
    (``_rows_hi32``, |d| <= 128) in (r, q_in) row order; bsk_step: int16
    [3, P, 2R, 4, N/2], one step of the folded split key; ts: int32 [2, B]
    rotation amounts in [0, 4 N/2).  Returns the residues v (|v| <=
    0.52p) as int8 limb planes [P, B, 2(c), 2(q), 2(limb), N/2], K1's
    input."""
    from zig_tfhe_tpu_torch.ops import split_ring as _sr

    _require_supported(digits, bsk_step, ts, plan, bgbit)
    d_hat = _sr._forward(digits, plan)                        # [P, B, 2R, N/2]
    us = [_sr._pointwise(d_hat, bsk_step[m], plan)
          for m in range(bsk_step.shape[0])]
    return split_limbs(_sr.rotate_combine_multi_split(us, [ts[0], ts[1]], plan))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p = ctypes.c_void_p
    i = ctypes.c_int
    f = ctypes.c_float
    lib.ztfhe_split_step_fused.argtypes = [p] * 9 + [i] * 5 + [p]
    lib.ztfhe_split_step_fused.restype = i
    lib.ztfhe_split_barrett_mismatches.argtypes = [i, ctypes.c_longlong, i, f,
                                                   p, p]
    lib.ztfhe_split_barrett_mismatches.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return _bind(_build.load(SOURCE))


def split_step_fused(digits: torch.Tensor, bsk_step: torch.Tensor,
                     ts: torch.Tensor, plan: _ntt.NTTPlan,
                     bgbit: int) -> torch.Tensor:
    """Digits -> the residues of one split-ring step as int8 limb planes
    [P, B, 2, 2, 2, N/2] (arguments as ``split_step_fused_reference``).
    Any B.  CUDA tensors launch the kernel (and count the launch in
    ``split_step_fused.launches``); CPU tensors run the plain version."""
    _require_supported(digits, bsk_step, ts, plan, bgbit)
    tensors = (digits, bsk_step, ts)
    if all(t.device.type == "cpu" for t in tensors):
        return split_step_fused_reference(digits, bsk_step, ts, plan, bgbit)
    dev = digits.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on {[str(t.device) for t in tensors]}: "
                         "all must be on the same CUDA device")
    P, N = plan.n_primes, plan.N
    B, R2 = digits.shape[0], digits.shape[1]
    if (P > _MAX_PRIMES or R2 > _MAX_ROWS or N % _COL_TILE
            or min(plan.primes) < MIN_PRIME):
        raise ValueError(f"kernel takes <= {_MAX_PRIMES} primes, all >= "
                         f"{MIN_PRIME}, <= {_MAX_ROWS} half-rows and N/2 % "
                         f"{_COL_TILE} == 0 (got primes {plan.primes}, "
                         f"2R={R2}, N/2={N})")
    digits, bsk_step, ts = (t.contiguous() for t in tensors)
    if digits.data_ptr() % 16 or bsk_step.data_ptr() % 16:
        raise ValueError("kernel operands must be 16-byte aligned")
    tabs = _device_tables(plan, dev)
    v = torch.empty((P, B, 2, 2, 2, N), dtype=torch.int8, device=dev)
    lib = _library()
    err = lib.ztfhe_split_step_fused(
        digits.data_ptr(), bsk_step.data_ptr(), ts.data_ptr(),
        tabs.fwd_lo_t.data_ptr(), tabs.fwd_hi_t.data_ptr(),
        tabs.rot.data_ptr(), v.data_ptr(),
        *_host_scalar_ptrs(plan, GROUP, bgbit)[:2], P,
        row_group(plan), B, R2, N, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "split_step_fused")
    split_step_fused.launches += 1
    return v


split_step_fused.launches = 0


def barrett_reference(x, p: int):
    """The plain version's Barrett of int32 x (numpy) modulo p:
    round(f32(x) * f32(1/p)) half to even, x - q p wrapping mod 2^32."""
    import numpy as np

    x = np.asarray(x, dtype=np.int32)
    q = np.rint(x.astype(np.float32) * np.float32(1.0 / p)).astype(np.int64)
    return (x.astype(np.int64) - q * p).astype(np.uint32).view(np.int32)


def barrett_mismatches(p: int, device, start: int = -(1 << 31),
                       count: int = 1 << 32) -> int:
    """How many int32 x = start + i (mod 2^32), 0 <= i < count, the
    kernel's Barrett (its rounding by the add of 1.5 * 2^23) reduces
    otherwise than the plain version's conversion form modulo p, counted
    on the CUDA ``device`` by the kernel's own device function (all 2^32
    inputs take a few ms)."""
    import numpy as np

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"device {device}: the check runs on a CUDA device")
    if p < MIN_PRIME:
        raise ValueError(f"p = {p} < {MIN_PRIME}: the rounding is not exact")
    n_diff = torch.zeros(1, dtype=torch.int64, device=device)
    lib = _library()
    err = lib.ztfhe_split_barrett_mismatches(
        int(np.int64(start).astype(np.uint32).view(np.int32)), count, p,
        float(np.float32(1.0 / p)), n_diff.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, err, "split_barrett_mismatches")
    return int(n_diff.item())
