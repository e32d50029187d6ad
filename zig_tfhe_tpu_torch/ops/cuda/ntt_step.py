"""The fused blind-rotation step core: gadget digits -> per-prime residues,
hand-written in CUDA C++ for Hopper.

Replaces zig_tfhe_tpu/ops/pallas/ntt_step.py:ntt_step_fused_pallas (forward
NTT, the pointwise external products against the step's BSK residues and
the multi-bit rotation combine) and widens it from group 2 to group 3, the
128-bit key default, and from one-limb engine digits to the 2-3-limb
digits of the uint sets (group 2, Bg_e up to 2^24), which every LUT
bootstrap runs.  The inverse NTT, the CRT lift and the accumulator add
that the TPU kernel's caller ran after it stay in K1
(ops/cuda/ntt_inverse.py), so one step is two launches:
``ntt_step_fused`` then ``ntt_inverse_to_crt_acc``, with the residues
between them as int8 limb planes [P, B, 2, 2, N] (``split_limbs`` of
ops/cuda/ntt_inverse.py: K1's operand as it stands, half the bytes of
int32).  The source is
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

Multi-limb digits (group 2 only) enter as int8 limb planes [B, R * n_dl,
N], plane r * n_dl + l holding limb l (little-endian,
ops/decomposition.py:``digit_planes`` of ``decompose_rows``, which K1
writes for the next step).  Their forward NTT is ops/ntt.py:ntt_forward's
limb loop (each limb's ``_limb_pair_combine``, then Horner from the top
limb down), followed by the group-2 arithmetic above.  The JAX package
runs these keys on its XLA ``step2`` (``pointwise_extprod`` +
``rotate_combine2``, no fold), whose residues differ from these only by
multiples of p; both lie within 0.55p, so K1's accumulator is bit-equal.

Each limb's combine takes ``_limb_pair_combine``'s branch at that limb's
bound: the single add where N * bound * (128 + 256 (p // 512 + 1)) <
2^31 (one-limb digits at Bg_e <= 2^7; the top limb of the uint sets,
bounded by ``top_limb_bound``), reduce-then-combine otherwise (Bg_e = 2^8;
every lower limb, bounded by 128).

The kernel has three instances.  g3's steps (group 3, R = 4 one-limb digit
rows, every prime's row group 4 or 2, on the wide tiles of a large batch)
take the one compiled at that shape, and the uint keys' steps (group 2, R
= 2 rows of 3-limb digits, row group 2 at every prime, on the wide tiles of
a large batch: uint2 to uint8) the one compiled at theirs.  Their pointwise
stages run several lanes a thread against each key load, unrolled rows
(and limbs) and a Barrett that rounds by an f32 add (exact for primes of
at least ``MIN_PRIME``; ``barrett_mismatches`` holds it to the conversion
form on the card).  ``shape_instance`` is the choice, made from the
launch's shape alone; ``ntt_step_fused.shape_launches`` counts g3's
instance and ``ntt_step_fused.uint_shape_launches`` the uint keys'.  Every
other launch takes the general instance.

``ntt_step_fused`` launches the kernel for CUDA tensors (or raises) and
runs the plain PyTorch version, ``ntt_step_fused_reference``, for CPU
tensors only.  Both take groups 2 and 3 with one-limb engine digits
(Bg_e <= 2^8) and group 2 with 2-3-limb digits (Bg_e <= 2^24) on the
32-bit torus, and raise ``NotImplementedError`` for anything else (group 3
with multi-limb digits stays on the plain ops of ops/blind_rotate_ntt.py).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from zig_tfhe_tpu_torch.ops import ntt as _ntt
from zig_tfhe_tpu_torch.ops.cuda import _build
from zig_tfhe_tpu_torch.ops.cuda.ntt_inverse import split_limbs

SOURCE = _build.CSRC / "ntt_step.cu"
GROUPS = (2, 3)
_MAX_PRIMES = 8     # kMaxPrimes in the source
_MAX_ROWS = 10      # kMaxRows in the source: limb planes R * n_dl
_MAX_LIMBS = 3      # kMaxLimbs in the source: Bg_e <= 2^24
_COL_TILE = 64      # N must be a multiple of the kernel's narrowest stage
_ROW_TILE = 64      # BM in the source: wgmma rows a tile, R * n_dl per lane
_SHAPE_ROWS = 4     # kShapeRows: digit rows of the instance compiled at g3's shape
_SHAPE_ROW_GROUPS = (2, 4)
_UINT_ROWS = 2      # kUintRows: digit rows of the instance compiled at the uint
_UINT_LIMBS = 3     # keys' shape, kUintLimbs: their limbs, and its row group
_UINT_ROW_GROUP = 2
MIN_PRIME = 1 << 11  # kMinPrime: the shape instances' Barrett rounds exactly above it
# the instances, as the C entry point's `shape` names them
GENERAL, G3_SHAPE, UINT_SHAPE = 0, 1, 2


def supports(group: int, digit_limbs: int) -> bool:
    """Whether the fused step takes a key of this multi-bit group and
    engine-digit limb count (read by ops/blind_rotate_ntt.py:key_form)."""
    return group in GROUPS and (digit_limbs == 1 or (
        group == 2 and digit_limbs <= _MAX_LIMBS))


def _require_supported(digits: torch.Tensor, bsk_step: torch.Tensor,
                       ts: torch.Tensor, plan: _ntt.NTTPlan,
                       bgbit: int) -> None:
    group = ts.shape[0]
    if group not in GROUPS:
        raise NotImplementedError(
            f"the fused step takes multi-bit groups {GROUPS}, not {group}")
    n_dl = _ntt.engine_digit_limbs(bgbit)
    if not supports(group, n_dl):
        raise NotImplementedError(
            f"the fused step takes one-limb engine digits (Bg_e <= 2^8) at "
            f"groups {GROUPS} and 2-3-limb digits (Bg_e <= 2^24) at group "
            f"2, not Bg_e = 2^{bgbit} at group {group}")
    if (digits.dtype != torch.int8 or bsk_step.dtype != torch.int16
            or ts.dtype != torch.int32):
        raise NotImplementedError(
            "the fused step takes int8 digits, int16 key residues and int32 "
            f"rotations of the 32-bit torus (got {digits.dtype}, "
            f"{bsk_step.dtype}, {ts.dtype})")
    P, N = plan.n_primes, plan.N
    B, R = digits.shape[0], bsk_step.shape[2]
    if (tuple(digits.shape) != (B, R * n_dl, N)
            or tuple(bsk_step.shape) != ((1 << group) - 1, P, R, 2, N)
            or tuple(ts.shape) != (group, B)):
        raise ValueError(
            f"shapes {tuple(digits.shape)}, {tuple(bsk_step.shape)}, "
            f"{tuple(ts.shape)} do not match [B, R*n_dl, N={N}] (n_dl = "
            f"{n_dl}), [2^g-1, P={P}, R, 2, N] and [g, B]")


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
    rows = _ntt.rot_rows(torch.cat([ts[0], ts[1]]) & (2 * N - 1), plan)
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

    digits: int8 [B, R * n_dl, N], the limb planes of the accumulator's
    gadget digits (``digit_planes``; n_dl = ``engine_digit_limbs(bgbit)``,
    1 for the boolean keys, whose planes are the digits); bsk_step: int16
    [2^g - 1, P, R, 2, N], one step of the key's ``bsk_ntt``; ts: int32
    [g, B] rotation amounts in [0, 2N].  Returns the residues v (|v| <=
    0.55p) as int8 limb planes [P, B, 2, 2, N], K1's input (``join_limbs``
    gives the int32 residues back)."""
    _require_supported(digits, bsk_step, ts, plan, bgbit)
    n_dl = _ntt.engine_digit_limbs(bgbit)
    B, N = digits.shape[0], digits.shape[-1]
    planes = digits.reshape(B, -1, n_dl, N)
    d_hat = _ntt.ntt_forward_limbs(
        [planes[:, :, l] for l in range(n_dl)], plan,
        _ntt.top_limb_bound(1 << (bgbit - 1), n_dl))
    if ts.shape[0] == 2:
        v = _pointwise_combine2(d_hat, bsk_step, ts, plan)
    else:
        us = [_ntt.pointwise_extprod(d_hat, bsk_step[m], plan,
                                     reduce_output=False)
              for m in range(bsk_step.shape[0])]
        v = _ntt.rotate_combine_multi(us, list(ts), plan, u_wide=True)
    return split_limbs(torch.stack(v))


@functools.lru_cache(maxsize=None)
def shape_instance(plan: _ntt.NTTPlan, group: int, R: int, n_dl: int,
                   B: int, sm_count: int) -> int:
    """The kernel's instance that a launch takes, from its shape alone.
    ``G3_SHAPE``: group 3, R = 4 one-limb digit rows, every prime's row
    group 4 or 2; ``UINT_SHAPE``: group 2, R = 2 rows of 3-limb digits,
    row group 2 at every prime; both with every prime >= ``MIN_PRIME``, on
    the 64 x 128 tiles that the entry point takes when N % 128 == 0 and
    they give each of the card's ``sm_count`` SMs one.  Every other launch
    runs the ``GENERAL`` instance."""
    row_tiles = -(-B // (_ROW_TILE // (R * n_dl)))
    if (plan.N % 128 or min(plan.primes) < MIN_PRIME
            or plan.n_primes * (plan.N // 128) * row_tiles < sm_count):
        return GENERAL
    groups = set(row_groups(plan, group))
    if (group == 3 and R == _SHAPE_ROWS and n_dl == 1
            and groups <= set(_SHAPE_ROW_GROUPS)):
        return G3_SHAPE
    if (group == 2 and R == _UINT_ROWS and n_dl == _UINT_LIMBS
            and groups == {_UINT_ROW_GROUP}):
        return UINT_SHAPE
    return GENERAL


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.ztfhe_ntt_step_fused.argtypes = [p] * 11 + [i] * 7 + [p]
    lib.ztfhe_ntt_step_fused.restype = i
    lib.ztfhe_ntt_step_barrett_mismatches.argtypes = [
        i, ctypes.c_longlong, i, ctypes.c_float, p, p]
    lib.ztfhe_ntt_step_barrett_mismatches.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return _bind(_build.load(SOURCE))


@dataclasses.dataclass(frozen=True)
class _DeviceTables:
    fwd_lo_t: torch.Tensor      # int8 [P, N, N]: fwd_lo transposed
    fwd_hi_t: torch.Tensor
    rot: torch.Tensor           # int16 [P, 2N, N] psi^{t(2k+1)} rows


@functools.lru_cache(maxsize=None)
def device_tables(plan: _ntt.NTTPlan, device: torch.device) -> _DeviceTables:
    """The forward matrices and psi rows the kernel reads (K2s's too), on
    ``device`` once per plan."""
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
    group, and per prime and limb [P, n_dl] whether the forward limb
    combine is the single add (``_limb_pair_combine``'s test at the limb's
    bound: 128 below the top limb, ``top_limb_bound`` at it)."""
    n_dl = _ntt.engine_digit_limbs(bgbit)
    bounds = ([128] * (n_dl - 1)
              + [_ntt.top_limb_bound(1 << (bgbit - 1), n_dl)])
    single = [[int(plan.N * b * (128 + 256 * (p // 512 + 1)) < 2**31)
               for b in bounds] for p in plan.primes]
    return (np.array(plan.primes, np.int32),
            np.array([np.float32(1.0 / p) for p in plan.primes], np.float32),
            np.array(row_groups(plan, group), np.int32),
            np.array(single, np.int32))


@functools.lru_cache(maxsize=None)
def host_scalar_ptrs(plan: _ntt.NTTPlan, group: int, bgbit: int) -> tuple:
    """``_host_scalars`` as ctypes pointers (made once: the launch path is
    host-bound at small batches; the cached arrays stay alive)."""
    return tuple(a.ctypes.data_as(ctypes.c_void_p)
                 for a in _host_scalars(plan, group, bgbit))


def ntt_step_fused(digits: torch.Tensor, bsk_step: torch.Tensor,
                   ts: torch.Tensor, plan: _ntt.NTTPlan,
                   bgbit: int) -> torch.Tensor:
    """Digits -> per-prime residues v of one multi-bit blind-rotation step,
    as int8 limb planes [P, B, 2, 2, N] (arguments as
    ``ntt_step_fused_reference``).  Any
    B.  CUDA tensors launch the kernel (and count the launch in
    ``ntt_step_fused.launches``, and in ``ntt_step_fused.shape_launches``
    or ``ntt_step_fused.uint_shape_launches`` when ``shape_instance`` picks
    g3's or the uint keys' instance); CPU tensors run the plain version."""
    _require_supported(digits, bsk_step, ts, plan, bgbit)
    tensors = (digits, bsk_step, ts)
    if all(t.device.type == "cpu" for t in tensors):
        return ntt_step_fused_reference(digits, bsk_step, ts, plan, bgbit)
    dev = digits.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on {[str(t.device) for t in tensors]}: "
                         "all must be on the same CUDA device")
    group = ts.shape[0]
    n_dl = _ntt.engine_digit_limbs(bgbit)
    P, N = plan.n_primes, plan.N
    B, R = digits.shape[0], bsk_step.shape[2]
    if P > _MAX_PRIMES or R * n_dl > _MAX_ROWS or N % _COL_TILE:
        raise ValueError(f"kernel takes <= {_MAX_PRIMES} primes, <= "
                         f"{_MAX_ROWS} limb planes and N % {_COL_TILE} == 0 "
                         f"(got {P} primes, R*n_dl={R * n_dl}, N={N})")
    digits, bsk_step, ts = (t.contiguous() for t in tensors)
    if digits.data_ptr() % 16 or bsk_step.data_ptr() % 16:
        raise ValueError("kernel operands must be 16-byte aligned")
    return _launch(_library(), digits, bsk_step, ts, plan, bgbit,
                   _sm_count(dev), torch.cuda.current_stream(dev).cuda_stream)


def _launch(lib, digits: torch.Tensor, bsk_step: torch.Tensor,
            ts: torch.Tensor, plan: _ntt.NTTPlan, bgbit: int, sm_count: int,
            stream) -> torch.Tensor:
    """One launch on checked, contiguous operands, on the instance that
    ``shape_instance`` picks for a card of ``sm_count`` SMs; counted."""
    group, n_dl = ts.shape[0], _ntt.engine_digit_limbs(bgbit)
    P, N = plan.n_primes, plan.N
    B, R = digits.shape[0], bsk_step.shape[2]
    shape = shape_instance(plan, group, R, n_dl, B, sm_count)
    tabs = device_tables(plan, digits.device)
    v = torch.empty((P, B, 2, 2, N), dtype=torch.int8, device=digits.device)
    err = lib.ztfhe_ntt_step_fused(
        digits.data_ptr(), bsk_step.data_ptr(), ts.data_ptr(),
        tabs.fwd_lo_t.data_ptr(), tabs.fwd_hi_t.data_ptr(),
        tabs.rot.data_ptr(), v.data_ptr(),
        *host_scalar_ptrs(plan, group, bgbit), P, group, B, R, n_dl, N,
        shape, stream)
    _build.check(lib, err, "ntt_step_fused")
    ntt_step_fused.launches += 1
    ntt_step_fused.shape_launches += int(shape == G3_SHAPE)
    ntt_step_fused.uint_shape_launches += int(shape == UINT_SHAPE)
    return v


ntt_step_fused.launches = 0
ntt_step_fused.shape_launches = 0
ntt_step_fused.uint_shape_launches = 0


def barrett_mismatches(p: int, device, start: int = -(1 << 31),
                       count: int = 1 << 32) -> int:
    """How many int32 x = start + i (mod 2^32), 0 <= i < count, the shape
    instances' Barrett (its rounding by an f32 add of 1.5 * 2^23) reduces
    otherwise than the general instance's conversion form modulo p,
    counted on the CUDA ``device`` by the kernel's own device functions
    (all 2^32 inputs take a few ms)."""
    return count_barrett_mismatches(_library, "ztfhe_ntt_step_barrett_mismatches",
                                    p, device, start, count)


def count_barrett_mismatches(library, entry: str, p: int, device, start: int,
                             count: int) -> int:
    """Run the Barrett check ``entry`` of the kernel library that
    ``library()`` loads (K2's or K2s's; both take start, count, p, f32 1/p,
    a device counter and the stream) on ``device``."""
    import numpy as np

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"device {device}: the check runs on a CUDA device")
    if p < MIN_PRIME:
        raise ValueError(f"p = {p} < {MIN_PRIME}: the rounding is not exact")
    n_diff = torch.zeros(1, dtype=torch.int64, device=device)
    lib = library()
    err = getattr(lib, entry)(int(np.int64(start).astype(np.uint32).view(np.int32)), count,
                p, float(np.float32(1.0 / p)), n_diff.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, err, "barrett_mismatches")
    return int(n_diff.item())
