"""Blind rotation on the matmul-NTT engine: the direct ring's set-up, the
key's resolved form, and the one step loop of both NTT rings.

Counterpart of zig_tfhe_tpu/ops/blind_rotate_ntt.py.  Per step:

    digits = gadget_decompose(acc)                 # coefficient domain
    d_hat  = NTT(digits)                           # int8 matmuls
    u_hat  = sum_rows d_hat * BSK_hat[i]           # pointwise modmul
    v_hat  = (psi^t - 1) * u_hat                   # NTT-domain X^t rotation
    acc   += CRT(invNTT(v_hat)) << drop_bits       # K1

``lax.scan`` becomes a Python loop over the steps (234 at the 128-bit
default, group 3).  ``key_form`` resolves once a call what a key asks for
(plan, engine gadget, digit format, ``Path``); ``scan`` runs the steps of
every path on this module's direct ring (N <= 1024) and on
ops/split_ring.py's split ring, which hands it K2s and its plain chain.

On a kernel path a step is the step core, then K1
(ops/cuda/ntt_inverse.py:ntt_inverse_to_crt_acc).  The direct ring's
core is K2 (ops/cuda/ntt_step.py:ntt_step_fused: forward NTT, pointwise
products, subset combine) at groups 2 and 3 with one-limb engine digits
(every boolean key) and at group 2 with 2-3-limb digits (every uint key);
its residues follow the JAX package's Pallas step at group 2 and its XLA
``step_multi`` at group 3 (module docstring there).  Every kernel path is
fused: step 0 decomposes the set-up's accumulator, and K1 of step s
writes the digit planes of the accumulator it makes (the form's gadget's
``planes``: the int8 digits of a one-limb key, the 2-3 limb planes a row
of a uint key's) into the one buffer the core of step s read, for step s
+ 1; the last step writes none.  Stream order makes one buffer enough,
and a step is two launches.  The span ``blind_rotate.steps`` carries
``fused_steps``: G - 1 on the fused path, 0 on the plain ones; and
``plain_digit_steps``, the steps whose digits were made outside K1 (by
the gadget's ``planes`` or inside the plain step): 1 on the fused path,
every step on the plain ones.  The test vector's rotation is span
``blind_rotate.testvec``.  Group 1, groups above 3, group 3 with multi-limb
digits, split keys K2s does not take and the 64-bit direct engine
(TEST_TINY64) run the plain ops of the JAX package's XLA step, then K1 on
an int32 accumulator or ops/ntt.py:finish_int64 on an int64 one.  Each
kernel is the hand-written one on CUDA tensors, its plain version on CPU
tensors.
"""

from __future__ import annotations

import dataclasses
import enum
import functools

import torch

from zig_tfhe_tpu_torch.ops import ntt as _ntt
from zig_tfhe_tpu_torch.ops.cuda import ntt_step as _k2
from zig_tfhe_tpu_torch.ops.cuda import split_step as _k2s
from zig_tfhe_tpu_torch.ops.cuda.ntt_inverse import ntt_inverse_to_crt_acc
from zig_tfhe_tpu_torch.ops.decomposition import (HalfRowGadget, RowGadget,
                                                  half_row_gadget, hi32_planes,
                                                  modswitch, row_gadget)
from zig_tfhe_tpu_torch.params import SecurityParams
from zig_tfhe_tpu_torch.utils import profiling


class Path(enum.Enum):
    """How a key's steps run."""
    GROUP1 = "group 1 on the plain ops"
    MULTI = "multi-bit on the plain ops"
    FUSED = "step core and K1, K1 writing the next step's digits"


@dataclasses.dataclass(frozen=True)
class KeyForm:
    """What a blind rotation derives from its key, once a call: ``hi32``
    (the split ring's scan carries int32 hi planes) and ``path`` route it,
    and ``drop`` and ``gadget`` follow from them."""
    params: SecurityParams
    plan: _ntt.NTTPlan
    bits: int                 # the engine gadget's base 2^bits
    levels: tuple             # (la, lb)
    digit_limbs: int
    digit_bound: int          # the top digit limb's
    key_drop: int             # the bits the key's residues were rounded by
    hi32: bool
    path: Path

    @functools.cached_property
    def drop(self) -> int:
        """The finish's shift: the hi planes take the key's less 32."""
        return self.key_drop - 32 if self.hi32 else self.key_drop

    @functools.cached_property
    def gadget(self) -> RowGadget | HalfRowGadget:
        """The digits the steps read: half-rows on the hi planes, else rows."""
        if self.hi32:
            return half_row_gadget(self.params, self.bits, self.levels)
        return row_gadget(self.params, self.levels, self.bits)


def key_form(params: SecurityParams, bsk: torch.Tensor, drop_bits: int,
             group: int, levels, bgbit: int | None) -> KeyForm:
    """The resolved form of a key: bsk int16 [n0, P, R, 2, N] (group 1) or
    [G, 2^g - 1, P, R, 2, N] on the direct ring, the split ring's [..., P,
    2R, 4, N/2]; (bgbit, levels) its engine gadget (None: the parameter
    base, levels read off the key's row axis).  Checks the key's rows
    against the levels and its primes against the plan, and routes it: the
    only reader of the kernels' ``supports`` and of ``hi32_planes``."""
    e = params.bgbit if bgbit is None else bgbit
    split = params.split_ring
    row_axis = 2 if group == 1 else 3
    rows = bsk.shape[row_axis] // (2 if split else 1)
    if levels is None:
        levels = rows // 2
    levels = _ntt.norm_levels(params, levels, bgbit=e)
    if levels[0] + levels[1] != rows:
        raise ValueError(f"levels {levels} do not match the key's "
                         f"{bsk.shape[row_axis]} gadget rows")
    plan = _ntt.plan_for_params(params, drop_bits, group, levels, bgbit=e,
                                pseudorandom_key=True)
    if bsk.shape[row_axis - 1] != plan.n_primes:
        raise ValueError(f"BSK holds {bsk.shape[row_axis - 1]} CRT prime planes "
                         f"but the plan selects {plan.n_primes}: the key was "
                         "generated under another plan bound")
    limbs = _ntt.engine_digit_limbs(e)
    hi32 = split and hi32_planes(params, drop_bits, e, levels)
    if group == 1:
        path = Path.GROUP1
    elif split:
        path = Path.FUSED if _k2s.supports(group, limbs, hi32) else Path.MULTI
    elif params.torus_bits == 32 and _k2.supports(group, limbs):
        path = Path.FUSED
    else:
        path = Path.MULTI
    return KeyForm(params, plan, e, levels, limbs,
                   _ntt.top_limb_bound(1 << (e - 1), limbs), drop_bits, hi32,
                   path)


def rotations(tlwe_batch: torch.Tensor, params: SecurityParams, group: int,
              steps: int) -> torch.Tensor:
    """Every step's rotation amounts at once, int32: [n0, B] at group 1,
    [G, g, B] at group g (a ragged last group padded with a = 0, the
    identity rotation), contiguous."""
    n0 = params.n0
    t = modswitch(tlwe_batch[:, :n0].T, params)
    if group > 1:
        if n0 < group * steps:
            t = torch.cat([t, t.new_zeros(group * steps - n0, t.shape[1])])
        t = t.reshape(steps, group, -1)
    return t.contiguous()


def scan(acc: torch.Tensor, bsk: torch.Tensor, ts: torch.Tensor,
         form: KeyForm, core, plain_step) -> torch.Tensor:
    """The steps of a blind rotation on either NTT ring.

    acc: int32 [B, 2, N] as K1 takes it (the split ring's hi planes as the
    views [2B, 2, N/2]), or int64 for the plain int64 finish; bsk: one key
    entry a step; ts: ``rotations``.  The ring's ``core(digits, bsk_step,
    ts_step, plan, bits)`` (kernel paths) and ``plain_step(acc, bsk_step,
    ts_step, form)`` (plain paths) return the residues as K1 takes them.
    The span ``blind_rotate.steps`` closes on the last K1."""
    steps = ts.shape[0]
    fused = form.path is Path.FUSED
    fused_steps = steps - 1 if fused else 0
    plan, drop, gadget = form.plan, form.drop, form.gadget
    with profiling.span("blind_rotate.steps", device=acc.device, steps=steps,
                        fused_steps=fused_steps,
                        plain_digit_steps=steps - fused_steps):
        if not fused:
            finish = (_ntt.finish_int64 if acc.dtype == torch.int64
                      else ntt_inverse_to_crt_acc)
            for s in range(steps):
                acc = finish(plain_step(acc, bsk[s], ts[s], form), acc, plan,
                             drop)
            return acc
        digits = gadget.planes(acc)
        for s in range(steps):
            v = core(digits, bsk[s], ts[s], plan, form.bits)
            acc = ntt_inverse_to_crt_acc(
                v, acc, plan, drop, gadget=gadget,
                digits=digits if s < steps - 1 else None)
    return acc


def rotate_via_ntt(polys: torch.Tensor, t: torch.Tensor,
                   plan: _ntt.NTTPlan, width: int = 32) -> torch.Tensor:
    """Exact negacyclic X^t rotation of full-torus polys (carriers at
    ``width``) through the NTT.  polys: [B or 1, ..., N] (batch axis
    leading); t: int32 [B]."""
    p_hat = _ntt.ntt_forward(polys, plan, digit_limbs=width // 8,
                             digit_bound=128)
    r_hat = _ntt.rotate_diag(p_hat, t, plan, minus_one=False)
    return _ntt.ntt_inverse_to_crt(r_hat, plan, width)


def _plain_step(acc: torch.Tensor, bsk_step: torch.Tensor, t: torch.Tensor,
                form: KeyForm) -> torch.Tensor:
    """One direct-ring step on the plain ops: the residues int32 [P, B, 2,
    N] of the JAX package's XLA step."""
    plan = form.plan
    d_hat = _ntt.ntt_forward(form.gadget.rows(acc), plan, form.digit_limbs,
                             form.digit_bound)
    if form.path is Path.GROUP1:
        u_hat = _ntt.pointwise_extprod(d_hat, bsk_step, plan,
                                       reduce_output=False)
        return torch.stack(_ntt.rotate_diag(u_hat, t, plan))
    fold = form.digit_limbs == 1
    us = [_ntt.pointwise_extprod(d_hat, bsk_step[m], plan,
                                 reduce_output=not fold)
          for m in range(bsk_step.shape[0])]
    return torch.stack(_ntt.rotate_combine_multi(us, list(t), plan,
                                                 u_wide=fold))


def blind_rotate_ntt(tlwe_batch: torch.Tensor, testvec: torch.Tensor,
                     bsk_ntt: torch.Tensor, params: SecurityParams,
                     drop_bits: int, group: int = 1, levels=None,
                     bgbit: int | None = None) -> torch.Tensor:
    """The direct ring (N <= 1024): tlwe_batch carrier [B, n0+1]; testvec
    carrier [2, N] or [B, 2, N]; bsk_ntt int16 [n0, P, la+lb, 2, N]
    (group 1) or [G, 2^g-1, P, la+lb, 2, N] (multi-bit, G = ceil(n0/g)).
    Returns carrier [B, 2, N].  (bgbit, levels) is the key's engine gadget
    (None: the parameter base / levels read off the key's row axis)."""
    form = key_form(params, bsk_ntt, drop_bits, group, levels, bgbit)
    N, B = params.N, tlwe_batch.shape[0]
    b_tilda = 2 * N - modswitch(tlwe_batch[:, params.n0], params)
    if testvec.dim() == 2:
        testvec = testvec[None]          # [1, 2, N] broadcasts against [B]
    with profiling.span("blind_rotate.testvec", device=tlwe_batch.device):
        acc = rotate_via_ntt(testvec, b_tilda, form.plan, params.torus_bits)
        if acc.shape[0] != B:
            acc = acc.expand(B, 2, N).contiguous()
    ts = rotations(tlwe_batch, params, group, bsk_ntt.shape[0])
    return scan(acc, bsk_ntt, ts, form, _k2.ntt_step_fused, _plain_step)
