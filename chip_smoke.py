#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zig_tfhe_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It drives the port's three gate paths at SECURITY_128_BIT (N = 1024,
n0 = 700) through the entry points a user calls: SecretKey/CloudKey.generate
on the card from a seeded torch.Generator, tlwe.encrypt_bool,
gates.apply_gates on B = 2048 lanes cycling through all 10 gates,
tlwe.decrypt_bool.  The paths are the three cloud-key configurations whose
blind rotation runs on the hand-written kernels:

  g3    the key defaults: multi-bit group 3, engine gadget Bg_e 2^7 (2, 2),
        BSK drop 5, 3 CRT primes -- 234 blind-rotation steps;
  g2    CloudKey.generate(..., group=2, decomp_levels=(3, 2)): the
        approximate gadget on the reference's Bg, Bg_e 2^6 (3, 2), drop 7
        -- 350 steps;
  toep  CloudKey.generate(..., engines=("toeplitz",)): the reference's own
        per-bit key and exact gadget (Bg 2^6, L = 3) in ext-limb form,
        which the gate path runs on the Toeplitz engine -- 700 steps.

Every step of g3 and g2 is two kernel launches: K2, the fused step core
(csrc/ntt_step.cu: forward NTT, pointwise products, subset combine), then
K1 (csrc/ntt_inverse.cu: inverse NTT, CRT lift, accumulator add).  Every
step of toep is one launch of K3 (csrc/extprod.cu: the digits against the
negacyclic circulants of the key step's rows, 4 key limbs).  Phases:

  1. the card's name and power limit (nvidia-smi);
  2. build the three kernels from zig_tfhe_tpu_torch/csrc (all three on
     csrc/hopper_prims.cuh: TMA, mbarrier, wgmma) with nvcc for sm_90a, one
     nvcc per source, started together; ptxas' registers and spills (and
     any wgmma serialization it reports);
  3. key generation on the card, all three configurations;
  4. each kernel against its plain PyTorch version at each path's shapes,
     at B = 2048, 200 (a ragged last tile) and 1: K1 on the int8 limb
     planes of residues of bounded polynomials (bit-equal to the plain
     version and to the exact acc + (c << drop)); K2 on the digits of an
     accumulator and a step of the real key (bit-equal); K3 on the digits
     of an accumulator difference and a step of the real key (bit-equal),
     also at B = 65 and 64 (one batch tile and a ragged second one);
  5. per path, B = 2048 heterogeneous gates with every launch count set to
     0 just before and read just after: accuracy must be 1.0, each kernel
     of the path must have been launched once per step and the others not
     at all, and the first 16 lanes must be bit-equal to the port's CPU
     path (the plain PyTorch versions, which the repository's tests hold
     bit-equal to the JAX package);
  6. timings with CUDA events, per path: gates/s at B = 2048, B = 1
     latency, each kernel and its plain version per call beside its bound
     (bytes, tensor-core operations or CUDA-core operations, whichever is
     largest) and the L2 -> SM bytes of its tiling, each kernel also per
     call at B = 1 from a CUDA graph (K3 also against torch._int_mm on
     circulants built beforehand, the build not timed), and one step split
     into its stages;
  7. per path, a torch.profiler trace of one warm batch at B = 2048 and at
     B = 1: device busy time, idle share and the costliest kernels.

The next-to-last stdout line is {"kernels": [...]}, before it the card's
nvidia-smi name and power limit; the last line is {"ok": true, "device":
{...}}.  Any failed phase raises (exit code != 0, no result line).
Without a CUDA device it exits 2 before printing anything.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

B_GATES = 2048
RAGGED_LANES = 200     # a batch that ends inside a kernel tile
SMALL_LANES = 16
WARM_ITERS = 3
KERNEL_ITERS = 20

# published H100 SXM peaks (NVIDIA data sheet): bytes/s, int8 op/s
HBM_BPS = 3.35e12
INT8_OPS = 1.979e15
# CUDA-core rates at compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic-instruction throughput table), results per clock per SM: f32
# add / multiply 128, int32 add and multiply-add 64, conversions between
# int32 and f32 64; the four schedulers of an SM issue 128 thread
# instructions per clock between them, and the pipes run side by side.
# 132 SMs at the 1.98 GHz boost clock that the 67 TFLOP/s f32 peak assumes
# (132 x 128 x 2 x 1.98e9).
SMS, SM_HZ = 132, 1.98e9
RATE_ISSUE, RATE_F32, RATE_INT, RATE_CVT = 128, 128, 64, 64


def _cuda_core_clocks(barretts: float, cvt: float = 0, f32: float = 0,
                      imad: float = 0) -> float:
    """Least SM clocks per thread-result for a CUDA-core stage: the larger
    of all its instructions over the issue rate and the busiest pipe's
    instructions over that pipe's rate.  A Barrett is counted as the least
    the function needs, not as a kernel issues it: int -> f32 conversion,
    f32 multiply, f32 -> int conversion (which rounds), int32
    multiply-subtract."""
    n_cvt, n_f32, n_int = 2 * barretts + cvt, barretts + f32, barretts + imad
    return max((n_cvt + n_f32 + n_int) / RATE_ISSUE, n_cvt / RATE_CVT,
               n_f32 / RATE_F32, n_int / RATE_INT)


# NTT path -> CloudKey.generate knobs and the expected (group, Bg_e,
# levels, drop); the Toeplitz path "toep" is the key of engines=("toeplitz",)
PATHS = {
    "g3": ({}, (3, 7, (2, 2), 5)),
    "g2": ({"group": 2, "decomp_levels": (3, 2)}, (2, 6, (3, 2), 7)),
}
TOEP = "toep"


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def _gpu_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call: ``iters`` calls captured into one
    CUDA graph and replayed, so that no host time lies between them."""
    import torch

    fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    return _cuda_ms(graph.replay, 3) / iters


def _kernel_vs_plain(kernel, plain, iters: int = KERNEL_ITERS):
    """(kernel ms, plain ms) per call, timed in turns: plain, kernel,
    kernel, plain (after one warm call of each)."""
    kernel()
    plain()
    times = {kernel: [], plain: []}
    for fn in (plain, kernel, kernel, plain):
        times[fn].append(_cuda_ms(fn, iters))
    return sum(times[kernel]) / 2, sum(times[plain]) / 2


def _trace_summary(fn, top: int = 6):
    """Profile one call of ``fn``: device busy ms, device span ms, idle
    share over the span, kernel count, and the costliest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        return None
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    by_name = {}
    for e in kernels:
        n = e["name"]
        t, c = by_name.get(n, (0.0, 0))
        by_name[n] = (t + float(e["dur"]), c + 1)
    tops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "idle_share": 1.0 - busy / span, "kernels": len(kernels),
            "top": [(n[:70], t / 1e3, c) for n, (t, c) in tops]}


def _bound(t_bytes: float, t_tensor: float, t_cuda: float):
    """(ms, bound_by, unit): the largest of the three times; ``bound_by`` is
    "bytes" or "operations", ``unit`` says whose operations."""
    t, by, unit = max((t_bytes, "bytes", "memory"),
                      (t_tensor, "operations", "tensor cores"),
                      (t_cuda, "operations", "cuda cores"))
    return t * 1e3, by, unit


def _k1_bound_ms(P: int, B: int, N: int):
    """K1's least time: the int8 limb planes, acc and the matrices read
    once, the output written once; 2B x N outputs x 2N depth x 2 matrices
    per prime, 2 ops per MAC, on the tensor cores; per output and prime 2
    Barretts, one more conversion, 2 f32 operations and 2 int32
    multiply-adds on the CUDA cores.  Returns the bound, then (for the
    printed line only) the L2 -> SM bytes a 128 x 64 tiling moves, the
    kernel's widest (every column tile reads the residues, every row tile
    the matrices), and the CUDA-core time in ms."""
    rows = 2 * B
    v_bytes, m_bytes = P * rows * 2 * N, 2 * P * N * 2 * N
    nbytes = v_bytes + 2 * (rows * N * 4) + m_bytes
    ops = 2 * rows * N * (2 * N) * 2 * P
    clocks = _cuda_core_clocks(2, cvt=1, f32=2, imad=2)
    t_cuda = rows * N * P * clocks / (SMS * SM_HZ)
    l2_bytes = (N // 64) * v_bytes + -(-rows // 128) * m_bytes + 2 * rows * N * 4
    return _bound(nbytes / HBM_BPS, ops / INT8_OPS, t_cuda) + (l2_bytes, t_cuda * 1e3)


def _k2_bound_ms(plan, group: int, R: int, B: int, n_rot_rows: int,
                 row_groups, single_add):
    """K2's least time: digits, the key step, the rotations, the forward
    matrices and the psi rows this run gathers read once, v (int8 limb
    planes) written once; int8 MACs (2 ops each) against the tensor-core
    rate; and the CUDA-core stage counted instruction by instruction
    (_cuda_core_clocks): every Barrett, the int32 multiply-adds of the
    pointwise sums (2 S R per (b, k, prime)) and the multiplies of the
    subset combine.  Returns the bound, then (for the printed line only) the
    L2 -> SM bytes a 64 x 128 tiling moves, the kernel's widest (every
    (prime, column tile) reads the digits, every row tile the matrices),
    and the CUDA-core time in ms."""
    P, N, S = plan.n_primes, plan.N, (1 << group) - 1
    d_bytes, m_bytes = B * R * N, 2 * P * N * N
    v_bytes = P * B * 2 * 2 * N
    nbytes = (d_bytes + S * P * R * 2 * N * 2 + group * B * 4 + m_bytes
              + n_rot_rows * P * N * 2 + v_bytes)
    int8_ops = 2 * B * R * N * N * 2 * P
    clocks = 0.0
    for rg, single in zip(row_groups, single_add):
        ng = -(-R // rg)
        fwd = R * (1 if single else 3)
        if group == 2:
            pw, comb, mults = S * 2 * (ng + 1), 1 + 2 * 3, 1 + 2 * 3
        else:
            pw = S * 2 * (ng + max(0, ng - 2))
            comb, mults = (S - group) + 2 * (S + 1), (S - group) + 2 * S
        clocks += _cuda_core_clocks(fwd + pw + comb, imad=S * 2 * R + mults)
    t_cuda = clocks * B * N / (SMS * SM_HZ)
    tb = 64 // R
    l2_bytes = (P * (N // 128) * d_bytes + -(-B // tb) * m_bytes + v_bytes)
    return _bound(nbytes / HBM_BPS, int8_ops / INT8_OPS, t_cuda) + (l2_bytes, t_cuda * 1e3)


def _k3_bound_ms(B: int, N: int, L: int, n_kl: int):
    """K3's least time: the digits, the key step and the output moved once;
    B x 2N outputs x 2L*N depth per key limb, 2 ops per MAC.  Returns the
    bound, then (for the printed line only) the L2 -> SM bytes of the
    kernel's tiling: the digits once per 128-column block, every consumer
    warpgroup's key windows (N + 64 bytes a key row and limb), the output."""
    d_bytes, out_bytes = B * 2 * L * N, B * 2 * N * 4
    nbytes = d_bytes + n_kl * 2 * L * 2 * 2 * N + out_bytes
    ops = 2 * B * (2 * L * N) * (2 * N) * n_kl
    t_b, t_o = nbytes / HBM_BPS, ops / INT8_OPS
    col_blocks, lane_tiles = 2 * N // 128, -(-B // 64)
    l2_bytes = (col_blocks * d_bytes + out_bytes
                + col_blocks * lane_tiles * 2 * n_kl * 2 * L * (N + 64))
    return _bound(t_b, t_o, 0.0) + (l2_bytes,)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    from zig_tfhe_tpu_torch import key, params, tlwe
    from zig_tfhe_tpu_torch.models import gates
    from zig_tfhe_tpu_torch.ops import ntt
    from zig_tfhe_tpu_torch.ops.blind_rotate import (_decompose_to_rows,
                                                     _digit_limbs, modswitch)
    from zig_tfhe_tpu_torch.ops.cuda import _build
    from zig_tfhe_tpu_torch.ops.cuda import extprod as k3
    from zig_tfhe_tpu_torch.ops.cuda import ntt_inverse as k1
    from zig_tfhe_tpu_torch.ops.cuda import ntt_step as k2
    from zig_tfhe_tpu_torch.ops.poly import matmul_i8, negacyclic_rotate
    from zig_tfhe_tpu_torch.trgsw import trgsw_matrices

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(dev)
    gpu = _gpu_line()
    print(f"device: {kind} ({torch.cuda.device_count()} visible); "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; [{gpu}]")

    # -- 2. build the three kernels, in parallel -----------------------------
    t0 = time.perf_counter()
    logs = _build.build(k1.SOURCE, k2.SOURCE, k3.SOURCE)
    print(f"built {', '.join(s.name for s in logs)} -> "
          f"{', '.join(_build.library_path(s).name for s in logs)} for sm_90a "
          f"in {time.perf_counter() - t0:.1f} s")
    for src, log in logs.items():
        kernel = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"([a-z][a-z_]*_kernel)(?:I((?:Li\d+E)+)E)?", line)
                kernel = "?"
                if m:
                    args = re.findall(r"Li(\d+)E", m[2] or "")
                    kernel = m[1] + (f"<{', '.join(args)}>" if args else "")
            elif "Used" in line or "spill" in line or "Loss" in line:
                print(f"  ptxas {src.name} {kernel}: "
                      f"{line.split(':', 1)[-1].strip()}")

    # -- 3. key generation on the card ---------------------------------------
    P = params.SECURITY_128_BIT
    g = torch.Generator(device=dev).manual_seed(1234)
    sk = key.SecretKey.generate(g, P)
    cks, plans = {}, {}
    for name, (knobs, want_cfg) in PATHS.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck = key.CloudKey.generate(g, sk, P, **knobs)
        torch.cuda.synchronize()
        cfg = (ck.bsk_group, ck.bsk_bgbit, ck.bsk_levels, ck.bsk_ntt_drop)
        _check(cfg == want_cfg, f"{name} key resolved to {cfg}, not {want_cfg}")
        plan = ntt.plan_for_params(P, ck.bsk_ntt_drop, ck.bsk_group,
                                   ck.bsk_levels, bgbit=ck.bsk_bgbit,
                                   pseudorandom_key=True)
        _check(plan.n_primes == 3 and plan.N == P.N, f"{name} plan")
        cks[name], plans[name] = ck, plan
        print(f"keygen {P.name} {name} (group {cfg[0]}, Bg_e 2^{cfg[1]} "
              f"{cfg[2]}, drop {cfg[3]}): {time.perf_counter() - t0:.2f} s, "
              f"bsk_ntt {tuple(ck.bsk_ntt.shape)} int16")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck_toep = key.CloudKey.generate(g, sk, P, engines=("toeplitz",))
    torch.cuda.synchronize()
    ext_shape = (P.n0, 4, 2 * P.L, 2, 2 * P.N)
    _check(ck_toep.bsk_ntt is None
           and tuple(ck_toep.bsk_ext_limbs.shape) == ext_shape
           and ck_toep.bsk_ext_limbs.dtype == torch.int8,
           f"toep key holds bsk_ntt or bsk_ext_limbs "
           f"{tuple(ck_toep.bsk_ext_limbs.shape)}, not {ext_shape} int8")
    print(f"keygen {P.name} {TOEP} (engines=('toeplitz',), Bg 2^{P.bgbit}, "
          f"L = {P.L}): {time.perf_counter() - t0:.2f} s, bsk_ext_limbs "
          f"{tuple(ck_toep.bsk_ext_limbs.shape)} int8 "
          f"({ck_toep.bsk_ext_limbs.numel() / 1e6:.1f} MB)")

    def uniform(shape):
        return torch.randint(0, 1 << 32, shape, dtype=torch.int64,
                             generator=g, device=dev).to(torch.int32)

    # -- 4. kernels vs plain versions at the paths' shapes -------------------
    k_results = {"k1": {}, "k2": {}, "k3": {}}
    step_inputs = {}
    for name, ck in cks.items():
        plan, drop = plans[name], ck.bsk_ntt_drop
        group, e, levels = ck.bsk_group, ck.bsk_bgbit, ck.bsk_levels
        c = uniform((B_GATES, 2, P.N))
        acc = uniform((B_GATES, 2, P.N))
        v = k1.split_limbs(torch.stack(
            ntt.ntt_forward(c, plan, digit_limbs=4, digit_bound=128)))
        digits = _decompose_to_rows(acc, P, levels, bgbit=e).to(torch.int8)
        ts = modswitch(uniform((group, B_GATES)), P)
        bsk_step = ck.bsk_ntt[0]
        errs1, errs2 = [], []
        for lanes in (B_GATES, RAGGED_LANES, 1):
            out = k1.ntt_inverse_to_crt_acc(v[:, :lanes], acc[:lanes], plan, drop)
            ref = k1.ntt_inverse_to_crt_acc_reference(v[:, :lanes], acc[:lanes],
                                                      plan, drop)
            torch.cuda.synchronize()
            errs1.append(int((out.long() - ref.long()).abs().max()))
            _check(errs1[-1] == 0, f"K1 differs from its plain version on "
                   f"{name} at B={lanes} (max |diff| {errs1[-1]})")
            _check(torch.equal(out, acc[:lanes] + (c[:lanes] << drop)),
                   f"K1 output is not the exact acc + (c << drop) on {name} "
                   f"at B={lanes}")
            step = (digits[:lanes], bsk_step, ts[:, :lanes].contiguous(), plan, e)
            v2 = k2.ntt_step_fused(*step)
            ref2 = k2.ntt_step_fused_reference(*step)
            torch.cuda.synchronize()
            errs2.append(int((v2.long() - ref2.long()).abs().max()))
            _check(torch.equal(v2, ref2), f"K2 differs from its plain version "
                   f"on {name} at B={lanes} (max |diff| {errs2[-1]})")
            if lanes == B_GATES:
                step_inputs[name] = (digits, bsk_step, ts, acc, v2)
        print(f"{name}: K1 == plain == exact at [P=3, B, 2, 2, N=1024] int8 limb "
              f"planes, drop {drop}, and K2 == plain at digits [B, "
              f"{digits.shape[1]}, 1024], key step {tuple(bsk_step.shape)}, for "
              f"B = {B_GATES}, {RAGGED_LANES}, 1")

        def run_k1(n=B_GATES, v=v, acc=acc, plan=plan, drop=drop):
            k1.ntt_inverse_to_crt_acc(v[:, :n], acc[:n], plan, drop)

        def plain_k1(v=v, acc=acc, plan=plan, drop=drop):
            k1.ntt_inverse_to_crt_acc_reference(v, acc, plan, drop)

        ts1 = ts[:, :1].contiguous()

        def run_k2(n=B_GATES, a=(digits, bsk_step, ts, plan, e), ts1=ts1):
            if n == 1:
                k2.ntt_step_fused(a[0][:1], a[1], ts1, a[3], a[4])
            else:
                k2.ntt_step_fused(*a)

        def plain_k2(a=(digits, bsk_step, ts, plan, e)):
            k2.ntt_step_fused_reference(*a)

        ms1, plain1 = _kernel_vs_plain(run_k1, plain_k1)
        ms2, plain2 = _kernel_vs_plain(run_k2, plain_k2)
        # B = 1: the host's enqueue rate (CUDA events around eager calls) and
        # the kernel alone (the same calls replayed from a CUDA graph)
        one1, one2 = (_cuda_ms(lambda f=f: f(1), KERNEL_ITERS)
                      for f in (run_k1, run_k2))
        dev1, dev2 = (_graph_ms(lambda f=f: f(1), KERNEL_ITERS)
                      for f in (run_k1, run_k2))
        n_rows = int(torch.unique(ts & (2 * P.N - 1)).numel())
        bound1, by1, unit1, l2_1, cc1 = _k1_bound_ms(plan.n_primes, B_GATES, P.N)
        bound2, by2, unit2, l2_2, cc2 = _k2_bound_ms(
            plan, group, digits.shape[1], B_GATES, n_rows,
            k2.row_groups(plan, group), k2._host_scalars(plan, group, e)[3])
        k_results["k1"][name] = dict(
            max_abs_err=max(errs1), ms=ms1, plain_ms=plain1, bound_ms=bound1,
            bound_by=by1, bound_unit=unit1,
            b1_eager_ms=one1, b1_device_ms=dev1)
        k_results["k2"][name] = dict(
            max_abs_err=max(errs2), ms=ms2, plain_ms=plain2, bound_ms=bound2,
            bound_by=by2, bound_unit=unit2,
            b1_eager_ms=one2, b1_device_ms=dev2)
        print(f"{name} B={B_GATES}: K1 {ms1 * 1e3:.1f} us/call (plain "
              f"{plain1 * 1e3:.1f} us, bound {bound1 * 1e3:.1f} us by {unit1}, "
              f"cuda cores {cc1 * 1e3:.1f} us, L2->SM of the widest tiling "
              f"{l2_1 / 1e6:.0f} MB/call); K2 {ms2 * 1e3:.1f} us/call "
              f"(plain {plain2 * 1e3:.1f} us, bound {bound2 * 1e3:.1f} us by "
              f"{unit2}, cuda cores {cc2 * 1e3:.1f} us, L2->SM of the widest "
              f"tiling {l2_2 / 1e6:.0f} MB/call) [{gpu}]")
        print(f"{name} B=1: K1 {dev1 * 1e3:.1f} us/call on the device (CUDA "
              f"graph replay; {one1 * 1e3:.1f} us eager, host-bound); K2 "
              f"{dev2 * 1e3:.1f} us/call ({one2 * 1e3:.1f} us eager) [{gpu}]")

    # K3 on the digits of an accumulator difference (acc rotated by X^t,
    # minus acc) and the first step of the real Toeplitz key
    acc3 = uniform((B_GATES, 2, P.N))
    t3 = modswitch(uniform((B_GATES,)), P)
    d3 = _digit_limbs(negacyclic_rotate(acc3, t3) - acc3, P)[..., 0].contiguous()
    bsk3 = ck_toep.bsk_ext_limbs[0]
    errs3 = []
    k3_lanes = (B_GATES, RAGGED_LANES, 65, 64, 1)
    for lanes in k3_lanes:
        out3 = k3.extprod_matmul(d3[:lanes], bsk3, P)
        ref3 = k3.extprod_matmul_reference(d3[:lanes], bsk3, P)
        torch.cuda.synchronize()
        errs3.append(int((out3.long() - ref3.long()).abs().max()))
        _check(torch.equal(out3, ref3), f"K3 differs from its plain version "
               f"at B={lanes} (max |diff| {errs3[-1]})")
    mats3 = trgsw_matrices(bsk3, P)

    def run_k3(n=B_GATES):
        k3.extprod_matmul(d3[:n], bsk3, P)

    def plain_k3():
        k3.extprod_matmul_reference(d3, bsk3, P)

    def int_mm_k3():
        for kl in range(mats3.shape[0]):
            matmul_i8(d3, mats3[kl])

    ms3, plain3 = _kernel_vs_plain(run_k3, plain_k3)
    int_mm3 = _cuda_ms(int_mm_k3, KERNEL_ITERS)
    one3 = _cuda_ms(lambda: run_k3(1), KERNEL_ITERS)
    dev3 = _graph_ms(lambda: run_k3(1), KERNEL_ITERS)
    bound3, by3, unit3, l2_3 = _k3_bound_ms(B_GATES, P.N, P.L, bsk3.shape[0])
    k_results["k3"] = {TOEP: dict(max_abs_err=max(errs3), ms=ms3,
                                  plain_ms=plain3, bound_ms=bound3,
                                  bound_by=by3, bound_unit=unit3,
                                  int_mm_prebuilt_ms=int_mm3,
                                  b1_eager_ms=one3, b1_device_ms=dev3)}
    print(f"{TOEP}: K3 == plain at digits [B, {d3.shape[1]}] for B = "
          f"{', '.join(map(str, k3_lanes))}, key step {tuple(bsk3.shape)}; "
          f"B={B_GATES}: K3 {ms3 * 1e3:.1f} us/call (plain {plain3 * 1e3:.1f} "
          f"us, _int_mm on prebuilt circulants {int_mm3 * 1e3:.1f} us, bound "
          f"{bound3 * 1e3:.1f} us by {unit3}, L2->SM of its tiling "
          f"{l2_3 / 1e6:.0f} MB/call) [{gpu}]")
    print(f"{TOEP} B=1: K3 {dev3 * 1e3:.1f} us/call on the device (CUDA graph "
          f"replay; {one3 * 1e3:.1f} us eager) [{gpu}]")

    # -- 5. the main paths: B=2048 heterogeneous gates ------------------------
    x = torch.randint(0, 2, (B_GATES,), generator=g, device=dev).bool()
    y = torch.randint(0, 2, (B_GATES,), generator=g, device=dev).bool()
    ids = torch.arange(B_GATES, device=dev) % len(gates.GATE_NAMES)
    a = tlwe.encrypt_bool(g, x, P.ksk_alpha, sk.key_lv0)
    b = tlwe.encrypt_bool(g, y, P.ksk_alpha, sk.key_lv0)
    truth = {
        "nand": lambda p, q: not (p and q), "or": lambda p, q: p or q,
        "and": lambda p, q: p and q, "xor": lambda p, q: p != q,
        "xnor": lambda p, q: p == q, "nor": lambda p, q: not (p or q),
        "andny": lambda p, q: (not p) and q, "andyn": lambda p, q: p and not q,
        "orny": lambda p, q: (not p) or q, "oryn": lambda p, q: p or not q}
    want = np.array([truth[gates.GATE_NAMES[i]](bool(p), bool(q)) for i, p, q
                     in zip(ids.tolist(), x.tolist(), y.tolist())])
    cks[TOEP] = ck_toep
    counters = {"k1": k1.ntt_inverse_to_crt_acc, "k2": k2.ntt_step_fused,
                "k3": k3.extprod_matmul}
    launches = {}
    for name, ck in cks.items():
        if name == TOEP:
            expect = {"k1": 0, "k2": 0, "k3": P.n0}
        else:
            steps = -(-P.n0 // ck.bsk_group)
            expect = {"k1": steps, "k2": steps, "k3": 0}
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = gates.apply_gates(ids, a, b, ck)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches[name] = {k: fn.launches for k, fn in counters.items()}
        _check(launches[name] == expect,
               f"{name}: launches {launches[name]} in one bootstrap, "
               f"expected {expect}")
        _check(res.dtype == torch.int32
               and tuple(res.shape) == (B_GATES, P.n0 + 1),
               f"{name} gate output {res.dtype} {tuple(res.shape)}")
        got = tlwe.decrypt_bool(res, sk.key_lv0).cpu().numpy()
        accuracy = float((got == want).mean())
        _check(accuracy == 1.0, f"{name} gate accuracy {accuracy} != 1.0")
        print(f"apply_gates B={B_GATES} {name}: accuracy {accuracy}, "
              f"launches {launches[name]}, first call {first_s:.2f} s")

        ck_cpu = key.CloudKey.from_numpy(
            {n: t.cpu().numpy() for n, t in ck.named_buffers()}, P,
            bsk_ntt_drop=ck.bsk_ntt_drop, bsk_group=ck.bsk_group,
            bsk_levels=ck.bsk_levels, bsk_bgbit=ck.bsk_bgbit, device="cpu")
        t0 = time.perf_counter()
        res_cpu = gates.apply_gates(ids[:SMALL_LANES].cpu(),
                                    a[:SMALL_LANES].cpu(),
                                    b[:SMALL_LANES].cpu(), ck_cpu)
        _check(torch.equal(res_cpu, res[:SMALL_LANES].cpu()),
               f"{name}: CUDA gate outputs differ from the port's CPU path")
        print(f"{name}: first {SMALL_LANES} lanes bit-equal to the CPU path "
              f"({time.perf_counter() - t0:.1f} s on the host)")

    # -- 6. timings -----------------------------------------------------------
    for name, ck in cks.items():
        def run_gates(ck=ck):
            gates.apply_gates(ids, a, b, ck)

        gate_ms = _cuda_ms(run_gates, WARM_ITERS)
        one = (ids[:1], a[:1], b[:1])
        gates.apply_gates(*one, ck)
        lat_ms = _cuda_ms(lambda ck=ck: gates.apply_gates(*one, ck), WARM_ITERS)
        print(f"{name}: gates/s at B={B_GATES}: {B_GATES / (gate_ms / 1e3):.1f} "
              f"({gate_ms:.1f} ms/batch); latency at B=1: {lat_ms:.1f} ms "
              f"[{gpu}]")

        if name == TOEP:
            t3_a = modswitch(uniform((B_GATES,)), P)
            diff3 = {}

            def rotate_decompose():
                diff3["d"] = _digit_limbs(
                    negacyclic_rotate(acc3, t3_a) - acc3, P)[..., 0]

            rotate_decompose()
            part3 = k3.extprod_matmul(diff3["d"], bsk3, P)
            stage = {
                "rotate+decompose": rotate_decompose,
                "K3": lambda: k3.extprod_matmul(diff3["d"], bsk3, P),
                "add": lambda: acc3 + part3.reshape(B_GATES, 2, P.N)}
        else:
            plan, drop = plans[name], ck.bsk_ntt_drop
            e, levels = ck.bsk_bgbit, ck.bsk_levels
            digits, bsk_step, ts, acc, v = step_inputs[name]
            stage = {
                "decompose": lambda acc=acc, levels=levels, e=e:
                    _decompose_to_rows(acc, P, levels, bgbit=e).to(torch.int8),
                "K2": lambda args=(digits, bsk_step, ts, plan, e):
                    k2.ntt_step_fused(*args),
                "K1": lambda args=(v, acc, plan, drop):
                    k1.ntt_inverse_to_crt_acc(*args)}
        split = {s: _cuda_ms(fn, KERNEL_ITERS) for s, fn in stage.items()}
        print(f"{name}: one step at B={B_GATES}: " + ", ".join(
            f"{s} {t * 1e3:.1f} us" for s, t in split.items())
            + f" (sum {sum(split.values()) * 1e3:.1f} us) [{gpu}]")

    # -- 7. device busy time and idle share ------------------------------------
    for name, ck in cks.items():
        for lanes in (B_GATES, 1):
            summ = _trace_summary(
                lambda ck=ck, n=lanes: gates.apply_gates(ids[:n], a[:n], b[:n], ck))
            if summ is None:
                print(f"{name} B={lanes}: profiler recorded no kernels "
                      "(idle share not measured)")
                continue
            print(f"{name} B={lanes} profile: busy {summ['busy_ms']:.1f} ms of "
                  f"{summ['span_ms']:.1f} ms device span, idle share "
                  f"{summ['idle_share']:.3f}, {summ['kernels']} kernels [{gpu}]")
            for n, t, c in summ["top"]:
                print(f"    {t:9.2f} ms {c:7d}x  {n}")

    print(gpu)
    kernels = []
    for kk, kname, route_src, replaces, main_path in (
            ("k1", "ntt_inverse_crt_acc", "zig_tfhe_tpu_torch/csrc/ntt_inverse.cu",
             "zig_tfhe_tpu/ops/pallas/ntt_inverse.py:100", "g3"),
            ("k2", "ntt_step_fused", "zig_tfhe_tpu_torch/csrc/ntt_step.cu",
             "zig_tfhe_tpu/ops/pallas/ntt_step.py:229", "g3"),
            ("k3", "extprod_matmul", "zig_tfhe_tpu_torch/csrc/extprod.cu",
             "zig_tfhe_tpu/ops/pallas/extprod.py:57", TOEP)):
        main = k_results[kk][main_path]
        kernels.append({
            "name": kname, "route": "cuda", "source": route_src,
            "replaces": replaces,
            "launches": sum(n[kk] for n in launches.values()),
            "max_abs_err": max(r["max_abs_err"] for r in k_results[kk].values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "bound_unit": main["bound_unit"], "library_ms": None,
            "by_path": {p: {"launches": launches[p][kk], **k_results[kk][p]}
                        for p in k_results[kk]}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
