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
  2. build the three kernels from zig_tfhe_tpu_torch/csrc with nvcc for
     sm_90a, one nvcc per source, started together;
  3. key generation on the card, all three configurations;
  4. each kernel against its plain PyTorch version at each path's shapes
     (B = 2048): K1 on residues of bounded polynomials (bit-equal to the
     plain version and to the exact acc + (c << drop)); K2 on the digits
     of an accumulator and a step of the real key (bit-equal); K3 on the
     digits of an accumulator difference and a step of the real key
     (bit-equal, also at B = 1 and B = 200);
  5. per path, B = 2048 heterogeneous gates with every launch count set to
     0 just before and read just after: accuracy must be 1.0, each kernel
     of the path must have been launched once per step and the others not
     at all, and the first 16 lanes must be bit-equal to the port's CPU
     path (the plain PyTorch versions, which the repository's tests hold
     bit-equal to the JAX package);
  6. timings with CUDA events, per path: gates/s at B = 2048, B = 1
     latency, each kernel and its plain version per call (K3 also against
     torch._int_mm on circulants built beforehand, the build not timed),
     and one step split into its stages;
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
SMALL_LANES = 16
WARM_ITERS = 3
KERNEL_ITERS = 20

# published H100 SXM peaks (NVIDIA data sheet): bytes/s, int8 op/s, f32 op/s
HBM_BPS = 3.35e12
INT8_OPS = 1.979e15
F32_OPS = 67e12

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


def _k1_bound_ms(P: int, B: int, N: int):
    """K1's least time: each input read once, the output written once;
    2B x N outputs x 2N depth x 2 matrices per prime, 2 ops per MAC."""
    nbytes = P * B * 2 * N * 4 + 2 * (B * 2 * N * 4) + 2 * P * N * 2 * N
    ops = 2 * (2 * B) * N * (2 * N) * 2 * P
    t_b, t_o = nbytes / HBM_BPS, ops / INT8_OPS
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def _k2_bound_ms(plan, group: int, R: int, B: int, n_rot_rows: int,
                 row_groups, single_add):
    """K2's least time: digits, the key step, the rotations, the forward
    matrices and the psi rows this run gathers read once, v written once;
    int8 MACs (2 ops each) against the tensor-core rate, one f32 multiply
    per Barrett against the f32 rate."""
    P, N, S = plan.n_primes, plan.N, (1 << group) - 1
    nbytes = (B * R * N + S * P * R * 2 * N * 2 + group * B * 4
              + 2 * P * N * N + n_rot_rows * P * N * 2 + P * B * 2 * N * 4)
    int8_ops = 2 * B * R * N * N * 2 * P
    barretts = 0
    for rg, single in zip(row_groups, single_add):
        ng = -(-R // rg)
        fwd = R * (1 if single else 3)
        if group == 2:
            pw, comb = S * 2 * (ng + 1), 1 + 2 * 3
        else:
            pw, comb = S * 2 * (ng + max(0, ng - 2)), (S - group) + 2 * (S + 1)
        barretts += fwd + pw + comb
    f32_ops = barretts * B * N
    t_b = nbytes / HBM_BPS
    t_o = max(int8_ops / INT8_OPS, f32_ops / F32_OPS)
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def _k3_bound_ms(B: int, N: int, L: int, n_kl: int):
    """K3's least time: the digits, the key step and the output moved once;
    B x 2N outputs x 2L*N depth per key limb, 2 ops per MAC."""
    nbytes = B * 2 * L * N + n_kl * 2 * L * 2 * 2 * N + B * 2 * N * 4
    ops = 2 * B * (2 * L * N) * (2 * N) * n_kl
    t_b, t_o = nbytes / HBM_BPS, ops / INT8_OPS
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


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
                m = re.search(r"([a-z][a-z_]*_kernel)(?:ILi(\d+)E)?", line)
                kernel = m[1] + (f"<{m[2]}>" if m[2] else "") if m else "?"
            elif "Used" in line or "spill" in line:
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
        v = torch.stack(ntt.ntt_forward(c, plan, digit_limbs=4, digit_bound=128))
        out = k1.ntt_inverse_to_crt_acc(v, acc, plan, drop)
        ref = k1.ntt_inverse_to_crt_acc_reference(v, acc, plan, drop)
        torch.cuda.synchronize()
        err1 = int((out.long() - ref.long()).abs().max())
        _check(err1 == 0, f"K1 differs from its plain version on {name} "
               f"(max |diff| {err1})")
        _check(torch.equal(out, acc + (c << drop)),
               f"K1 output is not the exact acc + (c << drop) on {name}")

        digits = _decompose_to_rows(acc, P, levels, bgbit=e).to(torch.int8)
        a = uniform((group, B_GATES))
        ts = modswitch(a, P)
        bsk_step = ck.bsk_ntt[0]
        v2 = k2.ntt_step_fused(digits, bsk_step, ts, plan, e)
        ref2 = k2.ntt_step_fused_reference(digits, bsk_step, ts, plan, e)
        torch.cuda.synchronize()
        err2 = int((v2.long() - ref2.long()).abs().max())
        _check(torch.equal(v2, ref2), f"K2 differs from its plain version on "
               f"{name} (max |diff| {err2})")
        step_inputs[name] = (digits, bsk_step, ts, acc, v2)
        print(f"{name}: K1 == plain == exact at [P=3, B={B_GATES}, 2, N=1024] "
              f"drop {drop}; K2 == plain at digits [{B_GATES}, "
              f"{digits.shape[1]}, 1024], key step {tuple(bsk_step.shape)}")

        def run_k1(v=v, acc=acc, plan=plan, drop=drop):
            k1.ntt_inverse_to_crt_acc(v, acc, plan, drop)

        def plain_k1(v=v, acc=acc, plan=plan, drop=drop):
            k1.ntt_inverse_to_crt_acc_reference(v, acc, plan, drop)

        def run_k2(a=(digits, bsk_step, ts, plan, e)):
            k2.ntt_step_fused(*a)

        def plain_k2(a=(digits, bsk_step, ts, plan, e)):
            k2.ntt_step_fused_reference(*a)

        ms1, plain1 = _kernel_vs_plain(run_k1, plain_k1)
        ms2, plain2 = _kernel_vs_plain(run_k2, plain_k2)
        n_rows = int(torch.unique(ts & (2 * P.N - 1)).numel())
        bound1, by1 = _k1_bound_ms(plan.n_primes, B_GATES, P.N)
        bound2, by2 = _k2_bound_ms(plan, group, digits.shape[1], B_GATES, n_rows,
                                   k2.row_groups(plan, group),
                                   k2._host_scalars(plan, group, e)[3])
        k_results["k1"][name] = dict(max_abs_err=err1, ms=ms1, plain_ms=plain1,
                                     bound_ms=bound1, bound_by=by1)
        k_results["k2"][name] = dict(max_abs_err=err2, ms=ms2, plain_ms=plain2,
                                     bound_ms=bound2, bound_by=by2)
        print(f"{name} B={B_GATES}: K1 {ms1 * 1e3:.1f} us/call (plain "
              f"{plain1 * 1e3:.1f} us, bound {bound1 * 1e3:.1f} us by {by1}); "
              f"K2 {ms2 * 1e3:.1f} us/call (plain {plain2 * 1e3:.1f} us, bound "
              f"{bound2 * 1e3:.1f} us by {by2}) [{gpu}]")

    # K3 on the digits of an accumulator difference (acc rotated by X^t,
    # minus acc) and the first step of the real Toeplitz key
    acc3 = uniform((B_GATES, 2, P.N))
    t3 = modswitch(uniform((B_GATES,)), P)
    d3 = _digit_limbs(negacyclic_rotate(acc3, t3) - acc3, P)[..., 0].contiguous()
    bsk3 = ck_toep.bsk_ext_limbs[0]
    errs3 = []
    for lanes in (B_GATES, 200, 1):
        out3 = k3.extprod_matmul(d3[:lanes], bsk3, P)
        ref3 = k3.extprod_matmul_reference(d3[:lanes], bsk3, P)
        torch.cuda.synchronize()
        errs3.append(int((out3.long() - ref3.long()).abs().max()))
        _check(torch.equal(out3, ref3), f"K3 differs from its plain version "
               f"at B={lanes} (max |diff| {errs3[-1]})")
    mats3 = trgsw_matrices(bsk3, P)

    def run_k3():
        k3.extprod_matmul(d3, bsk3, P)

    def plain_k3():
        k3.extprod_matmul_reference(d3, bsk3, P)

    def int_mm_k3():
        for kl in range(mats3.shape[0]):
            matmul_i8(d3, mats3[kl])

    ms3, plain3 = _kernel_vs_plain(run_k3, plain_k3)
    int_mm3 = _cuda_ms(int_mm_k3, KERNEL_ITERS)
    bound3, by3 = _k3_bound_ms(B_GATES, P.N, P.L, bsk3.shape[0])
    k_results["k3"] = {TOEP: dict(max_abs_err=max(errs3), ms=ms3,
                                  plain_ms=plain3, bound_ms=bound3,
                                  bound_by=by3, int_mm_prebuilt_ms=int_mm3)}
    print(f"{TOEP}: K3 == plain at digits [B, {d3.shape[1]}] for B = "
          f"{B_GATES}, 200, 1, key step {tuple(bsk3.shape)}; B={B_GATES}: K3 "
          f"{ms3 * 1e3:.1f} us/call (plain {plain3 * 1e3:.1f} us, _int_mm on "
          f"prebuilt circulants {int_mm3 * 1e3:.1f} us, bound "
          f"{bound3 * 1e3:.1f} us by {by3}) [{gpu}]")

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
            "library_ms": None,
            "by_path": {p: {"launches": launches[p][kk], **k_results[kk][p]}
                        for p in k_results[kk]}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
