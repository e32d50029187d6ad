#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zig_tfhe_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It drives the port's two gate paths at SECURITY_128_BIT (N = 1024,
n0 = 700, 3 CRT primes) through the entry points a user calls:
SecretKey/CloudKey.generate on the card from a seeded torch.Generator,
tlwe.encrypt_bool, gates.apply_gates on B = 2048 lanes cycling through all
10 gates, tlwe.decrypt_bool.  The two paths are the two cloud-key
configurations whose blind rotation runs on the hand-written kernels:

  g3  the key defaults: multi-bit group 3, engine gadget Bg_e 2^7 (2, 2),
      BSK drop 5 -- 234 blind-rotation steps;
  g2  CloudKey.generate(..., group=2, decomp_levels=(3, 2)): the
      approximate gadget on the reference's Bg, Bg_e 2^6 (3, 2), drop 7 --
      350 steps.

Every step of either path is two kernel launches: K2, the fused step core
(csrc/ntt_step.cu: forward NTT, pointwise products, subset combine), then
K1 (csrc/ntt_inverse.cu: inverse NTT, CRT lift, accumulator add).  Phases:

  1. the card's name and power limit (nvidia-smi);
  2. build both kernels from zig_tfhe_tpu_torch/csrc with nvcc for sm_90a,
     one nvcc per source, started together;
  3. key generation on the card, both configurations;
  4. each kernel against its plain PyTorch version at each path's shapes
     (B = 2048): K1 on residues of bounded polynomials (bit-equal to the
     plain version and to the exact acc + (c << drop)); K2 on the digits
     of an accumulator and a step of the real key (bit-equal);
  5. per path, B = 2048 heterogeneous gates with every launch count set to
     0 just before and read just after: accuracy must be 1.0, each kernel
     must have been launched once per step, and the first 16 lanes must be
     bit-equal to the port's CPU path (the plain PyTorch versions, which
     the repository's tests hold bit-equal to the JAX package);
  6. timings with CUDA events, per path: gates/s at B = 2048, B = 1
     latency, each kernel and its plain version per call, and one step
     split into decompose / K2 / K1;
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

# path -> CloudKey.generate knobs and the expected (group, Bg_e, levels, drop)
PATHS = {
    "g3": ({}, (3, 7, (2, 2), 5)),
    "g2": ({"group": 2, "decomp_levels": (3, 2)}, (2, 6, (3, 2), 7)),
}


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    from zig_tfhe_tpu_torch import key, params, tlwe
    from zig_tfhe_tpu_torch.models import gates
    from zig_tfhe_tpu_torch.ops import ntt
    from zig_tfhe_tpu_torch.ops.blind_rotate import _decompose_to_rows, modswitch
    from zig_tfhe_tpu_torch.ops.cuda import _build
    from zig_tfhe_tpu_torch.ops.cuda import ntt_inverse as k1
    from zig_tfhe_tpu_torch.ops.cuda import ntt_step as k2

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(dev)
    gpu = _gpu_line()
    print(f"device: {kind} ({torch.cuda.device_count()} visible); "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; [{gpu}]")

    # -- 2. build both kernels, in parallel ----------------------------------
    t0 = time.perf_counter()
    logs = _build.build(k1.SOURCE, k2.SOURCE)
    print(f"built {k1.SOURCE.name}, {k2.SOURCE.name} -> "
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

    def uniform(shape):
        return torch.randint(0, 1 << 32, shape, dtype=torch.int64,
                             generator=g, device=dev).to(torch.int32)

    # -- 4. kernels vs plain versions at the paths' shapes -------------------
    k_results = {"k1": {}, "k2": {}}
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
    launches = {}
    for name, ck in cks.items():
        steps = -(-P.n0 // ck.bsk_group)
        torch.cuda.synchronize()
        k1.ntt_inverse_to_crt_acc.launches = 0
        k2.ntt_step_fused.launches = 0
        t0 = time.perf_counter()
        res = gates.apply_gates(ids, a, b, ck)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches[name] = {"k1": k1.ntt_inverse_to_crt_acc.launches,
                          "k2": k2.ntt_step_fused.launches}
        _check(launches[name] == {"k1": steps, "k2": steps},
               f"{name}: launches {launches[name]} in one bootstrap, "
               f"expected {steps} of each kernel")
        _check(res.dtype == torch.int32
               and tuple(res.shape) == (B_GATES, P.n0 + 1),
               f"{name} gate output {res.dtype} {tuple(res.shape)}")
        got = tlwe.decrypt_bool(res, sk.key_lv0).cpu().numpy()
        accuracy = float((got == want).mean())
        _check(accuracy == 1.0, f"{name} gate accuracy {accuracy} != 1.0")
        print(f"apply_gates B={B_GATES} {name}: accuracy {accuracy}, "
              f"{steps} steps, launches {launches[name]}, first call "
              f"{first_s:.2f} s")

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
        plan, drop = plans[name], ck.bsk_ntt_drop
        e, levels = ck.bsk_bgbit, ck.bsk_levels

        def run_gates(ck=ck):
            gates.apply_gates(ids, a, b, ck)

        gate_ms = _cuda_ms(run_gates, WARM_ITERS)
        one = (ids[:1], a[:1], b[:1])
        gates.apply_gates(*one, ck)
        lat_ms = _cuda_ms(lambda ck=ck: gates.apply_gates(*one, ck), WARM_ITERS)
        print(f"{name}: gates/s at B={B_GATES}: {B_GATES / (gate_ms / 1e3):.1f} "
              f"({gate_ms:.1f} ms/batch); latency at B=1: {lat_ms:.1f} ms "
              f"[{gpu}]")

        digits, bsk_step, ts, acc, v = step_inputs[name]
        stage = {
            "decompose": lambda acc=acc: _decompose_to_rows(
                acc, P, levels, bgbit=e).to(torch.int8),
            "K2": lambda: k2.ntt_step_fused(digits, bsk_step, ts, plan, e),
            "K1": lambda: k1.ntt_inverse_to_crt_acc(v, acc, plan, drop)}
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
    for kname, route_src, replaces in (
            ("ntt_inverse_crt_acc", "zig_tfhe_tpu_torch/csrc/ntt_inverse.cu",
             "zig_tfhe_tpu/ops/pallas/ntt_inverse.py:100"),
            ("ntt_step_fused", "zig_tfhe_tpu_torch/csrc/ntt_step.cu",
             "zig_tfhe_tpu/ops/pallas/ntt_step.py:229")):
        kk = "k1" if kname == "ntt_inverse_crt_acc" else "k2"
        main = k_results[kk]["g3"]
        kernels.append({
            "name": kname, "route": "cuda", "source": route_src,
            "replaces": replaces,
            "launches": sum(launches[p][kk] for p in PATHS),
            "max_abs_err": max(r["max_abs_err"] for r in k_results[kk].values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            "by_path": {p: {"launches": launches[p][kk], **k_results[kk][p]}
                        for p in PATHS}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
