#!/usr/bin/env python3
"""Build, check and time the hand-written kernels of the PyTorch/CUDA port
on one GPU.

    python3 tools/torch_kernel_probe.py [--kernels k1,k2,k3,k2s]
                                        [--paths g3,g2,uint4,t64]
                                        [--batches 2048,200,1] [--iters 20]
                                        [--split]

A quicker loop than chip_smoke.py for work on one kernel: it builds the
kernels asked for (csrc/ntt_inverse.cu K1, csrc/ntt_step.cu K2,
csrc/extprod.cu K3, csrc/split_step.cu K2s) with nvcc, prints ptxas'
report (registers, shared memory, spills, warnings), and at the shapes of
each path (the 128-bit g3: group 3, Bg_e 2^7, R = 4, drop 5, and g2:
group 2, Bg_e 2^6, R = 5, drop 7, both with 3 primes; uint4: group 2,
Bg_e 2^22, R = 2 rows of 3 digit limbs, drop 0, 5 primes; N = 1024; K3:
2L = 6 digit rows, 1-4 key limbs of an ext-limb key step,
``--key-limbs``; t64, K2s only: SECURITY_128_BIT_T64's split step, N/2 =
1024, 4 primes, 10 half-rows of the hi-plane digits (``rows_hi32``) of
a uniform accumulator, one step of a key made on the card with n0 cut to
2; K1 there on the split views [P, 2B, 2, 2, 1024] of uniform hi planes,
without and with the next step's half-rows) holds each kernel
bit-equal to its plain PyTorch version at every batch size given,
then times kernel and plain version with CUDA events (plain, kernel, kernel,
plain), the kernel alone replayed from a CUDA graph (device time without
the host's gaps, which is what small batches otherwise measure) and the
host's cost of enqueueing one call.  Inputs are seeded:
uniform accumulators, digits in the gadget's range (multi-limb digits: the
limb planes of a uniform accumulator's digits), key residues of uniform
polynomials.  Prints the card's nvidia-smi name and power limit beside the
times.  Needs a CUDA device.

``--split`` also times K2 (paths g3, g2, uint4) and K2s (path t64) built
with one stage switched off (the sources' ZTFHE_PROBE_* switches: no
product stage, no pointwise stage, each Barrett's conversions and
multiply replaced by a shift; K2 also without one part of its pointwise
stage: the sums against the key, the subset DP and apply, the psi-row
gather, the limb-plane stores), prints how many of the
conversion instructions (I2F, I2FP, F2I) and of the other opcodes a
Barrett is made of are in each kernel's SASS (``cuobjdump -sass``), and
measures, with tools/cvt_rate.cu, the card's throughput per SM clock of
int32 -> f32 and f32 -> int32 conversions, of int32 multiply-adds and of
a whole Barrett in three forms (both conversions; the rounding by an f32
add; no conversion).
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (the timers, the probe-build swap, cvt_rate)

# path -> (parameter set, group, engine bgbit, levels, drop)
PATHS = {"g3": ("128bit", 3, 7, (2, 2), 5), "g2": ("128bit", 2, 6, (3, 2), 7),
         "uint4": ("uint4", 2, 22, (1, 1), 0),
         "t64": ("128bit_t64", 2, 8, (3, 2), 32)}
K2S_PATHS = ("t64",)      # the split-ring paths: K2s, not K2
# the opcodes a Barrett is made of, counted in the SASS
SASS_OPS = ("I2F", "I2FP", "F2I", "FMUL", "FADD", "IMAD", "IADD3", "LOP3",
            "SHF", "LDS", "STS")
# K2 built without one part of its pointwise stage (csrc/ntt_step.cu's
# switches; each keeps the results of the rest live)
K2_PARTS = {"no sums": ("-DZTFHE_PROBE_NO_SUMS",),
            "no combine": ("-DZTFHE_PROBE_NO_COMBINE",),
            "no gather": ("-DZTFHE_PROBE_NO_GATHER",),
            "no stores": ("-DZTFHE_PROBE_NO_STORES",)}


def _digits(P, levels, e, B, g):
    """K2's digit operand: int8 [B, R * n_dl, N], digits in [-Bg/2, Bg/2)
    for one limb, else the limb planes of a uniform accumulator's digits."""
    import torch

    from zig_tfhe_tpu_torch.ops import ntt
    from zig_tfhe_tpu_torch.ops.decomposition import decompose_rows, digit_planes

    n_dl = ntt.engine_digit_limbs(e)
    if n_dl == 1:
        half = 1 << (e - 1)
        return torch.randint(-half, half, (B, sum(levels), P.N), generator=g,
                             device=g.device, dtype=torch.int32).to(torch.int8)
    acc = torch.randint(0, 1 << 32, (B, 2, P.N), dtype=torch.int64,
                        generator=g, device=g.device).to(torch.int32)
    return digit_planes(decompose_rows(acc, P, levels, bgbit=e), n_dl)


def _time_calls(label, name, kern, plain, iters, gpu) -> None:
    """Kernel and plain version in turns (plain, kernel, kernel, plain), the
    kernel replayed from a CUDA graph, and the host's cost of one enqueue."""
    import torch

    kern()
    plain()
    t = {kern: [], plain: []}
    for fn in (plain, kern, kern, plain):
        t[fn].append(cs._cuda_ms(fn, iters))
    # device time alone: the calls replayed from a CUDA graph
    dev_us = cs._graph_ms(kern, iters) * 1e3
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for _ in range(200):
        kern()
    host_us = (time.perf_counter() - h0) / 200 * 1e6
    torch.cuda.synchronize()
    print(f"{label}: {name} {sum(t[kern]) / 2 * 1e3:.1f} us/call "
          f"({dev_us:.1f} us replayed from a CUDA graph; plain "
          f"{sum(t[plain]) / 2 * 1e3:.1f} us; host "
          f"{host_us:.1f} us per enqueue) [{gpu}]")


def _k3(args, batches, gpu, label="K3") -> bool:
    """K3 at the 128-bit Toeplitz shapes: digits in [-Bg/2, Bg/2), the ext
    limbs of uniform key rows, for each key-limb count asked for."""
    import torch

    from zig_tfhe_tpu_torch import params, trgsw
    from zig_tfhe_tpu_torch.ops.cuda import extprod as k3

    dev = torch.device("cuda", 0)
    P = params.SECURITY_128_BIT
    g = torch.Generator(device=dev).manual_seed(args.seed)
    half = 1 << (P.bgbit - 1)
    ok = True
    for n_kl in (int(n) for n in args.key_limbs.split(",")):
        rows = torch.randint(0, 1 << 32, (2 * P.L, 2, P.N), dtype=torch.int64,
                             generator=g, device=dev).to(torch.int32)
        ext = trgsw.to_ext_limbs(rows, n_kl).contiguous()
        for B in batches:
            digits = torch.randint(-half, half, (B, 2 * P.L * P.N), generator=g,
                                   device=dev, dtype=torch.int32).to(torch.int8)
            out = k3.extprod_matmul(digits, ext, P)
            ref = k3.extprod_matmul_reference(digits, ext, P)
            torch.cuda.synchronize()
            same = torch.equal(out, ref)
            bad = int((out != ref).sum())
            print(f"toep B={B} n_kl={n_kl}: {label} == plain: {same}"
                  + ("" if same else f" ({bad} of {out.numel()} differ)"))
            ok &= same
            _time_calls(f"toep B={B} n_kl={n_kl}", label,
                        lambda a=(digits, ext, P): k3.extprod_matmul(*a),
                        lambda a=(digits, ext, P): k3.extprod_matmul_reference(*a),
                        args.iters, gpu)
    return ok


def _k2s_key(dev, seed):
    """One step of a real SECURITY_128_BIT_T64 split key, made on the card
    with n0 cut to 2 (the key step's shape does not depend on n0)."""
    import dataclasses

    import torch

    from zig_tfhe_tpu_torch import key, params
    from zig_tfhe_tpu_torch.ops import ntt

    P = params.SECURITY_128_BIT_T64
    P = dataclasses.replace(P, tlwe_lv0=dataclasses.replace(P.tlwe_lv0, n=2))
    g = torch.Generator(device=dev).manual_seed(seed)
    sk = key.SecretKey.generate(g, P)
    ck = key.CloudKey.generate(g, sk, P, packing_key=False)
    plan = ntt.plan_for_params(P, 32, 2, ck.bsk_levels, bgbit=8,
                               pseudorandom_key=True)
    return P, plan, ck.bsk_levels, ck.bsk_ntt[0].contiguous()


def _k2s_inputs(key, B, g):
    """K2s's operands at B lanes: the hi-plane digits of a uniform int32
    accumulator, the key step, rotations in [0, 4 N/2)."""
    import torch

    from zig_tfhe_tpu_torch.ops import decomposition

    P, plan, levels, bsk = key
    acc = torch.randint(0, 1 << 32, (B, 2, 2, plan.N), dtype=torch.int64,
                        generator=g, device=g.device).to(torch.int32)
    digits = decomposition.rows_hi32(acc, P, 8, levels).to(torch.int8)
    ts = torch.randint(0, 4 * plan.N, (2, B), generator=g, device=g.device,
                       dtype=torch.int32)
    return digits, bsk, ts, plan, 8


def _k1_split(args, batches, gpu) -> bool:
    """K1 at t64's split views, without and with the next step's hi-plane
    half-rows: bit-equal to its plain version at each batch, each timed,
    then the two instances from CUDA graphs in turns at the first batch."""
    import torch

    from zig_tfhe_tpu_torch import params
    from zig_tfhe_tpu_torch.ops import decomposition, ntt
    from zig_tfhe_tpu_torch.ops.cuda import ntt_inverse as k1

    dev = torch.device("cuda", 0)
    P = params.SECURITY_128_BIT_T64
    plan = ntt.plan_for_params(P, 32, 2, (3, 2), bgbit=8,
                               pseudorandom_key=True)
    gadget = decomposition.half_row_gadget(P, 8, (3, 2))
    g = torch.Generator(device=dev).manual_seed(args.seed)
    Nh, ok, turns = plan.N, True, None
    for B in batches:
        c, acc = (torch.randint(0, 1 << 32, (B, 2, 2, Nh), dtype=torch.int64,
                                generator=g, device=dev).to(torch.int32)
                  for _ in range(2))
        v = k1.split_limbs(torch.stack(
            ntt.ntt_forward(c, plan, digit_limbs=4, digit_bound=128)))
        vv, aa = v.reshape(4, 2 * B, 2, 2, Nh), acc.reshape(2 * B, 2, Nh)
        rows = torch.empty((B, 10, Nh), dtype=torch.int8, device=dev)
        out = k1.ntt_inverse_to_crt_acc(vv, aa, plan, 0, digits=rows,
                                        gadget=gadget)
        plain = k1.ntt_inverse_to_crt_acc(vv, aa, plan, 0)
        want = decomposition.rows_hi32(acc + c, P, 8, (3, 2)).to(torch.int8)
        torch.cuda.synchronize()
        same = (torch.equal(out, plain)
                and torch.equal(out.reshape(B, 2, 2, Nh), acc + c)
                and torch.equal(rows, want))
        print(f"t64 B={B}: K1 with half-rows == without == exact, half-rows "
              f"== rows_hi32: {same}")
        ok &= same
        fns = {"K1": lambda a=(vv, aa, plan, 0): k1.ntt_inverse_to_crt_acc(*a),
               "K1 + half-rows": lambda a=(vv, aa, plan, 0), d=rows:
                   k1.ntt_inverse_to_crt_acc(*a, digits=d, gadget=gadget)}
        refs = {"K1": lambda a=(vv, aa, plan, 0):
                    k1.ntt_inverse_to_crt_acc_reference(*a),
                "K1 + half-rows": lambda a=(vv, aa, plan, 0), d=rows:
                    k1.ntt_inverse_to_crt_acc_reference(*a, d, gadget)}
        for name, fn in fns.items():
            _time_calls(f"t64 B={B}", name, fn, refs[name], args.iters, gpu)
        turns = turns or fns
    graph = {name: [] for name in turns}
    for name in (*turns, *reversed(turns), *turns, *reversed(turns)):
        graph[name].append(cs._graph_ms(turns[name], args.iters) * 1e3)
    print(f"t64 B={batches[0]}: from CUDA graphs in turns: " + "; ".join(
        f"{name} {', '.join(f'{t:.2f}' for t in ts)} us" for name, ts
        in graph.items()) + f" [{gpu}]")
    return ok


def _k2s(args, batches, gpu) -> bool:
    """K2s at t64's shapes: bit-equal to its plain version at each batch,
    then timed."""
    import torch

    from zig_tfhe_tpu_torch.ops.cuda import split_step as k2s

    dev = torch.device("cuda", 0)
    key = _k2s_key(dev, args.seed)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    ok = True
    for B in batches:
        a = _k2s_inputs(key, B, g)
        out = k2s.split_step_fused(*a)
        ref = k2s.split_step_fused_reference(*a)
        torch.cuda.synchronize()
        same = torch.equal(out, ref)
        bad = int((out != ref).sum())
        print(f"t64 B={B}: K2s == plain: {same}"
              + ("" if same else f" ({bad} of {out.numel()} differ)"))
        ok &= same
        _time_calls(f"t64 B={B}", "K2s", lambda a=a: k2s.split_step_fused(*a),
                    lambda a=a: k2s.split_step_fused_reference(*a),
                    args.iters, gpu)
    return ok


def _sass_counts(so: Path) -> dict:
    """Opcode counts (SASS_OPS) of each kernel function in a built library,
    from ``cuobjdump -sass``."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump") or os.path.join(CUDA_HOME or "", "bin",
                                                     "cuobjdump")
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m[1]
            counts[fn] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                      line)
        if m and fn:
            counts[fn][m[1]] += 1
            counts[fn]["all"] += 1
    return counts


def _print_sass(label, so: Path, pattern: str) -> None:
    try:
        counts = _sass_counts(so)
    except (OSError, subprocess.CalledProcessError) as e:
        print(f"  SASS {label}: cuobjdump failed ({e}); not counted")
        return
    for fn, c in counts.items():
        if pattern in fn:
            print(f"  SASS {label} {fn[:60]}: {c['all']} instructions; "
                  + ", ".join(f"{op} {c[op]}" for op in SASS_OPS))


def _cvt_rates(gpu) -> None:
    """tools/cvt_rate.cu's rates (chip_smoke._barrett_rates), each Barrett
    form's beside the rate chip_smoke's instruction model gives it, and
    the SASS of each of its loops."""
    import torch

    from zig_tfhe_tpu_torch.ops.cuda import _build

    rates = cs._barrett_rates(torch.device("cuda", 0))
    model = {3: 1 / cs._cuda_core_clocks(1, converted=1),
             4: 1 / cs._cuda_core_clocks(1, converted=0)}
    for op, (name, rate) in enumerate(zip(cs.CVT_RATE_OPS, rates)):
        print(f"rate {name}: {rate:.2f} a clock per SM"
              + (f" (model {model[op]:.2f})" if op in model else "") + f" [{gpu}]")
    _print_sass("cvt_rate", _build.library_path(cs.CVT_RATE), "rate_kernel")


def _stage_split(args, gpu) -> bool:
    """K2's time with one stage switched off at compile time (the source's
    ZTFHE_PROBE_* switches; the outputs are then wrong and not compared):
    what is left when the product (TMA loads + wgmma) or the pointwise stage
    does not run, replayed from a CUDA graph."""
    import torch

    from zig_tfhe_tpu_torch import params
    from zig_tfhe_tpu_torch.ops import ntt
    from zig_tfhe_tpu_torch.ops.cuda import _build
    from zig_tfhe_tpu_torch.ops.cuda import ntt_step as k2

    from zig_tfhe_tpu_torch.ops.cuda import split_step as k2s

    dev = torch.device("cuda", 0)
    B = int(args.batches.split(",")[0])
    g = torch.Generator(device=dev).manual_seed(args.seed)
    kernels = args.kernels.split(",")
    variants = {"whole": (), "no pointwise": ("-DZTFHE_PROBE_NO_POINTWISE",),
                "no product": ("-DZTFHE_PROBE_NO_PRODUCT",)}
    barrett_shift = {"Barretts as shifts": ("-DZTFHE_PROBE_BARRETT_IMAD",)}
    for path in args.paths.split(","):
        name, group, e, levels, drop = PATHS[path]
        if path in K2S_PATHS:
            if "k2s" not in kernels:
                continue
            mod, label = k2s, "K2s"
            a = _k2s_inputs(_k2s_key(dev, args.seed), B, g)
            call = lambda a=a: k2s.split_step_fused(*a)
            paths_variants = dict(variants, **barrett_shift, **{
                "no product, Barretts as shifts": (
                    "-DZTFHE_PROBE_NO_PRODUCT", "-DZTFHE_PROBE_BARRETT_IMAD")})
        else:
            if "k2" not in kernels:
                continue
            mod, label = k2, "K2"
            P = params.PARAMS_BY_NAME[name]
            plan = ntt.plan_for_params(P, drop, group, levels, bgbit=e,
                                       pseudorandom_key=True)
            R, S, N = sum(levels), (1 << group) - 1, P.N
            digits = _digits(P, levels, e, B, g)
            bsk = ntt.to_ntt_form(
                torch.randint(0, 1 << 32, (S, R, 2, N), dtype=torch.int64,
                              generator=g, device=dev).to(torch.int32),
                plan, drop).movedim(0, 1).contiguous()
            ts = torch.randint(0, 2 * N + 1, (group, B), generator=g,
                               device=dev, dtype=torch.int32)
            call = lambda a=(digits, bsk, ts, plan, e): k2.ntt_step_fused(*a)
            paths_variants = dict(variants, **K2_PARTS, **barrett_shift)
        _build.build(mod.SOURCE)
        with concurrent.futures.ThreadPoolExecutor(len(paths_variants)) as pool:
            for f in [pool.submit(_build.build, mod.SOURCE, defines=d)
                      for d in paths_variants.values() if d]:
                f.result()
        _print_sass(label, _build.library_path(mod.SOURCE), "_kernel")
        times = {vname: cs._variant_ms(mod, defines, call, args.iters) * 1e3
                 for vname, defines in paths_variants.items()}
        print(f"{path} B={B}: {label} stage split: " + ", ".join(
            f"{n} {t:.1f} us" for n, t in times.items()) + f" [{gpu}]")
    _cvt_rates(gpu)
    return True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="k1,k2")
    ap.add_argument("--paths", default="g3,g2")
    ap.add_argument("--batches", default="2048,200,33,1")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--key-limbs", default="4",
                    help="K3's key-limb counts (1-4), comma-separated")
    ap.add_argument("--k3-source", action="append", default=[],
                    help="another source of K3 (same C entry point; "
                         "hopper_prims.cuh beside it) to build, check and "
                         "time after the shipped one; repeatable")
    ap.add_argument("--split", action="store_true",
                    help="also time K2 / K2s built without a stage (B = the "
                         "first batch), count the Barrett's opcodes in the "
                         "SASS and measure the conversion rates")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    from zig_tfhe_tpu_torch import params
    from zig_tfhe_tpu_torch.ops import ntt
    from zig_tfhe_tpu_torch.ops.cuda import _build
    from zig_tfhe_tpu_torch.ops.cuda import extprod as k3
    from zig_tfhe_tpu_torch.ops.cuda import ntt_inverse as k1
    from zig_tfhe_tpu_torch.ops.cuda import ntt_step as k2
    from zig_tfhe_tpu_torch.ops.cuda import split_step as k2s

    dev = torch.device("cuda", 0)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[{gpu}] torch {torch.__version__}, CUDA {torch.version.cuda}")
    kernels = args.kernels.split(",")
    batches = [int(b) for b in args.batches.split(",")]
    sources = [m.SOURCE for n, m in (("k1", k1), ("k2", k2), ("k3", k3),
                                     ("k2s", k2s)) if n in kernels]
    sources += [Path(v).resolve() for v in args.k3_source]
    t0 = time.perf_counter()
    logs = _build.build(*sources)
    print(f"built {[s.name for s in sources]} in {time.perf_counter() - t0:.1f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if ("Compiling entry" in line or "Used" in line or "spill" in line
                    or "warning" in line.lower() or "Loss" in line):
                print(f"  {src.name}: {line.split(':', 1)[-1].strip()[:150]}")

    g = torch.Generator(device=dev).manual_seed(args.seed)

    def uniform(shape):
        return torch.randint(0, 1 << 32, shape, dtype=torch.int64,
                             generator=g, device=dev).to(torch.int32)

    ok = True
    for path in args.paths.split(",") if {"k1", "k2"} & set(kernels) else ():
        if path in K2S_PATHS:
            continue
        name, group, e, levels, drop = PATHS[path]
        P = params.PARAMS_BY_NAME[name]
        N = P.N
        plan = ntt.plan_for_params(P, drop, group, levels, bgbit=e,
                                   pseudorandom_key=True)
        R, S = sum(levels), (1 << group) - 1
        for B in batches:
            calls = {}
            if "k1" in kernels:
                c, acc = uniform((B, 2, N)), uniform((B, 2, N))
                v = k1.split_limbs(torch.stack(
                    ntt.ntt_forward(c, plan, digit_limbs=4, digit_bound=128)))
                out = k1.ntt_inverse_to_crt_acc(v, acc, plan, drop)
                ref = k1.ntt_inverse_to_crt_acc_reference(v, acc, plan, drop)
                torch.cuda.synchronize()
                same = torch.equal(out, ref) and torch.equal(out, acc + (c << drop))
                bad = int((out != ref).sum())
                print(f"{path} B={B}: K1 == plain == exact: {same}"
                      + ("" if same else f" ({bad} of {out.numel()} differ)"))
                ok &= same
                calls["K1"] = (
                    lambda a=(v, acc, plan, drop): k1.ntt_inverse_to_crt_acc(*a),
                    lambda a=(v, acc, plan, drop):
                        k1.ntt_inverse_to_crt_acc_reference(*a))
            if "k2" in kernels:
                digits = _digits(P, levels, e, B, g)
                bsk = ntt.to_ntt_form(uniform((S, R, 2, N)), plan,
                                      drop).movedim(0, 1).contiguous()
                ts = torch.randint(0, 2 * N + 1, (group, B), generator=g,
                                   device=dev, dtype=torch.int32)
                v2 = k2.ntt_step_fused(digits, bsk, ts, plan, e)
                ref2 = k2.ntt_step_fused_reference(digits, bsk, ts, plan, e)
                torch.cuda.synchronize()
                same = torch.equal(v2, ref2)
                bad = int((v2 != ref2).sum())
                print(f"{path} B={B}: K2 == plain: {same}"
                      + ("" if same else f" ({bad} of {v2.numel()} differ)"))
                ok &= same
                calls["K2"] = (
                    lambda a=(digits, bsk, ts, plan, e): k2.ntt_step_fused(*a),
                    lambda a=(digits, bsk, ts, plan, e):
                        k2.ntt_step_fused_reference(*a))
            for name, (kern, plain) in calls.items():
                _time_calls(f"{path} B={B}", name, kern, plain, args.iters, gpu)
    if "k3" in kernels:
        ok &= _k3(args, batches, gpu)
    if "k2s" in kernels and set(K2S_PATHS) & set(args.paths.split(",")):
        ok &= _k2s(args, batches, gpu)
    if "k1" in kernels and set(K2S_PATHS) & set(args.paths.split(",")):
        ok &= _k1_split(args, batches, gpu)
    for v in args.k3_source:
        import ctypes

        lib = ctypes.CDLL(str(_build.library_path(Path(v).resolve())))
        lib.ztfhe_extprod_matmul.argtypes = \
            k3._library().ztfhe_extprod_matmul.argtypes
        lib.ztfhe_extprod_matmul.restype = ctypes.c_int
        lib.ztfhe_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ztfhe_cuda_error_string.restype = ctypes.c_char_p
        with cs._on_library(k3, lib):     # the wrapper, on this build
            ok &= _k3(args, batches, gpu, label=Path(v).stem)
    if args.split:
        ok &= _stage_split(args, gpu)
    print("probe ok" if ok else "probe FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
