#!/usr/bin/env python3
"""Build, check and time the hand-written kernels of the PyTorch/CUDA port
on one GPU.

    python3 tools/torch_kernel_probe.py [--kernels k1,k2,k3] [--paths g3,g2]
                                        [--batches 2048,200,1] [--iters 20]

A quicker loop than chip_smoke.py for work on one kernel: it builds the
kernels asked for (csrc/ntt_inverse.cu K1, csrc/ntt_step.cu K2,
csrc/extprod.cu K3) with nvcc, prints ptxas' report (registers, shared
memory, spills, warnings), and at the 128-bit shapes of each path (g3:
group 3, Bg_e 2^7, R = 4, drop 5; g2: group 2, Bg_e 2^6, R = 5, drop 7;
N = 1024, 3 primes; K3: 2L = 6 digit rows, 1-4 key limbs of an ext-limb
key step, ``--key-limbs``) holds each kernel bit-equal to its plain
PyTorch version at every batch size given,
then times kernel and plain version with CUDA events (plain, kernel, kernel,
plain), the kernel alone replayed from a CUDA graph (device time without
the host's gaps, which is what small batches otherwise measure) and the
host's cost of enqueueing one call.  Inputs are seeded:
uniform accumulators, digits in the gadget's range, key residues of uniform
polynomials.  Prints the card's nvidia-smi name and power limit beside the
times.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# path -> (group, engine bgbit, levels, drop)
PATHS = {"g3": (3, 7, (2, 2), 5), "g2": (2, 6, (3, 2), 7)}


def _cuda_ms(fn, iters):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _time_calls(label, name, kern, plain, iters, gpu) -> None:
    """Kernel and plain version in turns (plain, kernel, kernel, plain), the
    kernel replayed from a CUDA graph, and the host's cost of one enqueue."""
    import torch

    kern()
    plain()
    t = {kern: [], plain: []}
    for fn in (plain, kern, kern, plain):
        t[fn].append(_cuda_ms(fn, iters))
    # device time alone: the calls replayed from a CUDA graph
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            kern()
    graph.replay()
    dev_us = _cuda_ms(graph.replay, 3) / iters * 1e3
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


def _stage_split(args, gpu) -> bool:
    """K2's time with one stage switched off at compile time (the source's
    ZTFHE_PROBE_* switches; the outputs are then wrong and not compared):
    what is left when the product (TMA loads + wgmma) or the pointwise stage
    does not run, replayed from a CUDA graph."""
    import ctypes

    import torch

    from zig_tfhe_tpu_torch import params
    from zig_tfhe_tpu_torch.ops import ntt
    from zig_tfhe_tpu_torch.ops.cuda import _build
    from zig_tfhe_tpu_torch.ops.cuda import ntt_step as k2

    dev = torch.device("cuda", 0)
    P = params.SECURITY_128_BIT
    B = int(args.batches.split(",")[0])
    g = torch.Generator(device=dev).manual_seed(args.seed)
    variants = {"whole": (), "no pointwise": ("-DZTFHE_PROBE_NO_POINTWISE",),
                "no product": ("-DZTFHE_PROBE_NO_PRODUCT",)}
    for path in args.paths.split(","):
        group, e, levels, drop = PATHS[path]
        plan = ntt.plan_for_params(P, drop, group, levels, bgbit=e,
                                   pseudorandom_key=True)
        R, S, N = sum(levels), (1 << group) - 1, P.N
        half = 1 << (e - 1)
        digits = torch.randint(-half, half, (B, R, N), generator=g, device=dev,
                               dtype=torch.int32).to(torch.int8)
        bsk = ntt.to_ntt_form(
            torch.randint(0, 1 << 32, (S, R, 2, N), dtype=torch.int64,
                          generator=g, device=dev).to(torch.int32),
            plan, drop).movedim(0, 1).contiguous()
        ts = torch.randint(0, 2 * N + 1, (group, B), generator=g, device=dev,
                           dtype=torch.int32)
        times = {}
        for name, defines in variants.items():
            _build.build(k2.SOURCE, defines=defines)
            lib = k2._bind(ctypes.CDLL(
                str(_build.library_path(k2.SOURCE, defines))))
            real = k2._library
            k2._library = lambda lib=lib: lib   # the wrapper, on this build
            try:
                k2.ntt_step_fused(digits, bsk, ts, plan, e)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    for _ in range(args.iters):
                        k2.ntt_step_fused(digits, bsk, ts, plan, e)
                graph.replay()
                times[name] = _cuda_ms(graph.replay, 3) / args.iters * 1e3
            finally:
                k2._library = real
        print(f"{path} B={B}: K2 stage split: " + ", ".join(
            f"{n} {t:.1f} us" for n, t in times.items()) + f" [{gpu}]")
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
                    help="also time K2 built without its product stage and "
                         "without its pointwise stage (B = the first batch)")
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

    dev = torch.device("cuda", 0)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[{gpu}] torch {torch.__version__}, CUDA {torch.version.cuda}")
    kernels = args.kernels.split(",")
    batches = [int(b) for b in args.batches.split(",")]
    sources = [m.SOURCE for n, m in (("k1", k1), ("k2", k2), ("k3", k3))
               if n in kernels]
    sources += [Path(v).resolve() for v in args.k3_source]
    t0 = time.perf_counter()
    logs = _build.build(*sources)
    print(f"built {[s.name for s in sources]} in {time.perf_counter() - t0:.1f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if ("Compiling entry" in line or "Used" in line or "spill" in line
                    or "warning" in line.lower() or "Loss" in line):
                print(f"  {src.name}: {line.split(':', 1)[-1].strip()[:150]}")

    P = params.SECURITY_128_BIT
    N = P.N
    g = torch.Generator(device=dev).manual_seed(args.seed)

    def uniform(shape):
        return torch.randint(0, 1 << 32, shape, dtype=torch.int64,
                             generator=g, device=dev).to(torch.int32)

    ok = True
    for path in args.paths.split(",") if {"k1", "k2"} & set(kernels) else ():
        group, e, levels, drop = PATHS[path]
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
                half = 1 << (e - 1)
                digits = torch.randint(-half, half, (B, R, N), generator=g,
                                       device=dev, dtype=torch.int32).to(torch.int8)
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
    for v in args.k3_source:
        import ctypes

        lib = ctypes.CDLL(str(_build.library_path(Path(v).resolve())))
        lib.ztfhe_extprod_matmul.argtypes = \
            k3._library().ztfhe_extprod_matmul.argtypes
        lib.ztfhe_extprod_matmul.restype = ctypes.c_int
        lib.ztfhe_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ztfhe_cuda_error_string.restype = ctypes.c_char_p
        real = k3._library
        k3._library = lambda lib=lib: lib   # the wrapper, on this build
        try:
            ok &= _k3(args, batches, gpu, label=Path(v).stem)
        finally:
            k3._library = real
    if args.split:
        ok &= _stage_split(args, gpu)
    print("probe ok" if ok else "probe FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
