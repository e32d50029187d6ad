#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zig_tfhe_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It drives the port's main path — bootstrapped boolean gates at
SECURITY_128_BIT with the key defaults (multi-bit group 3, engine gadget
Bg_e 2^7 (2,2), BSK drop 5, 3 CRT primes; 234 blind-rotation steps) —
through the entry points a user calls: SecretKey/CloudKey.generate on the
card from a seeded torch.Generator, tlwe.encrypt_bool, gates.apply_gates on
B = 2048 lanes cycling through all 10 gates, tlwe.decrypt_bool.  Phases:

  1. the card's name and power limit (nvidia-smi);
  2. build the hand-written kernel from zig_tfhe_tpu_torch/csrc with nvcc
     for sm_90a;
  3. the kernel against its plain PyTorch version at the path's shapes
     (P=3, N=1024, B=2048, drop 5), on residues of bounded polynomials:
     outputs must be bit-equal to each other and to acc + (c << 5);
  4. key generation on the card;
  5. B=2048 heterogeneous gates: accuracy must be 1.0, every kernel of the
     path must have been launched (234 times per bootstrap), and the first
     16 lanes must be bit-equal to the port's CPU path (the plain PyTorch
     versions, which the repository's tests hold bit-equal to the JAX
     package);
  6. timings with CUDA events: gates/s at B=2048, B=1 latency, the kernel
     and its plain version per call.

The next-to-last stdout line is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.  Any failed phase raises (exit code != 0,
no result line).  Without a CUDA device it exits 2 before printing anything.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

B_GATES = 2048
SMALL_LANES = 16
WARM_ITERS = 3


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    from zig_tfhe_tpu_torch import key, params, tlwe
    from zig_tfhe_tpu_torch.models import gates
    from zig_tfhe_tpu_torch.ops import ntt
    from zig_tfhe_tpu_torch.ops.cuda import ntt_inverse as k1

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(dev)
    gpu = _gpu_line()
    print(f"device: {kind} ({torch.cuda.device_count()} visible); "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    so = k1.build()
    print(f"built {k1.SOURCE.name} -> {so.name} for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")

    # -- 3. kernel vs plain version at the path's shapes --------------------
    P = params.SECURITY_128_BIT
    group = ntt.default_group(P)
    bgbit, levels = ntt.default_engine_gadget(P, group)
    drop = ntt.default_drop_bits(P, group, bgbit)
    plan = ntt.plan_for_params(P, drop, group, levels, bgbit=bgbit,
                               pseudorandom_key=True)
    _check((group, bgbit, levels, drop, plan.n_primes) == (3, 7, (2, 2), 5, 3),
           f"unexpected 128-bit defaults {(group, bgbit, levels, drop)}")
    g = torch.Generator(device=dev).manual_seed(1234)

    def uniform(shape):
        return torch.randint(0, 1 << 32, shape, dtype=torch.int64,
                             generator=g, device=dev).to(torch.int32)

    c = uniform((B_GATES, 2, P.N))
    acc = uniform((B_GATES, 2, P.N))
    v = torch.stack(ntt.ntt_forward(c, plan, digit_limbs=4, digit_bound=128))
    out = k1.ntt_inverse_to_crt_acc(v, acc, plan, drop)
    ref = k1.ntt_inverse_to_crt_acc_reference(v, acc, plan, drop)
    torch.cuda.synchronize()
    max_abs_err = int((out.long() - ref.long()).abs().max())
    _check(max_abs_err == 0, f"kernel differs from its plain version "
           f"(max |diff| {max_abs_err})")
    _check(torch.equal(out, acc + (c << drop)), "kernel output is not the "
           "exact acc + (c << drop)")
    print(f"kernel ntt_inverse_crt_acc == plain version == exact at "
          f"[P={plan.n_primes}, B={B_GATES}, 2, N={P.N}], drop {drop}")

    def run_kernel():
        k1.ntt_inverse_to_crt_acc(v, acc, plan, drop)

    def run_plain():
        k1.ntt_inverse_to_crt_acc_reference(v, acc, plan, drop)

    for fn in (run_kernel, run_plain):
        fn()
    times = {"kernel": [], "plain": []}
    for name, fn in (("plain", run_plain), ("kernel", run_kernel),
                     ("kernel", run_kernel), ("plain", run_plain)):
        times[name].append(_cuda_ms(fn, 20))
    k_ms = sum(times["kernel"]) / 2
    plain_ms = sum(times["plain"]) / 2

    # -- 4. key generation on the card --------------------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sk = key.SecretKey.generate(g, P)
    ck = key.CloudKey.generate(g, sk, P)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    _check((ck.bsk_group, ck.bsk_bgbit, ck.bsk_levels, ck.bsk_ntt_drop)
           == (3, 7, (2, 2), 5), "cloud key is not at the 128-bit defaults")
    print(f"keygen {P.name}: {keygen_s:.2f} s, bsk_ntt "
          f"{tuple(ck.bsk_ntt.shape)} int16, ksk1 {tuple(ck.ksk1.shape)}")

    # -- 5. the main path: B=2048 heterogeneous gates -----------------------
    x = torch.randint(0, 2, (B_GATES,), generator=g, device=dev).bool()
    y = torch.randint(0, 2, (B_GATES,), generator=g, device=dev).bool()
    ids = torch.arange(B_GATES, device=dev) % len(gates.GATE_NAMES)
    a = tlwe.encrypt_bool(g, x, P.ksk_alpha, sk.key_lv0)
    b = tlwe.encrypt_bool(g, y, P.ksk_alpha, sk.key_lv0)
    steps = -(-P.n0 // group)
    k1.ntt_inverse_to_crt_acc.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gates.apply_gates(ids, a, b, ck)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = k1.ntt_inverse_to_crt_acc.launches
    _check(launches == steps, f"kernel launched {launches} times in one "
           f"bootstrap, expected {steps}")
    _check(res.dtype == torch.int32 and tuple(res.shape) == (B_GATES, P.n0 + 1),
           f"gate output {res.dtype} {tuple(res.shape)}")
    truth = {
        "nand": lambda p, q: not (p and q), "or": lambda p, q: p or q,
        "and": lambda p, q: p and q, "xor": lambda p, q: p != q,
        "xnor": lambda p, q: p == q, "nor": lambda p, q: not (p or q),
        "andny": lambda p, q: (not p) and q, "andyn": lambda p, q: p and not q,
        "orny": lambda p, q: (not p) or q, "oryn": lambda p, q: p or not q}
    want = np.array([truth[gates.GATE_NAMES[i]](bool(p), bool(q)) for i, p, q
                     in zip(ids.tolist(), x.tolist(), y.tolist())])
    got = tlwe.decrypt_bool(res, sk.key_lv0).cpu().numpy()
    accuracy = float((got == want).mean())
    _check(accuracy == 1.0, f"gate accuracy {accuracy} != 1.0")
    print(f"apply_gates B={B_GATES} at {P.name}: accuracy {accuracy}, "
          f"{launches} kernel launches ({steps} steps), first call "
          f"{first_s:.2f} s")

    ck_cpu = key.CloudKey.from_numpy(
        {n: t.cpu().numpy() for n, t in ck.named_buffers()}, P,
        bsk_ntt_drop=ck.bsk_ntt_drop, bsk_group=ck.bsk_group,
        bsk_levels=ck.bsk_levels, bsk_bgbit=ck.bsk_bgbit)
    t0 = time.perf_counter()
    res_cpu = gates.apply_gates(ids[:SMALL_LANES].cpu(), a[:SMALL_LANES].cpu(),
                                b[:SMALL_LANES].cpu(), ck_cpu)
    _check(torch.equal(res_cpu, res[:SMALL_LANES].cpu()),
           "CUDA gate outputs differ from the port's CPU path")
    print(f"first {SMALL_LANES} lanes bit-equal to the CPU path "
          f"({time.perf_counter() - t0:.1f} s on the host)")

    # -- 6. timings ---------------------------------------------------------
    def run_gates():
        gates.apply_gates(ids, a, b, ck)

    gate_ms = _cuda_ms(run_gates, WARM_ITERS)
    one = (ids[:1], a[:1], b[:1])
    gates.apply_gates(*one, ck)
    lat_ms = _cuda_ms(lambda: gates.apply_gates(*one, ck), WARM_ITERS)
    rate = B_GATES / (gate_ms / 1e3)
    print(f"gates/s at B={B_GATES}: {rate:.1f} ({gate_ms:.1f} ms/batch) "
          f"[{gpu}]")
    print(f"gate latency at B=1: {lat_ms:.1f} ms [{gpu}]")
    print(f"ntt_inverse_crt_acc at B={B_GATES}: kernel {k_ms * 1e3:.1f} us/call, "
          f"plain version {plain_ms * 1e3:.1f} us/call [{gpu}]")

    print(gpu)
    print(json.dumps({"kernels": [{
        "name": "ntt_inverse_crt_acc", "route": "cuda",
        "source": "zig_tfhe_tpu_torch/csrc/ntt_inverse.cu",
        "replaces": "zig_tfhe_tpu/ops/pallas/ntt_inverse.py:100",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": k_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
