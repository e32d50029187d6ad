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
negacyclic circulants of the key step's rows, 4 key limbs).  Every step
of the 64-bit torus's split-ring scan (phase 11) is K2s (csrc/split_step.cu:
K2's function at the split shape) then K1.  Phases:

  1. the card's name and power limit (nvidia-smi);
  2. build the four kernels from zig_tfhe_tpu_torch/csrc (all on
     csrc/hopper_prims.cuh: TMA, mbarrier, wgmma) with nvcc for sm_90a, one
     nvcc per source, started together with K2s's three probe builds
     (phase 11's stage split) and tools/cvt_rate.cu; ptxas' registers and
     spills (and any wgmma serialization it reports); a Barrett's
     throughput per SM clock in its two forms (both conversions; the
     rounding by an f32 add) held to 80-100% of the rate the bounds'
     instruction model (_cuda_core_clocks) gives it;
  3. key generation on the card, all three configurations, and the
     SECURITY_UINT4 and SECURITY_UINT8 keys of phase 9 (group 2, Bg_e 2^22
     with (1, 1) levels: 3-limb engine digits, drop 0, 5 CRT primes; each
     with its packing key);
  4. each kernel against its plain PyTorch version at each path's shapes,
     at B = 2048, 200 (a ragged last tile) and 1: K1 on the int8 limb
     planes of residues of bounded polynomials (bit-equal to the plain
     version and to the exact acc + (c << drop)); K2 on the digits of an
     accumulator and a step of the real key (bit-equal); both also at
     uint4's shapes (K2 on the 6 limb planes of a real accumulator's
     digits, R = 2 rows of 3 limbs; K1 at 5 primes and drop 0); K3 on the
     digits of an accumulator difference and a step of the real key
     (bit-equal), also at B = 65 and 64 (one batch tile and a ragged
     second one); on every path K1's instance that also writes the next
     step's gadget digit planes (one limb a digit on g3 and g2, three on
     uint4), its planes bit-equal to the plain version's (``gadget.planes``
     of its output) and its accumulator to the instance without them, at
     each B, and the two instances timed in turns at B = 2048;
  5. per path, B = 2048 heterogeneous gates with every launch count set to
     0 just before and read just after: accuracy must be 1.0, each kernel
     of the path must have been launched once per step and the others not
     at all (K2's ``shape_launches`` on every g3 step, its
     ``uint_shape_launches`` on none), and the first 16 lanes must be
     bit-equal to the port's CPU
     path (the plain PyTorch versions, which the repository's tests hold
     bit-equal to the JAX package);
  6. timings with CUDA events, per path: gates/s at B = 2048, B = 1
     latency, each kernel and its plain version per call beside its bound
     (bytes, tensor-core operations or CUDA-core operations, whichever is
     largest) and the L2 -> SM bytes of its tiling, each kernel also per
     call at B = 1 from a CUDA graph (K3 also against torch._int_mm on
     circulants built beforehand, the build not timed), and one step split
     into its stages (g3 and g2: K2, then K1 writing the next digits);
  7. per path, a torch.profiler trace of one warm batch at B = 2048 and at
     B = 1: device busy time, idle share and the costliest kernels (every
     profile in the script is held complete only when it kept one record
     of each hand kernel for every launch counted in the call; else it is
     reported as incomplete and its idle share not measured);
  8. the circuit path (models/netlists.py, models/scheduler.py,
     models/circuits.py) on the g3 key: the Bristol 64x64 -> 128-bit
     multiplier (26,931 gates in 43 levels of the native level scheduler),
     each level one heterogeneous apply_gates bootstrap, at B = 1 and in
     serving mode at B = 4 clients, with the launch counts set to 0 just
     before each run and read just after (K1 and K2 once per step of every
     level with a bootstrapped lane, K3 never).  Each run is checked level
     by level (_checked_run): every gate's output must decrypt to the sign
     of its combination's phase unless that phase lies within the
     modswitch noise of a decision boundary, NOT/COPY/CONST must be exact,
     and the outputs must equal the evaluate run's.  A product is exact
     unless a gate failed from input noise (its inputs' noise moved the
     combination across a boundary: the scheme's failure, which the JAX
     package, bit-equal, shares); such a gate is rerun alone against the
     port's CPU path (bit-equal), and the exact products are counted; a
     product with no such gate must equal eval_bristol_plain's bits.  One
     warm run of each is timed with CUDA events (circuit gates/s, ms per
     level) and the B = 1 run traced (idle share).  The Kogge-Stone adder
     on 16 bits (402 + 304 = 706) and the ripple-carry adder on 4; a
     scheduler-built full adder on the card bit-equal to the port's CPU
     path, and on the toep key (K3 700 launches per level, sums exact);
     the g3 key saved and loaded (utils/serialization.py) gives bit-equal
     gate_pair outputs, and the product's ciphertext round-trips
     bit-equal;
  9. the LUT path (models/lut.py) on the uint keys, every blind-rotation
     step K2 (3-limb digit planes) then K1 (writing the next step's
     planes on every step but the last), with the launch counts set to
     0 just before each run and read just after (410 steps a rotation on
     uint4, 580 on uint8; K3 never): bootstrap_lut at B = 2048 on uint4,
     m = 16, f(x) = (7x + 3) mod 16 on lanes cycling all 16 messages;
     bootstrap_multi_lut (x mod 8, x div 8) from one rotation at B = 2048;
     bootstrap_lut_radix on uint8 at m = 256, f(x) = (5x + 1) mod 256, B =
     512 (a multi-value rotation of 512 lanes, then a per-family select of
     2 x 512); bootstrap_lut_bivariate, xy + 1 mod 16, on uint4 at B = 256.
     uint4's bootstrap_lut must have had K1 write the planes on 409 of
     its 410 steps (``digit_launches``) and run every K2 step on the
     instance compiled at the uint keys' shape (``uint_shape_launches``
     410, ``shape_launches`` 0).  Every lane of the uint4 runs must
     decrypt to what the test vector
     holds at its modswitched input phase (computed here with the secret
     key from the rounded mask and body, as the rotation rounds them: an
     exact check that input noise cannot break); the accuracy against the
     encrypted messages is printed, and a lane whose input noise moved its
     phase out of its bin is counted, not failed.  The radix run must
     reach accuracy >= 0.95, exact on every lane whose two digits stay in
     their bins.  The first 16 uint4 lanes and the first 8 radix lanes are
     bit-equal to the port's CPU path.  Timed with CUDA events: LUT/s at
     B = 2048, B = 1 latency, the multi-value, radix and bivariate runs,
     one uint4 step split into K2 / K1 writing the next limb planes; traced at
     B = 2048 and B = 1 (idle share);
 10. the integer layer (models/integer.py) on phase 3's uint4 key, every
     blind rotation 410 steps of K2 then K1, the launch counts set to 0
     just before each op and read just after (K1 = K2 = 410 x the op's
     blind rotations, which tests/test_torch_integer*.py pin; K3 never):
     the five ops of bench_integer.py at B = 256 on 6-bit (2-digit)
     operands from a numpy seed -- radix_mul (the tree PBS on the key's
     packing key), radix_add mod 64, radix_divmod (divisors >= 1, quotient
     and remainder), radix_lt, radix_eq (half the pairs equal) -- every
     lane exact against numpy (a miss fails the run, printing the op, the
     lane and both values), except div's quotient, whose misses are
     traced instead (_check_divmod: every quotient bit and remainder
     exact, the reassembly rotation exact against its modswitched input,
     the wrong digits exactly those whose sum b0 + 2 b1 + 4 b2 left its
     bin, bit-equal to the CPU path) and counted as the scheme's noise,
     which must stay within what was measured (DIV_NOISE_STD_MAX, and
     DIV_MISS_RATE plus DIV_MISS_SIGMAS binomial std in crossed lanes);
     the first 4 lanes of add and lt bit-equal to
     the port's CPU path; the classic digit multiplier (radix_mul on a
     uint4 key generated here with packing_key=False) at B = 256; FheInt
     at B = 64 on 2-digit signed values (+, -, <, >> 2, >> an encrypted
     amount, abs, div_rem, whose quotient is traced as div's) exact
     against Python's two's complement; the
     gates bridge at B = 64 (to_bools of two 3-bit values, a 3-bit ripple
     adder built with scheduler.Circuit and run by scheduler.evaluate,
     from_bools), sums exact.  Timed with CUDA events (the median of 3
     warm calls): ops/s at B = 256 per op, B = 1 latency of add and mul,
     peak device memory per op; one warm mul traced (busy time, idle
     share, kernels per op, the costliest kernels); the phase's wall time,
     split into the CPU-path checks, the timings and the rest;
 11. the 64-bit torus: one SECURITY_128_BIT_T64 key generated on the card
     (N = 2048, n0 = 768, int64 carriers; its defaults: group 2, Bg_e 2^8
     with (3, 2) levels, drop 32, the four-prime plan on N/2 = 1024, the
     packing key at (8, 3)), its arrays' shapes and bytes and the keygen
     time.  The split-ring scan runs on the int32 hi planes; every step is
     K2s (forward NTT, pointwise against the key group, the Y-twisted
     combine; the residues as int8 limb planes [P, B, 2, 2, 2, 1024]) and
     K1 on their views ([P, 2B, 2, 2, 1024], drop 32 - 32 = 0), which also
     writes the next step's hi-plane half-rows (all but the last step;
     step 0's come from the plain decompose).  K2s on one real step's inputs (the
     hi-plane digits of a rotated test vector, the key's first group, the
     rotations of real ciphertexts) bit-equal to its plain version (the
     prime-batched forward NTT, pointwise and combine of ops/split_ring.py)
     at B = 2048, 200 and 1, timed beside its bound and the plain chain;
     K2s's Barrett (its rounding by an f32 add) equal to the plain
     version's conversion form on all 2^32 int32 for each of the four
     primes (the kernel's own device function); K2s's stage split (the
     same call on builds without the pointwise stage, without the product
     stage and with every Barrett a shift, from a CUDA graph) and its
     ptxas registers and spills;
     K1 on K2s's residues, bit-equal to its plain version and to the plain
     hi-plane finish at the same batches, timed beside its bound; K1's
     instance that also writes the half-rows, its half-rows bit-equal to
     ``rows_hi32`` of its output at the same batches, timed in turns with
     the instance without them from CUDA graphs at B = 2048;
     apply_gates on 512 lanes cycling the 10 gates, the launch counts set to
     0 just before and read just after (K2s = K1 = 384, 383 K1 launches
     writing half-rows, K2 and K3 0), no
     call of the plain forward NTT, pointwise or combine on the card,
     accuracy 1.0, the first 4 lanes bit-equal to the port's CPU path;
     gates/s at B = 2048 (one batch, warm from the B = 512 run, and its
     peak device memory), B = 1 latency, one step split into decompose /
     K2s / K1, and profiles at B = 2048 and B = 1 read from the profiler's
     kernel records (busy time, idle share, kernels a step, the costliest
     kernels; a complete profile
     must hold fewer matrix-product kernels than steps: only the key
     switch's _int_mm is left); bootstrap_lut at m = 16 on B = 256
     (every lane equal to the table at its modswitched phase), the m = 64
     radix LUT through the tree PBS on B = 64 (every mid table on its
     dedicated rotation lane; in-bin lanes exact, accuracy >= 0.95),
     FheUint 2-digit add, lt and mul and an FheInt add on B = 64, exact
     against numpy, each with its launch counts (K2s = K1 = 384 x the op's
     rotations, T64_ROTATIONS); the split cloud key and a 64-bit ciphertext
     saved and loaded (gate_pair bit-equal after the load); the phase's
     wall time, split.
 12. slice 5 on SECURITY_128_BIT with phase 3's g3 key (Alice's): 2 x 2048
     bits encrypted seeded on the card (tlwe.encrypt_bool_seeded), saved
     (save_seeded_ciphertext), loaded and expanded on the card, bit-equal
     to the threefry mask of their seed beside their bodies (the file
     sizes printed, seeded vs expanded); apply_gates on them cycling the
     10 gates, the launch counts set to 0 just before and read just after
     (K2 = K1 = 234, K3 = 0), accuracy 1.0; Bob's public key and an
     asymmetric re-encryption key Alice -> Bob, Carol's secret key and a
     symmetric key Bob -> Carol, reencrypt twice: each hop's accuracy
     (>= 0.90, the reference's bar) and phase error std, its first 16
     lanes bit-equal to the CPU path; the public and re-encryption key
     files (reencrypt bit-equal after the load); the truncated bootstrap
     on 16 lanes and CloudKey.generate_no_ksk(group=None)'s gates on 8
     lanes (K2 = K1 = 234), each bit-equal to the CPU path; TEST_TINY64
     gates on the card (the direct 64-bit engine and its int64 finish, no
     hand kernel), bit-equal to the CPU path; parallel/: one NCCL rank
     (distributed_gates, shard_map_gates) bit-equal to apply_gates, then
     two gloo ranks on the one card (two processes; the key broadcast from
     rank 0), each rank's 1024 lanes bit-equal; timings with
     utils/profiling.time_op (CUDA events, median of 3): reencrypt per
     batch and lane, expand_seeded, seeded and public-key encryption, the
     three keygens; the phase's wall time, split.

The script prints its total wall time, a {"slice5_ms": ...} line of phase
12's timings; the next-to-last stdout line is {"kernels": [...]}, before
it the card's nvidia-smi name and power limit;
the last line is {"ok": true, "device": {...}}.  Any failed phase raises (exit code != 0, no result line).
Without a CUDA device it exits 2 before printing anything.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

B_GATES = 2048
RAGGED_LANES = 200     # a batch that ends inside a kernel tile
SMALL_LANES = 16
WARM_ITERS = 3
KERNEL_ITERS = 20

# published H100 SXM peaks (NVIDIA data sheet): bytes/s, int8 op/s
HBM_BPS = 3.35e12
INT8_OPS = 1.979e15
# CUDA-core pipes of an SM on this card, results per clock: the two FMA
# pipes take f32 add and multiply at 128 between them and int32 multiply
# and multiply-add (IMAD, IMUL) at 64 (the heavy one only); the ALU pipe
# takes int32 add, logic and int32 -> f32 (I2FP) at 64; the conversion pipe
# takes f32 -> int32 at 16; the four schedulers issue 128 thread
# instructions per clock between them, and the pipes run side by side.
# The f32, FMA and ALU rates are the CUDA C++ Programming Guide's
# arithmetic-instruction throughput table for compute capability 9.0 and
# the pipe names Nsight Compute's; the conversion rates were measured by
# tools/cvt_rate.cu (f32 -> int32 16.00, int32 -> f32 56.78 a clock per SM
# on an NVIDIA H100 80GB HBM3 at 700.00 W), and phase 2 measures them and
# holds _cuda_core_clocks to them on every run (_check_barrett_rates).
# 132 SMs at the 1.98 GHz boost clock that the 67 TFLOP/s f32 peak assumes
# (132 x 128 x 2 x 1.98e9).
SMS, SM_HZ = 132, 1.98e9
RATE_ISSUE, RATE_FMA, RATE_IMAD, RATE_ALU, RATE_CVT = 128, 128, 64, 64, 16


def _cuda_core_clocks(barretts: float, cvt: float = 0, f32: float = 0,
                      imad: float = 0, converted: float | None = None) -> float:
    """Least SM clocks per thread-result for a CUDA-core stage: the larger
    of all its instructions over the issue rate and each pipe's
    instructions over that pipe's rate.  A Barrett is counted as the least
    the function needs, not as a kernel issues it: int -> f32 (I2FP, ALU),
    f32 multiply (FMA), the rounding to an integer and an int32
    multiply-subtract (IMAD).  Each rounding (a Barrett's, and ``cvt``
    more) is either an f32 -> int conversion or an f32 add of 1.5 * 2^23
    (FMA) and an int32 add (ALU), as split_step.cu's barrett rounds;
    ``converted`` is the share of the roundings converted, by default the
    share that balances the pipes best.  ``f32`` more f32 operations and
    ``imad`` more int32 multiply-adds."""
    n_round = barretts + cvt
    best = math.inf
    for a in ((converted,) if converted is not None
              else (i / 1024 for i in range(1025))):
        n_cvt, n_add = a * n_round, (1 - a) * n_round
        n_alu = barretts + n_add
        n_imad = barretts + imad
        n_fma = n_imad + barretts + f32 + n_add
        best = min(best, max((n_cvt + n_alu + n_fma) / RATE_ISSUE,
                             n_cvt / RATE_CVT, n_alu / RATE_ALU,
                             n_imad / RATE_IMAD, n_fma / RATE_FMA))
    return best


# NTT path -> CloudKey.generate knobs and the expected (group, Bg_e,
# levels, drop); the Toeplitz path "toep" is the key of engines=("toeplitz",)
PATHS = {
    "g3": ({}, (3, 7, (2, 2), 5)),
    "g2": ({"group": 2, "decomp_levels": (3, 2)}, (2, 6, (3, 2), 7)),
}
TOEP = "toep"
# K2s built with one stage switched off (csrc/split_step.cu's probe
# switches; its outputs are then wrong and only timed): phase 11's stage
# split
K2S_PROBES = {"no pointwise": ("-DZTFHE_PROBE_NO_POINTWISE",),
              "no product": ("-DZTFHE_PROBE_NO_PRODUCT",),
              "Barretts as shifts": ("-DZTFHE_PROBE_BARRETT_IMAD",)}
# the microbenchmark of a Barrett's instructions (phase 2)
CVT_RATE = Path(__file__).resolve().with_name("tools") / "cvt_rate.cu"
# ptxas' report per (source, kernel), filled by phase 2
PTXAS = {}


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


@contextlib.contextmanager
def _on_library(mod, lib):
    """While the block runs, ``mod``'s wrapper launches on ``lib`` (another
    build of its source, bound as its own) instead of its own library."""
    real = mod._library
    mod._library = lambda: lib
    try:
        yield
    finally:
        mod._library = real


def _variant_ms(mod, defines: tuple, call, iters: int) -> float:
    """Device milliseconds per ``call`` (_graph_ms) with ``mod``'s wrapper
    on the build of its source with ``defines`` (a probe build: the
    outputs are then wrong and not used)."""
    from zig_tfhe_tpu_torch.ops.cuda import _build

    _build.build(mod.SOURCE, defines=defines)
    lib = mod._bind(ctypes.CDLL(str(_build.library_path(mod.SOURCE, defines))))
    with _on_library(mod, lib):
        return _graph_ms(call, iters)


# tools/cvt_rate.cu's operations, in the order of its op argument
CVT_RATE_OPS = ("int32 -> f32 (__int2float_rn)", "f32 -> int32 (__float2int_rn)",
                "int32 multiply-add", "Barrett, both conversions",
                "Barrett, rounding by the f32 add",
                "Barrett, no conversion (int32 -> f32 from 16-bit halves)")


def _barrett_rates(dev) -> list:
    """tools/cvt_rate.cu: results per SM clock of each of CVT_RATE_OPS (one
    block of 1024 threads per SM, 8 chains a thread, clock64 per block,
    the mean over the SMs; the second of two launches)."""
    import torch

    from zig_tfhe_tpu_torch.ops.cuda import _build

    _build.build(CVT_RATE)
    lib = ctypes.CDLL(str(_build.library_path(CVT_RATE)))
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    lib.ztfhe_cvt_rate.argtypes = [i_, p_, p_, i_, i_, i_, ctypes.c_float, p_]
    lib.ztfhe_cuda_error_string.argtypes = [i_]
    lib.ztfhe_cuda_error_string.restype = ctypes.c_char_p
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(blocks * 1024, dtype=torch.int32, device=dev)
    cycles = torch.empty(blocks, dtype=torch.int64, device=dev)
    p, iters = 61441, 4096
    rates = []
    for op in range(len(CVT_RATE_OPS)):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for _ in range(2):      # the first launch warms up
            err = lib.ztfhe_cvt_rate(op, out.data_ptr(), cycles.data_ptr(),
                                     blocks, iters, p, 1.0 / p, stream)
            _build.check(lib, err, "cvt_rate")
        torch.cuda.synchronize()
        rates.append(1024 * iters * 8 / float(cycles.double().mean()))
    return rates


def _check_barrett_rates(dev, gpu: str) -> None:
    """Hold _cuda_core_clocks to the card: a Barrett in each of its two
    forms (both conversions; the rounding by the f32 add) must run no
    faster than the model allows and at least 80% as fast."""
    rates = _barrett_rates(dev)
    for op, converted in ((3, 1), (4, 0)):
        model = 1 / _cuda_core_clocks(1, converted=converted)
        print(f"rate {CVT_RATE_OPS[op]}: {rates[op]:.2f} a clock per SM "
              f"(the yardstick's model {model:.2f}) [{gpu}]")
        _check(0.8 * model <= rates[op] <= model,
               f"{CVT_RATE_OPS[op]} at {rates[op]:.2f} a clock per SM, "
               f"outside 80-100% of the model's {model:.2f}")
    print("rates " + ", ".join(f"{n} {r:.2f}" for n, r in
                               zip(CVT_RATE_OPS, rates)) + f" a clock per SM [{gpu}]")


def _kernel_vs_plain(kernel, plain, iters: int = KERNEL_ITERS):
    """(kernel ms, plain ms) per call, timed in turns: plain, kernel,
    kernel, plain (after one warm call of each)."""
    kernel()
    plain()
    times = {kernel: [], plain: []}
    for fn in (plain, kernel, kernel, plain):
        times[fn].append(_cuda_ms(fn, iters))
    return sum(times[kernel]) / 2, sum(times[plain]) / 2


# each hand kernel's wrapper, by its counter key, and its symbol in a trace
_HAND_KERNELS = {"k1": ("ntt_inverse", "ntt_inverse_to_crt_acc",
                        "ntt_inverse_crt_acc_kernel"),
                 "k2": ("ntt_step", "ntt_step_fused", "ntt_step_fused_kernel"),
                 "k3": ("extprod", "extprod_matmul", "extprod_matmul_kernel"),
                 "k2s": ("split_step", "split_step_fused", "split_step_kernel")}


def _profile(label: str, fn, gpu: str, top: int = 6, steps: int = 0):
    """Profile one call of ``fn`` (CUDA activity only) and print the device
    busy ms (the union of the kernels' spans), the device span, the idle
    share over the span, the kernel count and the costliest kernels.  The
    profiler's kernel records are read directly, without a trace file, so a
    run of ~10^5 kernels (a 64-bit bootstrap) takes seconds to summarize.
    The profiler can lose records: every profiled call launches hand
    kernels, so the profile counts as complete only when it kept one record
    of each kernel for every launch its wrapper counted in the call;
    otherwise it is reported as incomplete and nothing else is printed.
    Returns the kernel count and (total ns, count) by kernel name of a
    complete profile, else None."""
    import importlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    wrappers = {k: getattr(importlib.import_module(
        f"zig_tfhe_tpu_torch.ops.cuda.{mod}"), fn_name)
        for k, (mod, fn_name, _) in _HAND_KERNELS.items()}
    torch.cuda.synchronize()
    before = {k: w.launches for k, w in wrappers.items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launched = {k: w.launches - before[k] for k, w in wrappers.items()}
    spans, by_name = _kernel_records(prof)
    kept = {k: sum(c for nm, (_, c) in by_name.items() if sym in nm)
            for k, (_, _, sym) in _HAND_KERNELS.items()}
    if not sum(launched.values()) or kept != launched:
        print(f"{label}: the profiler kept {kept} hand-kernel records of the "
              f"launches {launched} counted in the call (records lost; "
              f"profile incomplete, idle share not measured)")
        return None
    per_step = f" ({len(spans) / steps:.1f} a step)" if steps else ""
    _print_kernels(label, spans, by_name, gpu, top,
                   f"{per_step}, hand-kernel records {kept} complete")
    return len(spans), by_name


def _kernel_records(prof):
    """The CUDA kernels a ``torch.profiler`` run recorded, read from its
    kernel records: their (start, end) spans in ns, and (total ns, count)
    by kernel name."""
    import torch

    spans, by_name = [], {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != torch.autograd.DeviceType.CUDA
                or e.name().startswith(("Memcpy", "Memset"))):
            continue
        s, d = e.start_ns(), e.duration_ns()
        spans.append((s, s + d))
        t, c = by_name.get(e.name(), (0, 0))
        by_name[e.name()] = (t + d, c + 1)
    return spans, by_name


def _print_kernels(label, spans, by_name, gpu, top, note=""):
    """Print the busy time (the union of the kernels' spans), the device
    span, the idle share over it, the kernel count and the costliest
    kernels."""
    spans = sorted(spans)
    busy, (cur_s, cur_e) = 0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(e for _, e in spans) - spans[0][0]
    print(f"{label} profile: busy {busy / 1e6:.1f} ms of {span / 1e6:.1f} ms "
          f"device span, idle share {1.0 - busy / span:.3f}, {len(spans)} "
          f"kernels{note} [{gpu}]")
    for nm, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"    {t / 1e6:9.2f} ms {c:7d}x  {nm[:70]}")


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


def _k2_bound_ms(plan, group: int, R: int, n_dl: int, B: int,
                 n_rot_rows: int, row_groups, single_add):
    """K2's least time: the digits' R * n_dl int8 limb planes, the key
    step, the rotations, the forward matrices and the psi rows this run
    gathers read once, v (int8 limb planes) written once; int8 MACs (2 ops
    each, every limb plane through both matrix limbs) against the
    tensor-core rate; and the CUDA-core stage counted instruction by
    instruction (_cuda_core_clocks): every Barrett (per limb plane the
    forward combine, 1 or 3 as ``single_add`` [P, n_dl] says; per row the
    n_dl - 1 Horner steps, each with a multiply-add), the int32
    multiply-adds of the pointwise sums (2 S R per (b, k, prime)) and the
    multiplies of the subset combine.  Returns the bound, then (for the
    printed line only) the L2 -> SM bytes a 64 x 128 tiling moves, the
    kernel's widest (every (prime, column tile) reads the digits, every row
    tile the matrices), and the CUDA-core time in ms."""
    P, N, S = plan.n_primes, plan.N, (1 << group) - 1
    d_bytes, m_bytes = B * R * n_dl * N, 2 * P * N * N
    v_bytes = P * B * 2 * 2 * N
    nbytes = (d_bytes + S * P * R * 2 * N * 2 + group * B * 4 + m_bytes
              + n_rot_rows * P * N * 2 + v_bytes)
    int8_ops = 2 * B * R * n_dl * N * N * 2 * P
    clocks = 0.0
    for rg, singles in zip(row_groups, single_add):
        ng = -(-R // rg)
        fwd = R * sum(1 if single else 3 for single in singles)
        horner = R * (n_dl - 1)
        if group == 2:
            pw, comb, mults = S * 2 * (ng + 1), 1 + 2 * 3, 1 + 2 * 3
        else:
            pw = S * 2 * (ng + max(0, ng - 2))
            comb, mults = (S - group) + 2 * (S + 1), (S - group) + 2 * S
        clocks += _cuda_core_clocks(fwd + horner + pw + comb,
                                    imad=S * 2 * R + mults + horner)
    t_cuda = clocks * B * N / (SMS * SM_HZ)
    tb = 64 // (R * n_dl)
    l2_bytes = (P * (N // 128) * d_bytes + -(-B // tb) * m_bytes + v_bytes)
    return _bound(nbytes / HBM_BPS, int8_ops / INT8_OPS, t_cuda) + (l2_bytes, t_cuda * 1e3)


def _k2s_bound_ms(plan, B: int, RL: int, n_rot_rows: int, rg: int):
    """K2s's least time (csrc/split_step.cu's header): the digits' RL int8
    half-rows, the key step [3, P, RL, 4, N], the rotations, the forward
    matrices and the rot rows this run gathers (and psi1's) read once, the
    int8 limb planes [P, B, 2, 2, 2, N] written once; int8 MACs (2 ops
    each, every half-row through both matrix limbs) against the
    tensor-core rate; and the CUDA-core stage per (b, k, prime), counted
    as _cuda_core_clocks counts: the forward reduce-then-combine (3
    Barretts and a multiply-add a half-row), the pointwise sums (4 planes x
    3 subsets: a multiply-add a half-row, a Barrett a row group and one on
    the sum), the subset pair (3 Barretts, 5 multiplies), the apply (per
    subset and component 3 Barretts, 5 multiplies) and 4 final Barretts.
    Returns the bound, then (for the printed line only) the L2 -> SM bytes
    of the 64 x 128 tiling (every tile reads its 64 digit rows over all N
    and its column tile of both matrices) and the CUDA-core time in ms."""
    P, N, S = plan.n_primes, plan.N, 3
    ng = -(-RL // rg)
    barretts = 3 * RL + S * 4 * (ng + 1) + 3 + S * 2 * 3 + 4
    imad = RL + S * 4 * RL + 5 + S * 2 * 5
    t_cuda = (P * _cuda_core_clocks(barretts, imad=imad) * B * N
              / (SMS * SM_HZ))
    d_bytes, m_bytes, v_bytes = B * RL * N, 2 * P * N * N, P * B * 8 * N
    nbytes = (d_bytes + S * P * RL * 4 * N * 2 + 2 * B * 4 + m_bytes
              + (n_rot_rows + 1) * P * N * 2 + v_bytes)
    int8_ops = 2 * B * RL * N * N * 2 * P
    row_tiles = -(-B // (64 // RL))
    l2_bytes = (P * (N // 128) * row_tiles * 64 * N + row_tiles * m_bytes
                + v_bytes)
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


# A bootstrap decides its output's sign by its combination's phase after the
# switch to [0, 2N); that rounding has std 2^-9.6 of the torus at 128 bits
# (docs/NOISE.md section 6), so a phase within 6 of those, 2^-7, of a
# decision boundary may come out either way.
PHASE_BAND = 2.0 ** -7

_TRUTH = {
    "nand": lambda p, q: not (p and q), "or": lambda p, q: p or q,
    "and": lambda p, q: p and q, "xor": lambda p, q: p != q,
    "xnor": lambda p, q: p == q, "nor": lambda p, q: not (p or q),
    "andny": lambda p, q: (not p) and q, "andyn": lambda p, q: p and not q,
    "orny": lambda p, q: (not p) or q, "oryn": lambda p, q: p or not q}


def _checked_run(plan, cts, ck, sk, out_ref):
    """Run ``plan`` again level by level (scheduler._run_level, the body of
    scheduler.evaluate), decrypting every lane, and check each gate of the
    card against what its input ciphertexts require:

      * every bootstrapped lane's output decrypts to the sign of its linear
        combination's phase (computed here, with the secret key, from the
        gate table), unless that phase lies within PHASE_BAND of a decision
        boundary;
      * NOT, COPY and CONST lanes are the exact tensor results;
      * the outputs are bit-equal to ``out_ref`` (the evaluate run).

    Returns the bootstrapped lanes checked, the lanes inside the band, the
    closest phase's distance to a boundary, and the lanes whose output is
    not the truth table of their inputs' decryptions (the scheme's noise
    failures: input noise moved the combination across a boundary), each
    as (level, lane, client, gate, input phases, combination phase,
    (ids, a, b) on the card)."""
    import numpy as np
    import torch

    from zig_tfhe_tpu_torch.models import gates, scheduler

    if any((lvl[:, 0] == scheduler.OP_MUX).any() for lvl in plan.levels):
        raise ValueError("_checked_run takes plans without MUX lanes")
    s0, n0 = sk.key_lv0, ck.params.n0
    dev = s0.device

    def phase(ct):
        return (ct[..., n0] - (ct[..., :n0] * s0).sum(-1).to(torch.int32)).long()

    def idx(col):
        return torch.from_numpy(col.astype(np.int64)).to(dev)

    ca = torch.tensor(gates._COEFF_A, device=dev)
    cb = torch.tensor(gates._COEFF_B, device=dev)
    bias = torch.tensor(gates._BIAS, device=dev)
    truth = torch.tensor([[[_TRUTH[n](p, q) for q in (False, True)]
                           for p in (False, True)] for n in gates.GATE_NAMES],
                         device=dev)
    batched = cts.dim() == 3
    inp = cts if batched else cts[:, None]
    B = inp.shape[1]
    arena = torch.zeros((plan.n_slots + 1, B, n0 + 1), dtype=torch.int32,
                        device=dev)
    arena[idx(plan.input_slots)] = inp
    lanes, in_band, closest, failures = 0, 0, 0.5, []
    for li, lvl in enumerate(plan.levels):
        op = lvl[:, 0]
        two = lvl[op < 100]
        if len(two):
            ids = idx(two[:, 0])
            a, b = arena[idx(two[:, 1])], arena[idx(two[:, 2])]
            combo = ca[ids, None, None] * a + cb[ids, None, None] * b
            combo[..., n0] += bias[ids, None]
            ph = phase(combo)
            pa, pb = phase(a), phase(b)
            want = truth[ids[:, None], (pa >= 0).long(), (pb >= 0).long()]
        un = {c: (lvl[op == c], arena[idx(lvl[op == c][:, 1])])
              for c in (scheduler.OP_NOT, scheduler.OP_COPY)}
        scheduler._run_level(arena, lvl, ck)
        if len(two):
            got = phase(arena[idx(two[:, 4])]) >= 0
            dist = torch.minimum(ph.abs(), (1 << 31) - ph.abs()).double() / 2**32
            bad = (got != (ph >= 0)) & (dist >= PHASE_BAND)
            _check(not bool(bad.any()),
                   f"level {li}: {int(bad.sum())} bootstrapped lanes decrypt "
                   f"against their combination's phase, outside the noise band")
            lanes += ph.numel()
            in_band += int((dist < PHASE_BAND).sum())
            closest = min(closest, float(dist.min()))
            for r, c in (got != want).nonzero().tolist():
                failures.append((li, r, c, gates.GATE_NAMES[two[r, 0]],
                                 (int(pa[r, c]) / 2**32, int(pb[r, c]) / 2**32),
                                 int(ph[r, c]) / 2**32,
                                 (ids[r:r + 1], a[r, c][None], b[r, c][None])))
        for c, (rows, src) in un.items():
            if len(rows):
                want_t = -src if c == scheduler.OP_NOT else src
                _check(torch.equal(arena[idx(rows[:, 4])], want_t),
                       f"level {li}: NOT/COPY lanes are not exact")
        for c, value in ((scheduler.OP_CONST0, False), (scheduler.OP_CONST1, True)):
            rows = lvl[op == c]
            if len(rows):
                _check(torch.equal(arena[idx(rows[:, 4])],
                                   gates.constant(value, ck.params,
                                                  (len(rows), B), device=dev)),
                       f"level {li}: CONST lanes are not exact")
    outs = arena[idx(plan.output_slots)]
    _check(torch.equal(outs if batched else outs[:, 0], out_ref),
           "the level-by-level run differs from scheduler.evaluate's")
    return lanes, in_band, closest, failures


def _counted_run(counters, name, fn, expect):
    """Run ``fn`` once with every launch count set to 0 just before and read
    just after; fail unless the counts are ``expect`` (a kernel it does not
    name: 0).  Returns (output, counts, host seconds)."""
    import torch

    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {k: c.launches for k, c in counters.items()}
    expect = {k: expect.get(k, 0) for k in counters}
    _check(counts == expect, f"{name}: launches {counts}, expected {expect}")
    return out, counts, dt


def _on_cpu(ck):
    """The cloud key's copy on the CPU (the port's CPU path runs the plain
    versions of the kernels)."""
    from zig_tfhe_tpu_torch import key

    return key.CloudKey.from_numpy(
        {n: t.cpu().numpy() for n, t in ck.named_buffers()}, ck.params,
        bsk_ntt_drop=ck.bsk_ntt_drop, bsk_group=ck.bsk_group,
        bsk_levels=ck.bsk_levels, bsk_bgbit=ck.bsk_bgbit,
        pksk_gadget=ck.pksk_gadget, device="cpu")


def _circuit_phase(P, g, sk, ck, ck_toep, counters, gpu) -> dict:
    """Phase 8: the circuit path on the card (see the module docstring).
    Returns each run's launch counts by kernel."""
    import numpy as np
    import torch

    from zig_tfhe_tpu_torch import tlwe
    from zig_tfhe_tpu_torch.models import circuits, gates, netlists, scheduler
    from zig_tfhe_tpu_torch.utils import serialization

    dev = sk.key_lv0.device
    W = 64
    t0 = time.perf_counter()
    text = netlists.bristol_multiplier(W)
    plan = scheduler.parse_bristol(text)
    boot = [int(((lvl[:, 0] < 100) | (lvl[:, 0] == scheduler.OP_MUX)).sum())
            for lvl in plan.levels]
    stats = (plan.n_gates, sum(boot), plan.n_levels, plan.n_slots, max(boot))
    _check(stats == (26931, 26803, 43, 5908, 2048),
           f"the 64x64 plan is (gates, bootstrapped, levels, slots, widest) "
           f"{stats}")
    boot_levels = sum(1 for n in boot if n)
    steps = -(-P.n0 // ck.bsk_group)
    print(f"circuit: Bristol {W}x{W} multiplier, {plan.n_gates} gates "
          f"({sum(boot)} bootstrapped) in {plan.n_levels} levels "
          f"({boot_levels} with a bootstrapped lane), {plan.n_slots} arena "
          f"slots, widest level {max(boot)}; netlist + native build + "
          f"schedule {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(64)
    pairs = [tuple(int(v) for v in rng.integers(0, 1 << 64, 2, dtype=np.uint64))
             for _ in range(4)]
    in_bits = [[(a >> i) & 1 for i in range(W)] + [(b >> i) & 1 for i in range(W)]
               for a, b in pairs]
    cts = tlwe.encrypt_bool(g, torch.tensor(in_bits, dtype=torch.bool,
                                            device=dev).T,
                            P.ksk_alpha, sk.key_lv0)        # [128, 4, n0+1]

    def run(name, fn, expect):
        return _counted_run(counters, name, fn, expect)

    def products(out):
        dec = tlwe.decrypt_bool(out, sk.key_lv0).cpu().numpy()
        return dec, [sum(int(v) << i for i, v in enumerate(col))
                     for col in dec.reshape(2 * W, -1).T]

    expect = {"k1": steps * boot_levels, "k2": steps * boot_levels, "k3": 0}
    launches = {}
    ck_cpu = _on_cpu(ck)
    ct1 = cts[:, 0].contiguous()
    exact, total, outs = 0, 0, {}
    for B, inp in ((1, ct1), (4, cts)):
        name = f"circuit_b{B}"
        out, launches[name], first = run(
            f"64x64 B={B}", lambda inp=inp: scheduler.evaluate(plan, inp, ck),
            expect)
        _check(out.dtype == torch.int32
               and tuple(out.shape) == (2 * W, *inp.shape[1:-1], P.n0 + 1),
               f"product output {out.dtype} {tuple(out.shape)}")
        outs[B] = out
        t0 = time.perf_counter()
        lanes, in_band, closest, failures = _checked_run(plan, inp, ck, sk, out)
        dec, prods = products(out)
        dec = dec.reshape(2 * W, B)
        ok = [p == x * y for p, (x, y) in zip(prods, pairs)]
        for j in range(B):
            failed = [f for f in failures if f[2] == j]
            if not failed:
                _check(ok[j] and dec[:, j].astype(int).tolist()
                       == netlists.eval_bristol_plain(text, in_bits[j]),
                       f"64x64 B={B} client {j}: every gate follows its inputs "
                       f"but the bits differ from eval_bristol_plain")
        exact, total = exact + sum(ok), total + B
        print(f"circuit 64x64 B={B}: first run {first:.2f} s, launches "
              f"{launches[name]} = {steps} x {boot_levels} levels; exact "
              f"products {sum(ok)}/{B}; {lanes} bootstrapped lanes checked "
              f"level by level ({time.perf_counter() - t0:.1f} s): each "
              f"decrypts to the sign of its combination's phase "
              f"({in_band} within 2^-7 of a boundary, closest "
              f"{closest:.5f}); {len(failures)} gate outputs differ from the "
              f"truth table of their inputs' decryptions")
        for li, r, c, gname, (pa, pb), ph, lane in failures[:4]:
            print(f"  input-noise failure: level {li} lane {r} client {c} "
                  f"{gname}, input phases {pa:+.5f} {pb:+.5f}, combination "
                  f"{ph:+.5f}")
        if failures:
            # the first failing gate again, alone, on the card and on the CPU
            li, r, c, gname, _, _, (ids, a, b) = failures[0]
            card = gates.apply_gates(ids, a, b, ck)
            cpu = gates.apply_gates(ids.cpu(), a.cpu(), b.cpu(), ck_cpu)
            _check(torch.equal(card.cpu(), cpu),
                   f"64x64 B={B}: the failing gate's card output differs "
                   f"from the port's CPU path")
            print(f"  level {li} lane {r} client {c} {gname} alone: card == "
                  f"the CPU path (the plain versions), output decrypts to "
                  f"{bool(tlwe.decrypt_bool(cpu, sk.key_lv0.cpu())[0])}")
    print(f"circuit 64x64: exact products {exact}/{total} [{gpu}]")
    for B, inp in ((1, ct1), (4, cts)):
        ms = _cuda_ms(lambda inp=inp: scheduler.evaluate(plan, inp, ck), 1)
        print(f"circuit 64x64 B={B}: {ms:.1f} ms per product set, "
              f"{plan.n_gates * B / (ms / 1e3):.1f} circuit gates/s "
              f"({sum(boot) * B / (ms / 1e3):.1f} bootstrapped gates/s), "
              f"{ms / plan.n_levels:.1f} ms per level [{gpu}]")
    _profile("circuit 64x64 B=1", lambda: scheduler.evaluate(plan, ct1, ck),
             gpu)

    # the small adders of models/circuits.py
    x = circuits.encrypt_bits(g, 402, 16, sk, P)
    y = circuits.encrypt_bits(g, 304, 16, sk, P)
    s, _ = circuits.kogge_stone_add(x, y, ck)
    _check(circuits.decrypt_bits(s, sk) == 706, "kogge_stone_add 402 + 304")
    u, v = (int(t) for t in rng.integers(0, 16, 2))
    s, c = circuits.ripple_carry_add(
        circuits.encrypt_bits(g, u, 4, sk, P), circuits.encrypt_bits(g, v, 4, sk, P),
        gates.constant(False, P, (1,), device=dev), ck)
    total = circuits.decrypt_bits(s, sk) + 16 * circuits.decrypt_bits(c, sk)
    _check(total == u + v, f"ripple_carry_add {u} + {v} gave {total}")
    print(f"circuits: kogge_stone_add 402 + 304 = 706 (16 bits), "
          f"ripple_carry_add {u} + {v} = {total} (4 bits)")

    # a scheduler-built full adder: card vs the CPU path (g3), and on toep
    fa = scheduler.Circuit()
    fa_in = [fa.input() for _ in range(3)]
    xo, an = fa.gate("xor", fa_in[0], fa_in[1]), fa.gate("and", fa_in[0], fa_in[1])
    fa.output(fa.gate("xor", xo, fa_in[2]))
    fa.output(fa.gate("or", an, fa.gate("and", xo, fa_in[2])))
    fa_plan = fa.schedule()
    combos = np.array([(i >> 2 & 1, i >> 1 & 1, i & 1) for i in range(8)]).T
    fa_cts = tlwe.encrypt_bool(g, torch.from_numpy(combos.astype(bool)).to(dev),
                               P.ksk_alpha, sk.key_lv0)     # [3, 8, n0+1]
    want = np.stack([combos.sum(0) % 2, combos.sum(0) // 2]).astype(bool)
    fa1 = fa_cts[:, 5].contiguous()
    out, launches["full_adder_g3"], _ = run(
        "full adder g3", lambda: scheduler.evaluate(fa_plan, fa1, ck),
        {"k1": 3 * steps, "k2": 3 * steps, "k3": 0})
    t0 = time.perf_counter()
    cpu = scheduler.evaluate(fa_plan, fa1.cpu(), ck_cpu)
    _check(torch.equal(out.cpu(), cpu),
           "full adder: card outputs differ from the port's CPU path")
    _check(tlwe.decrypt_bool(out, sk.key_lv0).cpu().tolist() == want[:, 5].tolist(),
           "full adder g3: wrong sum or carry")
    out, launches["full_adder_toep"], _ = run(
        "full adder toep", lambda: scheduler.evaluate(fa_plan, fa_cts, ck_toep),
        {"k1": 0, "k2": 0, "k3": 3 * P.n0})
    _check(np.array_equal(tlwe.decrypt_bool(out, sk.key_lv0).cpu().numpy(),
                          want), "full adder toep: wrong sums or carries")
    print(f"full adder: card == CPU path on g3 ({time.perf_counter() - t0:.1f} "
          f"s on the host), all 8 inputs exact on toep, launches "
          f"{launches['full_adder_g3']} / {launches['full_adder_toep']}")

    # save and load: the g3 key and the product's ciphertext
    with tempfile.TemporaryDirectory() as d:
        serialization.save_cloud_key(os.path.join(d, "ck"), ck)
        ck2 = serialization.load_cloud_key(os.path.join(d, "ck"), device=dev)
        pair = (("nand", "xor"), (cts[0], cts[1]), (cts[64], cts[65]))
        _check(torch.equal(gates.gate_pair(*pair, ck),
                           gates.gate_pair(*pair, ck2)),
               "gate_pair on the reloaded g3 key differs")
        serialization.save_ciphertext(os.path.join(d, "ct"), outs[4], P)
        back, p2 = serialization.load_ciphertext(os.path.join(d, "ct"), device=dev)
        _check(p2 is P and torch.equal(back, outs[4]),
               "the product's ciphertext did not round-trip")
    print("serialization: g3 key saved and loaded, gate_pair bit-equal; "
          "product ciphertext round-trips bit-equal")
    return launches


# -- phase 9: the LUT path on the uint sets ------------------------------------

LUT_LANES = 2048       # bootstrap_lut and bootstrap_multi_lut on uint4
RADIX_LANES = 512      # bootstrap_lut_radix on uint8 (m = 256)
BIVARIATE_LANES = 256  # bootstrap_lut_bivariate on uint4
CPU_LUT_LANES = 16     # lanes held bit-equal to the port's CPU path
CPU_RADIX_LANES = 8


def _lut_f(x):
    return (7 * x + 3) % 16


def _radix_f(x):
    return (5 * x + 1) % 256


def _bivariate_f(x, y):
    return x * y + 1


def _ms_phase(ct, s, P):
    """The rotation a blind rotation applies to its test vector: k = b~ -
    <a~, s> mod 2N, from the modswitched mask a~ and body b~ (the same
    ``modswitch`` the rotation rounds them with); the rotated test vector's
    coefficient 0 is tv[k] for k < N, -tv[k - N] above."""
    import torch

    from zig_tfhe_tpu_torch.ops.decomposition import modswitch

    n0 = P.n0
    ta = modswitch(ct[..., :n0], P).long()
    tb = modswitch(ct[..., n0], P).long()
    return (tb - (ta * s.long()).sum(-1)) % (2 * P.N)


def _tv_at(body, k, N: int):
    """Coefficient 0 of X^-k times a trivial test vector of body ``body``
    (int32 [N], or [T, N] for T tables at once)."""
    import torch

    v = body[..., k % N]
    return torch.where(k < N, v, -v)


def _decode(value, m: int, width: int = 32):
    """The message a noiseless torus value decrypts to (tlwe.decrypt_message's
    rounding)."""
    import torch

    if width == 64:
        f = value.double()
        f = torch.where(value < 0, f + 2.0 ** 64, f) / 2.0 ** 64
    else:
        f = (value.long() & 0xFFFFFFFF).double() / float(1 << 32)
    return torch.floor(f * (2 * m) + 0.5).long() % m


def _bin(k, m: int, N: int):
    """The message bin of modulus m a modswitched phase k falls in (the
    codec's bins of width N/m centred on x N/m; m..2m-1: the negated half)."""
    return ((k + N // (2 * m)) % (2 * N)) // (N // m)


def _lut_phase(g, uint_keys, counters, gpu) -> dict:
    """Phase 9: the LUT path on SECURITY_UINT4 and SECURITY_UINT8 (see the
    module docstring).  Returns each run's launch counts by kernel."""
    import numpy as np
    import torch

    from zig_tfhe_tpu_torch.models import lut
    from zig_tfhe_tpu_torch.ops import ntt
    from zig_tfhe_tpu_torch.ops.decomposition import (decompose_rows,
                                                      digit_planes, row_gadget)
    from zig_tfhe_tpu_torch.ops.cuda import ntt_inverse as k1
    from zig_tfhe_tpu_torch.ops.cuda import ntt_step as k2

    (sk4, ck4), (sk8, ck8) = uint_keys["uint4"], uint_keys["uint8"]
    P4, P8 = ck4.params, ck8.params
    N = P4.N
    s4, s8 = sk4.key_lv0, sk8.key_lv0
    dev = s4.device
    steps4, steps8 = ck4.bsk_ntt.shape[0], ck8.bsk_ntt.shape[0]
    launches = {}

    def expect(n_rotations, steps):
        return {"k1": n_rotations * steps, "k2": n_rotations * steps, "k3": 0}

    ck4_cpu = _on_cpu(ck4)

    # -- bootstrap_lut, m = 16, lanes cycling all 16 messages ----------------
    m = 16
    gen = lut.Generator.new(m, P4)
    table = gen.generate_lookup_table(_lut_f)
    msgs = torch.arange(LUT_LANES, device=dev) % m
    ct = lut.encrypt_message(g, msgs, m, P4.tlwe_lv0.alpha, s4)
    digit_launches = k1.ntt_inverse_to_crt_acc.digit_launches
    shapes = (k2.ntt_step_fused.shape_launches,
              k2.ntt_step_fused.uint_shape_launches)
    out, launches["uint4"], first = _counted_run(
        counters, "uint4 bootstrap_lut", lambda: lut.bootstrap_lut(ct, table, ck4),
        expect(1, steps4))
    digit_launches = k1.ntt_inverse_to_crt_acc.digit_launches - digit_launches
    _check(digit_launches == steps4 - 1, f"uint4 bootstrap_lut: "
           f"{digit_launches} K1 launches wrote the next limb planes, "
           f"expected {steps4 - 1}")
    # every step on K2's instance compiled at the uint keys' shape
    shapes = (k2.ntt_step_fused.shape_launches - shapes[0],
              k2.ntt_step_fused.uint_shape_launches - shapes[1])
    _check(shapes == (0, steps4), f"uint4 bootstrap_lut: K2 shape_launches, "
           f"uint_shape_launches {shapes}, expected (0, {steps4})")
    _check(out.dtype == torch.int32 and tuple(out.shape) == (LUT_LANES, P4.n0 + 1),
           f"bootstrap_lut output {out.dtype} {tuple(out.shape)}")
    k = _ms_phase(ct, s4, P4)
    got = lut.decrypt_message(out, m, s4).long()
    want = _decode(_tv_at(torch.from_numpy(table.poly[1]).to(dev), k, N), m)
    _check(torch.equal(got, want), f"uint4 bootstrap_lut: "
           f"{int((got != want).sum())} lanes do not decrypt to f of the bin "
           f"of their modswitched input phase")
    truth = _lut_f(msgs)
    accuracy = float((got == truth).double().mean())
    off_bin = int((_bin(k, m, N) != msgs).sum())
    t0 = time.perf_counter()
    cpu = lut.bootstrap_lut(ct[:CPU_LUT_LANES].cpu(), table, ck4_cpu)
    _check(torch.equal(cpu, out[:CPU_LUT_LANES].cpu()),
           "uint4 bootstrap_lut: card lanes differ from the port's CPU path")
    print(f"uint4 bootstrap_lut B={LUT_LANES} m={m} f(x) = (7x + 3) mod 16: "
          f"every lane decrypts to f of its modswitched phase's bin; accuracy "
          f"against the messages {accuracy} ({off_bin} inputs modswitched out "
          f"of their bin); launches {launches['uint4']}, {digit_launches} "
          f"K1 launches writing the next limb planes, "
          f"ntt_step_fused.shape_launches {shapes[0]}, "
          f"ntt_step_fused.uint_shape_launches {shapes[1]}; first call "
          f"{first:.2f} s; first {CPU_LUT_LANES} lanes bit-equal to the CPU "
          f"path ({time.perf_counter() - t0:.1f} s on the host)")

    # -- bootstrap_multi_lut: mod 8 and div 8 from one rotation --------------
    fs = (lambda x: x % 8, lambda x: x // 8)
    tables = [gen.generate_lookup_table(f) for f in fs]
    outs, launches["uint4_multi_lut"], _ = _counted_run(
        counters, "uint4 bootstrap_multi_lut",
        lambda: lut.bootstrap_multi_lut(ct, tables, m, ck4), expect(1, steps4))
    _check(tuple(outs.shape) == (2, LUT_LANES, P4.n0 + 1),
           f"bootstrap_multi_lut output {tuple(outs.shape)}")
    multi_acc = []
    for t, f, o in zip(tables, fs, outs):
        got_t = lut.decrypt_message(o, m, s4).long()
        want_t = _decode(_tv_at(torch.from_numpy(t.poly[1]).to(dev), k, N), m)
        _check(torch.equal(got_t, want_t), "uint4 bootstrap_multi_lut: lanes "
               "do not decrypt to f of their modswitched phase's bin")
        multi_acc.append(float((got_t == f(msgs)).double().mean()))
    print(f"uint4 bootstrap_multi_lut B={LUT_LANES} (x mod 8, x div 8): every "
          f"lane right against its modswitched phase; accuracy {multi_acc}; "
          f"launches {launches['uint4_multi_lut']}")

    # -- bootstrap_lut_radix on uint8, m = 256: two rotations ---------------
    M = 256
    x8 = torch.arange(RADIX_LANES, device=dev) * 37 % M
    lo, hi = lut.encrypt_radix_message(g, x8, M, P8.tlwe_lv0.alpha, s8)
    (olo, ohi), launches["uint8_radix"], first = _counted_run(
        counters, "uint8 bootstrap_lut_radix",
        lambda: lut.bootstrap_lut_radix(lo, hi, _radix_f, M, ck8, ck8.pksk),
        expect(2, steps8))
    dec = lut.decrypt_radix_message((olo, ohi), M, s8).long()
    ok = dec == _radix_f(x8)
    radix_acc = float(ok.double().mean())
    in_bins = ((_bin(_ms_phase(lo, s8, P8), 16, N) == x8 % 16)
               & (_bin(_ms_phase(hi, s8, P8), M // 16, N) == x8 // 16))
    _check(bool(ok[in_bins].all()), f"uint8 radix: "
           f"{int((~ok & in_bins).sum())} lanes whose digits stay in their "
           f"bins after the modswitch are wrong")
    _check(radix_acc >= 0.95, f"uint8 radix accuracy {radix_acc} < 0.95")
    ck8_cpu = _on_cpu(ck8)
    t0 = time.perf_counter()
    c_lo, c_hi = lut.bootstrap_lut_radix(lo[:CPU_RADIX_LANES].cpu(),
                                         hi[:CPU_RADIX_LANES].cpu(), _radix_f,
                                         M, ck8_cpu, ck8_cpu.pksk)
    _check(torch.equal(c_lo, olo[:CPU_RADIX_LANES].cpu())
           and torch.equal(c_hi, ohi[:CPU_RADIX_LANES].cpu()),
           "uint8 radix: card lanes differ from the port's CPU path")
    print(f"uint8 bootstrap_lut_radix B={RADIX_LANES} m={M} f(x) = (5x + 1) "
          f"mod 256: accuracy {radix_acc} ({int(in_bins.sum())} lanes with "
          f"both digits in their bins, all exact); launches "
          f"{launches['uint8_radix']}; first call {first:.2f} s; first "
          f"{CPU_RADIX_LANES} lanes bit-equal to the CPU path "
          f"({time.perf_counter() - t0:.1f} s on the host)")

    # -- bootstrap_lut_bivariate on uint4: x * y + 1 mod 16 -------------------
    nb = BIVARIATE_LANES
    xb = torch.arange(nb, device=dev) % 16
    yb = torch.arange(nb, device=dev) // 16 % 16
    cx = lut.encrypt_message(g, xb, 16, P4.tlwe_lv0.alpha, s4)
    cy = lut.encrypt_message(g, yb, 16, P4.tlwe_lv0.alpha, s4)
    ob, launches["uint4_bivariate"], _ = _counted_run(
        counters, "uint4 bootstrap_lut_bivariate",
        lambda: lut.bootstrap_lut_bivariate(cx, cy, _bivariate_f, ck4, ck4.pksk),
        expect(2, steps4))
    got_b = lut.decrypt_message(ob, 16, s4).long()
    # the mid layer's candidates: table h at x's phase; the select picks the
    # block of y's phase (a negated block in the upper half)
    tvs = torch.from_numpy(np.stack([gen.generate_lookup_table(
        lambda v, h=h: _bivariate_f(v, h) % 16).poly[1] for h in range(16)])).to(dev)
    cand = _tv_at(tvs, _ms_phase(cx, s4, P4), N)               # [16, B]
    blk = _bin(_ms_phase(cy, s4, P4), 16, N)
    val = cand.gather(0, (blk % 16)[None])[0]
    want_b = _decode(torch.where(blk < 16, val, -val), 16)
    _check(torch.equal(got_b, want_b), "uint4 bivariate: lanes do not decrypt "
           "to f2 of their modswitched phases' bins")
    biv_acc = float((got_b == _bivariate_f(xb, yb) % 16).double().mean())
    print(f"uint4 bootstrap_lut_bivariate B={nb} f2(x, y) = xy + 1 mod 16: "
          f"every lane right against both modswitched phases; accuracy "
          f"{biv_acc}; launches {launches['uint4_bivariate']}")

    # -- timings ---------------------------------------------------------------
    lut_ms = _cuda_ms(lambda: lut.bootstrap_lut(ct, table, ck4), WARM_ITERS)
    one = ct[:1]
    lut.bootstrap_lut(one, table, ck4)
    lat_ms = _cuda_ms(lambda: lut.bootstrap_lut(one, table, ck4), WARM_ITERS)
    multi_ms = _cuda_ms(lambda: lut.bootstrap_multi_lut(ct, tables, m, ck4), 1)
    radix_ms = _cuda_ms(lambda: lut.bootstrap_lut_radix(
        lo, hi, _radix_f, M, ck8, ck8.pksk), 1)
    biv_ms = _cuda_ms(lambda: lut.bootstrap_lut_bivariate(
        cx, cy, _bivariate_f, ck4, ck4.pksk), 1)
    print(f"uint4: LUT/s at B={LUT_LANES}: {LUT_LANES / (lut_ms / 1e3):.1f} "
          f"({lut_ms:.1f} ms/batch); latency at B=1: {lat_ms:.1f} ms; "
          f"multi-LUT {2 * LUT_LANES / (multi_ms / 1e3):.1f} LUT/s "
          f"({multi_ms:.1f} ms for 2 x {LUT_LANES}); bivariate "
          f"{nb / (biv_ms / 1e3):.1f} evals/s ({biv_ms:.1f} ms at B={nb}) [{gpu}]")
    print(f"uint8: radix m=256 {RADIX_LANES / (radix_ms / 1e3):.1f} evals/s "
          f"({radix_ms:.1f} ms at B={RADIX_LANES}) [{gpu}]")
    e, levels = ck4.bsk_bgbit, ck4.bsk_levels
    n_dl = ntt.engine_digit_limbs(e)
    plan = ntt.plan_for_params(P4, ck4.bsk_ntt_drop, 2, levels, bgbit=e,
                               pseudorandom_key=True)
    acc = torch.randint(-2**31, 2**31, (LUT_LANES, 2, N), generator=g,
                        device=dev, dtype=torch.int64).to(torch.int32)
    rows = decompose_rows(acc, P4, levels, bgbit=e)
    planes = digit_planes(rows, n_dl)
    ts = torch.randint(0, 2 * N, (2, LUT_LANES), generator=g, device=dev,
                       dtype=torch.int64).to(torch.int32)
    v = k2.ntt_step_fused(planes, ck4.bsk_ntt[0], ts, plan, e)
    gadget = row_gadget(P4, levels, e)
    nxt = torch.empty_like(planes)
    stage = {"K2": lambda: k2.ntt_step_fused(planes, ck4.bsk_ntt[0], ts, plan, e),
             "K1 with the next limb planes": lambda: k1.ntt_inverse_to_crt_acc(
                 v, acc, plan, ck4.bsk_ntt_drop, digits=nxt, gadget=gadget)}
    split = {name: _cuda_ms(fn, KERNEL_ITERS) for name, fn in stage.items()}
    print(f"uint4: one step at B={LUT_LANES}: " + ", ".join(
        f"{name} {t * 1e3:.1f} us" for name, t in split.items())
        + f" (sum {sum(split.values()) * 1e3:.1f} us) [{gpu}]")
    for lanes in (LUT_LANES, 1):
        _profile(f"uint4 bootstrap_lut B={lanes}",
                 lambda n=lanes: lut.bootstrap_lut(ct[:n], table, ck4), gpu)
    return launches


# -- phase 10: the integer layer on SECURITY_UINT4 -----------------------------

INT_LANES = 256        # the five ops of bench_integer.py, 6-bit operands
INT_SMALL_LANES = 64   # FheInt and the gates bridge
CPU_INT_LANES = 4      # lanes of add and lt held bit-equal to the CPU path
# blind rotations per op at 2 digits (tests/test_torch_integer.py and
# tests/test_torch_integer_signed.py pin them); K1 = K2 = 410 x these
INT_ROTATIONS = {"mul": 18, "add": 2, "div": 32, "lt": 2, "eq": 2,
                 "mul_classic": 24, "int_add": 2, "int_sub": 2, "int_lt": 3,
                 "int_asr2": 2, "int_asr_enc": 10, "int_abs": 7,
                 "int_div_rem": 55, "bridge": 7}
# radix_divmod at SECURITY_UINT4 misses a lane where its reassembly input
# b0 + 2 b1 + 4 b2 leaves its bin.  Measured with tools/torch_integer_noise.py
# (1,024 lanes, the port's key and a JAX-made one): 30 and 45 such lanes,
# the inputs' noise std 0.187 and 0.194 message units.  A fault that raises
# the noise (a key's alpha, a table's scale) shows above these bounds:
DIV_MISS_RATE = 45 / 1024     # the highest rate measured
DIV_MISS_SIGMAS = 4.5         # allowed above it, in binomial std
DIV_NOISE_STD_MAX = 0.25      # message units; ~1.3x the highest measured


def _ripple_adder_plan(bits: int):
    """A ``bits``-bit ripple-carry adder built with scheduler.Circuit."""
    from zig_tfhe_tpu_torch.models import scheduler

    c = scheduler.Circuit()
    a_bits = [c.input() for _ in range(bits)]
    b_bits = [c.input() for _ in range(bits)]
    carry = None
    for i in range(bits):
        s1 = c.gate("xor", a_bits[i], b_bits[i])
        gg = c.gate("and", a_bits[i], b_bits[i])
        if carry is None:
            c.output(s1)
            carry = gg
        else:
            c.output(c.gate("xor", s1, carry))
            carry = c.gate("or", gg, c.gate("and", s1, carry))
    c.output(carry)
    return c.schedule()


def _exact(name: str, got, want) -> None:
    """Fail unless every lane of ``got`` equals ``want``, naming the first
    wrong lane and both values."""
    import numpy as np

    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    bad = np.nonzero(got != want)[0]
    if len(bad):
        raise RuntimeError(
            f"chip_smoke: integer {name}: {len(bad)} of {len(got)} lanes "
            f"wrong; lane {bad[0]}: got {got[bad[0]]}, want {want[bad[0]]}")


class _DivmodProbe:
    """Inside ``with``: records, for every radix_divmod that runs, what
    passes through the PBS helpers of models/integer.py -- each trial
    subtraction's quotient bit (the div lane of its last multi-value
    rotation, which is the bit itself) and the final reassembly rotation's
    input (b0 + 2 b1 + 4 b2 per quotient digit) and output."""

    def __init__(self, integer):
        self.integer = integer
        self.q_bits, self.final = [], []

    def __enter__(self):
        I = self.integer
        self._mv, self._rows = I._pbs_mv, I._pbs_rows

        def mv(ct, names, ck):
            out = self._mv(ct, names, ck)
            if tuple(names) == ("mod", "div", "div8"):
                self.q_bits.append(out[1])
            return out

        def rows(r, names, ck):
            out = self._rows(r, names, ck)
            if set(names) == {"mod"}:
                self.final.append((r, out))
            return out

        I._pbs_mv, I._pbs_rows = mv, rows
        return self

    def __exit__(self, *exc):
        self.integer._pbs_mv, self.integer._pbs_rows = self._mv, self._rows


def _reassembly_noise(rows_in, q_true, s):
    """The phase error of radix_divmod's reassembly inputs rows_in [2, B,
    n0+1] (b0 + 2 b1 + 4 b2 per quotient digit) against the true digits of
    q_true [B], in message units (1/32 of the torus; 0.5 is the bin
    edge): float64 [2, B]."""
    import numpy as np
    import torch

    from zig_tfhe_tpu_torch import tlwe

    digits = torch.from_numpy(np.stack([q_true & 7, q_true >> 3])).to(s.device)
    ph = tlwe.phase(rows_in, s).double() / 2**32 * 32
    return (ph - digits.double() + 16) % 32 - 16


def _check_divmod(name, probe, q_true, s, P, ck_cpu):
    """The checks of a radix_divmod on 2-digit operands (bb = 3, Dn = 2)
    that a miss of its quotient can be traced through:

      * every quotient bit the loop produced decrypts to the true bit;
      * the reassembly rotation's output decrypts, on every lane, to the
        mod table at its input's modswitched phase (exact);
      * its wrong digits are exactly those whose input b0 + 2 b1 + 4 b2
        left the true digit's bin: the sum's noise (the scheme's: the
        JAX package, bit-equal, computes the same); the first 4 such
        lanes' reassembly equals the port's CPU path bit for bit;
      * that noise stays within what was measured: its std at most
        DIV_NOISE_STD_MAX, and no more crossed lanes than DIV_MISS_RATE
        gives plus DIV_MISS_SIGMAS binomial std.

    Returns the lanes with a noise-crossed quotient digit (bool [B]) and
    the reassembly inputs' noise std (message units)."""
    import numpy as np
    import torch

    from zig_tfhe_tpu_torch import tlwe
    from zig_tfhe_tpu_torch.models import integer

    N = P.N
    bits = torch.stack(probe.q_bits[::-1])          # bit i at row i
    _check(len(probe.q_bits) == 6 and len(probe.final) == 1,
           f"{name}: the divmod probe saw {len(probe.q_bits)} quotient bits "
           f"and {len(probe.final)} reassembly rotations")
    want_bits = (q_true[None] >> np.arange(6)[:, None]) & 1
    _exact(f"{name} quotient bits", tlwe.decrypt_message(bits, 16, s).cpu(),
           want_bits)
    rows_in, out = probe.final[0]                   # [Dn, B, n0+1]
    k = _ms_phase(rows_in, s, P)
    body = torch.from_numpy(integer._luts(P)["mod"].poly[1]).to(s.device)
    got = tlwe.decrypt_message(out, 16, s).long()
    _check(torch.equal(got, _decode(_tv_at(body, k, N), 16)),
           f"{name}: the reassembly rotation's output is not the mod table "
           f"at its input's modswitched phase")
    digits = torch.from_numpy(np.stack([q_true & 7, q_true >> 3])).to(s.device)
    crossed = _bin(k, 16, N) != digits
    _check(torch.equal(got != digits, crossed),
           f"{name}: a quotient digit is wrong although its input stayed in "
           f"its bin")
    lanes = torch.nonzero(crossed.any(0)).flatten()[:4]
    if len(lanes):
        cpu = integer._pbs_rows(rows_in[:, lanes].cpu(), ("mod", "mod"), ck_cpu)
        _check(torch.equal(cpu, out[:, lanes].cpu()),
               f"{name}: the reassembly of a noise-crossed lane differs from "
               f"the port's CPU path")
    B = len(q_true)
    most = math.ceil(B * DIV_MISS_RATE + DIV_MISS_SIGMAS * math.sqrt(
        B * DIV_MISS_RATE * (1 - DIV_MISS_RATE)))
    n_crossed = int(crossed.any(0).sum())
    _check(n_crossed <= most,
           f"{name}: {n_crossed} of {B} quotients noise-crossed, more than "
           f"the {most} the measured rate allows")
    std = float(_reassembly_noise(rows_in, q_true, s).std())
    _check(std <= DIV_NOISE_STD_MAX,
           f"{name}: reassembly inputs' noise std {std:.3f} message units "
           f"above {DIV_NOISE_STD_MAX}")
    return crossed.any(0).cpu().numpy(), std


def _integer_phase(g, uint_keys, counters, gpu) -> dict:
    """Phase 10: the integer layer on SECURITY_UINT4 (see the module
    docstring).  Returns each op's launch counts by kernel."""
    import numpy as np
    import torch

    from zig_tfhe_tpu_torch import key
    from zig_tfhe_tpu_torch.models import integer, scheduler

    sk4, ck4 = uint_keys["uint4"]
    P4 = ck4.params
    s4 = sk4.key_lv0
    steps = ck4.bsk_ntt.shape[0]
    alpha = P4.tlwe_lv0.alpha
    launches, first_s, peak_mb = {}, {}, {}
    t_phase = time.perf_counter()
    wall = {"CPU-path checks": 0.0, "classic key": 0.0, "timings": 0.0}

    def run(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        n = INT_ROTATIONS[name] * steps
        out, launches[name], first_s[name] = _counted_run(
            counters, f"integer {name}", fn, {"k1": n, "k2": n, "k3": 0})
        peak = torch.cuda.max_memory_allocated()
        peak_mb[name] = (peak / 2**20, (peak - before) / 2**20)
        return out

    def dec(ct):
        return integer.decrypt_radix(ct if ct.dim() == 3 else ct[:, None], s4)

    # -- the five ops of bench_integer.py at B = 256 ---------------------------
    rng = np.random.default_rng(2026)
    a, b = rng.integers(0, 64, (2, INT_LANES))
    b_eq = np.where(np.arange(INT_LANES) < INT_LANES // 2, a, b)
    b_div = rng.integers(1, 64, INT_LANES)
    ca, cb, ce, cd = (integer.encrypt_radix(g, v, 2, alpha, s4)
                      for v in (a, b, b_eq, b_div))
    ops = {
        "mul": lambda: integer.radix_mul(ca, cb, ck4),
        "add": lambda: integer.radix_add(ca, cb, ck4)[..., :2, :],
        "div": lambda: integer.radix_divmod(ca, cd, ck4),
        "lt": lambda: integer.radix_lt(ca, cb, ck4),
        "eq": lambda: integer.radix_eq(ca, ce, ck4)}
    want = {"mul": a * b, "add": (a + b) % 64, "div": (a // b_div, a % b_div),
            "lt": (a < b).astype(int), "eq": (a == b_eq).astype(int)}
    ck4_cpu = _on_cpu(ck4)
    outs, accuracy = {}, {}
    for name, fn in ops.items():
        if name == "div":
            with _DivmodProbe(integer) as probe:
                outs[name] = out = run(name, fn)
            t0 = time.perf_counter()
            crossed, std = _check_divmod(name, probe, want[name][0], s4, P4,
                                         ck4_cpu)
            wall["CPU-path checks"] += time.perf_counter() - t0
            _exact("div remainder", dec(out[1]), want[name][1])
            _exact("div quotient", dec(out[0])[~crossed], want[name][0][~crossed])
            accuracy[name] = float(1.0 - crossed.mean())
            note = (f"remainder exact on every lane, every quotient bit exact, "
                    f"the reassembly rotation exact against its modswitched "
                    f"input; {int(crossed.sum())} lanes whose reassembled "
                    f"quotient digit b0 + 2 b1 + 4 b2 left its bin (the "
                    f"scheme's noise; CPU path bit-equal on them), the rest "
                    f"exact: accuracy {accuracy[name]}; the reassembly "
                    f"inputs' noise std {std:.3f} message units")
        else:
            outs[name] = out = run(name, fn)
            _exact(name, dec(out), want[name])
            accuracy[name] = 1.0
            note = "every lane exact"
        print(f"integer {name} B={INT_LANES} (6-bit operands): {note}; "
              f"launches {launches[name]} = {steps} x {INT_ROTATIONS[name]} "
              f"rotations; first call {first_s[name]:.2f} s; peak device "
              f"memory {peak_mb[name][0]:.1f} MiB, {peak_mb[name][1]:.1f} MiB "
              f"above what was allocated before the op")
    t0 = time.perf_counter()
    n = CPU_INT_LANES
    for name, fn in (("add", lambda: integer.radix_add(
                          ca[:n].cpu(), cb[:n].cpu(), ck4_cpu)[..., :2, :]),
                     ("lt", lambda: integer.radix_lt(ca[:n].cpu(), cb[:n].cpu(),
                                                     ck4_cpu))):
        _check(torch.equal(fn(), outs[name][:n].cpu()),
               f"integer {name}: card lanes differ from the port's CPU path")
    wall["CPU-path checks"] += time.perf_counter() - t0
    print(f"integer add, lt: first {n} lanes bit-equal to the CPU path "
          f"({time.perf_counter() - t0:.1f} s on the host)")

    # -- the classic digit multiplier (no packing key) --------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck_cl = key.CloudKey.generate(g, sk4, P4, packing_key=False)
    torch.cuda.synchronize()
    _check(ck_cl.pksk is None, "the packing_key=False key holds a packing key")
    keygen_s = wall["classic key"] = time.perf_counter() - t0
    out = run("mul_classic", lambda: integer.radix_mul(ca, cb, ck_cl))
    _exact("mul_classic", dec(out), a * b)
    print(f"integer mul, classic digit multiplier B={INT_LANES}: every lane "
          f"exact; launches {launches['mul_classic']}; keygen "
          f"{keygen_s:.2f} s; first call {first_s['mul_classic']:.2f} s")

    # -- FheInt at B = 64 ------------------------------------------------------
    sa = rng.integers(-32, 32, INT_SMALL_LANES)
    sb = rng.integers(-32, 31, INT_SMALL_LANES)
    sb = sb + (sb >= 0)                              # nonzero divisors
    u = rng.integers(0, 8, INT_SMALL_LANES)
    x = integer.FheInt.encrypt(g, sa, 2, sk4, ck4)
    y = integer.FheInt.encrypt(g, sb, 2, sk4, ck4)
    cu = integer.FheUint.encrypt(g, u, 1, sk4, ck4)

    def wrap(v):
        return (np.asarray(v) + 32) % 64 - 32

    q = np.trunc(sa / sb).astype(np.int64)
    signed = {"int_add": (lambda: x + y, wrap(sa + sb)),
              "int_sub": (lambda: x - y, wrap(sa - sb)),
              "int_lt": (lambda: x < y, (sa < sb).astype(int)),
              "int_asr2": (lambda: x >> 2, sa >> 2),
              "int_asr_enc": (lambda: x >> cu, sa >> u),
              "int_abs": (lambda: x.abs(), wrap(np.abs(sa))),
              "int_div_rem": (lambda: x.div_rem(y), (wrap(q), sa - q * sb))}
    for name, (fn, w) in signed.items():
        if name == "int_div_rem":
            # |a| divmod |b| inside, then the sign fixes
            with _DivmodProbe(integer) as probe:
                qh, rh = run(name, fn)
            t0 = time.perf_counter()
            crossed, std = _check_divmod(name, probe, np.abs(sa) // np.abs(sb),
                                         s4, P4, ck4_cpu)
            wall["CPU-path checks"] += time.perf_counter() - t0
            _exact(f"{name} remainder", rh.decrypt(sk4), w[1])
            _exact(f"{name} quotient", qh.decrypt(sk4)[~crossed], w[0][~crossed])
            accuracy[name] = float(1.0 - crossed.mean())
        else:
            _exact(name, run(name, fn).decrypt(sk4), w)
            accuracy[name] = 1.0
    print(f"integer FheInt B={INT_SMALL_LANES} (2-digit signed): "
          + ", ".join(f"{n[4:]} accuracy {accuracy[n]} "
                      f"({launches[n]['k2'] // steps} rotations, "
                      f"{first_s[n]:.2f} s)" for n in signed)
          + f" (div_rem checked as div is, reassembly noise std {std:.3f}; "
          f"the other lanes exact)")

    # -- the gates bridge: to_bools, a 3-bit ripple adder, from_bools ----------
    xb, yb = rng.integers(0, 8, (2, INT_SMALL_LANES))
    cxy = torch.cat([integer.encrypt_radix(g, v, 1, alpha, s4) for v in (xb, yb)],
                    dim=-2)                                   # [B, 2, n0+1]
    plan = _ripple_adder_plan(3)

    def bridge():
        bits = integer.to_bools(cxy, ck4)                     # [B, 6, n0+1]
        out = scheduler.evaluate(plan, bits.movedim(-2, 0), ck4)
        return integer.from_bools(out.movedim(0, -2), ck4)    # [B, 2, n0+1]

    _exact("bridge", dec(run("bridge", bridge)), xb + yb)
    print(f"integer bridge B={INT_SMALL_LANES}: to_bools, a 3-bit ripple adder "
          f"({plan.n_levels} levels of scheduler.evaluate), from_bools: every "
          f"sum exact; launches {launches['bridge']}")

    # -- timings ---------------------------------------------------------------
    def median_ms(fn):
        return sorted(_cuda_ms(fn, 1) for _ in range(WARM_ITERS))[WARM_ITERS // 2]

    t0 = time.perf_counter()
    rates = {}
    for name, fn in ops.items():
        ms = median_ms(fn)
        rates[name] = (INT_LANES / (ms / 1e3), ms)
    one = (ca[:1], cb[:1])
    lat = {}
    for name, fn in (("add", integer.radix_add), ("mul", integer.radix_mul)):
        fn(*one, ck4)
        lat[name] = median_ms(lambda fn=fn: fn(*one, ck4))
    print(f"integer ops/s at B={INT_LANES}: " + ", ".join(
        f"{n} {r:.1f} ({ms:.1f} ms)" for n, (r, ms) in rates.items())
        + f"; latency at B=1: add {lat['add']:.1f} ms, mul {lat['mul']:.1f} ms; "
        f"peak device memory above what was allocated before the op "
        + ", ".join(f"{n} {peak_mb[n][1]:.1f} MiB" for n in ops) + f" [{gpu}]")
    _profile(f"integer mul B={INT_LANES}",
             lambda: integer.radix_mul(ca, cb, ck4), gpu, top=8)
    wall["timings"] = time.perf_counter() - t0
    total = time.perf_counter() - t_phase
    print(f"phase 10 wall time {total:.1f} s: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in wall.items())
        + f", the checked ops {total - sum(wall.values()):.1f} s")
    return launches


# -- phase 11: the 64-bit torus, SECURITY_128_BIT_T64 ---------------------------

T64_STEPS = 384            # ceil(768 / 2): the split scan at group 2
T64_GATE_LANES = 512
T64_CPU_LANES = 4
T64_LUT_LANES = 256
T64_SMALL_LANES = 64       # the radix LUT and the integer ops
# blind rotations per op on this key (counted on the CPU path at the key's
# ||q||_1 budget, 5.31: every multi-value round of these ops holds a table
# over it, so it runs one rotation lane per table; the radix LUT's mid
# tables all take dedicated lanes)
T64_ROTATIONS = {"lut": 1, "radix": 2, "add": 4, "lt": 4, "mul": 34,
                 "int_add": 4}


def _radix64_f(x):
    return (5 * x + 1) % 64


def _t64_phase(g, counters, gpu):
    """Phase 11: the 64-bit torus (see the module docstring).  Returns
    each run's launch counts by kernel and K1's results at the split
    shapes."""
    import numpy as np
    import torch

    from zig_tfhe_tpu_torch import key, params, tlwe
    from zig_tfhe_tpu_torch.models import gates, integer, lut
    from zig_tfhe_tpu_torch.ops import decomposition, ntt, split_ring
    from zig_tfhe_tpu_torch.ops.decomposition import modswitch
    from zig_tfhe_tpu_torch.ops.cuda import ntt_inverse as k1
    from zig_tfhe_tpu_torch.ops.cuda import split_step as k2s
    from zig_tfhe_tpu_torch.ops.poly import negacyclic_rotate
    from zig_tfhe_tpu_torch.utils import serialization

    P = params.SECURITY_128_BIT_T64
    dev = g.device
    N, n0, alpha = P.N, P.n0, P.tlwe_lv0.alpha
    t_phase = time.perf_counter()
    wall = {"keygen": 0.0, "CPU-path checks": 0.0, "timings": 0.0,
            "files": 0.0}
    launches = {}

    def expect(rotations):
        return {"k1": rotations * T64_STEPS, "k2s": rotations * T64_STEPS}

    # -- the key: group 2, Bg_e 2^8 (3, 2), drop 32, 4 primes on N/2 ----------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sk = key.SecretKey.generate(g, P)
    ck = key.CloudKey.generate(g, sk, P)
    torch.cuda.synchronize()
    wall["keygen"] = time.perf_counter() - t0
    s = sk.key_lv0
    cfg = (ck.bsk_group, ck.bsk_bgbit, ck.bsk_levels, ck.bsk_ntt_drop)
    plan = ntt.plan_for_params(P, 32, 2, (3, 2), bgbit=8, pseudorandom_key=True)
    want_shapes = {"testvec": ((2, N), torch.int64),
                   "ksk1": ((N * P.iks_t, n0 + 1), torch.int64),
                   "bsk_ntt": ((T64_STEPS, 3, 4, 10, 4, N // 2), torch.int16),
                   "pksk": ((N * 3, 2, N), torch.int64)}
    got_shapes = {n: (tuple(t.shape), t.dtype) for n, t in ck.named_buffers()}
    _check(cfg == (2, 8, (3, 2), 32) and got_shapes == want_shapes
           and ck.pksk_gadget == (8, 3) and plan.N == N // 2
           and plan.primes == (18433, 40961, 59393, 61441)
           and decomposition.hi32_viable(P, 32, 8, (3, 2)),
           f"{P.name} key {cfg}, arrays {got_shapes}, packing gadget "
           f"{ck.pksk_gadget}, plan {plan.primes}")
    print(f"keygen {P.name} (N = {N}, n0 = {n0}, 64-bit torus; group 2, Bg_e "
          f"2^8 (3, 2), drop 32, 4 primes on the N/2 = {plan.N} plan; hi-plane "
          f"scan): {wall['keygen']:.2f} s; " + ", ".join(
              f"{n} {shape} {str(dt)[6:]} ({t.numel() * t.element_size() / 1e6:.1f} MB)"
              for (n, (shape, dt)), t in zip(got_shapes.items(),
                                             ck.buffers()))
          + f"; packing key at {ck.pksk_gadget}")

    # -- K2s and K1 at the split shapes, on one real step's inputs ------------
    B, Nh = B_GATES, plan.N
    x = torch.randint(0, 2, (B,), generator=g, device=dev).bool()
    y = torch.randint(0, 2, (B,), generator=g, device=dev).bool()
    ids = torch.arange(B, device=dev) % len(gates.GATE_NAMES)
    a = tlwe.encrypt_bool(g, x, P.ksk_alpha, s, width=64)
    b = tlwe.encrypt_bool(g, y, P.ksk_alpha, s, width=64)
    b_t = 2 * N - modswitch(a[:, n0], P)
    tv_hi = (ck.testvec >> 32).to(torch.int32).expand(B, 2, N)
    acc = split_ring.split(negacyclic_rotate(tv_hi, b_t)).contiguous()
    ts = modswitch(a[:, :2].T.contiguous(), P)                    # [2, B]
    bsk0 = ck.bsk_ntt[0]
    digits = decomposition.rows_hi32(acc, P, 8, (3, 2)).to(torch.int8)
    errs2s = []
    for lanes in (B, RAGGED_LANES, 1):
        step = (digits[:lanes], bsk0, ts[:, :lanes].contiguous(), plan, 8)
        out = k2s.split_step_fused(*step)
        ref = k2s.split_step_fused_reference(*step)
        torch.cuda.synchronize()
        errs2s.append(int((out.long() - ref.long()).abs().max()))
        _check(torch.equal(out, ref), f"K2s differs from its plain version at "
               f"B={lanes} (max |diff| {errs2s[-1]})")
    v8 = k2s.split_step_fused(digits, bsk0, ts, plan, 8)        # [P, B, 2, 2, 2, Nh]
    v = k1.join_limbs(v8)                                         # [P, B, 2, 2, Nh]
    finish = acc + ntt.ntt_inverse_to_crt(list(v), plan, 32)     # plain hi-plane finish
    ts1 = ts[:, :1].contiguous()
    ms2s, plain2s = _kernel_vs_plain(
        lambda: k2s.split_step_fused(digits, bsk0, ts, plan, 8),
        lambda: k2s.split_step_fused_reference(digits, bsk0, ts, plan, 8))
    one2s = _cuda_ms(lambda: k2s.split_step_fused(digits[:1], bsk0, ts1, plan, 8),
                     KERNEL_ITERS)
    dev2s = _graph_ms(lambda: k2s.split_step_fused(digits[:1], bsk0, ts1, plan, 8),
                      KERNEL_ITERS)
    n_rows = int(torch.unique(ts >> 1).numel())
    bound2s, by2s, unit2s, l2_2s, cc2s = _k2s_bound_ms(
        plan, B, digits.shape[1], n_rows, split_ring.row_group(plan))
    k2s_result = dict(max_abs_err=max(errs2s), ms=ms2s, plain_ms=plain2s,
                      bound_ms=bound2s, bound_by=by2s, bound_unit=unit2s,
                      b1_eager_ms=one2s, b1_device_ms=dev2s)
    print(f"t64: K2s == plain (the prime-batched forward NTT, 3 x pointwise, "
          f"the Y-twisted combine and the limb split) on one real step "
          f"(hi-plane digits [B, 10, {Nh}] of a rotated test vector, the "
          f"key's first group, rotations of real ciphertexts) for B = {B}, "
          f"{RAGGED_LANES}, 1; B={B}: K2s {ms2s * 1e3:.1f} us/call (plain "
          f"{plain2s * 1e3:.1f} us, bound {bound2s * 1e3:.1f} us by {unit2s}, "
          f"cuda cores {cc2s * 1e3:.1f} us, L2->SM of its tiling "
          f"{l2_2s / 1e6:.0f} MB/call); B=1 {dev2s * 1e3:.1f} us/call on the "
          f"device ({one2s * 1e3:.1f} us eager) [{gpu}]")

    # K2s's Barrett against the plain version's on every int32, each prime
    t0 = time.perf_counter()
    for p in plan.primes:
        n_diff = k2s.barrett_mismatches(p, dev)
        _check(n_diff == 0, f"K2s's Barrett differs from the plain version's "
               f"on {n_diff} int32 inputs modulo {p}")
    torch.cuda.synchronize()
    print(f"t64: K2s's Barrett (rounding by the f32 add) equals the plain "
          f"version's __float2int_rn form on all 2^32 int32 inputs for p in "
          f"{plan.primes} ({(time.perf_counter() - t0) * 1e3:.1f} ms)")
    # K2s's stage split: the same call on the probe builds, from a CUDA graph
    def call():
        k2s.split_step_fused(digits, bsk0, ts, plan, 8)

    split2s = {"whole": _graph_ms(call, KERNEL_ITERS)}
    for vname, defines in K2S_PROBES.items():
        split2s[vname] = _variant_ms(k2s, defines, call, KERNEL_ITERS)
    k2s_result["stage_split_ms"] = split2s
    print(f"t64 B={B}: K2s stage split (from a CUDA graph; the probe builds' "
          f"outputs are not used): " + ", ".join(
              f"{n} {t * 1e3:.1f} us" for n, t in split2s.items()) + f" [{gpu}]")
    for (src, kernel), lines in PTXAS.items():
        if src == k2s.SOURCE.name:
            print(f"t64: ptxas K2s {kernel}: {'; '.join(lines)}")

    def views(n):
        return (v[:, :n].reshape(plan.n_primes, 2 * n, 2, Nh),
                acc[:n].reshape(2 * n, 2, Nh))

    errs = []
    for lanes in (B, RAGGED_LANES, 1):
        vv, aa = views(lanes)
        out = k1.ntt_inverse_to_crt_acc(vv, aa, plan, 0)
        out8 = k1.ntt_inverse_to_crt_acc(
            v8[:, :lanes].reshape(plan.n_primes, 2 * lanes, 2, 2, Nh), aa,
            plan, 0)
        ref = k1.ntt_inverse_to_crt_acc_reference(vv, aa, plan, 0)
        torch.cuda.synchronize()
        errs.append(int((out.long() - ref.long()).abs().max()))
        _check(errs[-1] == 0 and torch.equal(out8, out)
               and torch.equal(out.reshape(lanes, 2, 2, Nh), finish[:lanes]),
               f"K1 at the split views differs from its plain version or the "
               f"plain hi-plane finish at B={lanes} (max |diff| {errs[-1]})")
    # K1 that also writes the next step's half-rows (every step of the scan
    # but the last): bit-equal to the plain decompose of its output
    gadget = decomposition.half_row_gadget(P, 8, (3, 2))
    for lanes in (B, RAGGED_LANES, 1):
        half_rows = torch.empty((lanes, 10, Nh), dtype=torch.int8, device=dev)
        out = k1.ntt_inverse_to_crt_acc(
            v8[:, :lanes].reshape(plan.n_primes, 2 * lanes, 2, 2, Nh),
            views(lanes)[1], plan, 0, digits=half_rows, gadget=gadget)
        want = decomposition.rows_hi32(out.reshape(lanes, 2, 2, Nh), P, 8,
                                     (3, 2)).to(torch.int8)
        torch.cuda.synchronize()
        _check(torch.equal(out.reshape(lanes, 2, 2, Nh), finish[:lanes])
               and torch.equal(half_rows, want),
               f"K1 writing the half-rows differs from its plain version at "
               f"B={lanes}")
    vv, aa = views(B)
    vv8 = v8.reshape(plan.n_primes, 2 * B, 2, 2, Nh)
    v1, a1 = v8[:, :1].reshape(plan.n_primes, 2, 2, 2, Nh), acc[:1].reshape(2, 2, Nh)
    ms1, plain1 = _kernel_vs_plain(
        lambda: k1.ntt_inverse_to_crt_acc(vv8, aa, plan, 0),
        lambda: k1.ntt_inverse_to_crt_acc_reference(vv8, aa, plan, 0))
    one1 = _cuda_ms(lambda: k1.ntt_inverse_to_crt_acc(v1, a1, plan, 0),
                    KERNEL_ITERS)
    dev1 = _graph_ms(lambda: k1.ntt_inverse_to_crt_acc(v1, a1, plan, 0),
                     KERNEL_ITERS)
    bound1, by1, unit1, l2_1, cc1 = _k1_bound_ms(plan.n_primes, 2 * B, Nh)
    half_rows = torch.empty((B, 10, Nh), dtype=torch.int8, device=dev)
    k1_fns = {
        "without": lambda: k1.ntt_inverse_to_crt_acc(vv8, aa, plan, 0),
        "half-rows": lambda: k1.ntt_inverse_to_crt_acc(
            vv8, aa, plan, 0, digits=half_rows, gadget=gadget)}
    k1_graph = {name: [] for name in k1_fns}
    for name in ("without", "half-rows", "half-rows", "without"):
        k1_graph[name].append(_graph_ms(k1_fns[name], KERNEL_ITERS))
    k1_result = dict(max_abs_err=max(errs), ms=ms1, plain_ms=plain1,
                     bound_ms=bound1, bound_by=by1, bound_unit=unit1,
                     b1_eager_ms=one1, b1_device_ms=dev1,
                     graph_ms={k: sum(t) / 2 for k, t in k1_graph.items()})
    print(f"t64: K1 == plain == the plain hi-plane finish at the split views "
          f"[P=4, 2B, 2, {Nh}] of K2s's residues, as int32 (split by the "
          f"wrapper) and as K2s's int8 limb planes (as the scan hands them "
          f"over), drop 32 - 32 = 0, for B = {B}, {RAGGED_LANES}, 1; B={B}: "
          f"K1 {ms1 * 1e3:.1f} us/call on the limb planes (plain "
          f"{plain1 * 1e3:.1f} us, bound {bound1 * 1e3:.1f} us by {unit1}, "
          f"cuda cores {cc1 * 1e3:.1f} us, L2->SM of the widest tiling "
          f"{l2_1 / 1e6:.0f} MB/call); B=1 {dev1 * 1e3:.1f} us/call on the "
          f"device ({one1 * 1e3:.1f} us eager) [{gpu}]")
    print(f"t64: K1 writing the next step's half-rows [B, 10, {Nh}] == "
          f"rows_hi32 of its output for B = {B}, {RAGGED_LANES}, 1; B={B} "
          f"from CUDA graphs, in turns: " + ", ".join(
              f"{k} {' / '.join(f'{t * 1e3:.1f}' for t in ts)} us"
              for k, ts in k1_graph.items()) + f" [{gpu}]")

    # -- gates: B = 512 lanes cycling the 10 gates -----------------------------
    nG = T64_GATE_LANES
    want = np.array([_TRUTH[gates.GATE_NAMES[i]](bool(p), bool(q)) for i, p, q
                     in zip(ids.tolist(), x.tolist(), y.tolist())])
    digit_launches = k1.ntt_inverse_to_crt_acc.digit_launches
    with _plain_split_calls(split_ring) as plain_calls:
        res, launches["t64"], first_s = _counted_run(
            counters, "t64 gates",
            lambda: gates.apply_gates(ids[:nG], a[:nG], b[:nG], ck), expect(1))
    _check(not plain_calls, f"t64 gates: the scan ran the plain split step "
           f"on the card ({plain_calls})")
    digit_launches = k1.ntt_inverse_to_crt_acc.digit_launches - digit_launches
    _check(digit_launches == T64_STEPS - 1, f"t64 gates: {digit_launches} K1 "
           f"launches wrote half-rows, expected {T64_STEPS - 1}")
    _check(res.dtype == torch.int64 and tuple(res.shape) == (nG, n0 + 1),
           f"t64 gate output {res.dtype} {tuple(res.shape)}")
    got = tlwe.decrypt_bool(res, s).cpu().numpy()
    accuracy = float((got == want[:nG]).mean())
    _check(accuracy == 1.0, f"t64 gate accuracy {accuracy} != 1.0")
    t0 = time.perf_counter()
    ck_cpu = _on_cpu(ck)
    n = T64_CPU_LANES
    res_cpu = gates.apply_gates(ids[:n].cpu(), a[:n].cpu(), b[:n].cpu(), ck_cpu)
    _check(torch.equal(res_cpu, res[:n].cpu()),
           "t64: CUDA gate outputs differ from the port's CPU path")
    wall["CPU-path checks"] += time.perf_counter() - t0
    print(f"apply_gates t64 B={nG}: accuracy {accuracy}, launches "
          f"{launches['t64']} (one K2s and one K1 per step of the "
          f"{T64_STEPS}-step hi-plane scan, {digit_launches} K1 launches "
          f"writing the next half-rows; no call of the plain forward NTT, "
          f"pointwise or combine), first call {first_s:.2f} s; first {n} lanes "
          f"bit-equal to the CPU path ({time.perf_counter() - t0:.1f} s on "
          f"the host)")

    # -- timings ---------------------------------------------------------------
    t0 = time.perf_counter()        # the B = 512 run warmed every stage
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gate_ms = _cuda_ms(lambda: gates.apply_gates(ids, a, b, ck), 1)
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    one = (ids[:1], a[:1], b[:1])
    gates.apply_gates(*one, ck)
    lat = sorted(_cuda_ms(lambda: gates.apply_gates(*one, ck), 1)
                 for _ in range(WARM_ITERS))
    lat_ms = lat[WARM_ITERS // 2]
    print(f"t64: gates/s at B={B}: {B / (gate_ms / 1e3):.1f} (one warm "
          f"batch, {gate_ms:.1f} ms, peak device memory {peak_mib:.1f} MiB "
          f"above what was allocated before); latency at B=1: {lat_ms:.1f} "
          f"ms (median of "
          + ", ".join(f"{t:.1f}" for t in lat) + f" ms) [{gpu}]")
    stage_fns = {
        "K2s": lambda: k2s.split_step_fused(digits, bsk0, ts, plan, 8),
        "K1 + half-rows": k1_fns["half-rows"],
        "step 0's decompose": lambda: decomposition.rows_hi32(
            acc, P, 8, (3, 2)).to(torch.int8)}
    split_us = {st: _cuda_ms(fn, KERNEL_ITERS) * 1e3
                for st, fn in stage_fns.items()}
    print(f"t64: one step at B={B}: " + ", ".join(
        f"{st} {t:.1f} us" for st, t in split_us.items())
        + f" (a fused step, K2s + K1 + half-rows: "
        f"{split_us['K2s'] + split_us['K1 + half-rows']:.1f} us) [{gpu}]")
    for lanes in (B, 1):
        prof = _profile(f"t64 B={lanes}",
                        lambda n=lanes: gates.apply_gates(ids[:n], a[:n], b[:n],
                                                          ck),
                        gpu, steps=T64_STEPS)
        if prof:
            n_kernels, by_name = prof
            gemm = sum(c for nm, (_, c) in by_name.items()
                       if re.search("gemm|wmma|cutlass", nm))
            _check(gemm < T64_STEPS, f"t64 B={lanes}: {gemm} matrix-product "
                   f"kernels in a bootstrap: the scan still runs _int_mm")
            print(f"t64 B={lanes}: {n_kernels / T64_STEPS:.1f} kernels a "
                  f"step, {gemm} matrix-product kernels in the bootstrap (the "
                  f"key switch's)")
    wall["timings"] = time.perf_counter() - t0

    # -- a LUT and the integer layer at width 64 -------------------------------
    rng = np.random.default_rng(64)
    msgs = torch.arange(T64_LUT_LANES, device=dev) % 16
    ct = tlwe.encrypt_message(g, msgs, 16, alpha, s, width=64)
    table = lut.Generator.new(16, P).generate_lookup_table(_lut_f)
    out, launches["t64 lut"], first_s = _counted_run(
        counters, "t64 bootstrap_lut",
        lambda: lut.bootstrap_lut(ct, table, ck), expect(T64_ROTATIONS["lut"]))
    k = _ms_phase(ct, s, P)
    got = tlwe.decrypt_message(out, 16, s, 64).long()
    _check(torch.equal(got, _decode(_tv_at(torch.from_numpy(table.poly[1])
                                           .to(dev), k, N), 16, 64)),
           "t64 bootstrap_lut: lanes do not decrypt to the table at their "
           "modswitched input phase")
    lut_acc = float((got == (7 * msgs + 3) % 16).double().mean())
    print(f"t64 bootstrap_lut B={T64_LUT_LANES}, m = 16: every lane equals "
          f"the table at its modswitched input phase; accuracy {lut_acc}; "
          f"launches {launches['t64 lut']}; first call {first_s:.2f} s")

    vals = torch.from_numpy(rng.integers(0, 64, T64_SMALL_LANES)).to(dev)
    lo, hi = lut.encrypt_radix_message(g, vals, 64, alpha, s, width=64)
    (r_lo, r_hi), launches["t64 radix"], first_s = _counted_run(
        counters, "t64 radix", lambda: lut.bootstrap_lut_radix(
            lo, hi, _radix64_f, 64, ck, ck.pksk),
        expect(T64_ROTATIONS["radix"]))
    got = lut.decrypt_radix_message((r_lo, r_hi), 64, s, 64).long()
    want_r = _radix64_f(vals)
    in_bins = ((_bin(_ms_phase(lo, s, P), 16, N) == vals % 16)
               & (_bin(_ms_phase(hi, s, P), 4, N) == vals // 16))
    radix_acc = float((got == want_r).double().mean())
    _check(bool((got == want_r)[in_bins].all()) and radix_acc >= 0.95,
           f"t64 radix m = 64: accuracy {radix_acc}, in-bin lanes wrong "
           f"{int((got != want_r)[in_bins].sum())}")
    print(f"t64 bootstrap_lut_radix B={T64_SMALL_LANES}, m = 64 (tree PBS, "
          f"every mid table on its dedicated lane): accuracy {radix_acc}, "
          f"{int(in_bins.sum())} lanes with both digits in their bins, all "
          f"exact; launches {launches['t64 radix']}; first call "
          f"{first_s:.2f} s")

    ua, ub = rng.integers(0, 64, (2, T64_SMALL_LANES))
    ca, cb = (integer.encrypt_radix(g, v, 2, alpha, s, width=64) for v in (ua, ub))
    sa = rng.integers(-32, 32, T64_SMALL_LANES)
    sb = rng.integers(-32, 32, T64_SMALL_LANES)
    xa, xb = (integer.FheInt.encrypt(g, v, 2, sk, ck) for v in (sa, sb))
    int_ops = {
        "add": (lambda: integer.radix_add(ca, cb, ck)[..., :2, :], (ua + ub) % 64),
        "lt": (lambda: integer.radix_lt(ca, cb, ck)[..., None, :],
               (ua < ub).astype(int)),
        "mul": (lambda: integer.radix_mul(ca, cb, ck), ua * ub),
        "int_add": (lambda: (xa + xb).digits, (sa + sb + 32) % 64 - 32)}
    int_first = {}
    for name, (fn, want_i) in int_ops.items():
        out, launches[f"t64 {name}"], int_first[name] = _counted_run(
            counters, f"t64 integer {name}", fn, expect(T64_ROTATIONS[name]))
        got = (integer.FheInt(out, ck).decrypt(sk) if name == "int_add"
               else integer.decrypt_radix(out, s))
        _exact(f"t64 {name}", got, want_i)
    print(f"t64 integer B={T64_SMALL_LANES} (2-digit operands): add, lt, mul "
          f"(tree PBS) and FheInt add exact on every lane; rotations "
          + ", ".join(f"{n} {T64_ROTATIONS[n]} ({int_first[n]:.2f} s)"
                      for n in int_ops))

    # -- files: the split cloud key and a 64-bit ciphertext --------------------
    t0 = time.perf_counter()
    pair = (("and", "xor"), (a[:4], a[4:8]), (b[:4], b[4:8]))
    before = gates.gate_pair(*pair, ck)
    with tempfile.TemporaryDirectory() as d:
        serialization.save_cloud_key(os.path.join(d, "ck"), ck)
        serialization.save_ciphertext(os.path.join(d, "ct"), a[:8], P)
        size = os.path.getsize(os.path.join(d, "ck.npz"))
        ck2 = serialization.load_cloud_key(os.path.join(d, "ck.npz"), device=dev)
        ct2, p2 = serialization.load_ciphertext(os.path.join(d, "ct.npz"),
                                                device=dev)
    _check(p2 == P and torch.equal(ct2, a[:8])
           and all(torch.equal(t, t2) for t, t2 in zip(ck.buffers(),
                                                       ck2.buffers())),
           "t64 files: the loaded key or ciphertext differs")
    after = gates.gate_pair(("and", "xor"), (ct2[:4], ct2[4:8]),
                            (b[:4], b[4:8]), ck2)
    _check(torch.equal(before, after),
           "t64 files: gate_pair outputs differ after the load")
    wall["files"] = time.perf_counter() - t0
    print(f"t64 files: cloud key ({size / 1e6:.0f} MB) and ciphertext saved "
          f"and loaded, arrays equal, gate_pair outputs bit-equal "
          f"({wall['files']:.1f} s)")
    total = time.perf_counter() - t_phase
    print(f"phase 11 wall time {total:.1f} s: " + ", ".join(
        f"{k_} {v_:.1f} s" for k_, v_ in wall.items())
        + f", the checked runs {total - sum(wall.values()):.1f} s")
    return launches, k1_result, k2s_result


@contextlib.contextmanager
def _plain_split_calls(module):
    """Count calls of the split step's plain stages (the forward NTT on
    _int_mm, the prime-batched pointwise, the combine) on CUDA tensors while
    the block runs: yields the list of their names, empty when the scan
    took K2s."""
    calls = []
    saved = {nm: getattr(module, nm) for nm in
             ("forward", "pointwise", "rotate_combine_multi_split")}

    def counting(nm, fn):
        def counted(first, *args):
            t = first[0] if isinstance(first, (list, tuple)) else first
            if t.is_cuda:
                calls.append(nm)
            return fn(first, *args)
        return counted

    for nm, fn in saved.items():
        setattr(module, nm, counting(nm, fn))
    try:
        yield calls
    finally:
        for nm, fn in saved.items():
            setattr(module, nm, fn)


# -- phase 12: slice 5 on SECURITY_128_BIT --------------------------------------
S5_LANES = 2048        # seeded encryptions, gates, re-encryption, timings
S5_CPU_LANES = 16      # lanes held bit-equal to the port's CPU path
S5_NO_KSK_LANES = 8    # gates on the generate_no_ksk key
S5_T64_LANES = 20      # TEST_TINY64 gates (the direct 64-bit engine)
REENC_MIN_ACCURACY = 0.90   # proxy_reenc.zig:401-427, the reference's bar

# Two ranks of parallel/distributed.py on the one card over gloo (NCCL refuses
# two ranks on one device): argv rank, port, work dir, repository root.  Rank
# 0 loads the parent's key and broadcasts it (broadcast_cloud_key, then
# shard_map_gates' buffer broadcast over a zeroed copy on rank 1); each rank
# evaluates its half of the batch and saves it.
_GLOO_WORKER = r"""
import copy, os, sys
rank, port, tmp, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, root)
import numpy as np
import torch
import torch.distributed as dist
from zig_tfhe_tpu_torch.parallel import distributed as D
from zig_tfhe_tpu_torch.parallel import mesh as M
from zig_tfhe_tpu_torch.utils import serialization as ser

dev = torch.device("cuda", 0)
D.initialize(f"localhost:{port}", 2, rank, backend="gloo")
mesh = M.make_mesh(device=dev)
assert mesh.shape == (2, 1) and mesh.data_index == rank, mesh
ck = ser.load_cloud_key(os.path.join(tmp, "parent_ck"), device=dev) if rank == 0 else None
ck = D.broadcast_cloud_key(os.path.join(tmp, "broadcast_ck"), ck, device=dev)
z = np.load(os.path.join(tmp, "batch.npz"))
ids, a, b = (D.global_batch(mesh, M.shard_batch(mesh, torch.from_numpy(z[k])))
             for k in ("ids", "a", "b"))
out = D.distributed_gates(mesh, D.replicate_global(mesh, ck))(ids, a, b)
mine = ck if rank == 0 else copy.deepcopy(ck)
if rank:
    for buf in mine.buffers():
        buf.zero_()
try:
    again = M.shard_map_gates(mesh, mine)(ids, a, b)
except RuntimeError as e:
    sys.exit(f"gloo refused the key broadcast of CUDA tensors: {e}")
assert torch.equal(again, out), "shard_map_gates differs from distributed_gates"
np.save(os.path.join(tmp, f"out{rank}.npy"), D.local_shards(out))
D.barrier()
dist.destroy_process_group()
print(f"GLOO_OK rank={rank}", flush=True)
"""


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _slice5_phase(P, g, sk, ck, counters, gpu):
    """Phase 12: slice 5 on the card (see the module docstring), its files
    in a temporary directory.  Returns the counted runs' launches by kernel
    and the timings (seconds by operation)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_s5_") as work:
        return _slice5_run(P, g, sk, ck, counters, gpu, work)


def _slice5_run(P, g, sk, ck, counters, gpu, work):
    import numpy as np
    import torch

    from zig_tfhe_tpu_torch import bootstrap, key, params, tlwe
    from zig_tfhe_tpu_torch.models import gates
    from zig_tfhe_tpu_torch.models import proxy_reenc as pr
    from zig_tfhe_tpu_torch.parallel import distributed as D
    from zig_tfhe_tpu_torch.parallel import mesh as M
    from zig_tfhe_tpu_torch.utils import profiling, serialization, threefry

    dev = g.device
    n0, B, nc = P.n0, S5_LANES, S5_CPU_LANES
    alpha = P.tlwe_lv0.alpha
    t_phase = time.perf_counter()
    wall = {"CPU-path checks": 0.0, "2 gloo ranks": 0.0, "timings": 0.0}
    steps = -(-n0 // ck.bsk_group)
    g3 = {"k1": steps, "k2": steps, "k3": 0}
    launches = {}
    s = sk.key_lv0

    # -- 1. seeded ciphertexts: 2 x 2048 bits, a file, expanded on the card ----
    x = torch.randint(0, 2, (B,), generator=g, device=dev).bool()
    y = torch.randint(0, 2, (B,), generator=g, device=dev).bool()
    seeded = [tlwe.encrypt_bool_seeded(g, bits, alpha, s) for bits in (x, y)]
    cts, sizes = [], []
    for i, (seed, body) in enumerate(seeded):
        path = os.path.join(work, f"seeded{i}")
        serialization.save_seeded_ciphertext(path, seed, body, P)
        (seed2, body2), p2 = serialization.load_seeded_ciphertext(
            path, expand=False, device=dev)
        ct, _ = serialization.load_seeded_ciphertext(path, device=dev)
        _check(p2 is P and np.array_equal(seed2, seed)
               and torch.equal(body2, body), "seeded file: seed or bodies "
               "differ after the load")
        # the ciphertext the seeded encryption implies: its threefry mask
        # (drawn here on the CPU) beside its bodies
        implied = torch.cat([threefry.random_bits32(seed, (B, n0)),
                             body.cpu()[:, None]], dim=-1)
        _check(ct.device == dev and ct.dtype == torch.int32
               and torch.equal(ct.cpu(), implied),
               "expand_seeded on the card differs from the implied ciphertext")
        full = os.path.join(work, f"expanded{i}")
        serialization.save_ciphertext(full, ct, P)
        sizes.append((os.path.getsize(path + ".npz"),
                       os.path.getsize(full + ".npz")))
        cts.append(ct)
    a, b = cts
    for ct, bits in ((a, x), (b, y)):
        _check(torch.equal(tlwe.decrypt_bool(ct, s), bits),
               "seeded ciphertexts do not decrypt to their bits")
    print(f"seeded: 2 x {B} bits encrypted seeded on the card, saved, loaded "
          f"and expanded on the card, bit-equal to the threefry mask of their "
          f"seed beside their bodies, every lane decrypts; files "
          f"{sizes[0][0]:,} B seeded vs {sizes[0][1]:,} B expanded "
          f"({sizes[0][1] / sizes[0][0]:.1f}x; the arrays {B * 4:,} B vs "
          f"{B * (n0 + 1) * 4:,} B, (n0+1) = {n0 + 1}x)")

    # -- 2. gates on the expanded batch -----------------------------------------
    ids = torch.arange(B, device=dev) % len(gates.GATE_NAMES)
    want = torch.tensor([_TRUTH[gates.GATE_NAMES[i]](bool(p), bool(q))
                         for i, p, q in zip(ids.tolist(), x.tolist(),
                                            y.tolist())], device=dev)
    res, launches["s5 gates"], first_s = _counted_run(
        counters, "slice 5 gates", lambda: gates.apply_gates(ids, a, b, ck), g3)
    accuracy = float((tlwe.decrypt_bool(res, s) == want).float().mean())
    _check(accuracy == 1.0, f"slice 5 gate accuracy {accuracy} != 1.0")
    print(f"apply_gates B={B} on the expanded seeded batch: accuracy "
          f"{accuracy}, launches {launches['s5 gates']}, first call "
          f"{first_s:.2f} s")

    # -- 3. the re-encryption chain Alice -> Bob (asymmetric) -> Carol --------
    bob, carol = key.SecretKey.generate(g, P), key.SecretKey.generate(g, P)
    bob_pk = pr.PublicKeyLv0.generate(g, bob.key_lv0, P)
    rk_ab = pr.ProxyReencryptionKey.new_asymmetric(g, s, bob_pk, P)
    rk_bc = pr.ProxyReencryptionKey.new_symmetric(g, bob.key_lv0,
                                                  carol.key_lv0, P)
    _check(tuple(bob_pk.encryptions.shape) == (2 * n0, n0 + 1)
           and tuple(rk_ab.key_encryptions.shape) == (n0 * P.iks_t, n0 + 1)
           and tuple(rk_bc.key_encryptions.shape) == (n0 * P.iks_t, n0 + 1),
           "public / re-encryption key shapes")
    mu = torch.where(want, 1 / 8, -1 / 8).double()
    ct_hop, t0 = res, time.perf_counter()
    hops = {}
    for name, rk, s_to in (("Alice -> Bob", rk_ab, bob.key_lv0),
                           ("Bob -> Carol", rk_bc, carol.key_lv0)):
        prev, ct_hop = ct_hop, pr.reencrypt(ct_hop, rk)
        _check(ct_hop.device == dev and ct_hop.dtype == torch.int32,
               "reencrypt left the card")
        acc_hop = float((tlwe.decrypt_bool(ct_hop, s_to) == want).float().mean())
        err = tlwe.phase(ct_hop, s_to).double() / 2.0 ** 32 - mu
        err = torch.remainder(err + 0.5, 1.0) - 0.5
        hops[name] = (acc_hop, float(err.std()))
        _check(acc_hop >= REENC_MIN_ACCURACY,
               f"re-encryption {name}: accuracy {acc_hop} < {REENC_MIN_ACCURACY}")
        tc = time.perf_counter()
        cpu = pr.reencrypt(prev[:nc].cpu(), pr.ProxyReencryptionKey(
            rk.key_encryptions.cpu(), rk.basebit, rk.t))
        _check(torch.equal(cpu, ct_hop[:nc].cpu()),
               f"re-encryption {name}: the card differs from the CPU path")
        wall["CPU-path checks"] += time.perf_counter() - tc
    print("reencrypt B=%d: " % B + "; ".join(
        f"{n} accuracy {acc_:.4f}, phase error std {std:.5f} (torus)"
        for n, (acc_, std) in hops.items())
        + f" (bar {REENC_MIN_ACCURACY}); first {nc} lanes of each hop "
        f"bit-equal to the CPU path; public key {tuple(bob_pk.encryptions.shape)} "
        f"({bob_pk.encryptions.numel() * 4 / 1e6:.1f} MB), re-encryption keys "
        f"{tuple(rk_ab.key_encryptions.shape)} "
        f"({rk_ab.key_encryptions.numel() * 4 / 1e6:.1f} MB)")

    # -- 4. key files -------------------------------------------------------------
    serialization.save_public_key(os.path.join(work, "pk"), bob_pk, P)
    serialization.save_reenc_key(os.path.join(work, "rk"), rk_ab, P)
    pk2, p_pk = serialization.load_public_key(os.path.join(work, "pk"), dev)
    rk2, p_rk = serialization.load_reenc_key(os.path.join(work, "rk"), dev)
    _check(p_pk is P and p_rk is P
           and torch.equal(pk2.encryptions, bob_pk.encryptions)
           and (rk2.basebit, rk2.t) == (rk_ab.basebit, rk_ab.t)
           and torch.equal(pr.reencrypt(res, rk2), pr.reencrypt(res, rk_ab)),
           "public / re-encryption key files: arrays or reencrypt differ "
           "after the load")
    print("key files: public and re-encryption keys saved and loaded onto the "
          "card, reencrypt bit-equal after the load")

    # -- 5. the truncated bootstrap ------------------------------------------------
    ck_cpu = _on_cpu(ck)
    trunc = bootstrap.bootstrap_without_key_switch_truncated(a[:nc], ck)
    tc = time.perf_counter()
    trunc_cpu = bootstrap.bootstrap_without_key_switch_truncated(a[:nc].cpu(),
                                                                 ck_cpu)
    wall["CPU-path checks"] += time.perf_counter() - tc
    _check(tuple(trunc.shape) == (nc, n0 + 1)
           and torch.equal(trunc.cpu(), trunc_cpu),
           "bootstrap_without_key_switch_truncated: the card differs from "
           "the CPU path")
    print(f"bootstrap_without_key_switch_truncated B={nc}: "
          f"[{nc}, {n0 + 1}], bit-equal to the CPU path")

    # -- 6. generate_no_ksk ----------------------------------------------------------
    nk = S5_NO_KSK_LANES
    t0 = time.perf_counter()
    ck0 = key.CloudKey.generate_no_ksk(P, group=None, device=dev)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    cfg = (ck0.bsk_group, ck0.bsk_bgbit, ck0.bsk_levels, ck0.bsk_ntt_drop)
    _check(cfg == (ck.bsk_group, ck.bsk_bgbit, ck.bsk_levels, ck.bsk_ntt_drop)
           and ck0.bsk_ntt.shape == ck.bsk_ntt.shape
           and ck0.ksk1.shape == ck.ksk1.shape,
           f"generate_no_ksk(group=None) resolved to {cfg}, "
           f"{tuple(ck0.bsk_ntt.shape)}")
    out0, launches["s5 no_ksk"], _ = _counted_run(
        counters, "generate_no_ksk gates",
        lambda: gates.apply_gates(ids[:nk], a[:nk], b[:nk], ck0), g3)
    tc = time.perf_counter()
    cpu0 = gates.apply_gates(ids[:nk].cpu(), a[:nk].cpu(), b[:nk].cpu(),
                             key.CloudKey.generate_no_ksk(P, group=None,
                                                          device="cpu"))
    wall["CPU-path checks"] += time.perf_counter() - tc
    _check(torch.equal(out0.cpu(), cpu0),
           "generate_no_ksk gates: the card differs from the CPU path")
    print(f"generate_no_ksk {P.name} group=None: {cfg}, bsk_ntt "
          f"{tuple(ck0.bsk_ntt.shape)} zeros, made in {keygen_s:.2f} s; "
          f"apply_gates B={nk}: launches {launches['s5 no_ksk']}, bit-equal "
          f"to the CPU path")

    # -- 7. the int64 finish: TEST_TINY64 on the card ------------------------------
    P64, n64 = params.TEST_TINY64, S5_T64_LANES
    sk64 = key.SecretKey.generate(g, P64)
    ck64 = key.CloudKey.generate(g, sk64, P64)
    x64 = torch.randint(0, 2, (2, n64), generator=g, device=dev).bool()
    a64, b64 = (tlwe.encrypt_bool(g, v, 0.0, sk64.key_lv0, width=64)
                for v in x64)
    ids64 = ids[:n64]
    out64, launches["s5 tiny64"], _ = _counted_run(
        counters, "TEST_TINY64 gates",
        lambda: gates.apply_gates(ids64, a64, b64, ck64),
        {"k1": 0, "k2": 0, "k3": 0})
    tc = time.perf_counter()
    cpu64 = gates.apply_gates(ids64.cpu(), a64.cpu(), b64.cpu(), _on_cpu(ck64))
    wall["CPU-path checks"] += time.perf_counter() - tc
    want64 = torch.tensor([_TRUTH[gates.GATE_NAMES[i]](bool(p), bool(q))
                           for i, p, q in zip(ids64.tolist(), x64[0].tolist(),
                                              x64[1].tolist())], device=dev)
    _check(out64.dtype == torch.int64 and out64.device == dev
           and torch.equal(out64.cpu(), cpu64)
           and torch.equal(tlwe.decrypt_bool(out64, sk64.key_lv0), want64),
           "TEST_TINY64 gates on the card differ from the CPU path or the "
           "truth table")
    print(f"TEST_TINY64 apply_gates B={n64} on the card (direct 64-bit engine, "
          f"int64 finish as plain ops, launches {launches['s5 tiny64']}): "
          f"exact, bit-equal to the CPU path")

    # -- 8. distributed gates: one NCCL rank, then two gloo ranks -------------------
    D.initialize(f"localhost:{_free_port()}", 1, 0)
    try:
        mesh = M.make_mesh()
        run = D.distributed_gates(mesh, D.replicate_global(mesh, ck))
        nccl = run(*(D.global_batch(mesh, t) for t in (ids, a, b)))
        nccl2 = M.shard_map_gates(mesh, ck)(ids, a, b)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    _check(mesh.shape == (1, 1) and torch.equal(nccl, res)
           and torch.equal(nccl2, res),
           "one-rank NCCL distributed_gates / shard_map_gates differ from "
           "apply_gates")
    t0 = time.perf_counter()
    serialization.save_cloud_key(os.path.join(work, "parent_ck"), ck)
    np.savez(os.path.join(work, "batch.npz"), ids=ids.cpu().numpy(),
             a=a.cpu().numpy(), b=b.cpu().numpy())
    port = _free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_WORKER, str(r), str(port), work, root],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        _check(p.returncode == 0 and f"GLOO_OK rank={r}" in out,
               f"gloo rank {r} failed (exit {p.returncode}):\n{out[-3000:]}")
        half = torch.from_numpy(np.load(os.path.join(work, f"out{r}.npy")))
        _check(torch.equal(half, res[r * B // 2:(r + 1) * B // 2].cpu()),
               f"gloo rank {r}'s half differs from apply_gates")
    wall["2 gloo ranks"] = time.perf_counter() - t0
    print(f"distributed gates B={B}: one NCCL rank (distributed_gates and "
          f"shard_map_gates) bit-equal to apply_gates; 2 gloo ranks on the "
          f"one card, the key broadcast from rank 0, each rank's "
          f"{B // 2} lanes bit-equal ({wall['2 gloo ranks']:.1f} s with the "
          f"processes' start)")

    # -- 9. timings (profiling.time_op: CUDA events, median of 3) -----------------
    t0 = time.perf_counter()
    seed0, body0 = seeded[0]
    bits = torch.randint(0, 2, (B,), generator=g, device=dev).bool()
    tms = {
        "reencrypt (asymmetric key)": profiling.time_op(pr.reencrypt, res, rk_ab),
        "reencrypt (symmetric key)": profiling.time_op(pr.reencrypt, res, rk_bc),
        "expand_seeded": profiling.time_op(tlwe.expand_seeded, seed0, body0, n0),
        "encrypt_bool_seeded": profiling.time_op(
            lambda: tlwe.encrypt_bool_seeded(g, bits, alpha, s)[1]),
        "public-key encrypt_bool": profiling.time_op(
            bob_pk.encrypt_bool, g, bits, alpha),
        "PublicKeyLv0.generate": profiling.time_op(
            lambda: pr.PublicKeyLv0.generate(g, bob.key_lv0, P).encryptions),
        "new_asymmetric": profiling.time_op(
            lambda: pr.ProxyReencryptionKey.new_asymmetric(
                g, s, bob_pk, P).key_encryptions),
        "new_symmetric": profiling.time_op(
            lambda: pr.ProxyReencryptionKey.new_symmetric(
                g, bob.key_lv0, carol.key_lv0, P).key_encryptions)}
    # one call each under utils/profiling.trace (a trace file each): the
    # kernels of the plain PyTorch ops, read from the profiler's records
    tdir = os.path.join(work, "traces")
    for name, fn in (("reencrypt", lambda: pr.reencrypt(res, rk_ab)),
                     ("expand_seeded", lambda: tlwe.expand_seeded(
                         seed0, body0, n0))):
        with profiling.trace(tdir) as prof:
            fn()
            torch.cuda.synchronize()
        spans, by_name = _kernel_records(prof)
        _check(bool(spans), f"the trace of {name} holds no CUDA kernel")
        _print_kernels(f"{name} B={B}", spans, by_name, gpu, 5,
                       " (plain PyTorch, no hand kernel)")
    traces = [os.path.getsize(os.path.join(tdir, f)) for f in os.listdir(tdir)]
    _check(len(traces) == 2 and min(traces) > 0,
           f"utils/profiling.trace wrote {traces}, not two trace files")
    wall["timings"] = time.perf_counter() - t0
    per_lane = {k: v / B for k, v in tms.items() if k.startswith("reencrypt")
                or k in ("expand_seeded", "public-key encrypt_bool")}
    print(f"slice 5 timings B={B}: " + ", ".join(
        f"{k} {v * 1e3:.3f} ms" + (f" ({per_lane[k] * 1e6:.3f} us/lane)"
                                   if k in per_lane else "")
        for k, v in tms.items()) + f" [{gpu}]")
    total = time.perf_counter() - t_phase
    print(f"phase 12 wall time {total:.1f} s: " + ", ".join(
        f"{k_} {v_:.1f} s" for k_, v_ in wall.items())
        + f", the rest {total - sum(wall.values()):.1f} s")
    return launches, tms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    import numpy as np

    from zig_tfhe_tpu_torch import key, params, tlwe
    from zig_tfhe_tpu_torch.models import gates
    from zig_tfhe_tpu_torch.ops import ntt
    from zig_tfhe_tpu_torch.ops.blind_rotate import _digit_limbs
    from zig_tfhe_tpu_torch.ops.decomposition import (decompose_rows,
                                                      digit_planes, modswitch,
                                                      row_gadget)
    from zig_tfhe_tpu_torch.ops.cuda import _build
    from zig_tfhe_tpu_torch.ops.cuda import extprod as k3
    from zig_tfhe_tpu_torch.ops.cuda import ntt_inverse as k1
    from zig_tfhe_tpu_torch.ops.cuda import ntt_step as k2
    from zig_tfhe_tpu_torch.ops.cuda import split_step as k2s
    from zig_tfhe_tpu_torch.ops.poly import matmul_i8, negacyclic_rotate
    from zig_tfhe_tpu_torch.trgsw import trgsw_matrices

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(dev)
    gpu = _gpu_line()
    print(f"device: {kind} ({torch.cuda.device_count()} visible); "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; [{gpu}]")

    # -- 2. build the four kernels, in parallel ------------------------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(K2S_PROBES) + 1) as pool:
        probes = [pool.submit(_build.build, k2s.SOURCE, defines=d)
                  for d in K2S_PROBES.values()]
        probes.append(pool.submit(_build.build, CVT_RATE))
        logs = _build.build(k1.SOURCE, k2.SOURCE, k3.SOURCE, k2s.SOURCE)
        for f in probes:
            f.result()
    print(f"built {', '.join(s.name for s in logs)} -> "
          f"{', '.join(_build.library_path(s).name for s in logs)} for sm_90a "
          f"in {time.perf_counter() - t0:.1f} s (and K2s's {len(K2S_PROBES)} "
          f"probe builds and tools/{CVT_RATE.name} beside them)")
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
                text = line.split(':', 1)[-1].strip()
                PTXAS.setdefault((src.name, kernel), []).append(text)
                print(f"  ptxas {src.name} {kernel}: {text}")
    _check_barrett_rates(dev, gpu)

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

    # the uint sets' keys (phase 9; uint4's also in phase 4): group 2, Bg_e
    # 2^22 with (1, 1) levels (3-limb digits), drop 0, 5 primes, each with
    # its packing key
    uint_keys = {}
    for name, steps in (("uint4", 410), ("uint8", 580)):
        PU = params.PARAMS_BY_NAME[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sku = key.SecretKey.generate(g, PU)
        cku = key.CloudKey.generate(g, sku, PU)
        torch.cuda.synchronize()
        cfg = (cku.bsk_group, cku.bsk_bgbit, cku.bsk_levels, cku.bsk_ntt_drop)
        _check(cfg == (2, 22, (1, 1), 0) and cku.bsk_ntt.shape[:3] == (steps, 3, 5)
               and cku.pksk is not None
               and tuple(cku.pksk.shape) == (PU.n1 * PU.iks_t, 2, PU.N),
               f"{name} key {cfg}, bsk_ntt {tuple(cku.bsk_ntt.shape)}")
        uint_keys[name] = (sku, cku)
        print(f"keygen {name} (group 2, Bg_e 2^22 (1, 1), 3 limbs, drop 0, 5 "
              f"primes): {time.perf_counter() - t0:.2f} s, bsk_ntt "
              f"{tuple(cku.bsk_ntt.shape)} int16, pksk "
              f"{tuple(cku.pksk.shape)} int32 at (basebit, t) "
              f"{cku.pksk_gadget}")

    def uniform(shape):
        return torch.randint(0, 1 << 32, shape, dtype=torch.int64,
                             generator=g, device=dev).to(torch.int32)

    # -- 4. kernels vs plain versions at the paths' shapes -------------------
    k_results = {"k1": {}, "k2": {}, "k3": {}}
    step_inputs = {}
    ck4 = uint_keys["uint4"][1]
    plans["uint4"] = ntt.plan_for_params(ck4.params, 0, 2, (1, 1), bgbit=22,
                                         pseudorandom_key=True)
    for name, ck in {**cks, "uint4": ck4}.items():
        PK = ck.params
        plan, drop = plans[name], ck.bsk_ntt_drop
        group, e, levels = ck.bsk_group, ck.bsk_bgbit, ck.bsk_levels
        n_dl = ntt.engine_digit_limbs(e)
        c = uniform((B_GATES, 2, PK.N))
        acc = uniform((B_GATES, 2, PK.N))
        v = k1.split_limbs(torch.stack(
            ntt.ntt_forward(c, plan, digit_limbs=4, digit_bound=128)))
        digits = digit_planes(decompose_rows(acc, PK, levels, bgbit=e), n_dl)
        ts = modswitch(uniform((group, B_GATES)), PK)
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
        print(f"{name}: K1 == plain == exact at [P={plan.n_primes}, B, 2, 2, "
              f"N=1024] int8 limb planes, drop {drop}, and K2 == plain at "
              f"digit limb planes [B, {digits.shape[1]} = R {levels} x "
              f"{n_dl} limbs, 1024], key step {tuple(bsk_step.shape)}, for "
              f"B = {B_GATES}, {RAGGED_LANES}, 1")
        gadget = row_gadget(PK, levels, e)
        nxt = torch.empty_like(digits)
        for lanes in (B_GATES, RAGGED_LANES, 1):
            buf = nxt[:lanes]
            out = k1.ntt_inverse_to_crt_acc(v[:, :lanes], acc[:lanes],
                                            plan, drop, digits=buf,
                                            gadget=gadget)
            _check(torch.equal(out, k1.ntt_inverse_to_crt_acc(
                v[:, :lanes], acc[:lanes], plan, drop)),
                f"K1 with digits changes the accumulator on {name} at "
                f"B={lanes}")
            _check(torch.equal(buf, gadget.planes(out)),
                   f"K1's digit planes differ from the plain version's on "
                   f"{name} at B={lanes}")

        def k1_digits(buf=nxt, v=v, acc=acc, plan=plan, drop=drop,
                      gadget=gadget):
            k1.ntt_inverse_to_crt_acc(v, acc, plan, drop, digits=buf,
                                      gadget=gadget)

        def k1_plain(v=v, acc=acc, plan=plan, drop=drop):
            k1.ntt_inverse_to_crt_acc(v, acc, plan, drop)

        k1_digits()
        k1_plain()
        turns = {"without": [], "with": []}
        for label in ("without", "with") * 4:
            fn = k1_plain if label == "without" else k1_digits
            turns[label].append(_cuda_ms(fn, KERNEL_ITERS))
        ms_wo = statistics.median(turns["without"])
        ms_w = statistics.median(turns["with"])
        digit_times = dict(digits_ms=ms_w, digits_without_ms=ms_wo)
        print(f"{name} B={B_GATES}: K1 with the next digit planes ({n_dl} "
              f"limb{'s' if n_dl > 1 else ''} a digit) "
              f"{ms_w * 1e3:.2f} us/call, without {ms_wo * 1e3:.2f} us "
              f"(medians of 4 turns each, {KERNEL_ITERS} calls a turn; "
              f"with {', '.join(f'{t * 1e3:.2f}' for t in turns['with'])}"
              f"; without "
              f"{', '.join(f'{t * 1e3:.2f}' for t in turns['without'])}); "
              f"planes == plain and the accumulator unchanged at B = "
              f"{B_GATES}, {RAGGED_LANES}, 1 [{gpu}]")

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
        n_rows = int(torch.unique(ts & (2 * PK.N - 1)).numel())
        bound1, by1, unit1, l2_1, cc1 = _k1_bound_ms(plan.n_primes, B_GATES, PK.N)
        bound2, by2, unit2, l2_2, cc2 = _k2_bound_ms(
            plan, group, bsk_step.shape[2], n_dl, B_GATES, n_rows,
            k2.row_groups(plan, group), k2._host_scalars(plan, group, e)[3])
        k_results["k1"][name] = dict(
            max_abs_err=max(errs1), ms=ms1, plain_ms=plain1, bound_ms=bound1,
            bound_by=by1, bound_unit=unit1,
            b1_eager_ms=one1, b1_device_ms=dev1, **digit_times)
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
    want = np.array([_TRUTH[gates.GATE_NAMES[i]](bool(p), bool(q)) for i, p, q
                     in zip(ids.tolist(), x.tolist(), y.tolist())])
    cks[TOEP] = ck_toep
    counters = {"k1": k1.ntt_inverse_to_crt_acc, "k2": k2.ntt_step_fused,
                "k3": k3.extprod_matmul, "k2s": k2s.split_step_fused}
    launches = {}
    for name, ck in cks.items():
        if name == TOEP:
            expect = {"k1": 0, "k2": 0, "k3": P.n0, "k2s": 0}
        else:
            steps = -(-P.n0 // ck.bsk_group)
            expect = {"k1": steps, "k2": steps, "k3": 0, "k2s": 0}
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        k1.ntt_inverse_to_crt_acc.digit_launches = 0
        k2.ntt_step_fused.shape_launches = 0
        k2.ntt_step_fused.uint_shape_launches = 0
        t0 = time.perf_counter()
        res = gates.apply_gates(ids, a, b, ck)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches[name] = {k: fn.launches for k, fn in counters.items()}
        _check(launches[name] == expect,
               f"{name}: launches {launches[name]} in one bootstrap, "
               f"expected {expect}")
        # g3's steps (group 3, R = 4, row groups 4 and 2, 2048 lanes on
        # wide tiles) take K2's instance compiled at that shape
        shape = k2.ntt_step_fused.shape_launches
        uint_shape = k2.ntt_step_fused.uint_shape_launches
        _check(shape == (expect["k2"] if name == "g3" else 0) and uint_shape == 0,
               f"{name}: {shape} and {uint_shape} of {expect['k2']} K2 "
               "launches took g3's and the uint keys' shape instances")
        print(f"{name}: K2 launches {launches[name]['k2']}, of them "
              f"ntt_step_fused.shape_launches {shape}, "
              f"ntt_step_fused.uint_shape_launches {uint_shape}")
        # one-limb keys: every K1 but the last writes the next digits
        digit_launches = k1.ntt_inverse_to_crt_acc.digit_launches
        _check(digit_launches == max(expect["k1"] - 1, 0),
               f"{name}: {digit_launches} K1 launches wrote digits, expected "
               f"{max(expect['k1'] - 1, 0)}")
        _check(res.dtype == torch.int32
               and tuple(res.shape) == (B_GATES, P.n0 + 1),
               f"{name} gate output {res.dtype} {tuple(res.shape)}")
        got = tlwe.decrypt_bool(res, sk.key_lv0).cpu().numpy()
        accuracy = float((got == want).mean())
        _check(accuracy == 1.0, f"{name} gate accuracy {accuracy} != 1.0")
        print(f"apply_gates B={B_GATES} {name}: accuracy {accuracy}, "
              f"launches {launches[name]}, first call {first_s:.2f} s")

        ck_cpu = _on_cpu(ck)
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
            nxt = torch.empty_like(digits)
            stage = {
                "K2": lambda args=(digits, bsk_step, ts, plan, e):
                    k2.ntt_step_fused(*args),
                "K1 with the next digits": lambda args=(v, acc, plan, drop),
                    kw=dict(digits=nxt, gadget=row_gadget(P, levels, e)):
                    k1.ntt_inverse_to_crt_acc(*args, **kw)}
        split = {s: _cuda_ms(fn, KERNEL_ITERS) for s, fn in stage.items()}
        print(f"{name}: one step at B={B_GATES}: " + ", ".join(
            f"{s} {t * 1e3:.1f} us" for s, t in split.items())
            + f" (sum {sum(split.values()) * 1e3:.1f} us) [{gpu}]")

    # -- 7. device busy time and idle share ------------------------------------
    for name, ck in cks.items():
        for lanes in (B_GATES, 1):
            _profile(f"{name} B={lanes}", lambda ck=ck, n=lanes:
                     gates.apply_gates(ids[:n], a[:n], b[:n], ck), gpu)

    phase_s = {"1-7": time.perf_counter() - t_start}
    # -- 8. the circuit path -------------------------------------------------
    circuit_launches = _circuit_phase(P, g, sk, cks["g3"], ck_toep, counters,
                                      gpu)
    launches.update(circuit_launches)
    t_mark = time.perf_counter()
    phase_s["8"] = t_mark - t_start - phase_s["1-7"]

    # -- 9. the LUT path on the uint sets --------------------------------------
    lut_launches = _lut_phase(g, uint_keys, counters, gpu)
    launches.update(lut_launches)
    phase_s["9"] = time.perf_counter() - t_mark
    t_mark = time.perf_counter()

    # -- 10. the integer layer on uint4 ----------------------------------------
    integer_launches = _integer_phase(g, uint_keys, counters, gpu)
    launches.update(integer_launches)
    phase_s["10"] = time.perf_counter() - t_mark
    t_mark = time.perf_counter()

    # -- 11. the 64-bit torus ---------------------------------------------------
    t64_launches, k_results["k1"]["t64"], k2s_t64 = _t64_phase(g, counters,
                                                               gpu)
    k_results["k2s"] = {"t64": k2s_t64}
    launches.update(t64_launches)
    phase_s["11"] = time.perf_counter() - t_mark
    t_mark = time.perf_counter()

    # -- 12. slice 5: seeded ciphertexts, re-encryption, parallel ----------------
    s5_launches, s5_times = _slice5_phase(P, g, sk, cks["g3"], counters, gpu)
    launches.update(s5_launches)
    phase_s["12"] = time.perf_counter() - t_mark

    print(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s: "
          + ", ".join(f"phases {k} {v:.1f} s" for k, v in phase_s.items()))
    kernels = []
    for kk, kname, route_src, replaces, main_path in (
            ("k1", "ntt_inverse_crt_acc", "zig_tfhe_tpu_torch/csrc/ntt_inverse.cu",
             "zig_tfhe_tpu/ops/pallas/ntt_inverse.py:100", "g3"),
            ("k2", "ntt_step_fused", "zig_tfhe_tpu_torch/csrc/ntt_step.cu",
             "zig_tfhe_tpu/ops/pallas/ntt_step.py:229", "g3"),
            ("k3", "extprod_matmul", "zig_tfhe_tpu_torch/csrc/extprod.cu",
             "zig_tfhe_tpu/ops/pallas/extprod.py:57", TOEP),
            # K2's function at the split-ring shape: the JAX package has no
            # Pallas kernel of its own for that step
            ("k2s", "split_step_fused", "zig_tfhe_tpu_torch/csrc/split_step.cu",
             "zig_tfhe_tpu/ops/pallas/ntt_step.py:229", "t64")):
        main = k_results[kk][main_path]
        kernels.append({
            "name": kname, "route": "cuda", "source": route_src,
            "replaces": replaces,
            "launches": sum(n[kk] for n in launches.values()),
            "max_abs_err": max(r["max_abs_err"] for r in k_results[kk].values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "bound_unit": main["bound_unit"],
            # K3: torch._int_mm on the circulants built beforehand (phase
            # 6); no single PyTorch call computes K1, K2 or K2s
            "library_ms": main.get("int_mm_prebuilt_ms"),
            "by_path": {p: {"launches": launches[p][kk], **k_results[kk][p]}
                        for p in k_results[kk]},
            "circuit_launches": {p: n[kk] for p, n in
                                 circuit_launches.items()},
            "lut_launches": {p: n[kk] for p, n in lut_launches.items()},
            "integer_launches": {p: n[kk] for p, n in
                                 integer_launches.items()},
            "t64_launches": {p: n[kk] for p, n in t64_launches.items()},
            "slice5_launches": {p: n[kk] for p, n in s5_launches.items()}})
    print(json.dumps({"slice5_ms": {k: v * 1e3 for k, v in s5_times.items()},
                      "device": gpu}))
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
