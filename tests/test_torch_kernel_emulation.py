"""The hand-written CUDA kernels' own sources, run on the CPU.

zig_tfhe_tpu_torch/csrc/ntt_step.cu (K2), csrc/ntt_inverse.cu (K1) and
csrc/extprod.cu (K3) are compiled with the host C++ compiler against
tests/cuda_emu.h, an emulation of the CUDA they use (one std::thread per
CUDA thread, a barrier for __syncthreads, and host versions of the
functions of csrc/hopper_prims.cuh: mbarriers, TMA loads into swizzled
shared memory, wgmma through its descriptors, and wgmma with A from
registers, which gathers the warpgroup's fragments).  Their C entry points
are called through ctypes on CPU tensors and must equal the plain PyTorch
versions bit for bit, at shapes that cover several column tiles, ragged
batch tiles, B = 1, every column-tile width the entry points pick (forced
through the emulated SM count), 1 to 4 primes, 3 to 10 digit rows,
pointwise sums of up to 5 row groups, and both branches of the forward
limb combine; for K3, 1 to 4 key limbs, one- and two-limb gadgets, batch
tiles of 64 lanes (full, ragged, several), both stage widths (64- and
128-byte digit chunks), blocks whose two column tiles straddle the two
components (N = 64, 192), and the 128-bit shape (N = 1024, 6 rows: every
key window wraps around 2N in some column tile).  The emulated wgmma with
A from registers is also held against a numpy product on its own, with
the fragments packed in Python by the PTX register layout.  This checks
the kernels' indexing and arithmetic; their behaviour on the card is
tests/test_torch_cuda.py's.  Skips where no host C++ compiler is found.
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch.ops import ntt
from zig_tfhe_tpu_torch.ops.cuda import extprod as K3
from zig_tfhe_tpu_torch.ops.cuda import ntt_inverse as K1
from zig_tfhe_tpu_torch.ops.cuda import ntt_step as K2

_EMU_H = Path(__file__).with_name("cuda_emu.h")


def _emulation_source(src: Path) -> str:
    s = src.read_text()
    s = s.replace("#include <cuda_runtime.h>", f'#include "{_EMU_H}"')
    s = s.replace('#include "hopper_prims.cuh"', f'#include "{_EMU_H}"')
    s = s.replace("extern __shared__ __align__(16) unsigned char smem[];",
                  "unsigned char* smem = g_smem;")
    return re.sub(r"(\w+(?:<[\w, ]+>)?)<<<(.*?)>>>\((.*?)\);",
                  lambda m: f"emu_launch([=] {{ {m[1]}({m[3]}); }}, {m[2]});",
                  s, flags=re.S)


# one warpgroup issues one emulated wgmma.m64n64k32 with A from registers:
# frags [128 threads][4] uint32, b [64][32] int8 (row n of the K-major B
# tile, placed 128-byte swizzled), d [128 threads][32] int32 in and out
_WGMMA_RS_HARNESS = f"""
#include "{_EMU_H}"
extern "C" void emu_wgmma_rs(const uint32_t* frags, const int8_t* b, int* d,
                             int accumulate) {{
  for (int n = 0; n < 64; ++n)
    for (int k = 0; k < 32; ++k)
      g_smem[hopper::emu_swizzle(n * 128 + k, 128)] = b[n * 32 + k];
  emu_launch([=] {{
    const int tid = threadIdx.x;
    uint32_t a[4];
    int acc[32];
    for (int i = 0; i < 4; ++i) a[i] = frags[tid * 4 + i];
    for (int i = 0; i < 32; ++i) acc[i] = d[tid * 32 + i];
    hopper::wgmma_fence();
    hopper::wgmma_s8_rs(acc, a, hopper::make_desc<128>(g_smem), accumulate);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    for (int i = 0; i < 32; ++i) d[tid * 32 + i] = acc[i];
  }}, dim3(1), 128);
}}
"""


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler for the CUDA emulation")
    out = tmp_path_factory.mktemp("cuda_emu")
    libs = {}
    sources = {src.stem: _emulation_source(src)
               for src in (K1.SOURCE, K2.SOURCE, K3.SOURCE)}
    sources["wgmma_rs"] = _WGMMA_RS_HARNESS
    for stem, text in sources.items():
        cpp = out / f"{stem}.cpp"
        cpp.write_text(text)
        so = out / f"lib{stem}.so"
        subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off",
                        "-shared", "-fPIC", "-pthread", "-w", "-o", str(so),
                        str(cpp)], check=True, capture_output=True)
        libs[stem] = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    libs["ntt_step"].ztfhe_ntt_step_fused.argtypes = [p] * 11 + [i] * 5 + [p]
    libs["ntt_inverse"].ztfhe_ntt_inverse_crt_acc.argtypes = [p] * 9 + [i] * 5 + [p]
    libs["extprod"].ztfhe_extprod_matmul.argtypes = [p] * 3 + [i] * 4 + [p]
    libs["wgmma_rs"].emu_wgmma_rs.argtypes = [p] * 3 + [i]
    for lib in libs.values():
        lib.emu_set_sm_count.argtypes = [i]
    return libs


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


# name -> (plan, group, digit rows R, engine bgbit, B, emulated SM count).
# The entry point takes 64 x 128 tiles when N % 128 == 0 and they give
# every SM a tile, else 64 x 32 (N = 64: with 64-byte stages); one block
# per SM walks the tiles: a producer thread, a product warpgroup and the
# pointwise warpgroups, two d_hat buffers between the last two.
_K2_CASES = {
    "tiny_g2": (lambda: ntt.plan_for_params(TP.TEST_TINY, 0, 2, (2, 2), bgbit=6,
                                            pseudorandom_key=True), 2, 4, 6, 5, 4),
    "n128_g2_R5_bg6": (lambda: ntt.make_plan(128, 40), 2, 5, 6, 30, 4),
    "n128_g3_R4_bg7": (lambda: ntt.make_plan(128, 40), 3, 4, 7, 40, 4),
    "n128_g3_R10_bg6": (lambda: ntt.make_plan(128, 56), 3, 10, 6, 13, 4),
    "n128_g2_R3_bg8": (lambda: ntt.make_plan(128, 40), 2, 3, 8, 43, 4),
    # N = 1024 at Bg_e 2^8: the forward combine's reduce-then-combine branch
    "n1024_g2_R4_bg8": (lambda: ntt.make_plan(1024, 12), 2, 4, 8, 3, 4),
    # B = 1: one ragged tile per (prime, column tile), narrow tiles
    "n128_g3_R4_B1": (lambda: ntt.make_plan(128, 40), 3, 4, 7, 1, 4),
    "n128_g2_R5_B1_wide": (lambda: ntt.make_plan(128, 40), 2, 5, 6, 1, 1),
    # one block walks all 9 wide tiles (12 lanes each at R = 5): several
    # rounds of the ring and of the two d_hat buffers
    "n128_g2_R5_one_block": (lambda: ntt.make_plan(128, 40), 2, 5, 6, 30, 1),
    # narrow tiles forced at a batch of three row tiles; 7 blocks, 36 tiles
    "n128_g3_R4_narrow": (lambda: ntt.make_plan(128, 40), 3, 4, 7, 40, 7),
    "tiny_g3_one_block": (lambda: ntt.plan_for_params(
        TP.TEST_TINY, 0, 3, (2, 2), bgbit=6, pseudorandom_key=True), 3, 4, 6, 37, 1),
}


@pytest.mark.parametrize("case", sorted(_K2_CASES))
def test_step_kernel_source_matches_plain(emu, case):
    make_plan, group, R, bgbit, B, sms = _K2_CASES[case]
    plan = make_plan()
    N, S = plan.N, (1 << group) - 1
    rng = np.random.default_rng(R * B)
    half = 1 << (bgbit - 1)
    digits = torch.from_numpy(rng.integers(-half, half, (B, R, N)).astype(np.int8))
    rows = torch.from_numpy(rng.integers(-2**31, 2**31, (S, R, 2, N)).astype(np.int32))
    bsk = ntt.to_ntt_form(rows, plan, 3).movedim(0, 1).contiguous()
    ts = torch.from_numpy(rng.integers(0, 2 * N + 1, (group, B)).astype(np.int32))
    tabs = K2._device_tables(plan, torch.device("cpu"))
    primes, inv_p, groups, single = K2._host_scalars(plan, group, bgbit)
    if case == "n1024_g2_R4_bg8":
        assert not single.any()
    v = torch.full((plan.n_primes, B, 2, 2, N), 7, dtype=torch.int8)
    emu["ntt_step"].emu_set_sm_count(sms)
    err = emu["ntt_step"].ztfhe_ntt_step_fused(
        digits.data_ptr(), bsk.data_ptr(), ts.data_ptr(),
        tabs.fwd_lo_t.data_ptr(), tabs.fwd_hi_t.data_ptr(), tabs.rot.data_ptr(),
        v.data_ptr(), _ptr(primes), _ptr(inv_p), _ptr(groups), _ptr(single),
        plan.n_primes, group, B, R, N, None)
    assert err == 0
    assert torch.equal(v, K2.ntt_step_fused_reference(digits, bsk, ts, plan,
                                                      bgbit))


# (B, N, bits, drop, emulated SM count): the entry point takes 64-wide column
# tiles when they give every SM a block, else 32-wide ones.  B = 70 is two
# row tiles, the second with one live warpgroup; B = 100 ends inside the
# second warpgroup's rows; 1000 SMs force the narrow tile at a large B, one
# SM the wide tile at B = 1.
@pytest.mark.parametrize("B, N, bits, drop, sms", [
    (3, 64, 40, 0, 4), (70, 128, 40, 5, 4), (1, 128, 40, 5, 4),
    (100, 128, 40, 3, 1000), (1, 64, 40, 0, 1), (100, 128, 56, 2, 4)])
def test_inverse_kernel_source_matches_plain(emu, B, N, bits, drop, sms):
    plan = ntt.make_plan(N, bits)
    rng = np.random.default_rng(B)
    c, acc = (torch.from_numpy(rng.integers(-2**31, 2**31, (B, 2, N))
                               .astype(np.int32)) for _ in range(2))
    v = K1.split_limbs(torch.stack(ntt.ntt_forward(c, plan, digit_limbs=4,
                                                   digit_bound=128)))
    tabs = K1._kernel_tables(plan, torch.device("cpu"))
    out = torch.empty_like(acc)
    emu["ntt_inverse"].emu_set_sm_count(sms)
    err = emu["ntt_inverse"].ztfhe_ntt_inverse_crt_acc(
        v.data_ptr(), acc.data_ptr(), out.data_ptr(), tabs.m_lo.data_ptr(),
        tabs.m_hi.data_ptr(), _ptr(tabs.primes), _ptr(tabs.crt_e),
        _ptr(tabs.inv_p), _ptr(tabs.theta), plan.p_mod, plan.n_primes, 2 * B,
        N, drop, None)
    assert err == 0
    assert torch.equal(out, K1.ntt_inverse_to_crt_acc_reference(v, acc, plan,
                                                                drop))
    assert torch.equal(out, acc + (c << drop))


def _with_n(P, N):
    return dataclasses.replace(P, trgsw_lv1=dataclasses.replace(P.trgsw_lv1, n=N))


# K3 at ring degrees no parameter set has: N = 128 (128-byte chunks, one a
# row, two column blocks), N = 192 (64-byte chunks; the middle block's two
# column tiles lie in o = 0 and o = 1)
_K3_PARAMS = {"n128": _with_n(TP.TEST_TINY, 128), "n192": _with_n(TP.TEST_TINY, 192)}


# (params, key limbs, B): a block takes 64 batch lanes and 128 output
# columns, 64 per consumer warpgroup.  tiny (N = 64): one block of 64-byte
# chunks whose two column tiles are o = 0 and o = 1; B = 63 / 64 / 65 / 130
# end inside, at and just past a batch tile, and span three; 128bit (N =
# 1024, 128-byte chunks, 16 column blocks): every window wraps at some block.
@pytest.mark.parametrize("name, n_kl, B", [
    ("tiny", 4, 5), ("tiny", 3, 130), ("tiny", 1, 1), ("tiny_uint", 2, 3),
    ("128bit", 1, 3), ("tiny", 4, 63), ("tiny", 2, 64), ("tiny", 4, 65),
    ("tiny", 4, 130), ("n128", 4, 70), ("n192", 3, 9), ("128bit", 4, 2)])
def test_extprod_kernel_source_matches_plain(emu, name, n_kl, B):
    P = _K3_PARAMS.get(name) or TP.PARAMS_BY_NAME[name]
    N, L = P.N, P.L
    rng = np.random.default_rng(B + n_kl)
    d_max = 1 << (P.bgbit - 1) if P.digit_limbs == 1 else 128
    digits = torch.from_numpy(rng.integers(-d_max, d_max, (B, 2 * L * N))
                              .astype(np.int8))
    ext = torch.from_numpy(rng.integers(-128, 128, (n_kl, 2 * L, 2, 2 * N))
                           .astype(np.int8))
    out = torch.full((B, 2 * N), 7, dtype=torch.int32)
    err = emu["extprod"].ztfhe_extprod_matmul(
        digits.data_ptr(), ext.data_ptr(), out.data_ptr(), B, 2 * L, N, n_kl,
        None)
    assert err == 0
    assert torch.equal(out, K3.extprod_matmul_reference(digits, ext, P))


def _pack_a_fragments(A: np.ndarray) -> np.ndarray:
    """A int8 [64, 32] -> the registers of a warpgroup, uint32 [128, 4], by
    the PTX ISA's register layout of wgmma .m64nNk32 .s8 A: thread 32 w + 4
    g + t holds rows 16 w + g (registers 0, 2) and 16 w + g + 8 (1, 3), at
    contraction 4 t .. 4 t + 3 (registers 0, 1) and 16 + 4 t .. (2, 3), the
    lowest k in the lowest byte."""
    frags = np.zeros((128, 4), dtype=np.uint32)
    for tid in range(128):
        w, g, t = tid // 32, (tid % 32) // 4, tid % 4
        for reg in range(4):
            row = 16 * w + g + 8 * (reg % 2)
            k0 = 4 * t + 16 * (reg // 2)
            frags[tid, reg] = A[row, k0:k0 + 4].view(np.uint8).astype(
                np.uint32) @ (np.uint32(1) << np.arange(0, 32, 8, dtype=np.uint32))
    return frags


@pytest.mark.parametrize("accumulate", [0, 1])
def test_emulated_wgmma_rs_matches_numpy(emu, accumulate):
    """The emulated wgmma_s8_rs against A @ B^T (+ C) in numpy, mod 2^32."""
    rng = np.random.default_rng(11 + accumulate)
    A = rng.integers(-128, 128, (64, 32)).astype(np.int8)
    Bm = rng.integers(-128, 128, (64, 32)).astype(np.int8)
    C = rng.integers(-2**31, 2**31, (64, 64)).astype(np.int64)
    tid = np.arange(128)[:, None]
    i = np.arange(32)[None, :]
    rows = 16 * (tid // 32) + (tid % 32) // 4 + 8 * ((i // 2) % 2)
    cols = 8 * (i // 4) + 2 * (tid % 4) + i % 2
    d = C[rows, cols].astype(np.int32)
    frags = np.ascontiguousarray(_pack_a_fragments(A))
    b = np.ascontiguousarray(Bm)
    emu["wgmma_rs"].emu_wgmma_rs(_ptr(frags), _ptr(b), _ptr(d), accumulate)
    want = A.astype(np.int64) @ Bm.astype(np.int64).T + (C if accumulate else 0)
    want = ((want + 2**31) % 2**32 - 2**31).astype(np.int32)
    assert np.array_equal(d, want[rows, cols])
