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
limb combine; multi-limb digit planes (the uint sets' 2 and 3 limbs, a
ragged row tile at uint4's 10 lanes a tile); for K3, 1 to 4 key limbs, one- and two-limb gadgets, batch
tiles of 64 lanes (full, ragged, several), both stage widths (64- and
128-byte digit chunks), blocks whose two column tiles straddle the two
components (N = 64, 192), and the 128-bit shape (N = 1024, 6 rows: every
key window wraps around 2N in some column tile).  The emulated wgmma with
A from registers is also held against a numpy product on its own, with
the fragments packed in Python by the PTX register layout.  This checks
the kernels' indexing and arithmetic; their behaviour on the card is
tests/test_torch_cuda.py's.  csrc/split_step.cu (K2s, the split-ring
step of the 64-bit torus) is held equal to its plain version on the digits
of real hi-plane accumulators (``_rows_hi32``) and one step of a real
split key, at SECURITY_128_BIT_T64's shape (N/2 = 1024, 4 primes, 10
half-rows, 6 lanes a tile: a ragged last tile, B = 1 on wide and on
narrow column tiles, one block walking every tile), TEST_TINY_SPLIT's (8
half-rows, 8 lanes a tile) and at 6 and 5 half-rows (the instance that
reads 2R at run time); its Barrett, which rounds by an f32 add, is held
equal to the conversion form on edge values, ties and 10^6 int32 per
prime.  Skips where no host C++ compiler is found.
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

from zig_tfhe_tpu_torch import key as TK
from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch.ops import ntt
from zig_tfhe_tpu_torch.ops import split_ring as SR
from zig_tfhe_tpu_torch.ops.cuda import extprod as K3
from zig_tfhe_tpu_torch.ops.cuda import ntt_inverse as K1
from zig_tfhe_tpu_torch.ops.cuda import ntt_step as K2
from zig_tfhe_tpu_torch.ops.cuda import split_step as K2S

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
               for src in (K1.SOURCE, K2.SOURCE, K3.SOURCE, K2S.SOURCE)}
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
    libs["ntt_step"].ztfhe_ntt_step_fused.argtypes = [p] * 11 + [i] * 6 + [p]
    libs["ntt_inverse"].ztfhe_ntt_inverse_crt_acc.argtypes = [p] * 9 + [i] * 5 + [p]
    libs["extprod"].ztfhe_extprod_matmul.argtypes = [p] * 3 + [i] * 4 + [p]
    libs["split_step"].ztfhe_split_step_fused.argtypes = [p] * 9 + [i] * 5 + [p]
    libs["split_step"].ztfhe_split_barrett.argtypes = [p, p, i, i,
                                                       ctypes.c_float, p]
    libs["split_step"].ztfhe_split_barrett_mismatches.argtypes = [
        i, ctypes.c_longlong, i, ctypes.c_float, p, p]
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
        plan.n_primes, group, B, R, 1, N, None)
    assert err == 0
    assert torch.equal(v, K2.ntt_step_fused_reference(digits, bsk, ts, plan,
                                                      bgbit))


# name -> (params, B, emulated SM count): group-2 keys with multi-limb engine
# digits at their key defaults.  TEST_TINY_UINT: Bg_e 2^11, (2, 2) levels, 2
# limbs (8 planes, 8 lanes a tile), 4 primes, N = 256; uint4: Bg_e 2^22, (1,
# 1) levels, 3 limbs (6 planes, 10 lanes a tile), 5 primes, N = 1024, where
# the lower limbs take the reduce-then-combine branch at the three large
# primes and the single add at the two small ones.  B = 11 at uint4 ends one lane into
# the second row tile; one SM walks every tile of the tiny set.
_K2_LIMB_CASES = {
    "tiny_uint_B5": ("tiny_uint", 5, 4),
    "tiny_uint_B17_one_block": ("tiny_uint", 17, 1),
    "uint4_B3": ("uint4", 3, 4),
    "uint4_B11_ragged": ("uint4", 11, 8),
}


@pytest.mark.parametrize("case", sorted(_K2_LIMB_CASES))
def test_step_kernel_source_multi_limb_matches_plain(emu, case):
    """The limb planes of real accumulators' digits (centred remainders
    with a carry into the top limb), a step of in-range key residues."""
    from zig_tfhe_tpu_torch.ops.blind_rotate import _decompose_to_rows

    name, B, sms = _K2_LIMB_CASES[case]
    P = TP.PARAMS_BY_NAME[name]
    bgbit, levels = ntt.default_engine_gadget(P, 2)
    n_dl = ntt.engine_digit_limbs(bgbit)
    assert n_dl > 1
    plan = ntt.plan_for_params(P, 0, 2, levels, bgbit=bgbit,
                               pseudorandom_key=True)
    N, R = plan.N, sum(levels)
    rng = np.random.default_rng(B)
    acc = torch.from_numpy(rng.integers(-2**31, 2**31, (B, 2, N)).astype(np.int32))
    digits = K2.digit_planes(_decompose_to_rows(acc, P, levels, bgbit=bgbit),
                             n_dl)
    rows = torch.from_numpy(rng.integers(-2**31, 2**31, (3, R, 2, N)).astype(np.int32))
    bsk = ntt.to_ntt_form(rows, plan, 0).movedim(0, 1).contiguous()
    ts = torch.from_numpy(rng.integers(0, 2 * N + 1, (2, B)).astype(np.int32))
    tabs = K2._device_tables(plan, torch.device("cpu"))
    primes, inv_p, groups, single = K2._host_scalars(plan, 2, bgbit)
    assert single.shape == (plan.n_primes, n_dl)
    if name == "uint4":     # lower limbs: single add at the two small primes only
        assert single[:, -1].all() and single[:, :-1].sum() == 4
    v = torch.full((plan.n_primes, B, 2, 2, N), 7, dtype=torch.int8)
    emu["ntt_step"].emu_set_sm_count(sms)
    err = emu["ntt_step"].ztfhe_ntt_step_fused(
        digits.data_ptr(), bsk.data_ptr(), ts.data_ptr(),
        tabs.fwd_lo_t.data_ptr(), tabs.fwd_hi_t.data_ptr(), tabs.rot.data_ptr(),
        v.data_ptr(), _ptr(primes), _ptr(inv_p), _ptr(groups), _ptr(single),
        plan.n_primes, 2, B, R, n_dl, N, None)
    assert err == 0
    assert torch.equal(v, K2.ntt_step_fused_reference(digits, bsk, ts, plan,
                                                      bgbit))


def _with_n0(P, n0):
    return dataclasses.replace(P, tlwe_lv0=dataclasses.replace(P.tlwe_lv0, n=n0))


@pytest.fixture(scope="module")
def split_keys():
    """One step of a real split key per set (the port's keygen on the CPU):
    SECURITY_128_BIT_T64 with n0 cut to 2 (one group, (3, 2) levels) and
    TEST_TINY_SPLIT ((2, 2) levels)."""
    out = {}
    for name, P in (("t64", _with_n0(TP.SECURITY_128_BIT_T64, 2)),
                    ("tiny_split", TP.TEST_TINY_SPLIT)):
        g = torch.Generator().manual_seed(len(name))
        sk = TK.SecretKey.generate(g, P)
        ck = TK.CloudKey.generate(g, sk, P, packing_key=False)
        out[name] = (P, ck.bsk_levels, ck.bsk_ntt[0].contiguous())
    return out


# name -> (key, B, emulated SM count[, half-rows kept]).  The entry point
# takes 64 x 128 tiles when they give every SM one, else 64 x 32; one block
# per SM walks the tiles.  Wide tiles at 2R = 10 and 8 (row group 2) run
# the instances compiled for them, any other 2R and every narrow tile the
# one that reads 2R and the row group at run time.  t64: 6 lanes a tile,
# so B = 7 ends one lane into the second row tile; B = 1 on 32 wide tiles
# and (33 SMs) on 128 narrow ones; one block walks all 96 tiles of B = 13
# (many rounds of the ring and of the two d_hat buffers).  tiny_split: 8
# lanes a tile, B = 9 ragged.  The key's first 6 half-rows (10 lanes a
# tile; B = 11: a ragged pair past the first tile) and the first 5 (12
# lanes a tile, an odd lane count at B = 3, narrow tiles) take the
# runtime instance.
_K2S_CASES = {
    "t64_B7_ragged": ("t64", 7, 4),
    "t64_B1": ("t64", 1, 4),
    "t64_B1_narrow": ("t64", 1, 33),
    "t64_B13_one_block": ("t64", 13, 1),
    "tiny_split_B9": ("tiny_split", 9, 4),
    "t64_rl6_runtime": ("t64", 11, 4, 6),
    "tiny_split_rl5_narrow": ("tiny_split", 3, 33, 5),
}


@pytest.mark.parametrize("case", sorted(_K2S_CASES))
def test_split_step_kernel_source_matches_plain(emu, split_keys, case):
    """K2s on the hi-plane digits of uniform int32 accumulators (any
    accumulator mid-scan) and one step of a real split key."""
    name, B, sms, *rows = _K2S_CASES[case]
    P, levels, bsk = split_keys[name]
    plan = ntt.plan_for_params(P, 32, 2, levels, bgbit=8, pseudorandom_key=True)
    assert plan.n_primes == 4 and plan.N == 1024
    rng = np.random.default_rng(B + sms)
    acc = torch.from_numpy(rng.integers(-2**31, 2**31, (B, 2, 2, plan.N))
                           .astype(np.int32))
    digits = SR._rows_hi32(acc, P, 8, levels).to(torch.int8)
    assert digits.shape[1] == 2 * sum(levels) == bsk.shape[2]
    if rows:
        digits = digits[:, :rows[0]].contiguous()
        bsk = bsk[:, :, :rows[0]].contiguous()
    ts = torch.from_numpy(rng.integers(0, 4 * plan.N, (2, B)).astype(np.int32))
    tabs = K2._device_tables(plan, torch.device("cpu"))
    primes, inv_p = K2._host_scalars(plan, 2, 8)[:2]   # p and f32 1/p
    v = torch.full((plan.n_primes, B, 2, 2, 2, plan.N), 7, dtype=torch.int8)
    emu["split_step"].emu_set_sm_count(sms)
    err = emu["split_step"].ztfhe_split_step_fused(
        digits.data_ptr(), bsk.data_ptr(), ts.data_ptr(),
        tabs.fwd_lo_t.data_ptr(), tabs.fwd_hi_t.data_ptr(), tabs.rot.data_ptr(),
        v.data_ptr(), _ptr(primes), _ptr(inv_p), plan.n_primes,
        K2S.row_group(plan), B, digits.shape[1], plan.N, None)
    assert err == 0
    assert torch.equal(v, K2S.split_step_fused_reference(digits, bsk, ts, plan,
                                                         8))


def _barrett_edges(p: int) -> np.ndarray:
    """0, +-1, +-2^23, +-2^24 +- 1, INT_MIN, INT_MAX, and the int32 next to
    each half-way point (q + 1/2) p of q = -2^10 .. 2^10 and of the largest
    q; those whose f32 product lands on q + 1/2 exactly are ties."""
    fixed = [0, 1, -1, 2**23, -2**23, 2**24 + 1, 2**24 - 1, -2**24 + 1,
             -2**24 - 1, -2**31, 2**31 - 1]
    q = np.concatenate([np.arange(-2**10, 2**10), [2**31 // p - 1, -(2**31 // p)]])
    half = (2 * q + 1) * p // 2
    near = (half[:, None] + np.arange(-2, 3)[None, :]).ravel()
    near = near[(near >= -2**31) & (near < 2**31)]
    return np.concatenate([fixed, near]).astype(np.int32)


def test_split_barrett_matches_conversion_form(emu, split_keys):
    """K2s's Barrett (the rounding as an f32 add of 1.5 * 2^23, off the
    conversion pipe) equals __float2int_rn(__fmul_rn(__int2float_rn(x),
    inv_p)) and x - q p of the plain version on the edge values, the ties
    and 10^6 seeded int32, for every prime of the SECURITY_128_BIT_T64 and
    TEST_TINY_SPLIT plans; the kernel's own mismatch counter finds none
    over the 2^21 int32 around 0; both entries refuse a prime below 2^11."""
    primes = set()
    for P, levels, _ in split_keys.values():
        primes |= set(ntt.plan_for_params(P, 32, 2, levels, bgbit=8,
                                          pseudorandom_key=True).primes)
    rng = np.random.default_rng(2**20)
    lib = emu["split_step"]
    lib.emu_set_sm_count(4)
    for p in sorted(primes):
        edges = _barrett_edges(p)
        inv = np.float32(1.0 / p)
        f = edges.astype(np.float32) * inv
        assert (f - np.floor(f) == np.float32(0.5)).any()   # real ties
        x = np.concatenate([edges, rng.integers(-2**31, 2**31, 10**6)
                            .astype(np.int32)])
        r = np.empty_like(x)
        assert lib.ztfhe_split_barrett(_ptr(x), _ptr(r), x.size, p,
                                       float(inv), None) == 0
        assert np.array_equal(r, K2S.barrett_reference(x, p)), p
        n_diff = np.zeros(1, dtype=np.uint64)
        assert lib.ztfhe_split_barrett_mismatches(-2**20, 2**21, p, float(inv),
                                                  _ptr(n_diff), None) == 0
        assert n_diff[0] == 0, p
    # the rounding is exact only for p >= 2^11: the entries refuse smaller
    small = K2S.MIN_PRIME - 1
    assert lib.ztfhe_split_barrett(_ptr(x), _ptr(r), 16, small,
                                   1.0 / small, None) != 0
    assert lib.ztfhe_split_barrett_mismatches(0, 16, small, 1.0 / small,
                                              _ptr(n_diff), None) != 0


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
