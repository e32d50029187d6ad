"""The hand-written CUDA kernels' own sources, run on the CPU.

zig_tfhe_tpu_torch/csrc/ntt_step.cu (K2) and csrc/ntt_inverse.cu (K1) are
compiled with the host C++ compiler against tests/cuda_emu.h, an
emulation of the CUDA they use (one std::thread per CUDA thread, a
barrier for __syncthreads, mma.sync computed per warp from the lanes'
fragments).  Their C entry points are called through ctypes on CPU tensors
and must equal the plain PyTorch versions bit for bit, at shapes that
cover several column tiles, ragged batch tiles, 1 to 4 primes, 3 to 10
digit rows, pointwise sums of up to 5 row groups, and both branches of
the forward limb combine.  This checks the kernels' indexing and
arithmetic; their behaviour on the card is tests/test_torch_cuda.py's.
Skips where no host C++ compiler is found.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch.ops import ntt
from zig_tfhe_tpu_torch.ops.cuda import ntt_inverse as K1
from zig_tfhe_tpu_torch.ops.cuda import ntt_step as K2

_EMU_H = Path(__file__).with_name("cuda_emu.h")


def _emulation_source(src: Path) -> str:
    s = src.read_text()
    s = s.replace("#include <cuda_runtime.h>", f'#include "{_EMU_H}"')
    s = re.sub(r"asm volatile\(.*?\);", "emu_mma(c, a, b0, b1);", s, flags=re.S)
    s = s.replace("extern __shared__ __align__(16) unsigned char smem[];",
                  "unsigned char* smem = g_smem;")
    return re.sub(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);",
                  lambda m: f"emu_launch([=] {{ {m[1]}({m[3]}); }}, {m[2]});",
                  s, flags=re.S)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler for the CUDA emulation")
    out = tmp_path_factory.mktemp("cuda_emu")
    libs = {}
    for src in (K1.SOURCE, K2.SOURCE):
        cpp = out / f"{src.stem}.cpp"
        cpp.write_text(_emulation_source(src))
        so = out / f"lib{src.stem}.so"
        subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off",
                        "-shared", "-fPIC", "-pthread", "-w", "-o", str(so),
                        str(cpp)], check=True, capture_output=True)
        libs[src.stem] = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    libs["ntt_step"].ztfhe_ntt_step_fused.argtypes = [p] * 11 + [i] * 5 + [p]
    libs["ntt_inverse"].ztfhe_ntt_inverse_crt_acc.argtypes = [p] * 9 + [i] * 5 + [p]
    return libs


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


# name -> (plan, group, digit rows R, engine bgbit, B)
_K2_CASES = {
    "tiny_g2": (lambda: ntt.plan_for_params(TP.TEST_TINY, 0, 2, (2, 2), bgbit=6,
                                            pseudorandom_key=True), 2, 4, 6, 5),
    "n128_g2_R5_bg6": (lambda: ntt.make_plan(128, 40), 2, 5, 6, 30),
    "n128_g3_R4_bg7": (lambda: ntt.make_plan(128, 40), 3, 4, 7, 40),
    "n128_g3_R10_bg6": (lambda: ntt.make_plan(128, 56), 3, 10, 6, 13),
    "n128_g2_R3_bg8": (lambda: ntt.make_plan(128, 40), 2, 3, 8, 43),
    # N = 1024 at Bg_e 2^8: the forward combine's reduce-then-combine branch
    "n1024_g2_R4_bg8": (lambda: ntt.make_plan(1024, 12), 2, 4, 8, 3),
}


@pytest.mark.parametrize("case", sorted(_K2_CASES))
def test_step_kernel_source_matches_plain(emu, case):
    make_plan, group, R, bgbit, B = _K2_CASES[case]
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
    v = torch.full((plan.n_primes, B, 2, N), 7, dtype=torch.int32)
    err = emu["ntt_step"].ztfhe_ntt_step_fused(
        digits.data_ptr(), bsk.data_ptr(), ts.data_ptr(),
        tabs.fwd_lo_t.data_ptr(), tabs.fwd_hi_t.data_ptr(), tabs.rot.data_ptr(),
        v.data_ptr(), _ptr(primes), _ptr(inv_p), _ptr(groups), _ptr(single),
        plan.n_primes, group, B, R, N, None)
    assert err == 0
    assert torch.equal(v, K2.ntt_step_fused_reference(digits, bsk, ts, plan,
                                                      bgbit))


@pytest.mark.parametrize("B, N, bits, drop", [(3, 64, 40, 0), (70, 128, 40, 5)])
def test_inverse_kernel_source_matches_plain(emu, B, N, bits, drop):
    plan = ntt.make_plan(N, bits)
    rng = np.random.default_rng(B)
    c, acc = (torch.from_numpy(rng.integers(-2**31, 2**31, (B, 2, N))
                               .astype(np.int32)) for _ in range(2))
    v = torch.stack(ntt.ntt_forward(c, plan, digit_limbs=4, digit_bound=128))
    tabs = K1._kernel_tables(plan, torch.device("cpu"))
    out = torch.empty_like(acc)
    err = emu["ntt_inverse"].ztfhe_ntt_inverse_crt_acc(
        v.data_ptr(), acc.data_ptr(), out.data_ptr(), tabs.m_lo.data_ptr(),
        tabs.m_hi.data_ptr(), _ptr(tabs.primes), _ptr(tabs.crt_e),
        _ptr(tabs.inv_p), _ptr(tabs.theta), plan.p_mod, plan.n_primes, 2 * B,
        N, drop, None)
    assert err == 0
    assert torch.equal(out, K1.ntt_inverse_to_crt_acc_reference(v, acc, plan,
                                                                drop))

