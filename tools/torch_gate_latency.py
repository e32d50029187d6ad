#!/usr/bin/env python3
"""Latency of one bootstrapped gate (B = 1) of the PyTorch/CUDA port on one
GPU, for comparing two trees inside one run.

    PYTHONPATH=<tree> python3 tools/torch_gate_latency.py <label>

Imports zig_tfhe_tpu_torch from PYTHONPATH (so the same script can time an
unpacked older commit and the working tree in turns: a, b, b, a), makes the
128-bit default key (g3) and the group-2 (3, 2) key (g2) on the card from a
fixed seed, and prints six host-clock times of apply_gates on one lane per
key, each ended by a synchronise, after one warm call.  B = 1 is bound by
the host's launches, so compare medians only within one run on one
machine.  Needs a CUDA device.
"""

import sys
import time

import torch

from zig_tfhe_tpu_torch import key, params, tlwe
from zig_tfhe_tpu_torch.models import gates


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gate_latency: no CUDA device", file=sys.stderr)
        return 2
    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    dev = torch.device("cuda", 0)
    P = params.SECURITY_128_BIT
    g = torch.Generator(device=dev).manual_seed(1)
    sk = key.SecretKey.generate(g, P)
    for name, knobs in (("g3", {}), ("g2", {"group": 2, "decomp_levels": (3, 2)})):
        ck = key.CloudKey.generate(g, sk, P, **knobs)
        x = torch.tensor([True], device=dev)
        a = tlwe.encrypt_bool(g, x, P.ksk_alpha, sk.key_lv0)
        b = tlwe.encrypt_bool(g, x, P.ksk_alpha, sk.key_lv0)
        ids = torch.zeros(1, dtype=torch.int64, device=dev)
        gates.apply_gates(ids, a, b, ck)
        torch.cuda.synchronize()
        times = []
        for _ in range(6):
            t0 = time.perf_counter()
            gates.apply_gates(ids, a, b, ck)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        print(label, name, "B=1 ms:", " ".join(f"{t:.1f}" for t in times),
              f"[{torch.cuda.get_device_name(0)}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
