#!/usr/bin/env python3
"""PBS output noise and radix_divmod accuracy of the integer layer at
SECURITY_UINT4 on one GPU, for the port's own key and, optionally, a key
made by the JAX package.

    python3 tools/torch_integer_noise.py [--jax-key PREFIX [--witness-out FILE]]

For each key: 2048 noiseless message-16 inputs through a plain bootstrap
(the mod table) and two multi-value ones (ubit0 alone; div of mod/div/div8,
division's quotient-bit rotation): the std and max of the output phase's
distance from its message (torus units; the m = 16 half-bin is 1/64).
Then radix_divmod on LANES = 1,024 pairs of 6-bit operands (2 digits,
divisors >= 1, a numpy seed) at the set's noise: wrong quotients and
remainders, and the noise of the final reassembly's inputs b0 + 2 b1 + 4 b2
(in message units; 0.5 is the bin edge), read through chip_smoke.py's
divmod probe.

The JAX package's key comes from its own files, PREFIX_sk.npz and
PREFIX_ck.npz, which ``tools/jax_divmod_witness.py PREFIX`` makes where
that package runs; this script loads them with the port's loaders.  With
``--witness-out FILE`` it writes the first WITNESS_LANES lanes whose
quotient that key's run got wrong (operands, input ciphertexts, the card's
quotient and remainder) to FILE, for ``tools/jax_divmod_witness.py PREFIX
FILE`` to run through the JAX package's own radix_divmod.
Prints the card's nvidia-smi name and power limit first.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LANES = 1024           # divmod lanes per key
WITNESS_LANES = 4      # wrong-quotient lanes written for the JAX witness


def _noise(name, sk, ck, g, witness_out=None):
    import numpy as np
    import torch

    import chip_smoke as cs
    from zig_tfhe_tpu_torch import tlwe
    from zig_tfhe_tpu_torch.models import integer

    s = sk.key_lv0
    dev = s.device
    vals = torch.arange(2048, device=dev) % 16
    ct = tlwe.encrypt_message(g, vals, 16, 0.0, s)         # noiseless inputs
    outs = {"plain mod": (integer._pbs_rows(ct[None], ("mod",), ck)[0], vals % 8),
            "multi-value ubit0": (integer._pbs_mv(ct, ("ubit0",), ck)[0], vals & 1),
            "multi-value div of (mod, div, div8)":
                (integer._pbs_mv(ct, ("mod", "div", "div8"), ck)[1], vals // 8)}
    for kind, (out, want) in outs.items():
        ph = tlwe.phase(out, s).double() / 2**32
        err = (ph - want.double() / 32 + 0.5) % 1.0 - 0.5
        print(f"{name}, {kind}: output noise std {float(err.std()):.3e}, max "
              f"{float(err.abs().max()):.3e} (torus)", flush=True)
    rng = np.random.default_rng(2026)
    a = rng.integers(0, 64, LANES)
    b = rng.integers(1, 64, LANES)
    alpha = ck.params.tlwe_lv0.alpha
    ca = integer.encrypt_radix(g, a, 2, alpha, s)
    cb = integer.encrypt_radix(g, b, 2, alpha, s)
    t0 = time.perf_counter()
    with cs._DivmodProbe(integer) as probe:
        q, r = integer.radix_divmod(ca, cb, ck)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    qd, rd = integer.decrypt_radix(q, s), integer.decrypt_radix(r, s)
    qt = a // b
    err = cs._reassembly_noise(probe.final[0][0], qt, s)
    print(f"{name}, radix_divmod B={LANES}: quotient wrong on "
          f"{int((qd != qt).sum())} lanes, remainder wrong on "
          f"{int((rd != a % b).sum())}; reassembly inputs' noise std "
          f"{float(err.std()):.3f}, max {float(err.abs().max()):.3f} message "
          f"units; {dt:.1f} s", flush=True)
    if witness_out:
        lanes = np.nonzero(qd != a // b)[0][:WITNESS_LANES]
        np.savez(witness_out, a=a[lanes], b=b[lanes],
                 **{k: v.cpu().numpy()[lanes]
                    for k, v in (("ca", ca), ("cb", cb), ("q", q), ("r", r))})
        print(f"{name}: lanes {lanes.tolist()} written to {witness_out}",
              flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jax-key", help="prefix of a JAX-made uint4 key's files")
    ap.add_argument("--witness-out", help="write the JAX-made key's first "
                    "wrong-quotient lanes here (needs --jax-key)")
    args = ap.parse_args()
    if args.witness_out and not args.jax_key:
        ap.error("--witness-out needs --jax-key")
    if not torch.cuda.is_available():
        print("torch_integer_noise: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from zig_tfhe_tpu_torch import key, params
    from zig_tfhe_tpu_torch.ops.cuda import _build
    from zig_tfhe_tpu_torch.ops.cuda import extprod as k3
    from zig_tfhe_tpu_torch.ops.cuda import ntt_inverse as k1
    from zig_tfhe_tpu_torch.ops.cuda import ntt_step as k2
    from zig_tfhe_tpu_torch.utils import serialization

    dev = torch.device("cuda", 0)
    print(cs._gpu_line(), flush=True)
    _build.build(k1.SOURCE, k2.SOURCE, k3.SOURCE)
    P = params.SECURITY_UINT4
    g = torch.Generator(device=dev).manual_seed(99)
    sk = key.SecretKey.generate(g, P)
    keys = [("the port's key", sk, key.CloudKey.generate(g, sk, P), None)]
    if args.jax_key:
        sk_j, P_j = serialization.load_secret_key(args.jax_key + "_sk", device=dev)
        ck_j = serialization.load_cloud_key(args.jax_key + "_ck", device=dev)
        if P_j is not P or ck_j.params is not P:
            raise ValueError(f"{args.jax_key}: not a {P.name} key")
        keys.append(("the JAX package's key", sk_j, ck_j, args.witness_out))
    for name, sk_, ck_, out in keys:
        _noise(name, sk_, ck_, g, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
