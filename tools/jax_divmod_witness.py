#!/usr/bin/env python3
"""The JAX package's own radix_divmod, on the CPU at SECURITY_UINT4, on
the lanes whose quotient the port got wrong on the card: it must return
the same ciphertexts, so the misses are the algorithm's at this set's
noise and not the port's.

    python3 tools/jax_divmod_witness.py PREFIX [LANES.npz]

PREFIX_sk.npz / PREFIX_ck.npz are a uint4 key in the JAX package's files.
Where they do not exist this script makes them first (SecretKey from
jax.random.key(7), CloudKey from key(8); a few minutes and ~2 GiB on the
CPU).  LANES.npz is what ``tools/torch_integer_noise.py --jax-key PREFIX
--witness-out LANES.npz`` wrote on a GPU with that key: the plain
operands ``a``, ``b``, their ciphertexts ``ca``, ``cb`` [L, 2, n0+1] and
the card's quotient and remainder ``q``, ``r``.  For each lane this
prints a // b, the quotient the card and the JAX package decrypt to, and
whether the JAX package's quotient and remainder ciphertexts equal the
card's bit for bit; it exits 1 unless every lane's do.  Imports JAX;
runs on the CPU only.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from zig_tfhe_tpu import key, params
    from zig_tfhe_tpu.models import integer
    from zig_tfhe_tpu.utils import serialization

    prefix = sys.argv[1]
    P = params.SECURITY_UINT4
    if not os.path.exists(prefix + "_ck.npz"):
        t0 = time.perf_counter()
        sk = key.SecretKey.generate(jax.random.key(7), P)
        ck = key.CloudKey.generate(jax.random.key(8), sk, P)
        serialization.save_secret_key(prefix + "_sk", sk, P)
        serialization.save_cloud_key(prefix + "_ck", ck)
        print(f"made {prefix}_sk.npz, {prefix}_ck.npz "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if len(sys.argv) == 2:
        return 0
    sk, P_sk = serialization.load_secret_key(prefix + "_sk")
    ck = serialization.load_cloud_key(prefix + "_ck")
    if P_sk.name != P.name or ck.params.name != P.name:
        raise ValueError(f"{prefix}: not a {P.name} key")
    z = np.load(sys.argv[2])
    a, b = z["a"], z["b"]
    t0 = time.perf_counter()
    q, r = integer.radix_divmod(jnp.asarray(z["ca"]), jnp.asarray(z["cb"]), ck)
    q, r = np.asarray(q), np.asarray(r)
    dt = time.perf_counter() - t0
    q_jax = integer.decrypt_radix(jnp.asarray(q), sk.key_lv0)
    q_card = integer.decrypt_radix(jnp.asarray(z["q"]), sk.key_lv0)
    same = [bool(np.array_equal(q[i], z["q"][i]) and
                 np.array_equal(r[i], z["r"][i])) for i in range(len(a))]
    for i in range(len(a)):
        print(f"lane {i}: {a[i]} // {b[i]} = {a[i] // b[i]}; card {q_card[i]}, "
              f"JAX package {q_jax[i]}; quotient and remainder ciphertexts "
              f"{'bit-equal' if same[i] else 'DIFFER'}", flush=True)
    print(f"JAX package radix_divmod on {len(a)} lanes at {P.name}, CPU: "
          f"{sum(same)} of {len(a)} bit-equal to the card, "
          f"{int((q_jax != a // b).sum())} wrong quotients ({dt:.1f} s)")
    return 0 if all(same) else 1


if __name__ == "__main__":
    sys.exit(main())
