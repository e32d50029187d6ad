"""zig_tfhe_tpu_torch — the PyTorch/CUDA port of zig_tfhe_tpu.

TFHE boolean gates with exact mod-2^32 (and, on the 64-bit torus sets,
mod-2^64) arithmetic: int8-limb matrix products for the NTT and the key
switch, and hand-written Hopper kernels
for the blind-rotation step (ops/cuda/ntt_step.py: forward NTT, pointwise
products, subset combine; ops/cuda/ntt_inverse.py: inverse NTT + CRT
lift; ops/cuda/extprod.py: the Toeplitz engine's external product, for
keys made with ``engines=("toeplitz",)``).  Circuits build on the gates:
models/circuits.py (bit codecs, full adder, ripple-carry and Kogge-Stone
adders), models/netlists.py (Bristol netlists, such as the 64x64
multiplier) and models/scheduler.py (the repository's native level
scheduler, built with g++ at first use, and an evaluator that runs each
level as one batched bootstrap).  Programmable bootstrapping runs on the
uint sets' keys: models/lut.py (lookup tables, multi-value and radix tree
PBS, bivariate LUTs) on the packing key switch of
ops/packing_keyswitch.py, and models/integer.py builds encrypted integers
on those LUTs (FheUint and FheInt: radix arithmetic, comparisons, shifts,
mul, divmod, the bridge to the boolean gates).  The N = 2048 sets of the
64-bit torus run the even/odd split-ring engine of ops/split_ring.py.
utils/serialization.py saves and loads keys and ciphertexts in the JAX
package's file format.  models/proxy_reenc.py holds public keys and proxy
re-encryption; tlwe.encrypt_*_seeded give seeded ciphertexts whose mask
is the JAX package's threefry draw (utils/threefry.py);
utils/security.py estimates a set's lattice security, utils/profiling.py
traces and times; parallel/ splits a batch over torch.distributed ranks.  The JAX package
``zig_tfhe_tpu`` is the reference: on equal keys and ciphertexts both
return the same bits.  This package imports torch and numpy only.

Quick start::

    import torch
    from zig_tfhe_tpu_torch import params, key, tlwe
    from zig_tfhe_tpu_torch.models import gates

    g = torch.Generator(device="cuda").manual_seed(0)
    sk = key.SecretKey.generate(g, params.SECURITY_128_BIT)
    ck = key.CloudKey.generate(g, sk, params.SECURITY_128_BIT)
    a = tlwe.encrypt_bool(g, [True], params.SECURITY_128_BIT.ksk_alpha, sk.key_lv0)
    b = tlwe.encrypt_bool(g, [False], params.SECURITY_128_BIT.ksk_alpha, sk.key_lv0)
    out = gates.gate("nand", a, b, ck)
    tlwe.decrypt_bool(out, sk.key_lv0)   # tensor([True])
"""

from zig_tfhe_tpu_torch import params
from zig_tfhe_tpu_torch import utils
from zig_tfhe_tpu_torch import ops
from zig_tfhe_tpu_torch import tlwe
from zig_tfhe_tpu_torch import trlwe
from zig_tfhe_tpu_torch import trgsw
from zig_tfhe_tpu_torch import key
from zig_tfhe_tpu_torch import bootstrap
from zig_tfhe_tpu_torch import models
from zig_tfhe_tpu_torch import parallel

__version__ = "0.1.0"


def get_info() -> dict:
    """Library info (main.zig:85-97 analog): name, version, backend
    ("cuda" with a card, else "cpu"), the visible cards' count and the
    first one's name, and the default parameter set."""
    import torch

    cuda = torch.cuda.is_available()
    return {
        "name": "zig_tfhe_tpu_torch",
        "version": __version__,
        "backend": "cuda" if cuda else "cpu",
        "devices": torch.cuda.device_count() if cuda else 0,
        "device_name": torch.cuda.get_device_name(0) if cuda else None,
        "default_security": params.DEFAULT_SECURITY.name,
    }


def print_info() -> None:
    for k, v in get_info().items():
        print(f"{k}: {v}")
