"""zig_tfhe_tpu_torch — the PyTorch/CUDA port of zig_tfhe_tpu.

TFHE boolean gates with exact mod-2^32 arithmetic: int8-limb matrix
products for the NTT and the key switch, and hand-written Hopper kernels
for the blind-rotation step (ops/cuda/ntt_step.py: forward NTT, pointwise
products, subset combine; ops/cuda/ntt_inverse.py: inverse NTT + CRT
lift; ops/cuda/extprod.py: the Toeplitz engine's external product, for
keys made with ``engines=("toeplitz",)``).  The JAX package
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

__version__ = "0.1.0"
