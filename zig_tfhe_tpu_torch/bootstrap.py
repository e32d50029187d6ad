"""Gate bootstrapping (bootstrap/vanilla.zig:38-52), batch-first.

Counterpart of zig_tfhe_tpu/bootstrap.py: blind rotate -> sample extract
at 0 -> identity key switch.  ``bootstrap_to_lv1`` stops before the key
switch and returns the TLWE lv1 ciphertext (the optimized MUX combines two
of them under one key switch).
"""

from __future__ import annotations

import torch

from zig_tfhe_tpu_torch import trlwe as _trlwe
from zig_tfhe_tpu_torch.key import CloudKey
from zig_tfhe_tpu_torch.ops.blind_rotate import blind_rotate
from zig_tfhe_tpu_torch.ops.keyswitch import identity_key_switch


def bootstrap(tlwe_batch: torch.Tensor, ck: CloudKey) -> torch.Tensor:
    """Full gate bootstrap: [B, n0+1] -> refreshed [B, n0+1]."""
    return identity_key_switch(bootstrap_to_lv1(tlwe_batch, ck), ck.ksk1,
                               ck.params)


def bootstrap_to_lv1(tlwe_batch: torch.Tensor, ck: CloudKey) -> torch.Tensor:
    """Blind rotate + extract, no key switch: [B, n0+1] -> [B, N+1] (lv1)."""
    tr = blind_rotate(tlwe_batch, ck.testvec, ck, ck.params)
    return _trlwe.sample_extract(tr, 0)
