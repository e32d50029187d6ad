"""Gate and programmable bootstrapping (bootstrap/vanilla.zig:38-52),
batch-first.

Counterpart of zig_tfhe_tpu/bootstrap.py: blind rotate -> sample extract
at 0 -> identity key switch.  ``bootstrap_to_lv1`` stops before the key
switch and returns the TLWE lv1 ciphertext (the optimized MUX combines two
of them under one key switch); ``bootstrap_without_key_switch_truncated``
is the reference's variant, which truncates that mask to n0.  ``bootstrap_with_testvec`` is the same
pipeline on a caller's test vector (models/lut.py).  The strategy pair,
``BootstrapStrategy`` and ``default_bootstrap``, mirrors the reference's
function-pointer table (bootstrap.zig:30-52).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from zig_tfhe_tpu_torch import trlwe as _trlwe
from zig_tfhe_tpu_torch.key import CloudKey
from zig_tfhe_tpu_torch.ops.blind_rotate import blind_rotate
from zig_tfhe_tpu_torch.ops.keyswitch import identity_key_switch

STRATEGY_NAME = "vanilla"


@dataclasses.dataclass(frozen=True)
class BootstrapStrategy:
    """Pluggable bootstrap strategy (bootstrap.zig:30-47's vtable, as a
    frozen dataclass of callables): ``bootstrap`` (full pipeline),
    ``bootstrap_without_key_switch`` (result under the lv1 key) and
    ``name``.  The callables are batch-first ``(tlwe_batch, cloud_key) ->
    batch``."""

    bootstrap: Callable[[Any, CloudKey], Any]
    bootstrap_without_key_switch: Callable[[Any, CloudKey], Any]
    name: str = "custom"


def default_bootstrap() -> BootstrapStrategy:
    """The vanilla strategy (bootstrap.zig:50-52, vanilla.zig:72-75)."""
    return BootstrapStrategy(bootstrap=bootstrap,
                             bootstrap_without_key_switch=bootstrap_to_lv1,
                             name=STRATEGY_NAME)


def bootstrap(tlwe_batch: torch.Tensor, ck: CloudKey) -> torch.Tensor:
    """Full gate bootstrap: [B, n0+1] -> refreshed [B, n0+1]."""
    return identity_key_switch(bootstrap_to_lv1(tlwe_batch, ck), ck.ksk1,
                               ck.params)


def bootstrap_to_lv1(tlwe_batch: torch.Tensor, ck: CloudKey) -> torch.Tensor:
    """Blind rotate + extract, no key switch: [B, n0+1] -> [B, N+1] (lv1)."""
    tr = blind_rotate(tlwe_batch, ck.testvec, ck, ck.params)
    return _trlwe.sample_extract(tr, 0)


def bootstrap_without_key_switch_truncated(tlwe_batch: torch.Tensor,
                                           ck: CloudKey) -> torch.Tensor:
    """The reference's bootstrapWithoutKeySwitch (vanilla.zig:58-69): blind
    rotate + extract with the lv1 mask truncated to n0 coefficients,
    [B, n0+1] under a truncation of the lv1 key (trlwe.py:
    sample_extract_lv0_shaped; n0 > N raises)."""
    tr = blind_rotate(tlwe_batch, ck.testvec, ck, ck.params)
    return _trlwe.sample_extract_lv0_shaped(tr, ck.params.n0, 0)


def bootstrap_with_testvec(tlwe_batch: torch.Tensor, testvec: torch.Tensor,
                           ck: CloudKey) -> torch.Tensor:
    """Programmable bootstrap core: a caller's test vector, full pipeline.
    testvec: carrier [2, N] shared or [B, 2, N] one per lane."""
    tr = blind_rotate(tlwe_batch, testvec, ck, ck.params)
    return identity_key_switch(_trlwe.sample_extract(tr, 0), ck.ksk1,
                               ck.params)
