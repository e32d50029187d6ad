"""Traffic kind ``gates``: one heterogeneous bootstrapped gate batch a call.

Mix parameters: ``lanes``, ``gates`` (``"all"``: the ten binary gates of
``reference/gates.py:GATE_NAMES``, or a list of their names), ``pool``,
``warm_calls``, ``trace_calls``.  Each lane is a gate drawn uniformly from
``gates`` on two random input bits, which the client encrypts as +-1/8
(``tlwe.encrypt_bool``).  A call is one ``models/gates.py:apply_gates``
over the lanes of a pool batch, inside the program's own span
``gates.apply``.  The judge (``reference/gates.py``) decrypts every output
against the truth table of its gate and inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from zig_tfhe_tpu_torch import tlwe as _tlwe
from zig_tfhe_tpu_torch.models import gates as _gates

from gpubench import system, traffic
from gpubench.reference import gates as ref

CALL_SPAN = "gates.apply"           # the program's span of one call
ENQUEUE = "enqueue apply_gates"     # the host span of a call's enqueue
WRONG = "wrong_bits"                # the check's count of wrong lanes


@dataclasses.dataclass(frozen=True)
class GateMix(traffic.Mix):
    gate_ids: np.ndarray   # int64 [pool, lanes], indices into GATE_NAMES
    x: np.ndarray          # bool [pool, lanes]
    y: np.ndarray          # bool [pool, lanes]


def draw(mix: dict, seed: int) -> GateMix:
    """The gates and input bits of ``mix`` for ``seed``."""
    gates = ref.GATE_NAMES if mix["gates"] == "all" else tuple(mix["gates"])
    unknown = set(gates) - set(ref.GATE_NAMES)
    if unknown:
        raise ValueError(f"unknown gates {sorted(unknown)}")
    size = traffic.sizes(mix)
    shape = (size["pool"], size["lanes"])
    r = traffic.rng(seed, traffic.STREAM_PLAINTEXTS)
    ids = np.array([ref.GATE_NAMES.index(g) for g in gates])
    return GateMix(**size, gate_ids=ids[r.integers(0, len(ids), shape)],
                   x=r.integers(0, 2, shape).astype(bool),
                   y=r.integers(0, 2, shape).astype(bool))


class Program(system.Keys):
    """The configuration's keys and its gate batches on ``device``."""

    def _encrypt(self, bits: np.ndarray) -> torch.Tensor:
        """Fresh encryptions of booleans [...] -> carriers [..., n0 + 1]."""
        return _tlwe.encrypt_bool(self.gen, torch.from_numpy(bits).to(self.device),
                                  self.params.tlwe_lv0.alpha, self.sk.key_lv0,
                                  width=self.width)

    def encrypt(self, mix: GateMix) -> tuple:
        """The client's pool on the device: gate ids, first and second
        inputs, each [pool, lanes, ...]."""
        a, b = self._encrypt(mix.x), self._encrypt(mix.y)
        return torch.from_numpy(mix.gate_ids).to(self.device), a, b

    def apply(self, pool: tuple, k: int) -> torch.Tensor:
        """One call: pool batch ``k`` through ``apply_gates``."""
        ids, a, b = pool
        return _gates.apply_gates(ids[k], a[k], b[k], self.ck)


def judge(outputs, key_lv0, cfg: dict, mix: GateMix, calls: int) -> dict:
    """The outputs of ``calls`` window calls [calls * lanes, n0 + 1]
    against the truth tables (``reference/gates.py:judge``)."""
    ks = np.arange(calls) % mix.pool
    want = ref.expected_bits(mix.gate_ids[ks], mix.x[ks], mix.y[ks])
    return ref.judge(outputs, key_lv0, cfg["torus_bits"], want)
