"""The one traffic generator: it reads a mix's parameters
(``gpubench/traffic/<mix>.json``) and draws the plaintexts a cell's
clients send, from the run's seed.

Kind ``gates`` (closed loop, one client): each call is one heterogeneous
gate batch of ``lanes`` lanes, each lane a gate drawn uniformly from
``gates`` (``"all"``: the ten binary gates) on two random input bits.  The
client encrypts a pool of ``pool`` distinct batches before the window;
call i of the window sends batch i mod ``pool``.  Every seed gives the same
sizes and the same number of bootstraps a call: only the bits and gates
differ.  ``warm_calls`` calls run before the window, on the same shapes;
a traced run profiles the window's first ``trace_calls`` calls.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gpubench.reference.gates import GATE_NAMES

KINDS = ("gates",)
# the draws each seed makes, apart from each other
STREAM_SECRET_KEY, STREAM_PLAINTEXTS = 0, 1


def rng(seed: int, stream: int) -> np.random.Generator:
    """A NumPy generator for one stream of draws of a seed (any integer)."""
    return np.random.default_rng([seed & (2 ** 64 - 1), stream])


@dataclasses.dataclass(frozen=True)
class GateMix:
    lanes: int
    pool: int
    warm_calls: int
    trace_calls: int
    gate_ids: np.ndarray   # int64 [pool, lanes], indices into GATE_NAMES
    x: np.ndarray          # bool [pool, lanes]
    y: np.ndarray          # bool [pool, lanes]

    def batch(self, call: int) -> int:
        """The pool batch that call ``call`` of the window sends."""
        return call % self.pool


def draw(mix: dict, seed: int):
    """The plaintexts of ``mix`` for ``seed``."""
    kind = mix.get("kind")
    if kind not in KINDS:
        raise ValueError(f"traffic kind {kind!r}: the generator draws {KINDS}")
    gates = GATE_NAMES if mix["gates"] == "all" else tuple(mix["gates"])
    unknown = set(gates) - set(GATE_NAMES)
    if unknown:
        raise ValueError(f"unknown gates {sorted(unknown)}")
    lanes, pool = int(mix["lanes"]), int(mix["pool"])
    if lanes < 1 or pool < 1:
        raise ValueError("lanes and pool must be at least 1")
    r = rng(seed, STREAM_PLAINTEXTS)
    ids = np.array([GATE_NAMES.index(g) for g in gates])
    return GateMix(lanes=lanes, pool=pool, warm_calls=int(mix["warm_calls"]),
                   trace_calls=int(mix["trace_calls"]),
                   gate_ids=ids[r.integers(0, len(ids), (pool, lanes))],
                   x=r.integers(0, 2, (pool, lanes)).astype(bool),
                   y=r.integers(0, 2, (pool, lanes)).astype(bool))
