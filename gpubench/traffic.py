"""The one traffic generator: it reads a mix's parameters
(``gpubench/traffic/<mix>.json``) and draws the plaintexts a cell's
clients send, from the run's seed.

A mix names its ``kind``, and a kind is a file: ``gpubench/kinds/<kind>.py``
(found by name, as the metric readers are) draws the mix, adapts the
program to it and judges its outputs.  Every kind is closed loop, one
client: the client encrypts a pool of ``pool`` distinct batches of
``lanes`` lanes before the window, and call i of the window sends batch
i mod ``pool``; ``warm_calls`` calls run before the window, on the same
shapes, and a traced run profiles the window's first ``trace_calls``
calls.  Every seed gives the same sizes and the same number of bootstraps
a call: only the plaintexts differ.  The kinds:

* ``gates`` (``lanes``, ``gates``: ``"all"`` or a list of the ten binary
  gates): each lane a gate drawn uniformly from ``gates`` on two random
  input bits, one heterogeneous ``apply_gates`` a call, judged by
  ``reference/gates.py`` (the sign of each phase, its distance from
  +-1/8);
* ``lut`` (``lanes``, ``message_modulus`` m, a power of two, and
  ``functions``: ``"all"`` or a list of names of
  ``reference/lut.py:FUNCTIONS``): each lane an input drawn uniformly from
  [0, m) and a function drawn uniformly from ``functions``, one
  programmable bootstrap a lane with the lane's own test vector, judged by
  ``reference/lut.py`` (each phase decoded as round(phase 2m / 2^w) mod m
  against f(x), its distance from f(x) / (2m)).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# the draws each seed makes, apart from each other
STREAM_SECRET_KEY, STREAM_PLAINTEXTS = 0, 1


def rng(seed: int, stream: int) -> np.random.Generator:
    """A NumPy generator for one stream of draws of a seed (any integer)."""
    return np.random.default_rng([seed & (2 ** 64 - 1), stream])


@dataclasses.dataclass(frozen=True)
class Mix:
    """What every kind's draw has; a kind's own draw adds its plaintexts."""
    lanes: int
    pool: int
    warm_calls: int
    trace_calls: int

    def batch(self, call: int) -> int:
        """The pool batch that call ``call`` of the window sends."""
        return call % self.pool


def sizes(mix: dict) -> dict:
    """A mix's ``lanes``, ``pool``, ``warm_calls`` and ``trace_calls``."""
    lanes, pool = int(mix["lanes"]), int(mix["pool"])
    if lanes < 1 or pool < 1:
        raise ValueError("lanes and pool must be at least 1")
    return {"lanes": lanes, "pool": pool, "warm_calls": int(mix["warm_calls"]),
            "trace_calls": int(mix["trace_calls"])}


def draw(mix: dict, seed: int):
    """The plaintexts of ``mix`` for ``seed``, drawn by its kind."""
    from gpubench import manifest

    return manifest.kind(mix.get("kind")).draw(mix, seed)
