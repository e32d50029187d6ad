"""Traffic kind ``lut``: one programmable bootstrap a lane, a function a
lane.

Mix parameters: ``lanes``, ``message_modulus`` m (a power of two),
``functions`` (``"all"``: every function of
``reference/lut.py:FUNCTIONS``, or a list of their names), ``pool``,
``warm_calls``, ``trace_calls``.  Each lane draws an input x uniformly from
[0, m) and a function uniformly from ``functions``; the client encrypts x
with the program's ``lut.encrypt_message`` at the set's lv0 noise (the
codec's scale 1/(2m)).  Set-up builds one test vector a function of the
mix with the program's ``lut.Generator`` and keeps them on the card
[F, 2, N].  A call is ``bootstrap_lut(ct[k], tvs[fn_ids[k]], ck)``: the
per-lane choice of test vectors is inside the timed call, as a server's
is.  ``bootstrap_lut`` records no span of its own around a call, so the
call runs inside a span that this kind opens in the program's recorder,
``lut.call``, which the program's spans of the call (the steps, the key
switch) nest in.  The judge (``reference/lut.py``) decodes every output
against f(x).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from zig_tfhe_tpu_torch.models import lut as _lut
from zig_tfhe_tpu_torch.utils import profiling

from gpubench import system, traffic
from gpubench.reference import lut as ref

CALL_SPAN = "lut.call"              # this kind's span of one call
ENQUEUE = "enqueue bootstrap_lut"   # the host span of a call's enqueue
WRONG = "wrong_values"              # the check's count of wrong lanes


@dataclasses.dataclass(frozen=True)
class LutMix(traffic.Mix):
    message_modulus: int
    functions: tuple       # names of reference/lut.py:FUNCTIONS
    fn_ids: np.ndarray     # int64 [pool, lanes], indices into functions
    x: np.ndarray          # int64 [pool, lanes], inputs in [0, m)


def draw(mix: dict, seed: int) -> LutMix:
    """The functions and inputs of ``mix`` for ``seed``."""
    m = ref.check_modulus(int(mix["message_modulus"]))
    functions = (ref.FUNCTION_NAMES if mix["functions"] == "all"
                 else tuple(mix["functions"]))
    unknown = set(functions) - set(ref.FUNCTION_NAMES)
    if unknown or not functions:
        raise ValueError(f"functions {sorted(unknown) or '[]'}: the reference "
                         f"has {ref.FUNCTION_NAMES}")
    size = traffic.sizes(mix)
    shape = (size["pool"], size["lanes"])
    r = traffic.rng(seed, traffic.STREAM_PLAINTEXTS)
    return LutMix(**size, message_modulus=m, functions=functions,
                  fn_ids=r.integers(0, len(functions), shape),
                  x=r.integers(0, m, shape))


class Program(system.Keys):
    """The configuration's keys and its programmable bootstraps on
    ``device``."""

    def encrypt(self, mix: LutMix) -> tuple:
        """The client's pool and the server's test vectors on the device:
        function ids [pool, lanes], encryptions of the inputs [pool, lanes,
        n0 + 1] and one test vector a function of the mix [F, 2, N]."""
        m = mix.message_modulus
        cts = _lut.encrypt_message(self.gen, torch.from_numpy(mix.x).to(self.device),
                                   m, self.params.tlwe_lv0.alpha,
                                   self.sk.key_lv0, width=self.width)
        gen = _lut.Generator.new(m, self.params)
        tvs = np.stack([gen.generate_lookup_table(
            functools.partial(ref.FUNCTIONS[f], m=m)).poly for f in mix.functions])
        return (torch.from_numpy(mix.fn_ids).to(self.device), cts,
                torch.from_numpy(tvs).to(self.device))

    def apply(self, pool: tuple, k: int) -> torch.Tensor:
        """One call: pool batch ``k``, each lane with its function's test
        vector, through ``bootstrap_lut``."""
        fn_ids, cts, tvs = pool
        with profiling.span(CALL_SPAN, device=self.device):
            return _lut.bootstrap_lut(cts[k], tvs[fn_ids[k]], self.ck)


def judge(outputs, key_lv0, cfg: dict, mix: LutMix, calls: int) -> dict:
    """The outputs of ``calls`` window calls [calls * lanes, n0 + 1]
    against f(x) (``reference/lut.py:judge``)."""
    ks = np.arange(calls) % mix.pool
    m = mix.message_modulus
    want = ref.expected(mix.functions, mix.fn_ids[ks], mix.x[ks], m)
    return ref.judge(outputs, key_lv0, cfg["torus_bits"], want, m)
