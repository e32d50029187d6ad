"""A traced stretch of the window: the device's kernel records from
``torch.profiler`` (CUDA activity only), the hand kernels' launches counted
over the same calls, and the benchmark's own host spans around each call.

A trace counts as complete only where it kept one record of each hand
kernel for every launch its wrapper counted: the profiler can lose
records.  The per-layer readers (``metrics/<name>.py``) read a ``Trace``.
"""

from __future__ import annotations

import dataclasses

from gpubench import yardstick
from gpubench.system import HAND_KERNELS

TOP = 10   # entries of each list in the breakdown


@dataclasses.dataclass
class Trace:
    records: list        # (kernel name, start ns, end ns)
    launched: dict       # hand kernel -> launches counted in the stretch
    host_spans: list     # (what the host did, start ns, end ns), host clock
    calls: int
    window_ns: int       # host clock, first call's start to last call's end
    cfg: dict            # the configuration's file
    lanes: int           # lanes a call
    # the outermost span of one call, the traffic kind's CALL_SPAN (the
    # gates kind's where a caller names none, as the port's own tests do)
    call_span: str = "gates.apply"

    def kept(self) -> dict:
        return {k: sum(1 for nm, _, _ in self.records if sym in nm)
                for k, (_, _, sym) in HAND_KERNELS.items()}

    @property
    def complete(self) -> bool:
        return bool(self.records) and self.kept() == self.launched

    def spans(self):
        return [(s, e) for _, s, e in self.records]

    def busy_ns(self) -> int:
        return yardstick.union_ns(self.spans())

    def mean_s(self, k: str):
        """A hand kernel's mean seconds a call, None without records."""
        sym = HAND_KERNELS[k][2]
        d = [e - s for nm, s, e in self.records if sym in nm]
        return sum(d) / len(d) / 1e9 if d else None

    def roofline_pct(self, k: str):
        """A hand kernel's least time at this cell's step shape over its
        mean time a call, in %; None where the cell does not run it."""
        mean = self.mean_s(k)
        bound = yardstick.step_shapes(self.cfg, self.lanes).get(k)
        if mean is None or bound is None:
            return None
        return 100.0 * bound / mean

    def idle_share_pct(self) -> float:
        return 100.0 * yardstick.idle_share(self.spans())

    def by_name(self) -> dict:
        out = {}
        for nm, s, e in self.records:
            out[nm] = out.get(nm, 0) + (e - s)
        return out

    def breakdown(self) -> dict:
        """The costliest device operations, and the idle gaps summed by the
        host span that held the gap's midpoint."""
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:TOP]
        gaps = {}
        spans = sorted(self.host_spans, key=lambda h: h[1])
        for s, e in yardstick.idle_gaps(self.spans()):
            mid = (s + e) / 2
            what = next((h for h, hs, he in spans if hs <= mid < he),
                        "outside the host spans")
            gaps[what] = gaps.get(what, 0) + (e - s)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[nm[:160], ns / 1e9] for nm, ns in ops],
                "idle_gaps": [[nm, ns / 1e9] for nm, ns in idle]}


def kernel_records(prof) -> list:
    """The CUDA kernels a ``torch.profiler`` run recorded (memory copies and
    sets left out), read from its records without a trace file."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != torch.autograd.DeviceType.CUDA
                or e.name().startswith(("Memcpy", "Memset"))):
            continue
        s = e.start_ns()
        out.append((e.name(), s, s + e.duration_ns()))
    return out
