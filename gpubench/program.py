"""The program's own records over a trace's stretch: the spans of
``zig_tfhe_tpu_torch.utils.profiling``, which the port makes while a
``torch.profiler`` session runs.  The ``program_span`` and
``program_counter`` readers read them here.

A call's parts are placed on the clock of the kernel records, not the
host's: the host may enqueue a part long before the device runs it, and
the profiler's conversion of the device's timestamps to the host clock
can be off by milliseconds in one run and drift by tens of microseconds a
call in another (H100).  Each span's CUDA event pair says where the stream
reached the span after the call's start event (``device_at_ms``) and how
long it took (``device_ms``).  One event of each call is tied to a record:
the end event of the call's last ``blind_rotate.steps`` span falls at the
end of the call's last hand-kernel record (``system.HAND_KERNELS``).  The
step loop ends with a hand kernel, the call launches none after it, and
through the scan the host runs
ahead of the device, so the event is on the stream before that kernel
ends; where the host falls behind, the event fires later by the host's lag
and every part of the call is placed that much early.  The calls' hand
kernels are the records of the stretch in time order, an equal share a
call (every call of a cell launches the same).

Every reader returns None where the stretch holds no ``gates.apply`` span
(a program without the recorder, a run with recording off, or one that
made no gate call), where the calls cannot be placed, or where the
recorder dropped spans.
"""

from __future__ import annotations

from gpubench import yardstick
from gpubench.system import HAND_KERNELS
from zig_tfhe_tpu_torch.utils import profiling

PARTS = ("prelude", "steps", "finish")
MS = 1_000_000          # ns


def _stretch(t):
    return t.host_spans[0][1], t.host_spans[-1][2]


def spans(t):
    """The closed spans that lie in ``t``'s stretch, None without a
    ``gates.apply`` among them or with spans dropped."""
    read = getattr(profiling, "spans", None)
    if read is None or profiling.dropped() > 0:
        return None
    lo, hi = _stretch(t)
    out = [s for s in read()
           if s.end_ns is not None and lo <= s.start_ns and s.end_ns <= hi]
    return out if any(s.name == "gates.apply" for s in out) else None


def calls(t):
    """Each ``gates.apply`` call's device intervals on the kernel records'
    clock (ns): ``"call"`` the call's, and under each span name of the
    call the intervals of its spans.  None where a call has no event pair
    or no ``blind_rotate.steps``, or the hand kernels do not share out
    evenly over the calls."""
    found = spans(t)
    if found is None:
        return None
    roots = [c for c in found if c.name == "gates.apply"]
    syms = [sym for _, _, sym in HAND_KERNELS.values()]
    hand = sorted((s, e) for nm, s, e in t.records
                  if any(x in nm for x in syms))
    if len(roots) != t.calls or not hand or len(hand) % t.calls:
        return None
    per = len(hand) // t.calls
    out = []
    for j, c in enumerate(roots):
        steps = [s for s in found if s.call == c.id
                 and s.name == "blind_rotate.steps"
                 and s.device_at_ms is not None]
        if c.device_ms is None or not steps:
            return None
        last = max(steps, key=lambda s: s.device_at_ms)
        end = max(e for _, e in hand[j * per:(j + 1) * per])
        a = end - round((last.device_at_ms + last.device_ms) * MS)
        placed = {"call": (a, a + round(c.device_ms * MS))}
        for s in found:
            if s.call == c.id and s is not c and s.device_at_ms is not None:
                lo = a + round(s.device_at_ms * MS)
                placed.setdefault(s.name, []).append(
                    (lo, lo + round(s.device_ms * MS)))
        out.append(placed)
    return out


def idle_ms_per_call(t, part: str):
    """The device's idle gaps (``yardstick.idle_gaps``, the breakdown's)
    whose midpoint lies in a call's device interval, in ms a call:
    ``part`` "prelude" before the device reaches the call's
    ``blind_rotate.steps``, "steps" inside it, "finish" after it.  Gaps
    elsewhere are the harness's."""
    placed = calls(t)
    if placed is None:
        return None
    bounds = []
    for c in placed:
        cs, ce = c["call"]
        steps = c.get("blind_rotate.steps", [])
        bounds.append((cs, ce, min((s for s, _ in steps), default=ce),
                       max((e for _, e in steps), default=ce)))
    idle = dict.fromkeys(PARTS, 0)
    for s, e in yardstick.idle_gaps(t.spans()):
        mid = (s + e) / 2
        for cs, ce, ss, se in bounds:
            if cs <= mid < ce:
                idle["prelude" if mid < ss else "steps" if mid < se
                     else "finish"] += e - s
                break
    return idle[part] / MS / t.calls


def busy_ms_per_call(t, name: str):
    """The time the device ran kernels inside the device intervals of the
    spans ``name``, in ms a call; None where none was placed."""
    placed = calls(t)
    if placed is None:
        return None
    where = [iv for c in placed for iv in c.get(name, [])]
    if not where:
        return None
    busy = 0
    for lo, hi in where:
        busy += yardstick.union_ns([(max(s, lo), min(e, hi))
                                    for s, e in t.spans()
                                    if s < hi and e > lo])
    return busy / MS / t.calls


def syncs_per_call(t):
    """The synchronising CUDA operations the ``gates.apply`` spans
    counted, a call; None where they were not counted (off a card)."""
    found = spans(t)
    if found is None:
        return None
    n = [s.syncs for s in found if s.name == "gates.apply"]
    return None if None in n else sum(n) / t.calls
