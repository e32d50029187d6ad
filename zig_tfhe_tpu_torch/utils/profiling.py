"""Profiling and timing helpers, and the port's own spans.

Counterpart of zig_tfhe_tpu/utils/profiling.py (the reference has none
beyond wall-clock prints in its examples):

- ``trace(logdir)``: a context manager around ``torch.profiler`` (CPU and,
  where a card is present, CUDA activity) that writes a Chrome trace file
  into ``logdir`` when it exits;
- ``time_op(fn, *args)``: the median seconds per call of ``fn(*args)``
  after warm-up calls, timed with CUDA events when the result lives on
  the card and with the host clock on the CPU;
- ``span(name)``: the program's own records at the gate path's layer
  boundaries, read back with ``spans()``.

Spans are recorded while any ``torch.profiler`` session runs
(``torch.autograd.profiler._is_profiler_enabled``, set by ``start()`` and
cleared by ``stop()``), ``trace(logdir)`` included, so they cover the
stretch of the device trace; ``recording(on)`` overrides that for a test
or an on/off comparison.  Outside both, ``span`` returns one shared no-op
object: a flag read.  The store holds one stretch of recording: the first
span recorded after a span was refused (recording off) forgets the
records before it.  Read them after the profiled stretch::

    with profiling.trace("logs"):
        gates.apply_gates(ids, a, b, ck)
    for s in profiling.spans():
        print(s.name, s.end_ns - s.start_ns, s.device_ms, s.device_at_ms)

Host times are ``time.time_ns()``, the clock the profiler's kernel
records are placed on.  A span given a CUDA device also carries a CUDA
event pair on that device's current stream: ``device_ms`` is the time the
stream took from its start event to its end event, and ``device_at_ms``
the start event's time after its call's (the outermost span's) start
event, on the device's clock.  Where the stream was idle when the call
opened, the call's start event fell at its ``start_ns``, and every span of
the call can be placed on the kernel records' clock from there: the host
may run far ahead of the device, so a host span says what was enqueued
when, and only the event pair says when the device reached it.  What the
gate path records:

- span ``gates.apply`` (``models/gates.py:apply_gates``, its whole body):
  one call; its id is the call id of every record made inside it.  On a
  card it counts in ``syncs``, as every outermost span with a device does,
  the synchronising CUDA operations its body made (a copy of host memory
  to the card that waits for the stream to drain, a read of a device
  value): torch's sync debug mode is set to warn inside it and its
  warnings are counted, not shown;
- span ``blind_rotate.steps`` (the step loop of each blind-rotation
  engine; attribute ``steps``): the scan;
- span ``bootstrap.key_switch`` (``ops/keyswitch.py:identity_key_switch``).

No range that the profiler itself records (``record_function``, NVTX) is
used on the path: a device-side annotation would enter the kernel records
that the benchmark reads.  Recording never synchronises the device; the
device times are read when ``spans()`` is called.  At most ``LIMIT`` spans
are kept; later ones are dropped and counted in ``dropped()``.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import statistics
import threading
import time
import warnings
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

LIMIT = 10 ** 6     # spans kept
# what torch's sync debug mode says of a synchronising CUDA operation, and
# of itself when it is first set
_SYNC_WARNING = "called a synchronizing CUDA operation"
_MODE_WARNING = "Synchronization debug mode is a prototype"


class Span(NamedTuple):
    name: str
    id: int
    parent: int | None     # the enclosing open span's id
    call: int              # the outermost open span's id
    start_ns: int          # time.time_ns()
    end_ns: int | None     # None while open
    device_ms: float | None      # start to end event; None without a pair
    device_at_ms: float | None   # the call's start event to this start event
    syncs: int | None      # synchronising CUDA operations (a call on a card)
    attrs: dict


class _OpenSpans(threading.local):
    def __init__(self):
        self.stack = []                 # this thread's open spans


class _Recorder:
    """The process's records: the spans of the gate path are opened by
    module-level calls, so there is one store a process."""

    def __init__(self):
        self.override = None            # recording(on) while not None
        self.spans = []
        self.dropped = 0
        self.stale = False              # a span refused since the last kept
        self.ids = itertools.count(1)
        self.open = _OpenSpans()

    def keep(self, record) -> None:
        if len(self.spans) >= LIMIT:
            self.dropped += 1
        else:
            self.spans.append(record)


_REC = _Recorder()


def is_recording() -> bool:
    """Whether ``span`` records now."""
    o = _REC.override
    return _autograd_profiler._is_profiler_enabled if o is None else o


@contextlib.contextmanager
def recording(on: bool = True):
    """Record (or not) inside the body, whatever the profiler does."""
    before, _REC.override = _REC.override, bool(on)
    try:
        yield
    finally:
        _REC.override = before


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _SyncCount:
    """Counts the synchronising CUDA operations of a body: torch's sync
    debug mode at warn, its warnings caught.  Other warnings, and the sync
    warnings where the mode was already on outside, are shown again."""

    def __enter__(self):
        self.mode = torch.cuda.get_sync_debug_mode()
        self.catch = warnings.catch_warnings(record=True)
        self.caught = self.catch.__enter__()
        warnings.simplefilter("always")
        if self.mode == 0:
            torch.cuda.set_sync_debug_mode(1)
        return self

    def exit(self) -> int:
        if self.mode == 0:
            torch.cuda.set_sync_debug_mode(0)
        self.catch.__exit__(None, None, None)
        n = 0
        for w in self.caught:
            text = str(w.message)
            sync = _SYNC_WARNING in text
            n += sync
            if (self.mode or not sync) and _MODE_WARNING not in text:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)
        return n


class _OpenSpan:
    __slots__ = ("name", "id", "parent", "call", "start_ns", "end_ns",
                 "attrs", "events", "anchor", "device_ms", "device_at_ms",
                 "counting", "syncs")

    def __init__(self, name, events, attrs):
        self.name, self.events, self.attrs = name, events, attrs
        self.id = next(_REC.ids)
        self.end_ns = self.device_ms = self.device_at_ms = None
        self.anchor = self.syncs = self.counting = None

    def __enter__(self):
        stack = _REC.open.stack
        root = stack[0] if stack else self
        self.parent = stack[-1].id if stack else None
        self.call = root.id
        stack.append(self)
        _REC.keep(self)
        if root is self and self.events is not None:
            self.counting = _SyncCount().__enter__()
        self.start_ns = time.time_ns()
        if self.events is not None:
            start, _, stream = self.events
            start.record(stream)
            if root.events is not None and root.events[2] == stream:
                self.anchor = root.events[0]
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self.events[2])
        self.end_ns = time.time_ns()
        if self.counting is not None:
            self.syncs = self.counting.exit()
            self.counting = None
        _REC.open.stack.pop()
        return False

    def resolved(self) -> Span:
        if self.events is not None and self.end_ns is not None:
            start, end, _ = self.events
            end.synchronize()
            self.device_ms = start.elapsed_time(end)
            if self.anchor is not None:
                self.device_at_ms = self.anchor.elapsed_time(start)
            self.events = self.anchor = None
        return Span(self.name, self.id, self.parent, self.call, self.start_ns,
                    self.end_ns, self.device_ms, self.device_at_ms,
                    self.syncs, self.attrs)


def _events(device):
    """A timing event pair and the stream it is recorded on, ``device``'s
    current stream; None off a card."""
    if device is None or device.type != "cuda":
        return None
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True),
            torch.cuda.current_stream(device))


def span(name: str, device: torch.device | None = None, **attrs):
    """A context manager that records the body as span ``name``, with the
    keyword arguments as its attributes.  Where ``device`` is a CUDA
    device, a CUDA event pair on its current stream times the work that
    the body enqueued there, and the outermost such span (a call) counts
    the body's synchronising CUDA operations."""
    if not is_recording():
        _REC.stale = True
        return _NO_SPAN
    if _REC.stale and not _REC.open.stack:
        clear()
    return _OpenSpan(name, _events(device), attrs)


def spans() -> list:
    """The spans recorded, in the order they opened, with the device
    times of closed spans read (waiting for their end events)."""
    return [s.resolved() for s in _REC.spans]


def dropped() -> int:
    """Spans refused since the last ``clear()``: past ``LIMIT``."""
    return _REC.dropped


def clear() -> None:
    """Forget every span recorded so far."""
    _REC.spans, _REC.dropped, _REC.stale = [], 0, False


@contextlib.contextmanager
def trace(logdir):
    """Profile the body; writes ``logdir/trace_<pid>_<ns>.json``.  Yields
    the ``torch.profiler.profile`` object (``key_averages()`` and the
    rest).  The port's spans are recorded meanwhile."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        os.fspath(logdir), f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (tuple, list)):
        for y in x:
            t = _first_tensor(y)
            if t is not None:
                return t
    return None


def time_op(fn, *args, iters: int = 3, warmup: int = 1) -> float:
    """Median seconds per call of ``fn(*args)`` over ``iters`` calls, after
    ``warmup`` calls.  When the warm-up's result (its first tensor) lies
    on a CUDA device, each call is timed by CUDA events on that device's
    current stream, which end after the call's kernels; otherwise by
    ``time.perf_counter``."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    t = _first_tensor(out)
    times = []
    if t is not None and t.device.type == "cuda":
        with torch.cuda.device(t.device):
            torch.cuda.synchronize()
            for _ in range(iters):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    return float(statistics.median(times))
