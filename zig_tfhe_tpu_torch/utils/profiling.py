"""Profiling and timing helpers.

Counterpart of zig_tfhe_tpu/utils/profiling.py (the reference has none
beyond wall-clock prints in its examples):

- ``trace(logdir)``: a context manager around ``torch.profiler`` (CPU and,
  where a card is present, CUDA activity) that writes a Chrome trace file
  into ``logdir`` when it exits;
- ``time_op(fn, *args)``: the median seconds per call of ``fn(*args)``
  after warm-up calls, timed with CUDA events when the result lives on
  the card and with the host clock on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time

import torch


@contextlib.contextmanager
def trace(logdir):
    """Profile the body; writes ``logdir/trace_<pid>_<ns>.json``.  Yields
    the ``torch.profiler.profile`` object (``key_averages()`` and the
    rest)."""
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
