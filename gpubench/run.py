"""Run one cell of the benchmark of ``zig_tfhe_tpu_torch`` on the card.

    python gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process, one run: set up (the secret key drawn from the seed, the
cloud key made on the card, the client's pool of encryptions, the cell's
own shapes warmed), then a closed-loop window of whole calls that ends on
the first call to finish after ``--seconds``, then the plain reference
judges every output of the window.  A call ends when its outputs are on
the host, as a server's answers are before they go back to the client.  The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
number compared, with its limit.  A run that finds no CUDA card, or that
finds the JAX package loaded after the window, prints no result and exits
with another code than 0.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()   # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "gpubench" / ".cache"
# build and kernel caches at fixed paths inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
              "torch_extensions", "CUDA_CACHE_PATH": "nv"}


class Window:
    """What the end-to-end readers read: the window's calls."""

    def __init__(self, times, lanes, window_s, setup_s):
        self.times, self.lanes = times, lanes
        self.window_s, self.setup_s = window_s, setup_s
        self.calls = len(times)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(bench, name: str, seed: int, seconds: float, trace: bool,
             device="cuda", key_form=None, t0: float = _T0) -> dict:
    """Set up, measure and judge one run of cell ``name``.  Returns the
    result's fields, and under ``log`` the lines for standard error."""
    import numpy as np
    import torch

    from gpubench import manifest, traffic
    from gpubench.system import launches

    device = torch.device(device)
    cell = bench.cell(name)
    cfg = bench.config(cell["config"])
    params = bench.traffic(cell["traffic"])
    kind = manifest.kind(params.get("kind"))
    mix = traffic.draw(params, seed)
    log = []
    t_import = time.perf_counter()
    prog = kind.Program(cfg, seed, device, key_form)
    _sync(device)
    t_key = time.perf_counter()
    pool = prog.encrypt(mix)
    _sync(device)
    t_pool = time.perf_counter()
    for i in range(mix.warm_calls):
        prog.apply(pool, mix.batch(i))
        _sync(device)
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    prof = None
    t_ready = time.perf_counter()
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        before = launches()
        prof.start()
    times, enqueue, outs, host_spans = [], [], [], []
    traced = None
    t_start = time.perf_counter()
    setup_s = t_start - t0
    prev_end = None
    while True:
        i = len(times)
        k = mix.batch(i)
        w0, c0 = time.time_ns(), time.perf_counter()
        out = prog.apply(pool, k)
        w1 = time.time_ns()
        # the answer goes back to the client: copied to the host, which
        # waits for the call's kernels
        out = out.cpu()
        _sync(device)
        c1, w2 = time.perf_counter(), time.time_ns()
        times.append(c1 - c0)
        enqueue.append((w1 - w0) / 1e9)
        outs.append(out.numpy())
        if prof is not None and traced is None:
            if prev_end is not None:
                host_spans.append(("harness loop", prev_end, w0))
            host_spans += [(kind.ENQUEUE, w0, w1), ("copy to host", w1, w2)]
            prev_end = w2
            if i + 1 == mix.trace_calls:
                traced = _stop(prof, before, host_spans, i + 1, cfg, mix.lanes,
                               kind.CALL_SPAN)
        if c1 - t_start >= seconds:
            break
    window_s = c1 - t_start
    if prof is not None and traced is None:
        traced = _stop(prof, before, host_spans, len(times), cfg, mix.lanes,
                       kind.CALL_SPAN)
    peak = max(setup_peak, torch.cuda.max_memory_allocated(device)) if cuda else 0

    # the program's state goes before the reference runs
    key_lv0 = prog.key_lv0
    prog.free()
    del pool, prog
    got = np.concatenate(outs)
    del outs
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    judged = kind.judge(got, key_lv0, cfg, mix, len(times))
    t_done = time.perf_counter()

    limit = cfg["limits"]["noise_sd"]
    check = {kind.WRONG: {"value": judged["wrong"], "limit": 0},
             "noise_sd": {"value": judged["noise_sd"], "limit": limit}}
    correct = judged["wrong"] <= 0 and judged["noise_sd"] <= limit
    win = Window(times, mix.lanes, window_s, setup_s)
    med = sorted(times)[len(times) // 2]
    slow = [i for i, t in enumerate(times) if t > 1.5 * med]
    log += [
        f"setup {setup_s:.3f} s: imports {t_import - t0:.3f}, keys "
        f"{t_key - t_import:.3f}, client encryptions {t_pool - t_key:.3f}, "
        f"warm-up ({mix.warm_calls} calls) {t_ready - t_pool:.3f}"
        + (f", profiler start {t_start - t_ready:.3f}" if trace else ""),
        f"window {window_s:.3f} s, {win.calls} calls of {mix.lanes} lanes, "
        f"median call {1e3 * med:.3f} ms; {len(slow)} calls over 1.5x it, "
        f"{sum(times[i] - med for i in slow):.3f} s past the median, "
        f"{sum(enqueue[i] for i in slow):.3f} s of them enqueuing",
        f"memory peak {peak} bytes (set-up {setup_peak})",
        f"reference: {judged['lanes']} lanes judged in {t_done - t_ref:.3f} s, "
        f"widest phase error {judged['noise_max']:.6g} of the torus",
    ]
    result = {"correct": bool(correct), "attempted": judged["lanes"],
              "failed": judged["wrong"], "window": win, "trace": traced,
              "memory_peak_bytes": int(peak), "check": check, "log": log}
    if traced is not None:
        n = traced.calls
        untraced = times[n:]
        log.append(
            f"traced {n} calls: mean {1e3 * sum(times[:n]) / n:.3f} ms a call; "
            + (f"untraced {len(untraced)} calls: mean "
               f"{1e3 * sum(untraced) / len(untraced):.3f} ms" if untraced
               else "no untraced calls")
            + f"; {len(traced.records)} kernel records, hand kernels kept "
            f"{traced.kept()} of {traced.launched} launched")
    return result


def _stop(prof, before, host_spans, calls, cfg, lanes, call_span):
    from gpubench.system import launches
    from gpubench.trace import Trace, kernel_records

    prof.stop()
    after = launches()
    launched = {k: after[k] - before[k] for k in after}
    return Trace(records=kernel_records(prof), launched=launched,
                 host_spans=list(host_spans), calls=calls,
                 window_ns=host_spans[-1][2] - host_spans[0][1],
                 cfg=cfg, lanes=lanes, call_span=call_span)


def _power_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read: {e}"


def result_line(bench, name: str, r: dict, trace: bool, device) -> dict:
    """The result's JSON object for run ``r`` of cell ``name``."""
    import torch

    from gpubench import manifest

    cell = bench.cell(name)
    line = {"correct": r["correct"], "attempted": r["attempted"],
            "failed": r["failed"]}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": r["memory_peak_bytes"]}
    metrics = {}
    if not trace:
        for x in bench.end_to_end(name):
            metrics[x["name"]] = {"value": manifest.reader(x["name"])(r["window"]),
                                  "unit": x["unit"]}
    else:
        t = r["trace"]
        dev["busy_s"] = t.busy_ns() / 1e9
        dev["window_s"] = t.window_ns / 1e9
        if t.complete:
            for x in bench.per_layer(name):
                v = manifest.reader(x["name"])(t)
                if v is not None:
                    metrics[x["name"]] = {"value": v, "unit": x["unit"]}
        else:
            r["log"].append(f"trace incomplete: the profiler kept {t.kept()} "
                            f"hand-kernel records of {t.launched} launched; "
                            "no per-layer metric read")
    line["metrics"] = metrics
    line["device"] = dev
    if trace:
        line["breakdown"] = r["trace"].breakdown()
    line["check"] = r["check"]
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(CACHE / sub)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    from gpubench import importcheck, manifest

    bench = manifest.Bench(ROOT)
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"no result: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    r = run_cell(bench, args.workload, args.seed, args.seconds,
                 bool(args.trace), device)
    line = result_line(bench, args.workload, r, bool(args.trace), device)
    bad = importcheck.refused(sys.modules)
    if bad:
        print(f"no result: the run loaded {bad}", file=sys.stderr)
        return 3
    for msg in r["log"] + [_power_line()]:
        print(msg, file=sys.stderr)
    for k, v in r["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
