"""Readings that a cell's limits are set from, in one process (the card's
set-up paid once): the numbers the check compares (the traffic kind's
count of wrong lanes and ``noise_sd``, whatever the kind), for the program
over many seeds and for the control, the program with its configuration's
``control_key`` (a key of the precision below the one the configuration
states: on g3 and t64 one gadget level fewer on the body).  The
benchmark's own runs never run this.

    python gpubench/calibrate.py --workload <cell> --seconds <s> --seeds 1 2 3 \
        [--control-seeds 4 5 6]

One JSON line a run on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=())
    p.add_argument("--control-seeds", type=int, nargs="*", default=())
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from gpubench import manifest, run

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    bench = manifest.Bench(ROOT)
    cfg = bench.config(bench.cell(args.workload)["config"])
    runs = [(s, "program", None) for s in args.seeds]
    runs += [(s, "control", cfg["control_key"]) for s in args.control_seeds]
    for seed, what, key_form in runs:
        r = run.run_cell(bench, args.workload, seed, args.seconds, False,
                         torch.device("cuda", 0), key_form=key_form,
                         t0=time.perf_counter())
        w = r["window"]
        print(json.dumps({"workload": args.workload, "seed": seed, "key": what,
                          "correct": r["correct"], "calls": w.calls,
                          "lanes": r["attempted"],
                          **{k: v["value"] for k, v in r["check"].items()},
                          "setup_s": w.setup_s}), flush=True)
        print("\n".join(r["log"]), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
