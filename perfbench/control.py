"""The readings the comparison's limits are set from, at a cell's own size
(not run by the benchmark's runs):

    python3 -m perfbench.control --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--fault tf32|half_batch|evict_skipped ...] \
        [--traced <k>]

For each seed, one run of the cell as the benchmark makes it (a window of
``--seconds``; the first ``--traced`` seeds traced, their per-layer
metrics printed too): the program's readings (the limits' lower
ends), then for each ``--fault`` the reference put in the program's
place, judged as the program is, from the same seeds and, for the late
stage, from the program's own state before it.  ``tf32`` (the control)
computes the reference's products in TF32, the nearest precision below
the configurations' float32 with TF32 off; ``half_batch`` (a planted
fault) trains on half of each batch, the mean taken over the rest;
``evict_skipped`` (another) never lets a full bag take a newcomer.  One
JSON line per seed: the run's ``correct`` must read true, each fault's
false.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from perfbench.harness import run_cell
from perfbench.registry import Benchmark

FAULTS = ("tf32", "half_batch", "evict_skipped")


def readings(cell, seed: int, faults, device: str, seconds: float = 0.0,
             trace: bool = False) -> dict:
    res = run_cell(Benchmark(), cell, seed, seconds, trace, device,
                   time.perf_counter(), controls=faults,
                   log=lambda s: print(s, file=sys.stderr, flush=True))
    return {"cell": cell.name, "seed": seed, "correct": res.correct,
            "failed": res.failed, "notes": (res.notes or [])[-16:],
            "checks": res.checks, "controls": res.controls or {},
            "metrics": res.metrics, "device": res.device}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", nargs="*", default=[], choices=FAULTS)
    p.add_argument("--traced", type=int, default=0)
    args = p.parse_args(argv)
    cell = Benchmark().cell(args.workload)
    for i, seed in enumerate(args.seeds):
        print(json.dumps(readings(cell, seed, args.fault, "cuda",
                                  args.seconds, i < args.traced)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
