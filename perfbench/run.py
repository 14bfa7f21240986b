"""The benchmark of ``dtqn_tpu_torch``: graphed Q-learning throughput.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  Prints, as its last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number the
comparison read, beside its limit; the same numbers close its standard
error.  Exits non-zero, and prints no result, without CUDA or with fewer
cards than the cell asks for, or when the process holds ``jax``,
``jaxlib``, ``flax`` or ``dtqn_tpu`` once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dtqn_tpu")


def loaded_forbidden() -> list:
    """The forbidden top-level modules the process holds, compared by whole
    top-level name (``dtqn_tpu_torch`` is not ``dtqn_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def card_power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it, or why not."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread: {type(e).__name__}"
    return out.stdout.strip().splitlines()[0]


def pin_to_one_core() -> int:
    """Keeps this process on one core (the last it may use), before any
    thread starts.  A graphed chunk's host side is one thread launching
    graphs of ~20 000 nodes; on the shared host, runs left free to migrate
    read the one-seed cell 2-3x as spread as pinned ones: their fastest
    chunks are as fast, their slow chunks more frequent."""
    core = max(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {core})
    return core


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = ROOT / "perfbench" / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    pin_to_one_core()
    _cache_dirs()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    torch.set_num_threads(1)
    from perfbench.harness import run_cell
    from perfbench.registry import Benchmark

    bench = Benchmark(ROOT)
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result = run_cell(bench, cell, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START, log=log)
    result.device["matmul_allow_tf32"] = \
        torch.backends.cuda.matmul.allow_tf32
    result.device["power_limit"] = card_power_limit()
    found = loaded_forbidden()
    if found:
        print(f"the process holds {found}: the benchmark may load none of "
              f"{list(FORBIDDEN)}", file=sys.stderr)
        return 3
    for line in result.notes or []:
        log(line)
    log(f"correct: {result.correct} (failed updates: {result.failed})")
    for name, c in result.checks.items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result.line()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
