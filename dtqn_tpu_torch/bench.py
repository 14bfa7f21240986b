"""Port benchmark: DTQN env-steps/s at the reference's 1:1 update ratio, on
one GPU.

    python -m dtqn_tpu_torch.bench [--bag N] [--seeds N] [--bf16]
                                   [--device cpu] [--iters N] [--no-extras]

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "device": ...}
preceded, on the GPU, by the card's name and power limit (nvidia-smi).

The configuration is the flagless one of the JAX package's ``bench.py``:
DiscreteCarFlag-v0, DTQN in_embed 64, context 50, 8 heads, 2 layers, batch
32, 64 envs, buffer 500k, and exactly 1 gradient step per env step
(run.py:290-298), so "env-steps/s" also equals learner updates/s.
``--bag N`` is that script's second line: gv_memory.7x7.yaml, in_embed 128,
and the persistent-memory bag of N slots; the metric's name then says so.
``--seeds N`` trains seeds 0..N-1 at once (``Agent.init_sweep_state``,
the JAX script's ``jax.vmap`` over stacked states): the value counts the
env steps of every seed and the metric's name ends in ``_x{N}seeds``.
``--bf16`` is the JAX script's bf16 mode (bfloat16 compute, float32
parameters): the metric's name gains ``_bf16``, so it never reads as the
float32 line.
It prepopulates 625 iterations, runs one warm-up chunk of ``--iters``
iterations (default 50), and reports the best of 4 timed chunks.  On the
GPU both go through the compiled entry points (``train/loop.py``:
``make_prepopulate``, ``make_train_chunk``): the warm-up chunk captures
the iteration as a CUDA graph, and the timed chunks replay it.  Only
``--device cpu`` runs on the CPU; ``--iters`` shortens the chunks so a test
can run the script.

The flagless invocation (no flag but ``--device``) also measures the JAX
script's two variants, ``--seeds 5`` and ``--bf16``, each in a process of
its own (``--no-extras``, the same ``--device``), and reports them in the
same line under ``"extra"``: {"aggregate_5seeds": ..., "bf16": ...}, each
env-steps/s or an error string.  ``--no-extras`` prints the value alone.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import torch

from dtqn_tpu_torch.utils.device import resolve_device

METRIC = "carflag_dtqn_torch_env_steps_per_s_1to1_updates"
BAG_METRIC = "gv7x7_dtqn_bag{bag}_torch_env_steps_per_s_1to1_updates"
NUM_ENVS = 64
DEFAULT_ITERS = 50
PREPOP_STEPS = 40_000
# The flagless line's variants: (name under "extra", their flags).
EXTRAS = (("aggregate_5seeds", ["--seeds", "5"]), ("bf16", ["--bf16"]))
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sync(state) -> None:
    """Wait for the whole learn chain: read values that depend on it."""
    _ = state.train_steps.tolist()
    _ = state.params.reshape(-1)[0].item()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails when no GPU is found) or cpu")
    p.add_argument("--iters", type=int, default=DEFAULT_ITERS,
                   help="iterations (of 64 env steps and 64 updates) per "
                        "timed chunk")
    p.add_argument("--seeds", type=int, default=1,
                   help="seeds trained at once (0..N-1)")
    p.add_argument("--bag", type=int, default=0,
                   help="bag slots; above 0 the configuration is "
                        "gv_memory.7x7.yaml at in_embed 128")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute, float32 parameters (the JAX "
                        "bench.py's bf16 mode)")
    p.add_argument("--no-extras", action="store_true",
                   help="the flagless line without its --seeds 5 and --bf16 "
                        "variants")
    args = p.parse_args(argv)
    if args.iters < 1 or args.seeds < 1:
        raise ValueError("--iters and --seeds must be at least 1")
    # Raises without a GPU unless the CPU is asked for, before anything
    # runs (the variants' processes included).
    resolve_device(args.device)
    line = measure(args)
    flagless = all(value == p.get_default(key)
                   for key, value in vars(args).items() if key != "device")
    if flagless:
        line["extra"] = run_extras(args.device)
    print(json.dumps(line), flush=True)
    return line


def run_extras(device: str) -> dict:
    """Each of ``EXTRAS`` in a process of its own, on ``device``: {name:
    env-steps/s, or an error string}."""
    return {
        name: _run_extra([sys.executable, "-m", "dtqn_tpu_torch.bench",
                          *flags, "--no-extras", "--device", device])
        for name, flags in EXTRAS
    }


def _run_extra(cmd, soft_deadline_s=1500.0):
    """Runs one variant and returns the value of the last line it prints,
    never SIGKILLing it (the JAX script's ``_run_extra``): poll to a soft
    deadline, send one SIGTERM, give it a grace minute, then leave the
    child running and report the timeout, so the flagless line always
    prints.  A child killed inside a device call can leave the device in a
    state the next job inherits."""
    try:
        child = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.DEVNULL, text=True,
                                 cwd=REPO_ROOT)
    except OSError as e:
        return f"error: {type(e).__name__}: {e}"[:120]
    # Drain stdout from a thread while polling: a child that writes more
    # than the pipe's buffer before exiting would otherwise block on write
    # and be reported as a timeout.
    chunks = []
    reader = threading.Thread(
        target=lambda: chunks.append(child.stdout.read()), daemon=True
    )
    reader.start()
    deadline = time.monotonic() + soft_deadline_s
    while child.poll() is None and time.monotonic() < deadline:
        time.sleep(2.0)
    if child.poll() is None:
        child.terminate()  # soft; a stalled device call may ignore it
        grace = time.monotonic() + 60.0
        while child.poll() is None and time.monotonic() < grace:
            time.sleep(2.0)
        if child.poll() is None:
            return "error: timeout (child left running, not SIGKILLed)"
        return "error: soft-timeout (child SIGTERMed after deadline)"
    reader.join(timeout=30.0)
    out = "".join(chunks).strip().splitlines()
    if child.returncode != 0 or not out:
        return f"error: exit code {child.returncode}"
    try:
        return json.loads(out[-1])["value"]
    except (ValueError, KeyError, TypeError) as e:
        return f"error: {type(e).__name__}: {e}"[:120]


def measure(args) -> dict:
    """The benchmark line of ``args`` (printing the card's line first on a
    GPU)."""
    from dtqn_tpu_torch.agents import Agent, AgentConfig
    from dtqn_tpu_torch.envs import make_env
    from dtqn_tpu_torch.train.loop import (
        make_prepopulate,
        make_train_chunk,
    )
    from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule

    if args.bag > 0:
        env_name, metric = "gv_memory.7x7.yaml", BAG_METRIC.format(bag=args.bag)
        in_embed = 128  # README.md:116-117 (128 for gridverse)
    else:
        env_name, metric, in_embed = "DiscreteCarFlag-v0", METRIC, 64
    if args.bf16:
        metric += "_bf16"
    seeds = args.seeds
    if seeds > 1:
        metric += f"_x{seeds}seeds"
    cfg = AgentConfig(
        model="DTQN",
        num_envs=NUM_ENVS,
        context_len=50,
        history=50,
        inner_embed=in_embed,
        num_heads=8,
        num_layers=2,
        batch_size=32,
        buffer_size=500_000,
        target_update_frequency=10_000,
        bag_size=args.bag,
        bf16=args.bf16,
    )
    agent = Agent(cfg, make_env(env_name), device=args.device)
    on_card = agent.device.type == "cuda"
    if on_card:
        print(card_line(), flush=True)

    iters = args.iters
    prepopulate = make_prepopulate(agent, max(PREPOP_STEPS // NUM_ENVS, 1))
    chunk = make_train_chunk(
        agent,
        EpsilonSchedule(1.0, 0.1, 200_000),
        updates_per_iter=NUM_ENVS,
        iters_per_chunk=iters,
    )

    state = (agent.init_sweep_state(list(range(seeds))) if seeds > 1
             else agent.init_state(0))
    # Enough prepopulation that learn() steps actually apply.
    state = prepopulate(state)
    if int(state.buffer.flushed_total.min()) <= cfg.batch_size:
        raise RuntimeError("prepopulation finished too few episodes")

    # Warm-up: builds the kernels and, on a GPU, captures the iteration.
    state = chunk(state)
    sync(state)

    best = float("inf")
    for _ in range(4):
        t0 = time.perf_counter()
        state = chunk(state)
        sync(state)
        best = min(best, time.perf_counter() - t0)
    # Every seed applied every update.
    applied = state.train_steps.reshape(-1).tolist()
    if applied != [5 * iters * NUM_ENVS] * seeds:
        raise RuntimeError(f"updates applied per seed: {applied}")
    if int(state.nonfinite_grads.sum()) != 0:
        raise FloatingPointError("non-finite gradient steps")

    line = {
        "metric": metric,
        "value": round(iters * NUM_ENVS * seeds / best, 1),
        "unit": "env-steps/s (== learner updates/s)",
        "device": (torch.cuda.get_device_name(0) if on_card else "cpu"),
    }
    return line


if __name__ == "__main__":
    main()
