#!/usr/bin/env python3
"""Where an iteration's device time goes, by phase, in one cell of the
benchmark (``BENCHMARK.json``), on the card.

    python3 tools/phase_probe.py --workload <cell> --seed <n> \
        --seconds <s> --tracing <0|1> [--out FILE]

from the root of a checkout (the program and ``perfbench/`` are imported
from the working directory, so a checkout without ``set_tracing`` runs it
with ``--tracing 0``).  It builds the cell's program as
``perfbench/harness.py`` does (the harness's weights, prepopulation, two
single iterations, the window's chunk once), with tracing switched on
before the first capture where ``--tracing 1``, pinned to one core, then:

- the window: chunks until their seconds pass ``--seconds``, each from its
  launch to its sync: per chunk its host seconds, its device ms between
  events recorded before and after it and, when tracing, its last replay's
  ``phase_ms``; ``env_steps_per_s`` over the chunks' seconds (the reads of
  the phases, after each sync, are outside them);
- the harness's traced readings (``traced_metrics``: its five per-layer
  metrics and breakdown) and the phases of its last traced iteration;
- ``--sessions`` chunks, each profiled again in a session of its own,
  with CUDA correlation ids: each device operation assigned to the graph
  launch that issued it, each replay's device span (its first operation's
  start to its last one's end), the idle time outside every replay's span
  (before a replay: the host's launch) and inside one, per iteration, the
  idle gaps labelled so, and the benchmark's ``device_idle_pct`` read from
  the same session, which the split has to add up to;
- the kernels of one iteration by name, for a comparison across checkouts;
- the readings by the names a benchmark metric of each would take
  (``phase_metrics``).

Prints one JSON line, also written to ``--out``.
"""

import argparse
import json
import os
import statistics
import sys
import time
from types import SimpleNamespace

T_START = time.perf_counter()


def profiled_chunk(prog):
    """One chunk under torch.profiler, launched and synced in the harness's
    spans: the device operations (name, start ns, end ns, replay index),
    the graph launches' host intervals, the window's ends, and the session
    as the benchmark's ``Trace``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench.trace import LAUNCH, SPANS, SYNC, Trace

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(LAUNCH):
            prog.chunk(prog.state)
        with record_function(SYNC):
            prog.sync()
    ops, launches, spans = [], [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation() and ev.name() not in SPANS:
                ops.append((ev.name(), ev.start_ns(), ev.end_ns(),
                            {ev.correlation_id(),
                             ev.linked_correlation_id()}))
        elif ev.name() == "cudaGraphLaunch":
            launches.append((ev.start_ns(), ev.end_ns(),
                             ev.correlation_id()))
        elif ev.name() in SPANS:
            spans.append((ev.name(), ev.start_ns(), ev.end_ns()))
    launches.sort()
    index = {corr: k for k, (_, _, corr) in enumerate(launches)}
    placed, unplaced = [], 0
    for name, a, b, corrs in ops:
        k = next((index[c] for c in corrs if c in index), None)
        unplaced += k is None
        placed.append((name, a, b, k))
    start = min(s for _, s, _ in spans)
    end = max(e for _, _, e in spans)
    trace = Trace([op[:3] for op in ops], spans, start, end)
    return placed, unplaced, launches, start, end, trace


def union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def replay_gaps(prog, iters, device_idle_pct):
    """The profiled chunk's idle time split at the replays' device spans:
    ms outside every span (before a replay, or after the last) and inside
    one, per iteration, and the ten longest gaps labelled; beside them the
    benchmark's ``device_idle_pct`` (its reader, ``device_idle_pct``) of
    the same session, and how far the split's sum lies from it, in points
    of the chunk."""
    ops, unplaced, launches, start, end, trace = profiled_chunk(prog)
    spans = {}
    for _, a, b, k in ops:
        if k is not None:
            lo, hi = spans.get(k, (a, b))
            spans[k] = (min(lo, a), max(hi, b))
    busy = union([(max(a, start), min(b, end)) for _, a, b, _ in ops
                  if min(b, end) > max(a, start)])
    gaps, t = [], start
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if end > t:
        gaps.append((t, end))
    ordered = sorted(spans.items())
    outside = inside = 0
    labelled = []
    for a, b in gaps:
        mid = (a + b) // 2
        within = [k for k, (lo, hi) in ordered if lo <= mid <= hi]
        if within:
            inside += b - a
            label = f"inside replay {within[0]}"
        else:
            outside += b - a
            host = [k for k, (la, _, _) in enumerate(launches) if la <= mid]
            nxt = [k for k, (lo, _) in ordered if lo > mid]
            label = (f"before replay {nxt[0]}" if nxt else "after the last "
                     "replay") + (f" (host in launch {host[-1]})"
                                  if host else "")
        labelled.append((label, (b - a) * 1e-6))
    split_pct = 100.0 * (outside + inside) / (end - start)
    idle_pct = device_idle_pct(SimpleNamespace(chunk_trace=trace))
    out = {
        "window_ms": (end - start) * 1e-6,
        "idle_ms": sum(b - a for a, b in gaps) * 1e-6,
        "device_idle_pct": idle_pct,
        "split_idle_pct": split_pct,
        "split_gap_points": abs(split_pct - idle_pct),
        "replays_ms": sum(hi - lo for _, (lo, hi) in ordered) * 1e-6,
        "graph_gap_ms_per_iter": outside * 1e-6 / iters,
        "inside_replays_idle_ms_per_iter": inside * 1e-6 / iters,
        "replays": len(spans),
        "graph_launches": len(launches),
        "ops": len(ops),
        "ops_unplaced": unplaced,
        "replay_span_ms": [(hi - lo) * 1e-6 for _, (lo, hi) in ordered],
        "launch_host_ms": [(b - a) * 1e-6 for a, b, _ in launches],
        "longest_gaps_ms": sorted(labelled, key=lambda g: -g[1])[:10],
    }
    marks = getattr(getattr(prog.chunk, "graph", None), "marks", None)
    if marks and ordered:
        out["last_replay_idle_ms_by_phase"] = idle_by_phase(
            marks, ordered[-1][1], gaps)
    return out


def idle_by_phase(marks, span, gaps):
    """The idle ms inside the last replay's device span, by the phase whose
    interval holds each gap's middle: the boundaries' times from the
    graph's events (read after the replay), placed from the replay's first
    device operation on."""
    marks[-1][1].synchronize()
    lo, hi = span
    at = [lo + int(marks[0][1].elapsed_time(e) * 1e6) for _, e in marks]
    out = {}
    for a, b in gaps:
        mid = (a + b) // 2
        if not lo <= mid <= hi:
            continue
        j = max(i for i, t in enumerate(at) if t <= mid or i == 0)
        name = marks[min(j, len(marks) - 2)][0]
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    out["span_ms_by_events"] = (at[-1] - at[0]) * 1e-6
    out["span_ms_by_ops"] = (hi - lo) * 1e-6
    return out


def phase_metrics(phases, gaps, updates):
    """The readings the phases give, under the names a benchmark metric of
    each would take: ms an iteration of ``act``, ``env``, ``replay_write``
    with ``sample``, ``evict`` (with a bag), ms an update of ``update``, and
    the idle ms an iteration outside every replay's span."""
    by = phases["phases"] if phases else {}
    out = {"graph_gap_ms_per_iter": gaps["graph_gap_ms_per_iter"]}
    if by:
        out.update(act_ms_per_iter=by["act"], env_ms_per_iter=by["env"],
                   replay_ms_per_iter=by["replay_write"] + by["sample"],
                   update_ms_per_update=by["update"] / updates)
        if "evict" in by:
            out["evict_ms_per_iter"] = by["evict"]
    return out


def iteration_kernels(prog):
    """{kernel name: count} of one iteration (copies and fills left out)."""
    from perfbench.trace import traced

    trace = traced(lambda: prog.step(prog.state), prog.sync, 1, True)
    out = {}
    for name, _, _ in trace.kernels():
        out[name] = out.get(name, 0) + 1
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--tracing", type=int, choices=(0, 1), default=1)
    p.add_argument("--sessions", type=int, default=3,
                   help="chunks profiled for the idle split, each alone")
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    from perfbench.run import card_power_limit, pin_to_one_core

    pin_to_one_core()
    import torch

    torch.set_num_threads(1)
    from perfbench import harness
    from perfbench.program import Program
    from perfbench.reference.envs import make_env as make_ref_env
    from perfbench.registry import Benchmark

    if args.tracing:
        from dtqn_tpu_torch.utils.profiling import set_tracing

        set_tracing(True)
    bench = Benchmark(os.getcwd())
    cell = bench.cell(args.workload)
    cfg, traffic = cell.config, cell.traffic
    seeds = harness.run_seeds(args.seed, traffic["seeds"])
    prog = Program(cfg, traffic, seeds, torch.device("cuda"))
    prog.set_weights(harness.make_weights(cfg, make_ref_env(cfg["env"]),
                                          len(seeds), args.seed, "cuda"))
    prog.prepopulate(prog.state)
    prog.sync()
    iters, envs = traffic["iters_per_chunk"], cfg["num_envs"]
    prog.run(prog.step, 1)
    prog.run(prog.step, 1)
    prog.run(prog.chunk, iters)
    setup_s = time.perf_counter() - T_START

    rows = []
    while sum(r["s"] for r in rows) < args.seconds:
        before = torch.cuda.Event(enable_timing=True)
        after = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        before.record()
        prog.chunk(prog.state)
        after.record()
        prog.sync()
        row = {"s": time.perf_counter() - t0,
               "device_ms": before.elapsed_time(after)}
        read = getattr(prog.chunk, "phase_ms", lambda: None)()
        if read:
            row.update(replay_ms=read["replay"], phases=read["phases"])
        rows.append(row)
    window_s = sum(r["s"] for r in rows)
    chunk_s = sorted(r["s"] for r in rows)

    info = {"kind": torch.cuda.get_device_name(0),
            "power_limit": card_power_limit()}
    metrics, breakdown = harness.traced_metrics(
        bench, cell, prog, info, True, len(rows) * iters, window_s,
        lambda s: print(s, file=sys.stderr, flush=True))
    read = getattr(prog.step, "phase_ms", lambda: None)()
    sessions = [replay_gaps(prog, iters, bench.reader("device_idle_pct"))
                for _ in range(args.sessions)]
    out = {
        "workload": args.workload, "seed": args.seed,
        "tracing": args.tracing, "device": info, "setup_s": setup_s,
        "env_steps_per_s": len(rows) * iters * envs * len(seeds) / window_s,
        "chunks": len(rows),
        "chunk_s_min_median_max": [chunk_s[0], statistics.median(chunk_s),
                                   chunk_s[-1]],
        "per_layer": metrics, "breakdown": breakdown,
        "iteration_phases": read,
        "phase_metrics": phase_metrics(
            read, sessions[0], traffic["updates_per_env_step"] * envs),
        "replay_gaps": sessions,
        "iteration_kernels": iteration_kernels(prog),
        "rows": rows,
    }
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    short = {k: v for k, v in out.items()
             if k not in ("rows", "iteration_kernels", "breakdown")}
    print(json.dumps(short), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
