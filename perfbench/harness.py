"""One run of one cell: set-up, the measured window, the traced
iterations, and the comparison that decides ``correct``.

The program builds two chunks of one state with ``make_train_chunk``: the
window's (``iters_per_chunk`` iterations a call) and one of a single
iteration, through which the comparison takes its iterations one at a
time.  Every call is checked to run the iterations it is meant to: a
change of a chunk's unit is the harness's error, not a wrong answer.

Set-up (``setup_s``, from the process's first line to the window's start):
imports, the card's start, the agent and its state, the initial weights
(made on the device from the seed, the same for the program and the
reference), prepopulation (``make_prepopulate``), the first two
iterations through the one-iteration chunk (the first call captures it,
the second replays it), and one warm-up call of the window's chunk (its
capture and replays).  The program's state after each of the two
iterations is kept on the host for the comparison.

The window starts at the next chunk's launch and ends at the sync after
the first chunk that ends past ``seconds``; every chunk in it ends in one
host read that depends on the whole learn chain.  ``env_steps_per_s`` is
every env step its chunks completed, summed over seeds, over its whole
wall time.

With ``trace``, after the window: two single iterations and one chunk
under the profiler, each in a session of its own; the per-layer metrics
are read from them.

Then the late stage (``perfbench.compare``): the program runs on to the
iteration that reaches the next target swap, its whole state is kept, and
that iteration runs through the one-iteration chunk.  Then the program is
dropped, and the plain reference runs the same seeds from the same
weights over prepopulation and the first iteration, continues from the
program's learned state over the second, and from the program's whole
state over the late one; it judges the program's three states against
its own.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from types import ModuleType
from typing import Callable, Dict, List, Optional, Sequence

import torch

from perfbench import compare, flops
from perfbench.program import Program
from perfbench.reference.envs import make_env as make_ref_env
from perfbench.reference.learner import ReferenceRun
from perfbench.reference.precision import Precision
from perfbench.registry import Benchmark, Cell, family
from perfbench.trace import Trace, traced

WEIGHT_STREAM = 0x5EED  # the weights' generator: seed * 2**16 + this


def run_seeds(seed: int, count: int) -> List[int]:
    """The program's and the reference's seeds of a cell run."""
    return [seed + i for i in range(count)]


def make_weights(cfg: dict, env, seeds: int, seed: int, device,
                 model: Optional[ModuleType] = None
                 ) -> Dict[str, torch.Tensor]:
    """Initial weights, name -> [S, *shape], as the reference ``model``'s
    ``param_spec`` lists them (by default the module ``cfg`` names, from
    the benchmark's own root): N(0, 0.02), zeros or ones, as it says for
    each, drawn on ``device`` in one call."""
    model = model or family(cfg).reference
    spec = model.param_spec(cfg, env)
    sizes = [(name, shape, init, _numel(shape)) for name, shape, init in spec]
    gen = torch.Generator(device=device).manual_seed(
        seed * 2**16 + WEIGHT_STREAM)
    normal = sum(n for _, _, init, n in sizes if init == "normal")
    draws = torch.randn((seeds, normal), generator=gen, device=device) * 0.02
    out, offset = {}, 0
    for name, shape, init, n in sizes:
        if init == "normal":
            out[name] = draws[:, offset:offset + n].reshape(seeds, *shape)
            offset += n
        else:
            fill = 1.0 if init == "ones" else 0.0
            out[name] = torch.full((seeds, *shape), fill, device=device)
    return out


@dataclasses.dataclass
class LayerContext:
    """What a per-layer metric's reader may read."""

    trace: Optional[Trace]  # one iteration
    chunk_trace: Optional[Trace]  # one chunk of the window's
    patterns: Callable[[str], list]
    iters_traced: int  # in ``trace``
    updates_traced: int
    iters_window: int
    window_s: float
    flops_per_iter: int
    peak_flops: float
    bytes_per_s: float
    applications: List[flops.Application]
    work: ModuleType  # the configuration's work counts

    def matching(self, group: str) -> List[tuple]:
        """The traced kernels whose names match a pattern of ``group``."""
        pats = self.patterns(group)
        return [k for k in (self.trace.kernels() if self.trace else [])
                if any(p.search(k[0]) for p in pats)]


@dataclasses.dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, dict]
    device: dict
    checks: Dict[str, dict]
    breakdown: Optional[dict] = None
    notes: Optional[List[str]] = None
    controls: Optional[Dict[str, dict]] = None

    def line(self) -> dict:
        out = {"correct": self.correct, "attempted": self.attempted,
               "failed": self.failed, "metrics": self.metrics,
               "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["checks"] = self.checks
        return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _device_info(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def measure_window(run_chunk: Callable[[], None], sync: Callable[[], None],
                   seconds: float,
                   clock: Callable[[], float] = time.perf_counter):
    """Chunks until one ends past ``seconds``: (chunks, window seconds from
    the first launch to the last sync, each chunk's launch seconds, each
    chunk's seconds from its launch to its sync's end)."""
    launch_s, chunk_s = [], []
    t0 = end = clock()
    while True:
        a = clock()
        run_chunk()
        launch_s.append(clock() - a)
        sync()
        chunk_s.append(clock() - end)
        end = clock()
        if end - t0 >= seconds:
            return len(chunk_s), end - t0, launch_s, chunk_s


def to_next_swap(prog: Program, target_update: int,
                 updates_per_iter: int) -> None:
    """Runs the program on, in chunks and then single iterations, until its
    next iteration's updates reach a multiple of ``target_update``."""
    done = max(prog.train_steps())
    swap = (done // target_update + 1) * target_update
    chunks, rest = divmod((swap - done - 1) // updates_per_iter,
                          prog.iters_per_chunk)
    for _ in range(chunks):
        prog.run(prog.chunk, prog.iters_per_chunk)
    for _ in range(rest):
        prog.run(prog.step, 1)


def run_cell(bench: Benchmark, cell: Cell, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             plant: Optional[Callable[[Program], None]] = None,
             log: Callable[[str], None] = lambda s: None,
             controls: Sequence[str] = ()) -> Result:
    """One run.  ``plant`` (for the checks of the comparison) breaks the
    program after it is built; the reference is never touched.
    ``controls`` (for the readings of the limits' upper ends): the
    reference put in the program's place, in TF32 (``tf32``) or with a
    planted fault (``half_batch``, ``evict_skipped``), judged as the
    program is, from the same seeds and from the program's state before
    the late stage."""
    device = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    model = cell.family.reference
    seeds = run_seeds(seed, traffic["seeds"])
    ref_env = make_ref_env(cfg["env"])
    prog = Program(cfg, traffic, seeds, device)
    spec = [(n, s) for n, s, _ in model.param_spec(cfg, ref_env)]
    if sorted(spec) != sorted((n, s) for n, _, s in prog.layout()):
        raise RuntimeError("the program's parameters differ from the "
                           "reference's: " + repr(sorted(
                               set(spec) ^ {(n, s) for n, _, s in
                                            prog.layout()})))
    weights = make_weights(cfg, ref_env, len(seeds), seed, device, model)
    prog.set_weights(weights)
    if plant is not None:
        plant(prog)
    prog.prepopulate(prog.state)
    prog.sync()
    if min(prog.flushed()) <= cfg["batch_size"]:
        raise RuntimeError("prepopulation finished too few episodes")
    iters, envs = traffic["iters_per_chunk"], cfg["num_envs"]
    updates_per_iter = traffic["updates_per_env_step"] * envs
    # The first two iterations one at a time (the one-iteration chunk's
    # capture, then its replay), then the window's chunk once (its capture
    # and replays).
    prog.run(prog.step, 1)
    start = prog.observables()
    prog.run(prog.step, 1)
    replayed = prog.observables()
    prog.run(prog.chunk, iters)
    steps_before = prog.train_steps()
    env_before = prog.env_steps()
    nonfinite_before = prog.nonfinite()

    # The measured window.
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    chunks, window_s, launch_s, chunk_s = measure_window(
        lambda: prog.chunk(prog.state), prog.sync, seconds)
    log(f"window: {chunks} chunks in {window_s:.3f} s; set-up "
        f"{setup_s:.3f} s; chunk s {min(chunk_s):.4f} / "
        f"{sorted(chunk_s)[len(chunk_s) // 2]:.4f} / {max(chunk_s):.4f}; "
        f"launch s {min(launch_s):.4f} / {max(launch_s):.4f}")
    ran = {b - a for a, b in zip(env_before, prog.env_steps())}
    if ran - {0, chunks * iters * envs}:
        raise RuntimeError(f"the window's {chunks} chunks ran {sorted(ran)} "
                           f"env steps, not {chunks * iters * envs}: the "
                           "chunk's unit is not what the harness drives")
    # Every update of every seed in the window was applied, and no
    # gradient was non-finite.
    expected = chunks * iters * updates_per_iter
    attempted = expected * len(seeds)
    failed = sum(expected - (b - a) for a, b in zip(
        steps_before, prog.train_steps())) + prog.nonfinite() \
        - nonfinite_before

    metrics: Dict[str, dict] = {}
    breakdown = None
    if not trace:
        values = {"env_steps_per_s": chunks * iters * envs * len(seeds)
                  / window_s, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    info = _device_info(device, cell.chips)
    if trace:
        metrics, breakdown = traced_metrics(
            bench, cell, prog, info, device.type == "cuda", chunks * iters,
            window_s, log)

    # The late stage.
    to_next_swap(prog, cfg["target_update"], updates_per_iter)
    before = prog.observables()
    generator_states = prog.generator_states()
    prog.run(prog.step, 1)
    late = prog.observables()
    info["memory_peak_bytes"] = _device_info(
        device, cell.chips)["memory_peak_bytes"]

    # The program's state is freed before the reference runs, so that the
    # reference sets no peak.
    prog.close()
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    stages = Stages(start, replayed, before, generator_states, late)
    values, notes = against_reference(cell, seeds, weights, device, stages)
    log(f"reference: {time.perf_counter() - t_ref:.3f} s")
    correct = compare.judge(values, cell.limits) and failed == 0
    checks, more_notes = compare.checks(values, cell.limits)
    notes += more_notes
    out = {}
    for fault in controls:
        out[fault] = control_checks(cell, seeds, weights, device, stages,
                                    fault)
    return Result(correct, attempted, failed, metrics, info, checks,
                  breakdown, notes, out or None)


def traced_metrics(bench: Benchmark, cell: Cell, prog: Program, info: dict,
                   on_card: bool, iters_window: int, window_s: float,
                   log: Callable[[str], None]):
    """The per-layer metrics, read after the window: one iteration, a
    second one (whose kernel count checks the first's: a session that drops
    records reads fewer), and one chunk under the profiler.  Fills ``info``'s ``busy_s`` and ``window_s`` from
    the chunk: (metrics, breakdown)."""
    cfg, traffic = cell.config, cell.traffic
    iters, envs = traffic["iters_per_chunk"], cfg["num_envs"]
    updates_per_iter = traffic["updates_per_env_step"] * envs
    env_before = prog.env_steps()

    def step():
        prog.step(prog.state)

    one = traced(step, prog.sync, 1, on_card)
    again = traced(step, prog.sync, 1, on_card)
    whole = traced(lambda: prog.chunk(prog.state), prog.sync, 1, on_card)
    ran = {b - a for a, b in zip(env_before, prog.env_steps())}
    if ran - {0, (2 + iters) * envs}:
        raise RuntimeError("the traced calls ran another number of "
                           "iterations than the harness drives")
    log(f"kernels traced in one iteration: {len(one.kernels())}, in a second: "
        f"{len(again.kernels())}, in a chunk of {iters}: "
        f"{len(whole.kernels())}")
    work = cell.family.work
    sizes = (make_ref_env(cfg["env"]), traffic["seeds"], envs,
             cfg["batch_size"], updates_per_iter)
    peak = flops.peaks(info["kind"] if on_card else "H100")
    ctx = LayerContext(
        trace=one, chunk_trace=whole, patterns=bench.patterns,
        iters_traced=1, updates_traced=updates_per_iter,
        iters_window=iters_window, window_s=window_s,
        flops_per_iter=work.iteration_flops(cfg, *sizes),
        peak_flops=peak[cfg["precision"]],
        bytes_per_s=peak["hbm_bytes_per_s"],
        applications=work.attention_applications(cfg, *sizes),
        work=work)
    metrics = {}
    for m in cell.per_layer:
        value = bench.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    breakdown = None
    if whole.device_ops:
        info["busy_s"] = whole.busy_s()
        info["window_s"] = whole.window_s
        by_name = sorted(whole.time_by_name().items(), key=lambda kv: -kv[1])
        breakdown = {
            "device_ops": [[n, s] for n, s in by_name[:10]],
            "idle_gaps": [[n, s] for n, s in whole.idle_gaps()[:10]],
        }
    return metrics, breakdown


@dataclasses.dataclass
class Stages:
    """What the program left for the comparison (host copies): its state
    after the first and the second iteration, its whole state and its
    generators' states before the late stage, and its state after it."""

    start: Dict[str, torch.Tensor]
    replayed: Dict[str, torch.Tensor]
    before: Dict[str, torch.Tensor]
    generator_states: List[torch.Tensor]
    late: Dict[str, torch.Tensor]


def against_reference(cell: Cell, seeds: List[int],
                      weights: Dict[str, torch.Tensor], device,
                      stages: Stages):
    """The float32 reference's readings of a run's three stages: (values,
    notes: where the exact part differs, and the worst leaves)."""
    cfg = cell.config
    updates = cell.traffic["updates_per_env_step"] * cfg["num_envs"]
    with Precision(tf32=False) as prec:
        run = ReferenceRun(cfg, cell.family.reference, seeds, weights,
                           device, prec)
        # Over the start no compared number reads a bag's contents (the
        # first iteration acts at epsilon 1, and updates draw their bags
        # from the replay): the evict is checked over the replay, from the
        # program's own bags.
        run.evicts = False
        run.prepopulate()
        run.iteration(updates)
        values, notes = compare.start_readings(stages.start,
                                                run.observables(), updates)
        run.take_learned_state(stages.start)
        run.evicts = True
        run.iteration(updates)
        more, more_notes = compare.replay_readings(
            stages.replayed, run.observables(), stages.start, updates,
            run.last_evict, run.last_done)
        values.update(more)
        notes += more_notes
        run.take_full_state(stages.before, stages.generator_states)
        run.iteration(updates)
        more, more_notes = compare.late_readings(
            stages.late, run.observables(), stages.before, updates,
            run.last_greedy)
    values.update(more)
    return values, notes + more_notes


def reference_stages(cell: Cell, seeds: List[int],
                     weights: Dict[str, torch.Tensor], device, tf32: bool,
                     before: Dict[str, torch.Tensor],
                     generator_states: List[torch.Tensor],
                     half_batch: bool = False, evicts: bool = True
                     ) -> Stages:
    """The reference put in the program's place (the control, in TF32, or
    with a planted fault: ``half_batch``, or no evict where not
    ``evicts``): its state after the first and second iteration from the
    seed, and after the late stage from ``before``."""
    cfg = cell.config
    updates = cell.traffic["updates_per_env_step"] * cfg["num_envs"]
    with Precision(tf32) as prec:
        run = ReferenceRun(cfg, cell.family.reference, seeds, weights,
                           device, prec, half_batch)
        run.evicts = evicts
        run.prepopulate()
        run.iteration(updates)
        start = run.observables()
        run.iteration(updates)
        replayed = run.observables()
        run.take_full_state(before, generator_states)
        run.iteration(updates)
        return Stages(start, replayed, before, generator_states,
                      run.observables())


def control_checks(cell: Cell, seeds: List[int],
                   weights: Dict[str, torch.Tensor], device, stages: Stages,
                   fault: str) -> dict:
    """The readings of the reference put in the program's place with
    ``fault``, judged against the cell's limits."""
    t0 = time.perf_counter()
    put = reference_stages(cell, seeds, weights, device, fault == "tf32",
                           stages.before, stages.generator_states,
                           half_batch=fault == "half_batch",
                           evicts=fault != "evict_skipped")
    values, notes = against_reference(cell, seeds, weights, device, put)
    checks, more_notes = compare.checks(values, cell.limits)
    return {"correct": compare.judge(values, cell.limits),
            "seconds": time.perf_counter() - t0,
            "notes": notes[:8] + more_notes, "checks": checks}
