"""Tracing / profiling hooks (``dtqn_tpu/utils/profiling.py``) on
``torch.profiler``.

``trace_chunks`` wraps a train chunk in a profiler run that records host
activity and, on the card, every CUDA kernel, and writes one Chrome trace
(``chrome://tracing``, Perfetto) under the directory: the port's
counterpart of the JAX package's TensorBoard trace.

Tracing is a process-wide switch, off by default (``set_tracing``,
``tracing_on``).  While it is off ``phase`` returns one shared null context
and costs one bool check, and a graph captured then is the graph the step
would give without it.  While it is on, ``phase(name)`` opens a host span
``dtqn.<name>`` (``record_function``), so that in eager code the profiler
ties each kernel to its phase, and, inside a capture that records marks
(``recording_phases``: ``utils/graphs.py``'s ``GraphedStep.capture``),
records a boundary into the graph at its entry and at its exit: a CUDA
event with ``external=True``, an event-record node, not a kernel.

Boundaries are flat: a phase's entry opens an interval named by it, its
exit one named by the phase around it, or ``other`` outside every phase.
An exit followed at once by an entry leaves an ``other`` interval of the
event node's own length.  A capture's marks are the ordered (name, event)
pairs, from a first boundary before the step's work to a last one after
it; after a replay has ended, ``phase_ms`` reads the device ms between
consecutive events, by name.

The phases (``train/loop.py``, ``agents/base.py``, ``train/host_loop.py``):
``act`` (the action choice, or prepopulation's random draw), ``env`` (the
env step), ``replay_write`` (the context append, the replay ring's writes
and the resets), ``evict`` (the bag's add and evict forward), ``sample``
(an update's batch) and ``update`` (the rest of an update).

On the card a chunk replays a CUDA graph (``train/loop.py``:
``make_train_chunk``), and CUPTI records every kernel of every replay as it
records eager launches (``chip_smoke.py`` phases 19 and 22 read them); the
host side of a replayed chunk is one ``cudaGraphLaunch`` per iteration,
with no operator spans: those appear only in the chunk that captures the
graph.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

PREFIX = "dtqn."
OTHER = "other"  # the intervals outside every phase
# Marks: (name of the interval a boundary opens, its event), in order.
Marks = List[Tuple[Optional[str], "torch.cuda.Event"]]

_NULL = contextlib.nullcontext()


class _Switch:
    """The tracing switch, the phases open now (innermost last) and the
    marks of the capture that records them (None outside one)."""

    on = False
    open: List[str] = []
    marks: Optional[Marks] = None


def set_tracing(on: bool) -> None:
    """Switches tracing on or off for the whole process; a graph keeps the
    marks (or none) of the switch at its capture."""
    _Switch.on = bool(on)


def tracing() -> bool:
    return _Switch.on


@contextlib.contextmanager
def tracing_on(on: bool = True) -> Iterator[None]:
    """Tracing switched on inside the context where ``on`` (left as it is
    otherwise), and set back to what it was when the context closes."""
    before = _Switch.on
    _Switch.on = before or bool(on)
    try:
        yield
    finally:
        _Switch.on = before


def phase(name: str):
    """Phase ``name`` of a step: the null context when tracing is off."""
    return _Phase(name) if _Switch.on else _NULL


def _new_event():
    event = torch.cuda.Event(enable_timing=True, external=True)
    event.record()
    return event


def _boundary(name: Optional[str]) -> None:
    if _Switch.marks is not None:
        _Switch.marks.append((name, _new_event()))


class _Phase:
    def __init__(self, name: str):
        self.name = name
        self.host = record_function(PREFIX + name)

    def __enter__(self):
        self.host.__enter__()
        _Switch.open.append(self.name)
        _boundary(self.name)
        return self

    def __exit__(self, *exc):
        _Switch.open.pop()
        _boundary(_Switch.open[-1] if _Switch.open else OTHER)
        return self.host.__exit__(*exc)


@contextlib.contextmanager
def recording_phases() -> Iterator[Marks]:
    """Yields the marks that the phases inside the context record, with a
    boundary before them and one after; while tracing is off, an empty list
    and no boundary.  Open it on the capturing stream, inside the capture."""
    marks: Marks = []
    if not _Switch.on:
        yield marks
        return
    outer, _Switch.marks = _Switch.marks, marks
    try:
        _boundary(OTHER)
        yield marks
        _boundary(None)
    finally:
        _Switch.marks = outer


def phase_ms(marks: Marks) -> Dict[str, object]:
    """``{"phases": {name: device ms}, "replay": ms}`` of a replay of the
    graph that recorded ``marks``, once the replay has ended: the ms between
    each boundary and the next, summed by the name of the interval, and the
    ms from the first boundary to the last."""
    by_name: Dict[str, float] = {}
    for (name, start), (_, end) in zip(marks, marks[1:]):
        by_name[name] = by_name.get(name, 0.0) + start.elapsed_time(end)
    return {"phases": by_name,
            "replay": marks[0][1].elapsed_time(marks[-1][1])}


@contextlib.contextmanager
def trace_chunks(log_dir: Optional[str],
                 device: Optional[torch.device] = None,
                 chunk=None) -> Iterator[None]:
    """Profile everything inside the context when ``log_dir`` is set, CUDA
    kernels included when ``device`` is a card; the trace is written to
    ``<log_dir>/trace_<pid>_<ms>.json`` when the context closes (after a
    synchronize, so the device work of the chunk is in it).  Where
    ``chunk`` is a graphed step that recorded marks (``GraphedStep``,
    captured while tracing), ``<log_dir>/phases_<pid>_<ms>.json`` beside it
    holds its last replay's ``phase_ms``."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    on_card = device is not None and torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if on_card:
            torch.cuda.synchronize(device)
    stamp = f"{os.getpid()}_{int(time.time() * 1e3)}"
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{stamp}.json"))
    read = getattr(chunk, "phase_ms", None)
    phases = read() if read else None
    if phases:
        with open(os.path.join(log_dir, f"phases_{stamp}.json"), "w") as f:
            json.dump(phases, f, indent=1)
