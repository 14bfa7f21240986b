"""The traced window: ``torch.profiler`` (CPU and CUDA activities) around
whole chunks, each chunk's launch and sync in a span of the harness's own,
reduced to device intervals by kernel name and host spans on one clock.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

LAUNCH, SYNC = "perfbench.chunk_launch", "perfbench.sync"
SPANS = (LAUNCH, SYNC)
MEMORY_OPS = ("Memcpy", "Memset", "memcpy", "memset")


@dataclasses.dataclass
class Trace:
    device_ops: List[Tuple[str, int, int]]  # (name, start ns, end ns)
    spans: List[Tuple[str, int, int]]  # the harness's host spans
    start_ns: int
    end_ns: int

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def kernels(self) -> List[Tuple[str, int, int]]:
        """Device operations that are kernels (not copies or fills)."""
        return [op for op in self.device_ops
                if not op[0].startswith(MEMORY_OPS)]

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of device operations' intervals inside the window."""
        out: List[List[int]] = []
        for _, a, b in sorted(self.device_ops, key=lambda op: op[1]):
            a, b = max(a, self.start_ns), min(b, self.end_ns)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Every idle stretch of the window, longest first, named by the
        harness span open on the host at its middle."""
        edges, t = [], self.start_ns
        for a, b in self.busy_intervals():
            if a > t:
                edges.append((t, a))
            t = max(t, b)
        if self.end_ns > t:
            edges.append((t, self.end_ns))
        out = []
        for a, b in edges:
            mid = (a + b) // 2
            names = [n for n, s, e in self.spans if s <= mid <= e]
            label = {LAUNCH: "chunk launch", SYNC: "sync"}.get(
                names[0] if names else "", "between chunks")
            out.append((label, (b - a) * 1e-9))
        return sorted(out, key=lambda g: -g[1])

    def time_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, a, b in self.device_ops:
            out[name] = out.get(name, 0.0) + (b - a) * 1e-9
        return out


def traced(run_chunk: Callable[[], None], sync: Callable[[], None],
           chunks: int, on_card: bool) -> Trace:
    """Profiles ``chunks`` chunks, each launched and synced inside a span
    of its own; the window runs from the first launch to the last sync."""
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for _ in range(chunks):
            with record_function(LAUNCH):
                run_chunk()
            with record_function(SYNC):
                sync()
    device_ops, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            # The device's copy of a span (a user annotation) is no work.
            if not ev.is_user_annotation() and ev.name() not in SPANS:
                device_ops.append((ev.name(), ev.start_ns(), ev.end_ns()))
        elif ev.name() in SPANS:
            spans.append((ev.name(), ev.start_ns(), ev.end_ns()))
    if not spans:
        raise RuntimeError("the profiler recorded none of the harness's "
                           "spans")
    return Trace(device_ops, spans, min(s for _, s, _ in spans),
                 max(e for _, _, e in spans))
