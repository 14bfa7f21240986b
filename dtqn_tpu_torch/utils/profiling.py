"""Tracing / profiling hooks (``dtqn_tpu/utils/profiling.py``) on
``torch.profiler``.

``trace_chunks`` wraps a train chunk in a profiler run that records host
activity and, on the card, every CUDA kernel, and writes one Chrome trace
(``chrome://tracing``, Perfetto) under the directory: the port's
counterpart of the JAX package's TensorBoard trace.  ``annotate`` names a
span inside it; ``device_memory_summary`` reports the card's allocator
statistics.

On the card a chunk replays a CUDA graph (``train/loop.py``:
``make_train_chunk``), and CUPTI records every kernel of every replay as it
records eager launches (``chip_smoke.py`` phases 19 and 22 read them); the
host side of a replayed chunk is one graph launch per iteration, with no
operator spans: those appear only in the chunk that captures the graph.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace_chunks(log_dir: Optional[str],
                 device: Optional[torch.device] = None) -> Iterator[None]:
    """Profile everything inside the context when ``log_dir`` is set, CUDA
    kernels included when ``device`` is a card; the trace is written to
    ``<log_dir>/trace_<pid>_<ms>.json`` when the context closes (after a
    synchronize, so the device work of the chunk is in it)."""
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
    name = f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


def annotate(name: str):
    """A named span inside a trace."""
    return record_function(name)


def device_memory_summary() -> dict:
    """Allocator statistics per card (bytes): in use, peak, limit."""
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
