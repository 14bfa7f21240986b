"""On-device replay: episode-major ring buffer and rolling context."""

from dtqn_tpu_torch.replay.buffer import (
    Batch,
    BufferState,
    can_sample,
    flush,
    init_buffer,
    sample,
    store_first_obs,
    store_step,
)
from dtqn_tpu_torch.replay.context import (
    ContextState,
    add_transition,
    init_context,
    reset_context,
)

__all__ = [
    "Batch",
    "BufferState",
    "ContextState",
    "init_buffer",
    "store_first_obs",
    "store_step",
    "flush",
    "can_sample",
    "sample",
    "init_context",
    "reset_context",
    "add_transition",
]
