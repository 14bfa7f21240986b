"""On-device replay: episode-major ring buffer, rolling context and bag."""

from dtqn_tpu_torch.replay.bag import BagState, bag_add, init_bag, reset_bag
from dtqn_tpu_torch.replay.buffer import (
    Batch,
    BufferState,
    can_sample,
    flush,
    init_buffer,
    sample,
    sample_with_bag,
    sample_with_stored_bag,
    stack_buffers,
    store_act_bag,
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
    "BagState",
    "Batch",
    "BufferState",
    "ContextState",
    "init_buffer",
    "store_first_obs",
    "store_step",
    "flush",
    "can_sample",
    "sample",
    "sample_with_bag",
    "sample_with_stored_bag",
    "stack_buffers",
    "store_act_bag",
    "init_bag",
    "reset_bag",
    "bag_add",
    "init_context",
    "reset_context",
    "add_transition",
]
