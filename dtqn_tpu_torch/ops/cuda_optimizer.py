"""The learner's step after the gradient as two hand-written CUDA kernels
for Hopper: the global-norm clip, Adam, the gate, the step counters and the
hard target swap.

The kernels live in ``dtqn_tpu_torch/csrc/optimizer.cu`` (which says what
bounds them and how they round), built at first use like the attention
pair's (``ops/nvcc.py``).  They replace no TPU kernel: the JAX package
leaves this step to XLA.  Their plain version is the PyTorch chain of
``agents/base.py`` (``torch.linalg.vector_norm``, then
``gated_adam_step``), which ``optimizer_step`` there runs for a CPU
tensor; a CUDA tensor launches the kernels or raises.

``launch_counts`` counts the launches; ``utils/graphs.py`` registers it in
``TRACKED_COUNTERS``, so that a graph replay counts what its capture
launched.  The launches go to the current stream, and the partial sums
come from PyTorch's allocator: a CUDA graph captures them.
"""

from __future__ import annotations

import ctypes
import torch

from dtqn_tpu_torch.ops import nvcc

THREADS = 256  # a block's threads, each one float4 group (csrc: THREADS)
GROUP = 4  # floats a group
BLOCK_ELEMS = THREADS * GROUP

_SOURCE = nvcc.CSRC_DIR / "optimizer.cu"
_BUILD_DIR = nvcc.BUILD_DIR

# Launches of each kernel since the last reset (graph replays count what
# their capture counted, ``utils/graphs.py``).
launch_counts = {"adam_sumsq": 0, "adam_apply": 0}

_lib = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ------------------------------------------------------------------ geometry
def blocks_per_row(p: int) -> int:
    """The blocks of one seed's row of ``p`` floats: the grid is (blocks,
    S), and the partial sums are [S, blocks], seed-major."""
    return max(1, -(-p // BLOCK_ELEMS))


# --------------------------------------------------------------------- build
def build(verbose: bool = False) -> ctypes.CDLL:
    """Compiles csrc/optimizer.cu for sm_90a once and loads it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = nvcc.build_library(_SOURCE, _BUILD_DIR, verbose)
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.dtqn_adam_grad_sumsq.argtypes = [ptr, ptr, i64, i32, i32, ptr]
    lib.dtqn_adam_grad_sumsq.restype = i32
    lib.dtqn_adam_clip_apply.argtypes = (
        [ptr] * 15 + [i64, i32, i32] + [f32] * 7 + [i32, ptr])
    lib.dtqn_adam_clip_apply.restype = i32
    lib.dtqn_cuda_error_string.argtypes = [i32]
    lib.dtqn_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


# ------------------------------------------------------------------ wrapper
def _check(vectors, counters, ok):
    grads = vectors[0]
    if grads.dim() not in (1, 2):
        raise ValueError(f"the step takes [P] or [S, P], got "
                         f"{tuple(grads.shape)}")
    seeds, device = grads.shape[:-1], grads.device

    def wrong(tensors, shape, dtype):
        return any(t.shape != shape or t.dtype != dtype or t.device != device
                   or not t.is_contiguous() for t in tensors)

    if wrong(vectors, grads.shape, torch.float32):
        raise ValueError("params, grads, moments and target must be "
                         "contiguous float32 tensors of one shape and device")
    if any(t.data_ptr() % (4 * GROUP) for t in vectors):
        raise ValueError("params, grads, moments and target must start on "
                         "16 bytes: the kernels' rows share one head")
    if wrong(counters, seeds, torch.int32) or wrong((ok,), seeds, torch.bool):
        raise ValueError(f"the counters (int32) and ok (bool) must be of "
                         f"shape {tuple(seeds)} on {device}")


def clip_adam_apply(params, grads, mu, nu, count, ok, train_steps,
                    nonfinite_grads, target_params, learning_rate: float,
                    max_norm: float, target_update_frequency: int,
                    b1: float, b2: float, eps: float):
    """The fused step on CUDA tensors: ``params``, ``mu``, ``nu`` and
    ``target_params`` ([P] or [S, P]) are written in place where the step
    applies; returns (gnorm, apply, count, train_steps, nonfinite_grads),
    fresh tensors of the seeds' shape, as ``gated_adam_step`` leaves
    them."""
    vectors = (grads, params, mu, nu, target_params)
    counters = (count, train_steps, nonfinite_grads)
    _check(vectors, counters, ok)
    if grads.numel() == 0:
        raise ValueError("the step needs P >= 1 and S >= 1")
    lib = build()
    p, seeds = grads.shape[-1], grads.shape[:-1]
    rows = grads.numel() // p
    blocks = blocks_per_row(p)
    partials = torch.empty(rows * blocks, dtype=torch.float32,
                           device=grads.device)
    gnorm = torch.empty(seeds, dtype=torch.float32, device=grads.device)
    apply = torch.empty(seeds, dtype=torch.bool, device=grads.device)
    new_count, new_steps, new_nonfinite = (torch.empty_like(t)
                                           for t in counters)
    stream = torch.cuda.current_stream(grads.device).cuda_stream
    code = lib.dtqn_adam_grad_sumsq(grads.data_ptr(), partials.data_ptr(),
                                    p, rows, blocks, stream)
    nvcc.raise_on_error(lib, code, "adam_grad_sumsq")
    launch_counts["adam_sumsq"] += 1
    code = lib.dtqn_adam_clip_apply(
        grads.data_ptr(), partials.data_ptr(), params.data_ptr(),
        mu.data_ptr(), nu.data_ptr(), target_params.data_ptr(),
        ok.data_ptr(), count.data_ptr(), train_steps.data_ptr(),
        nonfinite_grads.data_ptr(), gnorm.data_ptr(), apply.data_ptr(),
        new_count.data_ptr(), new_steps.data_ptr(), new_nonfinite.data_ptr(),
        p, rows, blocks, -learning_rate, max_norm, b1, 1 - b1, b2,
        1 - b2, eps, target_update_frequency, stream)
    nvcc.raise_on_error(lib, code, "adam_clip_apply")
    launch_counts["adam_apply"] += 1
    return gnorm, apply, new_count, new_steps, new_nonfinite
