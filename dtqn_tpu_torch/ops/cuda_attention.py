"""Packed multi-head attention: hand-written CUDA kernels for Hopper.

Replaces ``dtqn_tpu/ops/pallas_attention.py``: ``_fwd`` / ``_fwd_kernel``
(forward) and ``_bwd`` / ``_bwd_kernel`` (recompute backward), wired as
``pallas_attention_packed``'s ``custom_vjp``.  Here the wiring is
``AttentionFunction``, a ``torch.autograd.Function``.

The kernels live in ``dtqn_tpu_torch/csrc/attention.cu``.  They are built
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library
with a plain C interface at first use, under ``dtqn_tpu_torch/_build/``
keyed by a hash of the source and the flags, and loaded with ctypes
(``ops/nvcc.py``).

What bounds them on an H100: at the main path's shapes (B = 32..64,
L = 50, E = 64 or 128) a call moves 1-2 MB, under a microsecond at
3.35 TB/s, and does a few MFLOP, so the time goes to the launch and to the
latency of each warp's dependent chain; at the bag evict forward's
B = 1664 the bytes bound it, where the CUDA-core instances run at the
issue rate of their FMAs and shuffles.  ``launch_config`` picks the
instance by the element type and the shape:

- bfloat16 at head width 8 or 16 with Lk <= 64 (and, backward, Lq <= 64),
  every bf16 shape of a driven path, takes the tensor-core form
  (``MMA_INSTANCES``, ``keys_per_lane`` ``MMA_FORM``): a warp per 16 query
  rows, Q K^T and P V (backward also dO V^T, dS K, P^T dO, dS^T Q) as
  ``mma.sync`` products of bf16 operands in float32, P and dS split into
  hi and lo bf16 so that they keep ~16 bits, the head's rows staged as bf16
  by ``cp.async``.
- Every other call (all of float32; bf16 at other widths, past Lk = 64 or,
  backward, past Lq = 64) takes the keys-on-lanes CUDA-core instances
  (``INSTANCES``, head width padded to 8, 16, 32 or 64, and keys per lane):
  a warp takes query rows of one (batch, head), each lane holds its keys'
  scores in registers and the softmax sums are warp shuffles; 1 or 2 keys
  a lane with K and V in registers where that is at most
  ``REGISTER_KEY_FLOATS`` floats (head width 8); 2 keys a lane at head
  width 16 (Lk up to 64) with the head's rows staged once in shared memory
  by ``cp.async`` (the backward also keeps P and dS as [Lq, Lk] tiles
  there, and spreads dK and dV over the whole block); or 0, the streamed
  form that takes any Lk.  No tensor cores in float32 (TF32 keeps about
  three digits).  Each is built for float32 and for bfloat16 (``DTYPES``);
  a bfloat16 instance loads bf16, computes in float32 and stores its
  outputs rounded to bf16.

``launch_config`` also picks the warps, the query rows per block and the
shared memory, and the C entry point launches that instance.  No TMA: a
tensor map would be encoded on the host for every call.

Dispatch is by device: a CPU tensor takes the plain PyTorch version, which
repeats the kernels' math (``plain_attention_fwd`` / ``plain_attention_bwd``:
float32 inside, each output rounded once to the inputs' dtype); a CUDA
tensor launches the instance of its dtype or raises.  There is no fallback
and no cast: a bfloat16 call never reaches a float32 instance.

A CUDA graph captures the launches (``utils/graphs.py``): they go to the
current stream, and besides the launch the C entry points call only
``cudaFuncSetAttribute`` and ``cudaGetLastError``, which a stream capture
allows (``chip_smoke.py`` phase 22 holds graphed launches bit-equal to
eager ones).  A wrapper's Python runs only while a graph is captured, so
``launch_counts`` gains there, and ``utils/graphs.py`` takes that back
and adds it again on every replay.
"""

from __future__ import annotations

import ctypes
import functools
import re
from pathlib import Path
from typing import List, NamedTuple, Optional, Tuple

import torch

from dtqn_tpu_torch.ops import nvcc

MASK_VALUE = -1e30  # pallas_attention.py:55
MAX_HEAD_DIM = 64
MAX_SMEM_BYTES = 232_448  # what one block may use on sm_90 (227 KB)

# (head width, keys per lane) pairs built in csrc/attention.cu
# (DTQN_INSTANCES); keys per lane 0 is the streamed form, which takes any Lk.
INSTANCES = ((8, 1), (8, 2), (16, 2), (8, 0), (16, 0), (32, 0), (64, 0))
# The element types every instance of INSTANCES is built in, by the code
# the C entry points take (DTQN_DTYPES).
DTYPES = (torch.float32, torch.bfloat16)
# The tensor-core form's head widths, bfloat16 only (DTQN_MMA_INSTANCES);
# a launch configuration names it by keys_per_lane MMA_FORM.  It takes Lk
# up to MMA_MAX_KEYS and, backward, Lq up to MMA_MAX_ROWS; a warp takes
# MMA_WARP_ROWS query rows, a forward block up to MMA_MAX_ROWS.
MMA_INSTANCES = (8, 16)
MMA_FORM = -1
MMA_MAX_KEYS = MMA_MAX_ROWS = 64
MMA_WARP_ROWS = 16
# A lane holds its keys' K and V rows (and, backward, their dK and dV sums)
# in registers when keys per lane times the head width is at most this;
# past it, an instance stages the head's rows in shared memory.
REGISTER_KEY_FLOATS = 16
FWD_WARPS, FWD_ROWS_PER_WARP = 4, 2
BWD_MAX_WARPS, BWD_ROWS_PER_WARP = 8, 4
# The staged form: 8 warps a block, up to 64 query rows a forward block
# (one block per (batch, head) at Lq <= 64), head rows padded by 4 floats.
STAGED_WARPS, STAGED_FWD_ROWS, STAGED_ROW_PAD = 8, 64, 4

_SOURCE = nvcc.CSRC_DIR / "attention.cu"
_BUILD_DIR = nvcc.BUILD_DIR

KINDS = ("attention_fwd", "attention_bwd")
# Launches of each kernel since the last reset, the bfloat16 instances
# under their own names (plain versions never count; graph replays count
# what their capture counted, ``utils/graphs.py``).
launch_counts = {"attention_fwd": 0, "attention_bwd": 0,
                 "attention_fwd_bf16": 0, "attention_bwd_bf16": 0}

_lib = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def instances(dtype: torch.dtype) -> Tuple[Tuple[int, int], ...]:
    """The (head width, keys per lane) instances built in ``dtype``."""
    if dtype == torch.bfloat16:
        return INSTANCES + tuple((d, MMA_FORM) for d in MMA_INSTANCES)
    return INSTANCES


def form_name(cfg) -> str:
    """A launch configuration's instance as text: "mma <16>" or
    "lanes <16, 2>"."""
    if cfg.keys_per_lane == MMA_FORM:
        return f"mma <{cfg.head_dim_pad}>"
    return f"lanes <{cfg.head_dim_pad}, {cfg.keys_per_lane}>"


def count_name(kind: str, dtype: torch.dtype) -> str:
    """The ``launch_counts`` entry of ``kind`` launched in ``dtype``."""
    return kind if dtype == torch.float32 else f"{kind}_bf16"


# --------------------------------------------------------------- plain math
def _scale(head_dim: int) -> float:
    return 1.0 / (head_dim ** 0.5)  # pallas_attention.py:130


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, length, e = x.shape
    return x.reshape(b, length, num_heads, e // num_heads).transpose(1, 2)


def _packed(x: torch.Tensor) -> torch.Tensor:
    b, h, length, d = x.shape
    return x.transpose(1, 2).reshape(b, length, h * d)


def _probs(qh, kh, causal, scale):
    """``_softmax_scores`` on [B, H, L, D] heads; returns (P, mask)."""
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    lq, lk = s.shape[-2], s.shape[-1]
    rows = torch.arange(lq, device=s.device)[:, None]
    cols = torch.arange(lk, device=s.device)[None, :]
    mask = cols < lk
    if causal:
        mask = mask & (cols <= rows)
    s = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    return p / p.sum(dim=-1, keepdim=True), mask


def plain_attention_fwd(q, k, v, num_heads: int, causal: bool):
    """The math of ``_fwd_kernel`` in plain PyTorch: [B, Lq, E] out, in
    float32 on the inputs widened to it, rounded once to their dtype."""
    d = q.shape[-1] // num_heads
    q32, k32, v32 = (x.float() for x in (q, k, v))
    p, _ = _probs(_heads(q32, num_heads), _heads(k32, num_heads), causal,
                  _scale(d))
    return _packed(torch.matmul(p, _heads(v32, num_heads))).to(q.dtype)


def plain_attention_bwd(q, k, v, dout, num_heads: int, causal: bool):
    """The math of ``_bwd_kernel`` in plain PyTorch: (dq, dk, dv), in
    float32 on the inputs widened to it, each rounded once to their
    dtype."""
    d = q.shape[-1] // num_heads
    scale = _scale(d)
    qh, kh, vh = (_heads(x.float(), num_heads) for x in (q, k, v))
    doh = _heads(dout.float(), num_heads)
    p, mask = _probs(qh, kh, causal, scale)
    dv = torch.matmul(p.transpose(-1, -2), doh)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = torch.where(mask, ds, torch.zeros_like(ds)) * scale
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    return tuple(_packed(x).to(q.dtype) for x in (dq, dk, dv))


# ------------------------------------------------------------------- checks
def check_shapes(q, k, v, num_heads: int, causal: bool) -> Tuple[int, ...]:
    """Validates the packed shapes; returns (B, Lq, Lk, H, D)."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be [B, L, H*D]")
    b, lq, e = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != e:
        raise ValueError(
            f"k and v must be [B, Lk, E] matching q {tuple(q.shape)}; got "
            f"{tuple(k.shape)} and {tuple(v.shape)}"
        )
    if e % num_heads:
        raise ValueError(f"width {e} does not divide into {num_heads} heads")
    lk = k.shape[1]
    if causal and lq != lk:
        # The kernels' causal mask is top-left aligned (cols <= rows), the
        # plain XLA one bottom-right; they agree only when Lq == Lk.
        raise ValueError(f"causal attention needs Lq == Lk, got {lq}, {lk}")
    return b, lq, lk, num_heads, e // num_heads


def _check_cuda(tensors, b, lq, lk):
    device, dtype = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != device:
            raise ValueError("all attention tensors must share one device")
        if t.dtype not in DTYPES or t.dtype != dtype:
            raise TypeError(
                f"attention kernels take float32 or bfloat16 tensors of one "
                f"dtype, got {[x.dtype for x in tensors]}"
            )
        if not t.is_contiguous():
            raise ValueError("attention kernels take contiguous tensors")
    if min(b, lq, lk) < 1:
        raise ValueError("attention kernels need B, Lq, Lk >= 1")


class LaunchConfig(NamedTuple):
    """What the C entry point launches: the instance (``head_dim_pad``,
    ``keys_per_lane``; ``keys_per_lane`` ``MMA_FORM`` is the tensor-core
    form at head width ``head_dim_pad``), ``warps`` per block, query rows
    per block (the grid is B*H by ceil(Lq / rows_per_block)) and dynamic
    shared bytes."""

    head_dim_pad: int
    keys_per_lane: int
    warps: int
    rows_per_block: int
    smem_bytes: int


def _lanes_config(kind, lq, lk, dp, kpl):
    """The register (kpl 1, 2) and streamed (kpl 0) forms."""
    if kind == "attention_fwd":
        warps = min(FWD_WARPS, -(-lq // FWD_ROWS_PER_WARP))
        return LaunchConfig(dp, kpl, warps, warps * FWD_ROWS_PER_WARP, 0)
    # One block per (batch, head) owns its dK and dV: the warps' partials
    # ([2][warps][Lk][dp]) or each row's max, sum and rowsum(dP * P).
    warps = min(BWD_MAX_WARPS, -(-lq // BWD_ROWS_PER_WARP))
    smem = 4 * (2 * warps * lk * dp if kpl else 3 * lq)
    return LaunchConfig(dp, kpl, warps, lq, smem)


def _staged_config(kind, lq, lk, dp, kpl):
    """The staged form: the forward's shared memory holds the tile's query
    rows and the head's K and V rows; the backward's Q, dO, K and V rows
    and the [Lq, Lk] tiles of P and dS."""
    row = dp + STAGED_ROW_PAD
    if kind == "attention_fwd":
        rows = min(lq, STAGED_FWD_ROWS)
        return LaunchConfig(dp, kpl, min(STAGED_WARPS, rows), rows,
                            4 * row * (rows + 2 * lk))
    smem = 4 * (row * (2 * lq + 2 * lk) + 2 * lq * lk)
    return LaunchConfig(dp, kpl, STAGED_WARPS, lq, smem)


def _mma_config(kind, lq, lk, d):
    """The tensor-core form: bf16 head rows of d values padded to
    ``d`` (8) or ``d + 8`` (16) bf16, an odd multiple of 16 bytes; the
    forward's shared memory holds the tile's query rows and the head's K
    and V rows, the backward's Q, dO, K and V rows and the P and dS tiles
    as hi and lo bf16, [4][Lq][Lk + 8], each length padded to 16."""
    pitch = d if d == 8 else d + 8
    lk16 = -(-lk // 16) * 16
    if kind == "attention_fwd":
        rows = min(lq, MMA_MAX_ROWS)
        rows16 = -(-rows // 16) * 16
        return LaunchConfig(d, MMA_FORM, rows16 // MMA_WARP_ROWS, rows,
                            2 * pitch * (rows16 + 2 * lk16))
    lq16 = -(-lq // 16) * 16
    smem = 2 * (2 * pitch * (lq16 + lk16) + 4 * lq16 * (lk16 + 8))
    return LaunchConfig(d, MMA_FORM, max(lq16, lk16) // MMA_WARP_ROWS, lq,
                        smem)


def takes_mma(kind: str, lq: int, lk: int, d: int,
              dtype: torch.dtype) -> bool:
    """Whether the tensor-core form takes this call."""
    return (dtype == torch.bfloat16 and d in MMA_INSTANCES
            and lk <= MMA_MAX_KEYS
            and (kind == "attention_fwd" or lq <= MMA_MAX_ROWS))


@functools.lru_cache(maxsize=256)
def launch_config(kind: str, lq: int, lk: int, d: int,
                  dtype: torch.dtype = torch.float32,
                  streamed: bool = False, lanes: bool = False
                  ) -> LaunchConfig:
    """The launch of ``kind`` ("attention_fwd" or "attention_bwd") at
    Lq, Lk and head width d in ``dtype``; raises ValueError past the
    kernels' limits.  A bfloat16 call that ``takes_mma`` takes the
    tensor-core form.  Any other call picks the keys-on-lanes instance of
    its padded width with the fewest keys a lane that takes Lk, else the
    streamed form, which also takes the shapes whose staged backward
    outgrows a block's shared memory (Lq past ~330 at Lk = 64).  Asked for
    by the timing code only, at any shape: ``lanes`` the keys-on-lanes
    instance that the shape would pick without the tensor-core form, and
    ``streamed`` the streamed form."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} is not in [1, {MAX_HEAD_DIM}]")
    if kind not in KINDS:
        raise ValueError(f"unknown kernel {kind!r}")
    if dtype not in DTYPES:
        raise TypeError(f"no attention instance takes {dtype}")
    if not (streamed or lanes) and takes_mma(kind, lq, lk, d, dtype):
        return _mma_config(kind, lq, lk, d)
    dp = max(8, 1 << (d - 1).bit_length())
    kpl = 0 if streamed else min(
        (k for w, k in INSTANCES if w == dp and 32 * k >= lk), default=0)
    if kpl * dp > REGISTER_KEY_FLOATS:
        cfg = _staged_config(kind, lq, lk, dp, kpl)
        if cfg.smem_bytes > MAX_SMEM_BYTES:
            cfg = _lanes_config(kind, lq, lk, dp, 0)
    else:
        cfg = _lanes_config(kind, lq, lk, dp, kpl)
    if cfg.smem_bytes > MAX_SMEM_BYTES:
        raise ValueError(
            f"{kind} at Lq={lq}, Lk={lk}, D={d} needs {cfg.smem_bytes} "
            f"bytes of shared memory, more than the {MAX_SMEM_BYTES} a "
            f"block may use"
        )
    return cfg


# -------------------------------------------------------------------- build
def build(verbose: bool = False) -> ctypes.CDLL:
    """Compiles csrc/attention.cu for sm_90a once and loads it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = nvcc.build_library(_SOURCE, _BUILD_DIR, verbose)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dtqn_attention_fwd.argtypes = (
        [ptr] * 4 + [i32] * 7 + [f32] + [i32] * 5 + [ptr])
    lib.dtqn_attention_fwd.restype = i32
    lib.dtqn_attention_bwd.argtypes = (
        [ptr] * 7 + [i32] * 7 + [f32] + [i32] * 5 + [ptr])
    lib.dtqn_attention_bwd.restype = i32
    lib.dtqn_cuda_error_string.argtypes = [i32]
    lib.dtqn_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


# The element types as they appear in a mangled instance name.
_MANGLED_DTYPES = {"f": "float32", "13__nv_bfloat16": "bfloat16"}


def ptxas_usage(log: Optional[str] = None) -> List[dict]:
    """Registers and spill bytes of each kernel instance, from ``-Xptxas
    -v`` output: ``log``, or what ``build`` kept beside the library.  An
    instance is named ``attention_fwd_kernel<dtype,D,KPL>``, a tensor-core
    one ``attention_fwd_mma<D>``."""
    if log is None:
        if _lib is None:
            raise RuntimeError("build() the kernels first")
        log = Path(_lib._name).with_suffix(".log").read_text()
    kernel = re.compile(r"(attention_(?:fwd|bwd)_kernel)I(f|13__nv_bfloat16)"
                        r"Li(\d+)ELi(\d+)E")
    mma = re.compile(r"(attention_(?:fwd|bwd)_mma)ILi(\d+)EE")
    usage, current = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:entry function|properties for) '?(\w+)", line)
        if m:
            k, t = kernel.search(m.group(1)), mma.search(m.group(1))
            current = (f"{k.group(1)}<{_MANGLED_DTYPES[k.group(2)]},"
                       f"{k.group(3)},{k.group(4)}>" if k else
                       f"{t.group(1)}<{t.group(2)}>" if t else None)
            continue
        if current is None:
            continue
        entry = usage.setdefault(current, {"kernel": current})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            entry["spill_stores"], entry["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
    return sorted(usage.values(), key=lambda u: u["kernel"])


# ----------------------------------------------------------------- wrappers
def launch_fwd(q, k, v, num_heads: int, causal: bool,
               cfg: LaunchConfig) -> torch.Tensor:
    """Launches the forward instance ``cfg`` on CUDA tensors; counts
    nothing (``attention_fwd`` counts its launches)."""
    b, lq, lk, h, d = check_shapes(q, k, v, num_heads, causal)
    _check_cuda((q, k, v), b, lq, lk)
    lib = build()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.dtqn_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPES.index(q.dtype), b, lq, lk, h, d, int(causal), _scale(d), *cfg,
        stream,
    )
    nvcc.raise_on_error(lib, code, "attention_fwd")
    return out


def launch_bwd(q, k, v, dout, num_heads: int, causal: bool,
               cfg: LaunchConfig):
    """Launches the backward instance ``cfg`` on CUDA tensors: (dq, dk,
    dv); counts nothing (``attention_bwd`` counts its launches)."""
    b, lq, lk, h, d = check_shapes(q, k, v, num_heads, causal)
    _check_cuda((q, k, v, dout), b, lq, lk)
    lib = build()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.dtqn_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        DTYPES.index(q.dtype), b, lq, lk, h, d, int(causal), _scale(d), *cfg,
        stream,
    )
    nvcc.raise_on_error(lib, code, "attention_bwd")
    return dq, dk, dv


def attention_fwd(q, k, v, num_heads: int, causal: bool) -> torch.Tensor:
    """Forward on packed [B, L, H*D]: the kernel on CUDA, plain on CPU."""
    _, lq, lk, _, d = check_shapes(q, k, v, num_heads, causal)
    if q.device.type == "cpu":
        return plain_attention_fwd(q, k, v, num_heads, causal)
    out = launch_fwd(q, k, v, num_heads, causal,
                     launch_config("attention_fwd", lq, lk, d, q.dtype))
    launch_counts[count_name("attention_fwd", q.dtype)] += 1
    return out


def attention_bwd(q, k, v, dout, num_heads: int, causal: bool):
    """Recompute backward: (dq, dk, dv), the kernel on CUDA, plain on CPU."""
    _, lq, lk, _, d = check_shapes(q, k, v, num_heads, causal)
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} != q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return plain_attention_bwd(q, k, v, dout, num_heads, causal)
    grads = launch_bwd(q, k, v, dout, num_heads, causal,
                       launch_config("attention_bwd", lq, lk, d, q.dtype))
    launch_counts[count_name("attention_bwd", q.dtype)] += 1
    return grads


class AttentionFunction(torch.autograd.Function):
    """``pallas_attention_packed``'s custom_vjp: forward kernel, recompute
    backward kernel; num_heads and causal are not differentiated.

    Under ``torch.func.vmap`` (a stack of networks, one per seed) the
    ``vmap`` rule folds the mapped axis into B of the packed layout and
    makes one call: one launch at the folded batch, forward and backward."""

    @staticmethod
    def forward(q, k, v, num_heads: int, causal: bool):
        return attention_fwd(q, k, v, num_heads, causal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, num_heads, causal = inputs
        ctx.save_for_backward(q, k, v)
        ctx.num_heads, ctx.causal = num_heads, causal

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_bwd(
            q, k, v, dout.contiguous(), ctx.num_heads, ctx.causal
        )
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, num_heads: int, causal: bool):
        """[S, B, L, E] (the mapped axis moved first, an unmapped operand
        expanded) -> one call at [S*B, L, E] -> [S, B, Lq, E]."""
        folded = []
        for x, dim in zip((q, k, v), in_dims[:3]):
            x = (x.expand(info.batch_size, *x.shape) if dim is None
                 else x.movedim(dim, 0))
            folded.append(x.reshape(-1, *x.shape[2:]).contiguous())
        out = AttentionFunction.apply(*folded, num_heads, causal)
        return out.unflatten(0, (info.batch_size, -1)), 0


def cuda_attention_packed(q, k, v, num_heads: int, causal: bool = False):
    """Fused attention on packed [B, L, H*D] tensors, differentiable."""
    return AttentionFunction.apply(q, k, v, num_heads, causal)
