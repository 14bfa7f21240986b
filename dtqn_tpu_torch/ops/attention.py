"""Attention primitives on the packed [B, L, H*D] layout.

Counterpart of ``dtqn_tpu/ops/attention.py``.  There is no global backend
selector: ``dot_product_attention`` dispatches on the tensor's device.  A
CUDA tensor goes through the hand-written kernels of ``ops/cuda_attention``
(forward and recompute backward); a CPU tensor goes through the same
``torch.autograd.Function`` with the kernels' plain PyTorch versions.

A call with ``kv_mask`` (the masked-bag ablation) is a different function:
in the JAX package it never reaches the Pallas kernels
(``dtqn_tpu/ops/attention.py:119-123``), which take no key mask, and here it
is ``plain_attention_packed``'s masked softmax in stock torch ops on either
device.

``plain_attention_packed`` is the plain reference of the JAX package's XLA
path (``_xla_attention``): scores masked with ``finfo.min`` under a
bottom-right-aligned causal mask and the key mask, differentiated by
autograd.  Its scores, mask and softmax are in the inputs' dtype, as
``_xla_attention``'s are: under a bfloat16 compute dtype every step is
rounded to bf16 (the kernels, and their plain versions, compute in float32
inside, as the Pallas kernels do).  The JAX package's default ``--attention
xla`` computes even its unmasked attention that way; the port follows the
Pallas semantics there on both devices.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from dtqn_tpu_torch.ops.cuda_attention import cuda_attention_packed


@functools.lru_cache(maxsize=None)
def _scale(d: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """1 / sqrt(d) as a 0-dim tensor of ``dtype`` on ``device``, each step
    rounded to ``dtype``; made once per (d, dtype, device), so that a
    forward makes no tensor from Python data."""
    return (1.0 / torch.sqrt(torch.tensor(d, dtype=dtype))).to(device)


def attention_probs(
    q: torch.Tensor,
    k: torch.Tensor,
    *,
    num_heads: int,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Softmax attention probabilities [B, H, Lq, Lk] of packed q [B, Lq, E]
    and k [B, Lk, E], in stock ops on either device
    (``dtqn_tpu/ops/attention.py:66-95``): the kernels keep no
    probabilities.  The train-mode forward with dropout and
    ``attention_weights`` read them."""
    b, lq, e = q.shape
    lk = k.shape[1]
    d = e // num_heads
    qh = q.reshape(b, lq, num_heads, d)
    kh = k.reshape(b, lk, num_heads, d)
    scale = _scale(d, q.dtype, q.device)
    scores = torch.einsum("blhd,bmhd->bhlm", qh, kh) * scale
    if causal:
        mask = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril(
            lk - lq
        )
        scores = torch.where(
            mask, scores, torch.finfo(scores.dtype).min
        )
    if kv_mask is not None:
        scores = torch.where(
            kv_mask[:, None, None, :], scores, torch.finfo(scores.dtype).min
        )
    return _softmax(scores)


def _softmax(scores: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis.  In float32 ``torch.softmax``
    agrees with it within rounding; in a narrower dtype jnp rounds after
    each of its steps (shift by the max, exp, sum, divide), where
    ``torch.softmax`` rounds once, so its steps are taken one by one."""
    if scores.dtype == torch.float32:
        return torch.softmax(scores, dim=-1)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True).detach())
    return e / e.sum(dim=-1, keepdim=True)


def apply_probs(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Probabilities [B, H, Lq, Lk] over packed values [B, Lk, E] ->
    [B, Lq, E]."""
    b, h, lq, lk = probs.shape
    e = v.shape[-1]
    vh = v.reshape(b, lk, h, e // h)
    return torch.einsum("bhlm,bmhd->blhd", probs, vh).reshape(b, lq, e)


def plain_attention_packed(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``_xla_attention`` in plain PyTorch: q [B, Lq, E], k/v [B, Lk, E];
    ``kv_mask`` [B, Lk] bool hides key/value positions (False = masked)."""
    probs = attention_probs(q, k, num_heads=num_heads, causal=causal,
                            kv_mask=kv_mask)
    return apply_probs(probs, v)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    num_heads: int,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head attention core, packed layout: [B, Lq, E] out.

    Without ``kv_mask``, CUDA tensors launch the attention kernels (or the
    call raises) and CPU tensors run the kernels' plain versions.  With
    ``kv_mask`` ([B, Lk] bool, False hides a key) the masked softmax runs in
    stock torch ops on either device and launches no kernel.
    """
    if kv_mask is not None:
        return plain_attention_packed(q, k, v, num_heads, causal, kv_mask)
    return cuda_attention_packed(q, k, v, num_heads, causal)
