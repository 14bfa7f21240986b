"""Transformer blocks for DTQN (``dtqn_tpu/models/transformer.py``).

Post-LN ``TransformerLayer`` (transformer.py:63-78): causal MHA -> **ReLU on
the attention output** (a deliberate reference quirk) -> gate -> LayerNorm
-> 4x ReLU FFN -> ReLU -> gate -> LayerNorm.  ``identity=True`` is the GTrXL
identity-map order (pre-LN, no LayerNorm after the gates;
transformer.py:81-101).  LayerNorm eps is flax's 1e-6, not torch's 1e-5.
The attention core dispatches by device through
``dtqn_tpu_torch.ops.attention``; a train-mode forward with dropout takes
the attention probabilities in stock ops instead, drops them out, and never
reaches the kernels, as in the JAX package.

With a compute dtype (bfloat16) the projections, the attention and the FFN
run in it; the residual stream stays float32 (the position add promotes),
so the gates and the two LayerNorms compute in float32, as flax's do.
torch's LayerNorm would return bfloat16 for a bfloat16 input where flax's
returns float32: ``TransformerLayer`` refuses a residual stream that is
not float32 rather than cast it.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from dtqn_tpu_torch.models.dropout import DropoutDraws, apply_dropout
from dtqn_tpu_torch.models.gates import make_gate
from dtqn_tpu_torch.models.init import make_dense
from dtqn_tpu_torch.ops.attention import (
    apply_probs,
    attention_probs,
    dot_product_attention,
)

LAYERNORM_EPS = 1e-6  # flax nn.LayerNorm's default


class MultiHeadAttention(nn.Module):
    """Projections + attention core + output projection.

    Self-attention (the default) has one fused [F, 3F] ``qkv`` Linear that
    splits in q, k, v order (transformer.py:55-57).  ``cross=True`` builds
    the separate ``query`` / ``key`` / ``value`` projections of attention
    over another sequence (transformer.py:58-61): the bag.

    While ``maps`` is a list, each forward appends its head-averaged
    attention probabilities [B, Lq, Lk] to it (``attention_weights``).
    """

    def __init__(self, features: int, num_heads: int, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 cross: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if features % num_heads:
            raise ValueError("features must divide num_heads")
        self.num_heads = num_heads
        self.dropout = dropout
        self.maps: Optional[List[torch.Tensor]] = None
        self.cross = cross
        cd = compute_dtype
        if cross:
            self.query = make_dense(features, features, generator,
                                    compute_dtype=cd)
            self.key = make_dense(features, features, generator,
                                  compute_dtype=cd)
            self.value = make_dense(features, features, generator,
                                    compute_dtype=cd)
        else:
            self.qkv = make_dense(features, 3 * features, generator,
                                  compute_dtype=cd)
        self.out = make_dense(features, features, generator,
                              compute_dtype=cd)

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None, *,
                causal: bool = False,
                kv_mask: Optional[torch.Tensor] = None,
                draws: Optional[DropoutDraws] = None):
        """``x`` [B, Lq, F] queries; ``kv`` [B, Lk, F] the keys' and values'
        source (cross-attention only); ``kv_mask`` [B, Lk] bool hides
        key/value positions (False = masked); ``draws`` makes it a
        train-mode forward."""
        if self.cross != (kv is not None):
            raise ValueError(
                "cross-attention takes kv and self-attention does not"
            )
        if self.cross:
            q, k, v = self.query(x), self.key(kv), self.value(kv)
        else:
            q, k, v = (t.contiguous() for t in self.qkv(x).chunk(3, dim=-1))
        if draws is not None and self.dropout > 0.0:
            # Dropout acts on the softmax probabilities (the reference's
            # nn.MultiheadAttention, transformer.py:30-36), which only this
            # stock-op path materializes.
            probs = attention_probs(q, k, num_heads=self.num_heads,
                                    causal=causal, kv_mask=kv_mask)
            out = apply_probs(draws(probs, self.dropout), v)
        else:
            out = dot_product_attention(
                q, k, v, num_heads=self.num_heads, causal=causal,
                kv_mask=kv_mask,
            )
        if self.maps is not None:
            self.maps.append(attention_probs(
                q, k, num_heads=self.num_heads, causal=causal,
                kv_mask=kv_mask,
            ).mean(dim=1))
        return self.out(out)


class FeedForward(nn.Module):
    """4x-wide ReLU MLP (transformer.py:37-42)."""

    def __init__(self, features: int, widening: int = 4,
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout = dropout
        self.dense_0 = make_dense(features, widening * features, generator,
                                  compute_dtype=compute_dtype)
        self.dense_1 = make_dense(widening * features, features, generator,
                                  compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor,
                draws: Optional[DropoutDraws] = None) -> torch.Tensor:
        return apply_dropout(self.dense_1(torch.relu(self.dense_0(x))),
                             self.dropout, draws)


class TransformerLayer(nn.Module):
    def __init__(self, features: int, num_heads: int, dropout: float = 0.0,
                 gate: str = "res", identity: bool = False,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.identity = identity
        self.attention = MultiHeadAttention(
            features, num_heads, dropout, generator,
            compute_dtype=compute_dtype,
        )
        self.ffn = FeedForward(features, dropout=dropout, generator=generator,
                               compute_dtype=compute_dtype)
        self.attn_gate = make_gate(gate, features, generator)
        self.mlp_gate = make_gate(gate, features, generator)
        self.layernorm1 = nn.LayerNorm(features, eps=LAYERNORM_EPS)
        self.layernorm2 = nn.LayerNorm(features, eps=LAYERNORM_EPS)

    def forward(self, x: torch.Tensor,
                draws: Optional[DropoutDraws] = None) -> torch.Tensor:
        if x.dtype != torch.float32:
            # Every LayerNorm input is this stream plus a gate's output,
            # float32 by promotion; flax's LayerNorm computes it in float32.
            raise TypeError(f"the residual stream must be float32, got "
                            f"{x.dtype}")
        if self.identity:
            att = self.attention(self.layernorm1(x), causal=True, draws=draws)
            x = self.attn_gate(x, torch.relu(att))
            y = self.ffn(self.layernorm2(x), draws)
            return self.mlp_gate(x, torch.relu(y))
        att = self.attention(x, causal=True, draws=draws)
        x = self.layernorm1(self.attn_gate(x, torch.relu(att)))
        y = self.ffn(x, draws)
        return self.layernorm2(self.mlp_gate(x, torch.relu(y)))
