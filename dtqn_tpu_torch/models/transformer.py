"""Transformer blocks for DTQN (``dtqn_tpu/models/transformer.py``).

Post-LN ``TransformerLayer`` (transformer.py:63-78): causal MHA -> **ReLU on
the attention output** (a deliberate reference quirk) -> gate -> LayerNorm
-> 4x ReLU FFN -> ReLU -> gate -> LayerNorm.  LayerNorm eps is flax's 1e-6,
not torch's 1e-5.  The attention core dispatches by device through
``dtqn_tpu_torch.ops.attention``.  Dropout and the identity (pre-LN) layer
are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dtqn_tpu_torch.models.gates import make_gate
from dtqn_tpu_torch.models.init import make_dense
from dtqn_tpu_torch.ops.attention import dot_product_attention

LAYERNORM_EPS = 1e-6  # flax nn.LayerNorm's default


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet; see ROADMAP.md queue 1 item 12b"
    )


class MultiHeadAttention(nn.Module):
    """Projections + attention core + output projection.

    Self-attention (the default) has one fused [F, 3F] ``qkv`` Linear that
    splits in q, k, v order (transformer.py:55-57).  ``cross=True`` builds
    the separate ``query`` / ``key`` / ``value`` projections of attention
    over another sequence (transformer.py:58-61): the bag.
    """

    def __init__(self, features: int, num_heads: int, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 cross: bool = False):
        super().__init__()
        if features % num_heads:
            raise ValueError("features must divide num_heads")
        if dropout > 0.0:
            raise _not_ported("attention dropout")
        self.num_heads = num_heads
        self.cross = cross
        if cross:
            self.query = make_dense(features, features, generator)
            self.key = make_dense(features, features, generator)
            self.value = make_dense(features, features, generator)
        else:
            self.qkv = make_dense(features, 3 * features, generator)
        self.out = make_dense(features, features, generator)

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None, *,
                causal: bool = False,
                kv_mask: Optional[torch.Tensor] = None):
        """``x`` [B, Lq, F] queries; ``kv`` [B, Lk, F] the keys' and values'
        source (cross-attention only); ``kv_mask`` [B, Lk] bool hides
        key/value positions (False = masked)."""
        if self.cross != (kv is not None):
            raise ValueError(
                "cross-attention takes kv and self-attention does not"
            )
        if self.cross:
            q, k, v = self.query(x), self.key(kv), self.value(kv)
        else:
            q, k, v = (t.contiguous() for t in self.qkv(x).chunk(3, dim=-1))
        out = dot_product_attention(
            q, k, v, num_heads=self.num_heads, causal=causal, kv_mask=kv_mask
        )
        return self.out(out)


class FeedForward(nn.Module):
    """4x-wide ReLU MLP (transformer.py:37-42)."""

    def __init__(self, features: int, widening: int = 4,
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dropout > 0.0:
            raise _not_ported("FFN dropout")
        self.dense_0 = make_dense(features, widening * features, generator)
        self.dense_1 = make_dense(widening * features, features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense_1(torch.relu(self.dense_0(x)))


class TransformerLayer(nn.Module):
    def __init__(self, features: int, num_heads: int, dropout: float = 0.0,
                 gate: str = "res", identity: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if identity:
            raise _not_ported("the identity (pre-LN) layer")
        self.attention = MultiHeadAttention(
            features, num_heads, dropout, generator
        )
        self.ffn = FeedForward(features, dropout=dropout, generator=generator)
        self.attn_gate = make_gate(gate, features)
        self.mlp_gate = make_gate(gate, features)
        self.layernorm1 = nn.LayerNorm(features, eps=LAYERNORM_EPS)
        self.layernorm2 = nn.LayerNorm(features, eps=LAYERNORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        att = self.attention(x, causal=True)
        x = self.layernorm1(self.attn_gate(x, torch.relu(att)))
        y = self.ffn(x)
        return self.layernorm2(self.mlp_gate(x, torch.relu(y)))
