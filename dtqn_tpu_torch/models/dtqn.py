"""DTQN: GPT-style causal transformer Q-network (``dtqn_tpu/models/dtqn.py``).

The obs embedding gets ``inner_embed - action_dim`` features; with
``action_dim > 0`` the previous-action embedding is right-shifted one step
(first step zeroed) and concatenated in front (dtqn.py:63-64,184-192).
Then the position encoding, input dropout, N transformer layers and a ReLU
MLP head; Q is [B, L, num_actions] for every timestep.  Dropout acts only
in a train-mode forward, one given ``DropoutDraws``.

With ``bag_size > 0`` (DTQN-bag) the working memory cross-attends over the
embedded persistent-memory bag (query = context, keys and values = bag) and
the result is concatenated to it in front of a head whose first layer takes
``2 * inner_embed`` inputs (dtqn.py:134-153,201-214).

Under a bfloat16 ``compute_dtype`` the embeddings, the projections, the
attention, the FFNs and the head compute in bf16 and Q is bf16; the
position add (float32 positions) makes the residual stream float32, and
the bag's concat promotes its bf16 half to float32, as jnp's promotion
does in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from dtqn_tpu_torch.envs.core import ObsKind
from dtqn_tpu_torch.models.dropout import DropoutDraws, apply_dropout
from dtqn_tpu_torch.models.embeddings import (
    ActionEmbedding,
    make_obs_embedding,
)
from dtqn_tpu_torch.models.init import make_dense
from dtqn_tpu_torch.models.positions import PositionEncoding
from dtqn_tpu_torch.models.transformer import (
    MultiHeadAttention,
    TransformerLayer,
)


class DTQN(nn.Module):
    def __init__(
        self,
        *,
        obs_kind: ObsKind,
        obs_shape: Tuple[int, ...],
        num_actions: int,
        vocab_size: int = 0,
        embed_per_obs_dim: int = 8,
        action_dim: int = 0,
        inner_embed: int = 128,
        num_heads: int = 8,
        num_layers: int = 2,
        context_len: int = 50,
        dropout: float = 0.0,
        gate: str = "res",
        identity: bool = False,
        pos: str = "learned",
        bag_size: int = 0,
        bag_mask: bool = False,
        obs_mask_value: float = 0.0,
        generator: Optional[torch.Generator] = None,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        """``bag_mask`` (an ablation) hides mask-padded bag slots from the
        cross-attention instead of attending over them as the reference
        does (dtqn.py:201-213).  ``obs_mask_value`` is the env's padding
        sentinel, by which empty slots are told; that is sound only when
        the sentinel lies outside the observable range, which
        ``build_network`` enforces (discrete-observation envs only)."""
        super().__init__()
        self.dropout = dropout
        self.context_len = context_len
        self.action_dim = action_dim
        self.bag_size = bag_size
        self.bag_mask = bag_mask
        self.obs_mask_value = obs_mask_value
        self.obs_embedding = make_obs_embedding(
            features=inner_embed - action_dim,
            obs_kind=obs_kind,
            obs_shape=obs_shape,
            vocab_size=vocab_size,
            embed_per_obs_dim=embed_per_obs_dim,
            generator=generator,
            compute_dtype=compute_dtype,
        )
        self.action_embed = (
            ActionEmbedding(num_actions, action_dim, generator, compute_dtype)
            if action_dim > 0
            else None
        )
        self.position = PositionEncoding(pos, context_len, inner_embed)
        self.layers = nn.ModuleList(
            TransformerLayer(inner_embed, num_heads, dropout, gate, identity,
                             generator, compute_dtype)
            for _ in range(num_layers)
        )
        self.bag_attention = (
            MultiHeadAttention(inner_embed, num_heads, dropout, generator,
                               cross=True, compute_dtype=compute_dtype)
            if bag_size > 0
            else None
        )
        head_in = 2 * inner_embed if bag_size > 0 else inner_embed
        self.head_hidden = make_dense(head_in, inner_embed, generator,
                                      compute_dtype=compute_dtype)
        self.head_out = make_dense(inner_embed, num_actions, generator,
                                   compute_dtype=compute_dtype)

    def forward(
        self,
        obss: torch.Tensor,
        actions: Optional[torch.Tensor] = None,
        bag_obss: Optional[torch.Tensor] = None,
        bag_actions: Optional[torch.Tensor] = None,
        *,
        draws: Optional[DropoutDraws] = None,
    ) -> torch.Tensor:
        """obss: [B, L, *obs_shape]; actions: [B, L] int; bag_*: [B, bag,
        ...] -> Q [B, L, A].  ``draws`` makes it a train-mode forward
        (flax's ``deterministic=False``)."""
        seq_len = obss.shape[1]
        if seq_len > self.context_len:
            raise ValueError(
                f"history {seq_len} longer than context {self.context_len}"
            )
        tokens = self.obs_embedding(obss)
        if self.action_embed is not None:
            if actions is None:
                raise ValueError("action_dim > 0 requires actions")
            act_tok = self.action_embed(actions)
            if seq_len > 1:
                # Right-shift: token t sees action t-1; the first step has
                # no previous action (dtqn.py:188-192).
                act_tok = torch.cat(
                    [torch.zeros_like(act_tok[:, :1]), act_tok[:, :-1]],
                    dim=1,
                )
            tokens = torch.cat([act_tok, tokens], dim=-1)
        x = apply_dropout(tokens + self.position()[:, :seq_len],
                          self.dropout, draws)
        for layer in self.layers:
            x = layer(x, draws)
        if self.bag_attention is not None:
            x = torch.cat(
                [x, self._persistent(x, bag_obss, bag_actions, draws)],
                dim=-1)
        return self.head_out(torch.relu(self.head_hidden(x)))

    def dropout_shapes(self, batch: int, seq_len: int):
        """The shape of each dropout mask of a train-mode forward at [batch,
        seq_len], in the order the sites draw them (``DropoutDraws``): the
        input; per layer the attention probabilities and the FFN output;
        the bag attention's probabilities."""
        features = self.head_hidden.out_features
        tokens = (batch, seq_len, features)
        shapes = [tokens]
        for layer in self.layers:
            heads = layer.attention.num_heads
            shapes += [(batch, heads, seq_len, seq_len), tokens]
        if self.bag_attention is not None:
            shapes.append((batch, self.bag_attention.num_heads, seq_len,
                           self.bag_size))
        return shapes

    def _persistent(self, x, bag_obss, bag_actions, draws) -> torch.Tensor:
        """Cross-attention of the working memory ``x`` over the (possibly
        padded) bag."""
        if bag_obss is None:
            raise ValueError("bag_size > 0 requires bag_obss")
        # The bag goes through the same obs and action embedders as the
        # context (dtqn.py:201-209); its actions are not right-shifted.
        bag_tokens = self.obs_embedding(bag_obss)
        if self.action_embed is not None:
            bag_tokens = torch.cat(
                [self.action_embed(bag_actions), bag_tokens], dim=-1
            )
        if not self.bag_mask:
            # The reference always attends over the full bag, padding
            # included (dtqn.py:201-213).
            return self.bag_attention(x, bag_tokens, draws=draws)
        # A slot is empty when every obs element equals the padding
        # sentinel; the persistent features are zero where no slot is valid.
        slot_dims = tuple(range(2, bag_obss.dim()))
        kv_mask = ~torch.all(bag_obss == self.obs_mask_value, dim=slot_dims)
        persistent = self.bag_attention(x, bag_tokens, kv_mask=kv_mask,
                                        draws=draws)
        any_valid = torch.any(kv_mask, dim=-1)
        return torch.where(any_valid[:, None, None], persistent, 0.0)
