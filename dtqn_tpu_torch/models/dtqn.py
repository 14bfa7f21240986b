"""DTQN: GPT-style causal transformer Q-network (``dtqn_tpu/models/dtqn.py``).

The obs embedding gets ``inner_embed - action_dim`` features; with
``action_dim > 0`` the previous-action embedding is right-shifted one step
(first step zeroed) and concatenated in front (dtqn.py:63-64,184-192).
Then learned positions, N post-LN transformer layers and a ReLU MLP head;
Q is [B, L, num_actions] for every timestep.  The persistent-memory bag is
not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from dtqn_tpu_torch.envs.core import ObsKind
from dtqn_tpu_torch.models.embeddings import (
    ActionEmbedding,
    make_obs_embedding,
)
from dtqn_tpu_torch.models.init import make_dense
from dtqn_tpu_torch.models.positions import PositionEncoding
from dtqn_tpu_torch.models.transformer import TransformerLayer


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
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if bag_size > 0:
            raise NotImplementedError(
                "DTQN-bag is not ported yet; see ROADMAP.md queue 1 item 10"
            )
        if dropout > 0.0:
            raise NotImplementedError(
                "dropout > 0 is not ported yet; see ROADMAP.md queue 1 item 12"
            )
        self.context_len = context_len
        self.action_dim = action_dim
        self.obs_embedding = make_obs_embedding(
            features=inner_embed - action_dim,
            obs_kind=obs_kind,
            obs_shape=obs_shape,
            vocab_size=vocab_size,
            embed_per_obs_dim=embed_per_obs_dim,
            generator=generator,
        )
        self.action_embed = (
            ActionEmbedding(num_actions, action_dim, generator)
            if action_dim > 0
            else None
        )
        self.position = PositionEncoding(pos, context_len, inner_embed)
        self.layers = nn.ModuleList(
            TransformerLayer(inner_embed, num_heads, dropout, gate, identity,
                             generator)
            for _ in range(num_layers)
        )
        self.head_hidden = make_dense(inner_embed, inner_embed, generator)
        self.head_out = make_dense(inner_embed, num_actions, generator)

    def forward(
        self, obss: torch.Tensor, actions: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """obss: [B, L, *obs_shape]; actions: [B, L] int -> Q [B, L, A]."""
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
        x = tokens + self.position()[:, :seq_len]
        for layer in self.layers:
            x = layer(x)
        return self.head_out(torch.relu(self.head_hidden(x)))
