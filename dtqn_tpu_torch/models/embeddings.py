"""Observation / action embedders (``dtqn_tpu/models/embeddings.py``).

Ported: the continuous-obs Linear (representations.py:64-75) and the action
Embedding (representations.py:146-155).  Discrete-token and image
embedders are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from dtqn_tpu_torch.envs.core import ObsKind
from dtqn_tpu_torch.models.init import make_dense, normal_


class ContinuousObsEmbedding(nn.Module):
    """Linear projection for Box observations."""

    def __init__(self, obs_dim: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense_0 = make_dense(obs_dim, features, generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.dense_0(obs.to(torch.float32))


class ActionEmbedding(nn.Module):
    """Embed(num_actions, action_dim): [...] int -> [..., action_dim]."""

    def __init__(self, num_actions: int, action_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = nn.Embedding(num_actions, action_dim)
        normal_(self.embedding.weight, generator)

    def forward(self, actions: torch.Tensor) -> torch.Tensor:
        return self.embedding(actions.to(torch.int64))


def make_obs_embedding(
    *,
    features: int,
    obs_kind: ObsKind,
    obs_shape: Sequence[int],
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    if obs_kind != ObsKind.CONTINUOUS:
        raise NotImplementedError(
            f"{obs_kind.name} observation embedding is not ported yet; see "
            "ROADMAP.md queue 1"
        )
    return ContinuousObsEmbedding(int(obs_shape[0]), features, generator)
