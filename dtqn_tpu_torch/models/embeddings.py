"""Observation / action embedders (``dtqn_tpu/models/embeddings.py``).

Ported: the discrete-obs token Embedding -> flatten -> Linear
(representations.py:26-52), the continuous-obs Linear
(representations.py:64-75) and the action Embedding
(representations.py:146-155).  The image embedder is not ported yet
(ROADMAP.md queue 1 item 12b).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dtqn_tpu_torch.envs.core import ObsKind
from dtqn_tpu_torch.models.init import make_dense, normal_


class _Lookup(torch.autograd.Function):
    """``table[tokens]`` with a table gradient that repeats bit for bit.

    The stock embedding backward on a CUDA device sums the rows of equal
    tokens with atomic adds, in an order that changes from launch to launch,
    so two runs from the same state drift apart in the last bits and a
    resumed run no longer equals the uninterrupted one.  Here the gradient
    is one matrix product, ``one_hot(tokens)^T @ grad``, whose order of
    summation is fixed; the one-hot matrix exists only in the backward.
    """

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.rows = table.shape[0]
        return F.embedding(tokens, table)

    @staticmethod
    def backward(ctx, grad):
        (tokens,) = ctx.saved_tensors
        hot = F.one_hot(tokens.reshape(-1).to(torch.int64), ctx.rows)
        return hot.to(grad.dtype).t() @ grad.reshape(-1, grad.shape[-1]), None


def lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` [V, F] at int ``tokens`` [...] -> [..., F]."""
    return _Lookup.apply(table, tokens)


class DiscreteObsEmbedding(nn.Module):
    """Per-dimension token embedding for (Multi)Discrete observations."""

    def __init__(self, vocab_size: int, obs_dim: int, embed_per_obs_dim: int,
                 features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = nn.Embedding(vocab_size, embed_per_obs_dim)
        normal_(self.embedding.weight, generator)
        self.dense_0 = make_dense(obs_dim * embed_per_obs_dim, features,
                                  generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        # obs: [..., obs_dim] int32 tokens (mask token == vocab_size - 1),
        # looked up as they are: no widening copy per call.
        tok = lookup(self.embedding.weight, obs)
        return self.dense_0(tok.flatten(-2))


class ContinuousObsEmbedding(nn.Module):
    """Linear projection for Box observations."""

    def __init__(self, obs_dim: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense_0 = make_dense(obs_dim, features, generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.dense_0(obs.to(torch.float32))


class ActionEmbedding(nn.Module):
    """Embed(num_actions, action_dim): [...] int -> [..., action_dim],
    looked up through ``lookup`` so that its table gradient repeats bit for
    bit (ADRQN trains it on every step)."""

    def __init__(self, num_actions: int, action_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = nn.Embedding(num_actions, action_dim)
        normal_(self.embedding.weight, generator)

    def forward(self, actions: torch.Tensor) -> torch.Tensor:
        return lookup(self.embedding.weight, actions)


def make_obs_embedding(
    *,
    features: int,
    obs_kind: ObsKind,
    obs_shape: Sequence[int],
    vocab_size: int = 0,
    embed_per_obs_dim: int = 8,
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    """The obs embedder for the env's observation kind (dtqn.py:71-94)."""
    if obs_kind == ObsKind.IMAGE:
        raise NotImplementedError(
            "IMAGE observation embedding is not ported yet; see ROADMAP.md "
            "queue 1 item 12b"
        )
    if obs_kind == ObsKind.DISCRETE:
        return DiscreteObsEmbedding(
            vocab_size, int(obs_shape[0]), embed_per_obs_dim, features,
            generator,
        )
    return ContinuousObsEmbedding(int(obs_shape[0]), features, generator)
