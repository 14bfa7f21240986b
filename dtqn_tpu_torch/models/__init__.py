"""Q-network registry (``dtqn_tpu/models/__init__.py``): DTQN only so far."""

from __future__ import annotations

from typing import Optional

import torch

from dtqn_tpu_torch.envs.core import Environment
from dtqn_tpu_torch.models.dtqn import DTQN

MODEL_MAP = {"DTQN": DTQN}
NOT_PORTED = ("DTQN-bag", "ADRQN", "DRQN", "DARQN", "DQN")


def build_network(
    model_str: str,
    env: Environment,
    *,
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
) -> DTQN:
    """Builds the network on the CPU; the caller moves it to its device."""
    if model_str in NOT_PORTED:
        item = 10 if model_str == "DTQN-bag" else 12
        raise NotImplementedError(
            f"model {model_str!r} is not ported yet; see ROADMAP.md queue 1 "
            f"item {item}"
        )
    if model_str not in MODEL_MAP:
        raise KeyError(
            f"Unknown model {model_str!r}; choices: "
            f"{sorted((*MODEL_MAP, *NOT_PORTED))}"
        )
    return DTQN(
        obs_kind=env.obs_kind,
        obs_shape=tuple(env.obs_shape),
        num_actions=env.num_actions,
        vocab_size=env.obs_vocab_size if env.is_discrete else 0,
        embed_per_obs_dim=embed_per_obs_dim,
        action_dim=action_dim,
        inner_embed=inner_embed,
        num_heads=num_heads,
        num_layers=num_layers,
        context_len=context_len,
        dropout=dropout,
        gate=gate,
        identity=identity,
        pos=pos,
        bag_size=bag_size,
        generator=generator,
    )


__all__ = ["MODEL_MAP", "DTQN", "build_network"]
