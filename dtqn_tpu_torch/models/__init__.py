"""Q-network registry (``dtqn_tpu/models/__init__.py``): model string ->
network, as the reference's MODEL_MAP (utils/agent_utils.py:17-24)."""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

import torch
from torch import nn

from dtqn_tpu_torch.envs.core import Environment
from dtqn_tpu_torch.models.dtqn import DTQN
from dtqn_tpu_torch.models.recurrent import (
    ADRQN,
    DARQN,
    DQN,
    DRQN,
    LSTMCarry,
    zero_carry,
)
from dtqn_tpu_torch.models.transformer import MultiHeadAttention

MODEL_MAP = {
    "DTQN": DTQN,
    "DTQN-bag": DTQN,
    "ADRQN": ADRQN,
    "DRQN": DRQN,
    "DARQN": DARQN,
    "DQN": DQN,
}

RECURRENT_MODELS = ("DRQN", "ADRQN", "DARQN")


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
    bag_mask: bool = False,
    generator: Optional[torch.Generator] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> nn.Module:
    """Builds the network on the CPU; the caller moves it to its device.
    The transformer's options (heads, layers, gate, ...) reach DTQN only,
    as in the JAX package.  ``compute_dtype`` (None: float32, or
    ``torch.bfloat16``) is the JAX package's ``set_compute_dtype``: the
    parameters stay float32 and the layers flax builds with
    ``dtype=compute_dtype()`` compute in it."""
    if model_str not in MODEL_MAP:
        raise KeyError(
            f"Unknown model {model_str!r}; choices: {sorted(MODEL_MAP)}"
        )
    common = dict(
        obs_kind=env.obs_kind,
        obs_shape=tuple(env.obs_shape),
        num_actions=env.num_actions,
        vocab_size=env.obs_vocab_size if env.is_discrete else 0,
        embed_per_obs_dim=embed_per_obs_dim,
        inner_embed=inner_embed,
        generator=generator,
        compute_dtype=compute_dtype,
    )
    if model_str == "DQN":
        return DQN(**common)
    if model_str == "ADRQN":
        # ADRQN conditions on the previous action; ensure it has features.
        return ADRQN(action_dim=action_dim or 8, **common)
    if model_str in ("DRQN", "DARQN"):
        return MODEL_MAP[model_str](action_dim=0, **common)
    if bag_mask and not env.is_discrete:
        # Padded-slot detection compares every obs element against the
        # sentinel; that is only sound when the sentinel cannot occur as a
        # real observation.  Discrete/MultiDiscrete envs guarantee it
        # (sentinel = vocab, outside the token range); a continuous env
        # whose observation equals the sentinel in every element would be
        # silently masked.
        raise ValueError(
            "--bag-mask requires a discrete-observation env: the padding "
            f"sentinel {float(env.obs_mask)} is inside a continuous "
            "observation space's range"
        )
    return DTQN(
        action_dim=action_dim,
        num_heads=num_heads,
        num_layers=num_layers,
        context_len=context_len,
        dropout=dropout,
        gate=gate,
        identity=identity,
        pos=pos,
        bag_size=bag_size,
        bag_mask=bag_mask,
        obs_mask_value=float(env.obs_mask),
        **common,
    )


def _flax_path(name: str) -> str:
    """A module's flax path: ``layers.0.attention`` -> ``layer_0/attention``."""
    return re.sub(r"layers\.(\d+)", r"layer_\1", name).replace(".", "/")


def attention_weights(
    network: nn.Module, *args, **kwargs
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Per-layer head-averaged attention maps for visualization
    (``dtqn_tpu/models/__init__.py:95-114``, the reference's ``layer.alpha``):
    (Q of the ordinary forward, [maps]), each map [B, Lq, Lk], sorted by
    module path as flax's intermediates are: DTQN-bag's ``bag_attention``
    first, then ``layer_0`` ... ``layer_{n-1}``.  The maps are the stock-op
    probabilities on either device: the kernels keep none."""
    modules = sorted(
        ((_flax_path(name), m) for name, m in network.named_modules()
         if isinstance(m, MultiHeadAttention)),
        key=lambda pm: pm[0],
    )
    for _, m in modules:
        m.maps = []
    try:
        q = network(*args, **kwargs)
        maps = [mp for _, m in modules for mp in m.maps]
    finally:
        for _, m in modules:
            m.maps = None
    return q, maps


__all__ = [
    "MODEL_MAP", "RECURRENT_MODELS", "attention_weights", "build_network",
    "DTQN", "DQN", "DRQN", "ADRQN", "DARQN", "LSTMCarry", "zero_carry",
]
