"""Weight initialization matching the reference (``dtqn_tpu/models/init.py``).

Every Linear/Embedding weight is N(0, 0.02), every bias zero, LayerNorm
(1, 0) (the reference's utils/torch_utils.py:4-15).  Parameters are
float32 only; the JAX package's bf16 compute dtype is not ported.  Draws
come from an explicit CPU ``torch.Generator``, so a seed gives the same
weights whatever device the module later moves to.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

WEIGHT_INIT_STD = 0.02


def normal_(tensor: torch.Tensor, generator: Optional[torch.Generator]):
    """In-place N(0, 0.02) draw from ``generator`` (CPU)."""
    with torch.no_grad():
        tensor.copy_(
            torch.randn(tensor.shape, generator=generator) * WEIGHT_INIT_STD
        )
    return tensor


def make_dense(
    in_features: int,
    out_features: int,
    generator: Optional[torch.Generator] = None,
    bias: bool = True,
) -> nn.Linear:
    """Linear layer with the reference's N(0, 0.02) / zeros init."""
    layer = nn.Linear(in_features, out_features, bias=bias)
    normal_(layer.weight, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer
