"""Weight initialization matching the reference (``dtqn_tpu/models/init.py``).

Every Linear/Embedding weight is N(0, 0.02), every bias zero, LayerNorm
(1, 0) (the reference's utils/torch_utils.py:4-15); the LSTM cells keep
flax's own families (LeCun-normal input kernels, orthogonal recurrent
kernels, zero biases).  Parameters are float32 only; the JAX package's
bf16 compute dtype is not ported.  Draws come from an explicit CPU
``torch.Generator``, so a seed gives the same weights whatever device the
module later moves to.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

WEIGHT_INIT_STD = 0.02
# The standard deviation of a unit normal truncated at +-2 (flax's
# variance_scaling divides by it).
TRUNCATED_NORMAL_STD = 0.87962566103423978


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


def lecun_normal_(tensor: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]):
    """In-place flax ``lecun_normal``: a normal truncated at two standard
    deviations, scaled so that the variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / TRUNCATED_NORMAL_STD
    lo, hi = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (-2, 2))
    u = torch.rand(tensor.shape, generator=generator) * (hi - lo) + lo
    x = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    with torch.no_grad():
        tensor.copy_(torch.clamp(x, -2.0, 2.0) * std)
    return tensor


def orthogonal_(tensor: torch.Tensor, generator: Optional[torch.Generator]):
    """In-place flax ``orthogonal`` for a square matrix: Q of the QR of a
    normal draw, its columns' signs set by R's diagonal."""
    n = tensor.shape[0]
    q, r = torch.linalg.qr(torch.randn((n, n), generator=generator))
    with torch.no_grad():
        tensor.copy_(q * torch.sign(torch.diagonal(r))[None, :])
    return tensor
