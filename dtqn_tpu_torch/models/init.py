"""Weight initialization matching the reference (``dtqn_tpu/models/init.py``).

Every Linear/Embedding weight is N(0, 0.02), every bias zero, LayerNorm
(1, 0) (the reference's utils/torch_utils.py:4-15); the LSTM cells keep
flax's own families (LeCun-normal input kernels, orthogonal recurrent
kernels, zero biases).  Parameters are float32 only.  Draws come from an
explicit CPU ``torch.Generator``, so a seed gives the same weights whatever
device the module later moves to.

The compute dtype (the JAX package's ``set_compute_dtype``) is not a global
here: ``build_network(..., compute_dtype=torch.bfloat16)`` hands it to the
layers that flax builds with ``dtype=compute_dtype()`` (``make_dense``'s
``Dense``, the embedding tables, the CNN's convolutions), and every other
operation takes its dtype from torch's type promotion, which for these
operations is jnp's (float32 + bfloat16 -> float32).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
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


class Dense(nn.Linear):
    """flax's ``nn.Dense(dtype=compute_dtype, param_dtype=float32)``: with
    a compute dtype it casts its input, weight and bias to it, so the
    product and the output are in that dtype; without one it is
    ``nn.Linear``.  The parameters stay float32.  As in flax, the product
    is rounded to the compute dtype before the bias is added (a fused
    ``addmm`` would round once, and differ from flax in the last bit)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if cd is None:
            return super().forward(x)
        y = F.linear(x.to(cd), self.weight.to(cd))
        return y if self.bias is None else y + self.bias.to(cd)


def in_compute_dtype(x: torch.Tensor,
                     compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` cast to the compute dtype, or as it is without one."""
    return x if compute_dtype is None else x.to(compute_dtype)


def make_dense(
    in_features: int,
    out_features: int,
    generator: Optional[torch.Generator] = None,
    bias: bool = True,
    compute_dtype: Optional[torch.dtype] = None,
) -> Dense:
    """Linear layer with the reference's N(0, 0.02) / zeros init, computing
    in ``compute_dtype`` (float32 when None)."""
    layer = Dense(in_features, out_features, bias=bias,
                  compute_dtype=compute_dtype)
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
