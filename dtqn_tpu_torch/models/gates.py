"""Combine gates after attention/FFN submodules (``dtqn_tpu/models/gates.py``).

``ResGate`` is a plain residual add (gates.py:34-41); ``GRUGate`` is the
GTrXL gating with the w_z bias initialized to -2 (gates.py:5-31).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dtqn_tpu_torch.models.init import make_dense


class ResGate(nn.Module):
    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return x + y


class GRUGate(nn.Module):
    """z = sigmoid(w_z y + u_z x), r = sigmoid(w_r y + u_r x),
    h = tanh(w_g y + u_g (r * x)); out = (1 - z) x + z h.  Six bias-free
    Linears but ``w_z``, whose bias starts at -2 (the GTrXL bias)."""

    def __init__(self, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w_z = make_dense(features, features, generator)
        nn.init.constant_(self.w_z.bias, -2.0)
        for name in ("u_z", "w_r", "u_r", "w_g", "u_g"):
            setattr(self, name,
                    make_dense(features, features, generator, bias=False))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        # flax's nn.Dense without a dtype promotes its input with its float32
        # kernel: under a bfloat16 compute dtype the gate still computes in
        # float32 (y, the attention or FFN output, arrives in bfloat16).
        y = y.to(torch.float32)
        z = torch.sigmoid(self.w_z(y) + self.u_z(x))
        r = torch.sigmoid(self.w_r(y) + self.u_r(x))
        h = torch.tanh(self.w_g(y) + self.u_g(r * x))
        return (1.0 - z) * x + z * h


def make_gate(kind: str, features: int,
              generator: Optional[torch.Generator] = None) -> nn.Module:
    if kind == "gru":
        return GRUGate(features, generator)
    if kind == "res":
        return ResGate()
    raise ValueError("Gate must be one of `gru`, `res`")
