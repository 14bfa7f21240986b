"""Combine gates after attention/FFN submodules (``dtqn_tpu/models/gates.py``).

``ResGate`` is a plain residual add (gates.py:34-41).  The GRU gate is not
ported yet.
"""

from __future__ import annotations

import torch
from torch import nn


class ResGate(nn.Module):
    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return x + y


def make_gate(kind: str, features: int) -> nn.Module:
    if kind == "res":
        return ResGate()
    if kind == "gru":
        raise NotImplementedError(
            "the GRU gate is not ported yet; see ROADMAP.md queue 1 "
            "item 12b"
        )
    raise ValueError("Gate must be one of `gru`, `res`")
