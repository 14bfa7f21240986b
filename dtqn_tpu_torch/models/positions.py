"""Learned position encoding (``dtqn_tpu/models/positions.py``).

Trainable zeros [1, L, F] (position_encodings.py:8-51).  The sinusoidal and
``none`` kinds are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn


class PositionEncoding(nn.Module):
    def __init__(self, kind: str, context_len: int, embed_dim: int):
        super().__init__()
        if kind != "learned":
            raise NotImplementedError(
                f"position encoding {kind!r} is not ported yet; see "
                "ROADMAP.md queue 1 item 12b"
            )
        self.embedding = nn.Parameter(torch.zeros(1, context_len, embed_dim))

    def forward(self) -> torch.Tensor:
        return self.embedding
