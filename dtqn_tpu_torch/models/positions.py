"""Position encodings: learned / sinusoidal / none
(``dtqn_tpu/models/positions.py``).

learned = trainable zeros [1, L, F]; sin = the standard fixed sinusoid; none
= frozen zeros (position_encodings.py:8-51).  The fixed tables are buffers
left out of the ``state_dict``, so the parameters, the flat vector Adam runs
over and the saved policies hold what the JAX package's do.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

KINDS = ("learned", "sin", "none")


def sinusoidal_table(context_len: int, embed_dim: int) -> np.ndarray:
    """Fixed sinusoid [1, L, F] (position_encodings.py:22-35), in float32
    numpy as the JAX package computes it."""
    position = np.arange(context_len)[:, None].astype(np.float32)
    div_term = np.exp(
        np.arange(0, embed_dim, 2).astype(np.float32)
        * (-np.log(10000.0) / embed_dim)
    )
    table = np.zeros((1, context_len, embed_dim), np.float32)
    table[0, :, 0::2] = np.sin(position * div_term)
    table[0, :, 1::2] = np.cos(position * div_term)
    return table


class PositionEncoding(nn.Module):
    def __init__(self, kind: str, context_len: int, embed_dim: int):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"position encoding must be one of {KINDS}")
        self.kind = kind
        shape = (1, context_len, embed_dim)
        if kind == "learned":
            self.embedding = nn.Parameter(torch.zeros(shape))
        else:
            table = (torch.from_numpy(sinusoidal_table(context_len, embed_dim))
                     if kind == "sin" else torch.zeros(shape))
            self.register_buffer("table", table, persistent=False)

    def forward(self) -> torch.Tensor:
        return self.embedding if self.kind == "learned" else self.table
