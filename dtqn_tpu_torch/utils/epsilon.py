"""Epsilon-greedy exploration schedule (``dtqn_tpu/utils/epsilon.py``).

The multiplicative-decrement-to-min anneal
    val <- max(min, val - (val - min) / duration)
advanced k env steps at once in closed form:
    val_k = min + (val - min) * (1 - 1/duration)^k
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class EpsilonSchedule:
    start: float = 1.0
    end: float = 0.1
    duration: int = 200_000  # number of single-step anneals

    def initial(self, device) -> torch.Tensor:
        return torch.tensor(self.start, dtype=torch.float32, device=device)

    def anneal(self, val: torch.Tensor, steps: int = 1) -> torch.Tensor:
        """Advance the schedule by ``steps`` env steps (closed form)."""
        if self.duration <= 0:
            return val
        decay = (1.0 - 1.0 / self.duration) ** steps
        return torch.clamp_min(self.end + (val - self.end) * decay, self.end)
