"""Train-mode dropout with explicit draws (flax's ``nn.Dropout``).

flax keeps an element with probability ``keep = 1 - rate`` (``bernoulli``,
i.e. a uniform draw below ``keep``) and returns ``where(kept, x / keep, 0)``
in ``x``'s dtype: ``keep`` is a weakly typed Python float, so jnp rounds
it to that dtype first (to 0.8984375 for 0.9 in bfloat16).
``DropoutDraws`` is the randomness of one stochastic forward: each dropout
site of the network calls it once, in forward order (the input, then per
layer the attention probabilities and the FFN output, then the bag
attention), and gets its mask from the generator or, for tests, the next of
the given masks.  A forward without draws is deterministic, as flax's
``deterministic=True``.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch


@functools.lru_cache(maxsize=None)
def rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as jnp rounds a weakly typed Python
    float beside an array of that dtype; worked out once per (value,
    dtype), so that a forward makes no tensor from Python data."""
    return torch.tensor(value, dtype=dtype).item()


class DropoutDraws:
    """The dropout masks of one train-mode forward: drawn from
    ``generator``, or taken in call order from ``masks`` (bool, each of its
    site's shape)."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 masks: Optional[Sequence[torch.Tensor]] = None):
        if (generator is None) == (masks is None):
            raise ValueError("give a generator or masks, not both")
        self.generator = generator
        self.masks = None if masks is None else list(masks)

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if rate >= 1.0:
            return torch.zeros_like(x)
        keep_prob = 1.0 - rate
        if self.masks is not None:
            if not self.masks:
                raise ValueError("fewer dropout masks given than sites")
            keep = self.masks.pop(0).to(device=x.device, dtype=torch.bool)
            if keep.shape != x.shape:
                raise ValueError(
                    f"dropout mask {tuple(keep.shape)} for an input "
                    f"{tuple(x.shape)}"
                )
        else:
            keep = torch.rand(x.shape, generator=self.generator,
                              device=x.device) < keep_prob
        # keep_prob as jnp sees it beside x: rounded to x's dtype.
        scale = rounded(keep_prob, x.dtype)
        return torch.where(keep, x / scale, torch.zeros_like(x))


def apply_dropout(x: torch.Tensor, rate: float,
                  draws: Optional[DropoutDraws]) -> torch.Tensor:
    """``x`` unchanged in a deterministic forward (no draws) or at rate 0,
    else masked by the next of ``draws``."""
    if draws is None or rate <= 0.0:
        return x
    return draws(x, rate)
