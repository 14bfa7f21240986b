"""Environment registry: the CarFlag entries of ``dtqn_tpu/envs``."""

from __future__ import annotations

from dtqn_tpu_torch.envs.car_flag import CarFlag, CarFlagState
from dtqn_tpu_torch.envs.core import Environment, ObsKind, Timestep

_REGISTRY = {
    # Car Flag (reference envs/__init__.py:42-47: 200-step limit)
    "DiscreteCarFlag-v0": CarFlag,
}


def make_env(name: str) -> Environment:
    """Instantiate a ported environment by name."""
    if name in _REGISTRY:
        return _REGISTRY[name]()
    raise NotImplementedError(
        f"environment {name!r} is not ported yet (ported: "
        f"{sorted(_REGISTRY)}); see ROADMAP.md queue 1"
    )


__all__ = [
    "CarFlag", "CarFlagState", "Environment", "ObsKind", "Timestep",
    "make_env",
]
