"""Environment registry: the Car Flag, Memory Cards and Gridverse entries of
``dtqn_tpu/envs``."""

from __future__ import annotations

from dtqn_tpu_torch.envs.car_flag import CarFlag, CarFlagState
from dtqn_tpu_torch.envs.core import Environment, ObsKind, Timestep
from dtqn_tpu_torch.envs.gridverse import (
    GridverseMemory,
    GridverseState,
    make_gridverse_env,
)
from dtqn_tpu_torch.envs.memory_cards import MemoryCards, MemoryState

_REGISTRY = {
    # Memory cards (reference envs/__init__.py:31-36: 50-step limit)
    "Memory-5-v0": lambda: MemoryCards(num_pairs=5, max_episode_steps=50),
    # Car Flag (reference envs/__init__.py:42-47: 200-step limit)
    "DiscreteCarFlag-v0": CarFlag,
}


def make_env(name: str) -> Environment:
    """Instantiate a ported environment by name; Gridverse YAML names
    (``gv_*.yaml``) resolve to the Gridverse memory engine."""
    if name in _REGISTRY:
        return _REGISTRY[name]()
    if name.startswith("gv_"):
        return make_gridverse_env(name)
    raise NotImplementedError(
        f"environment {name!r} is not ported yet (ported: "
        f"{sorted(_REGISTRY)} and gv_memory*.yaml); see ROADMAP.md queue 1 "
        "item 11"
    )


__all__ = [
    "CarFlag", "CarFlagState", "Environment", "GridverseMemory",
    "GridverseState", "MemoryCards", "MemoryState", "ObsKind", "Timestep",
    "make_env", "make_gridverse_env",
]
