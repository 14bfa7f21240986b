"""Environment registry (``dtqn_tpu/envs/__init__.py``): Car Flag (discrete
and continuous), Memory Cards, the image maze, Gridverse and the classic
POMDPs (Hallway, HeavenHell and any Cassandra ``.pomdp`` file); several
domains combine in ``MultiDomainEnv``."""

from __future__ import annotations

import os

from dtqn_tpu_torch.envs.car_flag import CarFlag, CarFlagState
from dtqn_tpu_torch.envs.core import Environment, ObsKind, Timestep
from dtqn_tpu_torch.envs.gridverse import (
    GridverseMemory,
    GridverseState,
    make_gridverse_env,
)
from dtqn_tpu_torch.envs.image_maze import ImageMaze, ImageMazeState
from dtqn_tpu_torch.envs.memory_cards import MemoryCards, MemoryState
from dtqn_tpu_torch.envs.multi import MultiDomainEnv, MultiDomainState
from dtqn_tpu_torch.envs.pomdp import (
    TabularPOMDP,
    TabularState,
    make_hallway,
    make_heavenhell,
)
from dtqn_tpu_torch.envs.pomdp_parser import (
    make_tabular_env,
    parse_pomdp_file,
)

REPO_DATA = os.path.normpath(
    os.path.join(os.path.dirname(__file__), "..", "..", "data")
)


def _make_hallway_env() -> Environment:
    """Hallway: the Cassandra tables of the first ``hallway.pomdp`` found in
    ``DTQN_TPU_POMDP_DIR``, the working directory or the repo's ``data/``,
    as the JAX package looks them up; else its reconstruction
    (envs/pomdp.py)."""
    for d in (os.environ.get("DTQN_TPU_POMDP_DIR", ""), os.getcwd(),
              REPO_DATA):
        path = os.path.join(d, "hallway.pomdp") if d else ""
        if path and os.path.exists(path):
            return make_tabular_env(
                parse_pomdp_file(path),
                name="POMDP-hallway-episodic-v0",
                max_episode_steps=100,
            )
    return make_hallway()


_REGISTRY = {
    # Memory cards (reference envs/__init__.py:31-36: 50-step limit)
    "Memory-5-v0": lambda: MemoryCards(num_pairs=5, max_episode_steps=50),
    # Car Flag (reference envs/__init__.py:42-47: 200-step limit)
    "DiscreteCarFlag-v0": CarFlag,
    # Continuous-force mode (car_flag.py:58-63): scripted or external
    # policies only; the Q agents are discrete-action, as in the reference.
    "CarFlag-continuous-v0": lambda: CarFlag(discrete=False),
    "ImageMaze-9-v0": lambda: ImageMaze(size=9),
    "POMDP-hallway-episodic-v0": _make_hallway_env,
    "POMDP-heavenhell_3-episodic-v0": lambda: make_heavenhell(3),
}


def make_env(name: str) -> Environment:
    """Instantiate an environment by name.  Gridverse YAML names
    (``gv_*.yaml``) resolve to the Gridverse memory engine, and paths ending
    in ``.pomdp`` load the Cassandra file into a ``TabularPOMDP`` with a
    100-step limit."""
    if name in _REGISTRY:
        return _REGISTRY[name]()
    if name.endswith(".pomdp"):
        if not os.path.exists(name):
            raise FileNotFoundError(f"POMDP file not found: {name!r}")
        base = os.path.splitext(os.path.basename(name))[0]
        return make_tabular_env(
            parse_pomdp_file(name),
            name=f"POMDP-{base}-episodic-v0",
            max_episode_steps=100,
        )
    if name.startswith("gv_"):
        return make_gridverse_env(name)
    raise KeyError(
        f"Unknown environment {name!r}. Registered: {sorted(_REGISTRY)}"
    )


__all__ = [
    "CarFlag", "CarFlagState", "Environment", "GridverseMemory",
    "GridverseState", "ImageMaze", "ImageMazeState", "MemoryCards",
    "MemoryState", "MultiDomainEnv", "MultiDomainState", "ObsKind",
    "TabularPOMDP", "TabularState", "Timestep", "make_env",
    "make_gridverse_env", "make_hallway", "make_heavenhell",
]
