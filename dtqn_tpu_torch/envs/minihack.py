"""MiniHack adapter (``dtqn_tpu/envs/minihack.py``), gated on the external
``minihack`` package.

The reference registers 18 MiniHack variants (envs/__init__.py:53-211)
through ``MiniHackWrapper`` (envs/mini_hack.py): glyph mode flattens the
``glyphs_crop`` window into a MultiDiscrete vector, pixel mode reshapes
``pixel_crop`` HWC -> CHW uint8.  MiniHack steps NetHack's C engine on the
host, so these domains run through the host loop (``train/host_loop.py``):
host envs step between device calls while acting, replay and learning stay
on the card.  ``python -m dtqn_tpu_torch.run --envs MH-Room-5-v0``
dispatches there.

When ``minihack`` is not installed, construction raises with the guidance
the reference prints (envs/__init__.py:20-24).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from dtqn_tpu_torch.envs.core import ObsKind
from dtqn_tpu_torch.envs.host import HostEnvironment

MH_SPECS = {
    # name -> (minihack env id, obs_type, obs_crop, max_episode_steps)
    "MH-Room-5-v0": ("MiniHack-Room-5x5-v0", "glyphs_crop", 9, 100),
    "MH-Room-5-v1": ("MiniHack-Room-5x5-v0", "glyphs_crop", 3, 100),
    "MH-Room-5-v2": ("MiniHack-Room-5x5-v0", "pixel_crop", 9, 100),
    "MH-DarkRoom-5-v0": ("MiniHack-Room-Dark-5x5-v0", "glyphs_crop", 9, 100),
    "MH-DarkRoom-5-v1": ("MiniHack-Room-Dark-5x5-v0", "glyphs_crop", 3, 100),
    "MH-DarkRoom-5-v2": ("MiniHack-Room-Dark-5x5-v0", "pixel_crop", 9, 100),
    "MH-Room-15-v0": ("MiniHack-Room-15x15-v0", "glyphs_crop", 9, 300),
    "MH-Room-15-v1": ("MiniHack-Room-15x15-v0", "glyphs_crop", 3, 300),
    "MH-Room-15-v2": ("MiniHack-Room-15x15-v0", "pixel_crop", 9, 300),
    "MH-DarkRoom-15-v0": ("MiniHack-Room-Dark-15x15-v0", "glyphs_crop", 9, 300),
    "MH-DarkRoom-15-v1": ("MiniHack-Room-Dark-15x15-v0", "glyphs_crop", 3, 300),
    "MH-DarkRoom-15-v2": ("MiniHack-Room-Dark-15x15-v0", "pixel_crop", 9, 300),
    "MH-Maze-9-v0": ("MiniHack-MazeWalk-9x9-v0", "glyphs_crop", 9, 180),
    "MH-Maze-9-v1": ("MiniHack-MazeWalk-9x9-v0", "glyphs_crop", 3, 180),
    "MH-Maze-9-v2": ("MiniHack-MazeWalk-9x9-v0", "pixel_crop", 9, 180),
    "MH-MazeMap-9-v0": ("MiniHack-MazeWalk-Mapped-9x9-v0", "glyphs_crop", 9, 180),
    "MH-MazeMap-9-v1": ("MiniHack-MazeWalk-Mapped-9x9-v0", "glyphs_crop", 3, 180),
    "MH-MazeMap-9-v2": ("MiniHack-MazeWalk-9x9-v0", "pixel_crop", 9, 180),
    # Custom des-file maze pair (reference envs/__init__.py:181-211 builds
    # MH-maze-v1/v2 from an inline NetHack .des map via
    # MiniHack-Navigation-Custom-v0); env_id None selects the des path.
    "MH-maze-v1": (None, "glyphs_crop", 3, 180),
    "MH-maze-v2": (None, "pixel_crop", 9, 180),
}

# A 12-wide premapped maze, the JAX package's own (the same capability as
# the reference's inline des map; the map is the level definition).
DES_MAZE_V0 = """
MAZE: "mylevel", ' '
FLAGS:premapped
GEOMETRY:center,center
MAP
||||||||||||
|.....|....|
|.|||.|.||.|
|.|...|..|.|
|.|.|||||..|
|.|.....||.|
|...|||....|
||||||||||||
ENDMAP
STAIR:(10, 1),down
BRANCH: (1,6,1,6),(2,2,2,2)
"""


def minihack_available() -> bool:
    try:
        import minihack  # noqa: F401

        return True
    except ImportError:
        return False


class HostMiniHack(HostEnvironment):
    """Host-side MiniHack env with the reference wrapper's obs conventions.

    glyph mode: flattened crop window, MultiDiscrete-style int32 tokens,
    mask = max glyph + 1 (env_processing.py:108-116); pixel mode: CHW
    uint8, mask 0.  Steps NetHack's C code on the host; trained through the
    host loop.
    """

    def __init__(self, name: str):
        if name not in MH_SPECS:
            raise KeyError(f"Unknown MiniHack domain {name!r}")
        if not minihack_available():
            raise ImportError(
                "``minihack`` is not installed. This means you cannot run "
                "an experiment with any of the MH- domains. "
                "(reference envs/__init__.py:20-24)"
            )
        import gym  # minihack requires gym
        import minihack  # noqa: F401

        env_id, obs_type, obs_crop, max_steps = MH_SPECS[name]
        if env_id is None:
            # des-file variants (envs/__init__.py:199-211, mini_hack.py:26-33)
            self.env = gym.make(
                "MiniHack-Navigation-Custom-v0",
                des_file=DES_MAZE_V0,
                observation_keys=(obs_type,),
                obs_crop_h=obs_crop,
                obs_crop_w=obs_crop,
            )
        else:
            self.env = gym.make(
                env_id,
                observation_keys=(obs_type,),
                obs_crop_h=obs_crop,
                obs_crop_w=obs_crop,
            )
        self.obs_type = obs_type
        self.max_episode_steps = max_steps
        self.name = name

        space = self.env.observation_space[obs_type]
        if obs_type == "glyphs_crop":
            self.obs_kind = ObsKind.DISCRETE
            self.obs_shape = (int(np.prod(space.shape)),)
            self.obs_dtype = torch.int32
            # MultiDiscrete mask rule: max(nvec) + 1, where the wrapper's
            # nvec is high.max() per cell (mini_hack.py:44-53).
            self._mask = float(int(space.high.max()) + 1)
        else:
            self.obs_kind = ObsKind.IMAGE
            h, w, c = space.shape
            self.obs_shape = (c, h, w)
            self.obs_dtype = torch.uint8
            self._mask = 0.0
        self.num_actions = int(self.env.action_space.n)

    @property
    def obs_mask(self) -> float:
        return self._mask

    def _convert(self, obs) -> np.ndarray:
        o = obs[self.obs_type]
        if self.obs_type == "glyphs_crop":
            return o.flatten().astype(np.int32)
        return o.reshape(o.shape[2], o.shape[0], o.shape[1])  # HWC -> CHW

    def seed(self, seed: int) -> None:
        try:
            self.env.seed(seed)
        except Exception:  # noqa: BLE001 - gym versions differ; optional
            pass

    def reset(self) -> np.ndarray:
        return self._convert(self.env.reset())

    def step(
        self, action: int
    ) -> Tuple[np.ndarray, float, bool, Dict[str, Any]]:
        obs, reward, done, info = self.env.step(int(action))
        return self._convert(obs), float(reward), bool(done), dict(info)


def make_host_env(name: str) -> HostEnvironment:
    """Factory for host-side environments by name (MH-* domains)."""
    return HostMiniHack(name)
