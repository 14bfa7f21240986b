"""Image-observation grid maze, batched (``dtqn_tpu/envs/image_maze.py``).

The in-repo pixel domain: it drives the image pipeline of the reference's
MiniHack pixel mode (CHW uint8 observations -> 5-layer CNN -> DTQN).  A dark
NxN maze is rendered as a 3-channel image (walls / goal when lit / agent);
only cells within Chebyshev distance ``light_radius`` of the agent are lit,
so the goal shows only nearby, and remembering where it was seen matters.
Reward +1 on reaching the goal, which ends the episode; 4 actions (N, E, S,
W) and a 100-step cap.

Every function works on a batch of envs; a reset's random outcomes are the
pillars kept (one draw per cell) and two categorical draws (goal and start
over the free cells, Gumbel-max as ``jax.random.categorical``), and
``reset_with`` builds the episodes from given outcomes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from dtqn_tpu_torch.envs.core import Environment, ObsKind
from dtqn_tpu_torch.envs.pomdp import draw
from dtqn_tpu_torch.utils.rng import sharded_draw

DIRS = ((-1, 0), (0, 1), (1, 0), (0, -1))  # N E S W


@dataclasses.dataclass
class ImageMazeState:
    walls: torch.Tensor  # [E, N, N] bool
    goal: torch.Tensor  # [E, 2] int32 (y, x)
    pos: torch.Tensor  # [E, 2] int32 (y, x)
    t: torch.Tensor  # [E] int32


class ImageMaze(Environment):
    """Pixel-observation maze (CHW uint8, like the MiniHack pixel mode)."""

    obs_kind = ObsKind.IMAGE
    obs_dtype = torch.uint8
    num_actions = 4

    def __init__(self, size: int = 9, light_radius: int = 2,
                 max_episode_steps: int = 100):
        self.size = size
        self.light_radius = light_radius
        self.name = f"ImageMaze-{size}-v0"
        self.max_episode_steps = max_episode_steps
        self.obs_shape = (3, size, size)
        self._dirs: Dict[str, torch.Tensor] = {}

    @property
    def obs_mask(self) -> float:
        return 0.0  # image obs mask is 0 (env_processing.py:104-105)

    def _dirs_on(self, device) -> torch.Tensor:
        """``DIRS`` as [4, 2] int32 on ``device``, made once per device."""
        key = str(device)
        if key not in self._dirs:
            self._dirs[key] = torch.tensor(DIRS, dtype=torch.int32,
                                           device=device)
        return self._dirs[key]

    def _grid(self, device):
        n = self.size
        return torch.meshgrid(torch.arange(n, device=device),
                              torch.arange(n, device=device), indexing="ij")

    def _walls(self, keep: torch.Tensor) -> torch.Tensor:
        """The border, and the pillars on even-even cells where ``keep``
        [E, N, N]; sparse pillars keep the maze connected."""
        n = self.size
        yy, xx = self._grid(keep.device)
        border = (yy == 0) | (xx == 0) | (yy == n - 1) | (xx == n - 1)
        pillars = (yy % 2 == 0) & (xx % 2 == 0)
        return border | (pillars & keep)

    def _render(self, state: ImageMazeState) -> torch.Tensor:
        """[E, 3, N, N] uint8: walls and the goal where lit, the agent."""
        yy, xx = self._grid(state.pos.device)

        def at(cell):
            return ((yy == cell[:, 0, None, None])
                    & (xx == cell[:, 1, None, None]))

        dist = torch.maximum((yy - state.pos[:, 0, None, None]).abs(),
                             (xx - state.pos[:, 1, None, None]).abs())
        lit = dist <= self.light_radius
        goal = at(state.goal)
        goal_visible = (lit & goal).flatten(1).any(dim=-1)
        channels = (state.walls & lit, goal & goal_visible[:, None, None],
                    at(state.pos))
        return torch.stack(channels, dim=1).to(torch.uint8) * 255

    def reset_with(
        self, keep: torch.Tensor, goal_cell: torch.Tensor,
        pos_cell: torch.Tensor,
    ) -> Tuple[torch.Tensor, ImageMazeState]:
        """Fresh episodes from given outcomes: ``keep`` [E, N, N] bool (the
        pillars kept), ``goal_cell`` and ``pos_cell`` [E] as y * N + x."""
        n = self.size

        def cell(c):
            c = c.to(torch.int32)
            return torch.stack([c // n, c % n], dim=-1)

        state = ImageMazeState(
            walls=self._walls(keep.to(torch.bool)),
            goal=cell(goal_cell),
            pos=cell(pos_cell),
            t=torch.zeros(keep.shape[:1], dtype=torch.int32,
                          device=keep.device),
        )
        return self._render(state), state

    def reset_env(self, generator, num_envs: int, device):
        n = self.size
        keep = sharded_draw(generator, (num_envs, n, n),
                            lambda g, s: torch.rand(s, generator=g,
                                                    device=device)) < 0.5
        free = ~self._walls(keep).reshape(num_envs, -1)
        free_logits = torch.where(free, 0.0, -torch.inf)
        goal_cell = draw(generator, free_logits)
        pos_logits = free_logits.scatter(1, goal_cell[:, None], -torch.inf)
        return self.reset_with(keep, goal_cell, draw(generator, pos_logits))

    def step_env(self, generator, state: ImageMazeState, action):
        del generator  # dynamics are deterministic
        n = self.size
        dirs = self._dirs_on(action.device)
        target = torch.clamp(state.pos + dirs[action.to(torch.int64)], 0,
                             n - 1)
        e = torch.arange(action.shape[0], device=action.device)
        blocked = state.walls[e, target[:, 0].to(torch.int64),
                              target[:, 1].to(torch.int64)]
        new_pos = torch.where(blocked[:, None], state.pos, target)
        reached = (new_pos == state.goal).all(dim=-1)
        new_state = dataclasses.replace(state, pos=new_pos, t=state.t + 1)
        info = {"is_success": reached}
        return (self._render(new_state), new_state, reached.to(torch.float32),
                reached, info)
