"""Car Flag, batched (``dtqn_tpu/envs/car_flag.py``).

A car on [-1.1, 1.1] with velocity clamped to +-0.07 accelerates with force
+-0.0015; heaven is at +1 or -1 each episode (hell opposite); a priest near
x = 0.5 (+-0.2) reveals heaven's side in the third obs component.  Reward
+1 at heaven, -1 at hell; the episode ends at either.  Obs = [position,
velocity, priest_hint]; actions {0, 1, 2} -> force {-1, 0, 1}.  200-step cap.
``CarFlag(discrete=False)`` takes a Box(1) force clipped to [-1, 1] instead
(car_flag.py:58-63,82-83): an env for scripted or external policies, which
the discrete-action Q agents refuse.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from dtqn_tpu_torch.envs.core import Environment, ObsKind
from dtqn_tpu_torch.utils.rng import sharded_draw


@dataclasses.dataclass
class CarFlagState:
    position: torch.Tensor  # [E] f32
    velocity: torch.Tensor  # [E] f32
    heaven: torch.Tensor  # [E] f32, +1.0 or -1.0
    t: torch.Tensor  # [E] int32, steps taken this episode


class CarFlag(Environment):
    """Car Flag; ``discrete=False`` switches to Box(1) force actions."""

    name = "DiscreteCarFlag-v0"
    num_actions = 3
    max_episode_steps = 200
    obs_kind = ObsKind.CONTINUOUS
    obs_shape = (3,)
    obs_dtype = torch.float32

    max_position = 1.1
    max_speed = 0.07
    power = 0.0015
    priest_position = 0.5
    priest_delta = 0.2
    goal_position = 1.0

    def __init__(self, discrete: bool = True):
        self.discrete = discrete
        if not discrete:
            # num_actions 0 marks the env unusable by the Q agents.
            self.name = "CarFlag-continuous-v0"
            self.num_actions = 0

    @property
    def obs_mask(self) -> float:
        return -5.0  # below any real observation (env_processing.py:110-116)

    def _observe(self, state: CarFlagState) -> torch.Tensor:
        near_priest = (
            (state.position >= self.priest_position - self.priest_delta)
            & (state.position <= self.priest_position + self.priest_delta)
        )
        hint = torch.where(near_priest, state.heaven,
                           torch.zeros_like(state.heaven))
        return torch.stack([state.position, state.velocity, hint], dim=-1)

    def render_frame(self, state: CarFlagState):
        """Headless RGB raster of the track for one env (``state`` holds
        scalars): car, heaven and hell flags, priest zone.  Returns uint8
        [80, 400, 3], composable into enjoy-mode episode strips."""
        import numpy as np

        height, width = 80, 400
        img = np.full((height, width, 3), 255, np.uint8)

        def x2px(x):
            span = 2 * self.max_position
            return int(
                np.clip((float(x) + self.max_position) / span, 0, 1)
                * (width - 1)
            )

        img[60:62, :] = 160  # track
        a = x2px(self.priest_position - self.priest_delta)
        b = x2px(self.priest_position + self.priest_delta)
        img[62:68, a:b] = (230, 210, 80)  # priest zone
        heaven = float(state.heaven)
        hx = x2px(heaven * self.goal_position)
        lx = x2px(-heaven * self.goal_position)
        img[16:60, hx - 2:hx + 2] = (40, 160, 60)  # heaven flag
        img[16:60, lx - 2:lx + 2] = (200, 50, 50)  # hell flag
        cx = x2px(state.position)
        img[46:60, max(cx - 5, 0):cx + 5] = (25, 25, 25)  # car
        return img

    def reset_with(
        self, heaven_left: torch.Tensor, position: torch.Tensor
    ) -> Tuple[torch.Tensor, CarFlagState]:
        """Fresh episodes from given draws: ``heaven_left`` [E] bool puts
        heaven at -1, ``position`` [E] f32 in [-0.2, 0.2)."""
        heaven = torch.where(
            heaven_left,
            torch.full_like(position, -1.0),
            torch.full_like(position, 1.0),
        )
        state = CarFlagState(
            position=position,
            velocity=torch.zeros_like(position),
            heaven=heaven,
            t=torch.zeros(position.shape, dtype=torch.int32,
                          device=position.device),
        )
        return self._observe(state), state

    def reset_env(self, generator, num_envs: int, device):
        draws = sharded_draw(generator, (2, num_envs), lambda g, s: torch.rand(
            s, generator=g, device=device), env_axis=1)
        return self.reset_with(draws[0] < 0.5, draws[1] * 0.4 - 0.2)

    def step_env(self, generator, state: CarFlagState, action):
        del generator  # dynamics are deterministic
        if self.discrete:
            force = action.to(torch.float32) - 1.0
        else:  # [E] or [E, 1] forces
            force = torch.clamp(
                action.to(torch.float32).reshape(action.shape[0]), -1.0, 1.0
            )
        velocity = torch.clamp(
            state.velocity + force * self.power, -self.max_speed,
            self.max_speed,
        )
        position = torch.clamp(
            state.position + velocity, -self.max_position, self.max_position
        )
        # Left wall is sticky: hitting it zeroes negative velocity.
        velocity = torch.where(
            (position == -self.max_position) & (velocity < 0),
            torch.zeros_like(velocity),
            velocity,
        )
        at_plus = position >= self.goal_position
        at_minus = position <= -self.goal_position
        terminated = at_plus | at_minus
        heaven_right = state.heaven > 0
        one = torch.ones_like(position)
        reward = torch.where(
            at_plus,
            torch.where(heaven_right, one, -one),
            torch.where(at_minus, torch.where(heaven_right, -one, one),
                        torch.zeros_like(position)),
        )
        new_state = CarFlagState(
            position=position, velocity=velocity, heaven=state.heaven,
            t=state.t + 1,
        )
        info = {"is_success": reward > 0}
        return self._observe(new_state), new_state, reward, terminated, info
