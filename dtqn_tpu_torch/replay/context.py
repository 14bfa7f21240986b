"""Rolling per-episode history window (``dtqn_tpu/replay/context.py``).

Vectorized over env instances and kept on the device:
  - obs padded with ``obs_mask``; **actions initialized to random ints**
    (context.py:50, a deliberate reference quirk), rewards 0, dones True
  - ``add_transition`` rolls left when full and returns the evicted
    (obs, action) pair (context.py:56-80)
  - ``timestep`` counts transitions
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from dtqn_tpu_torch.envs.core import where_batch
from dtqn_tpu_torch.utils.rng import folded_draw


@dataclasses.dataclass
class ContextState:
    obs: torch.Tensor  # [E, L, *obs_shape]
    action: torch.Tensor  # [E, L] int32
    reward: torch.Tensor  # [E, L] float32
    done: torch.Tensor  # [E, L] bool
    timestep: torch.Tensor  # [E] int32

    @property
    def context_len(self) -> int:
        return self.obs.shape[1]

    @property
    def last_index(self) -> torch.Tensor:
        """Row holding the newest observation: min(timestep, L-1)."""
        return torch.clamp_max(self.timestep, self.context_len - 1)


def init_context(
    generator: torch.Generator,
    num_envs: int,
    context_len: int,
    obs_shape: Tuple[int, ...],
    obs_dtype: torch.dtype,
    obs_mask: float,
    num_actions: int,
    first_obs: torch.Tensor,
) -> ContextState:
    """Fresh contexts seeded with each env's first observation, on
    ``first_obs``'s device (context.py:36-54).  With a list of per-seed
    generators the ``num_envs`` are S seed-major blocks, each drawing its
    actions from its seed's generator."""
    device = first_obs.device
    obs = torch.full((num_envs, context_len, *obs_shape), obs_mask,
                     dtype=obs_dtype, device=device)
    obs[:, 0] = first_obs.to(obs_dtype)
    action = folded_draw(generator, num_envs, lambda g, n: torch.randint(
        0, num_actions, (n, context_len), generator=g, device=device,
        dtype=torch.int32,
    ))
    return ContextState(
        obs=obs,
        action=action,
        reward=torch.zeros((num_envs, context_len), dtype=torch.float32,
                           device=device),
        done=torch.ones((num_envs, context_len), dtype=torch.bool,
                        device=device),
        timestep=torch.zeros((num_envs,), dtype=torch.int32, device=device),
    )


def reset_context(
    ctx: ContextState,
    generator: torch.Generator,
    first_obs: torch.Tensor,
    reset_mask: torch.Tensor,
    obs_mask: float,
    num_actions: int,
) -> ContextState:
    """Fresh contexts for the envs selected by ``reset_mask`` (bool [E])."""
    fresh = init_context(
        generator, ctx.obs.shape[0], ctx.context_len, tuple(ctx.obs.shape[2:]),
        ctx.obs.dtype, obs_mask, num_actions, first_obs,
    )
    return where_batch(reset_mask, fresh, ctx)


def add_transition(
    ctx: ContextState,
    obs: torch.Tensor,
    action: torch.Tensor,
    reward: torch.Tensor,
    done: torch.Tensor,
) -> Tuple[ContextState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Append one transition per env; returns (ctx, evicted_obs,
    evicted_action, was_full).

    Increment timestep, roll left when the new timestep has reached
    capacity, write at min(timestep, L-1); when full, the pre-overwrite
    slot content (the evicted oldest entry) is returned.
    """
    length = ctx.context_len
    timestep = ctx.timestep + 1
    full = timestep >= length

    def roll_if_full(arr):
        return where_batch(full, torch.roll(arr, -1, dims=1), arr)

    obs_arr = roll_if_full(ctx.obs)
    act_arr = roll_if_full(ctx.action)
    rew_arr = roll_if_full(ctx.reward)
    done_arr = roll_if_full(ctx.done)

    t = torch.clamp_max(timestep, length - 1).to(torch.int64)
    e_idx = torch.arange(ctx.obs.shape[0], device=t.device)
    evicted_obs = obs_arr[e_idx, t]
    evicted_action = act_arr[e_idx, t]

    obs_arr[e_idx, t] = obs.to(ctx.obs.dtype)
    act_arr[e_idx, t] = action.to(torch.int32)
    rew_arr[e_idx, t] = reward.to(torch.float32)
    done_arr[e_idx, t] = done.to(torch.bool)
    new_ctx = ContextState(obs=obs_arr, action=act_arr, reward=rew_arr,
                           done=done_arr, timestep=timestep)
    return new_ctx, evicted_obs, evicted_action, full
