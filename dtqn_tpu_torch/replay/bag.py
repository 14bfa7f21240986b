"""Persistent-memory bag, batched over envs (``dtqn_tpu/replay/bag.py``).

A fixed-size store of (obs, action) pairs evicted from the context,
mask-padded, with an ``add`` that rejects when full (bag.py:6-55); the
Q-driven eviction policy lives in the agent.  Each slot also tracks
``obs_idx``, the episode observation index its entry was evicted from (-1
when empty), which lets ``--bag-store`` record the act-time bag into replay
as indices (``replay/buffer.py`` ``store_act_bag``).

Like the context, the bag is small and every function returns a new
``BagState``; nothing is written in place, so a caller may keep the old one
(the evaluation's done-latch does).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from dtqn_tpu_torch.envs.core import where_batch


@dataclasses.dataclass
class BagState:
    obs: torch.Tensor  # [E, bag_size, *obs_shape]
    action: torch.Tensor  # [E, bag_size] int32
    obs_idx: torch.Tensor  # [E, bag_size] int32: episode obs index, -1 empty
    pos: torch.Tensor  # [E] int32

    @property
    def size(self) -> int:
        return self.obs.shape[1]

    @property
    def is_full(self) -> torch.Tensor:
        return self.pos >= self.size


def init_bag(
    num_envs: int,
    bag_size: int,
    obs_shape: Tuple[int, ...],
    obs_dtype: torch.dtype,
    obs_mask: float,
    device,
) -> BagState:
    return BagState(
        obs=torch.full((num_envs, bag_size, *obs_shape), obs_mask,
                       dtype=obs_dtype, device=device),
        action=torch.zeros((num_envs, bag_size), dtype=torch.int32,
                           device=device),
        obs_idx=torch.full((num_envs, bag_size), -1, dtype=torch.int32,
                           device=device),
        pos=torch.zeros((num_envs,), dtype=torch.int32, device=device),
    )


def reset_bag(bag: BagState, reset_mask: torch.Tensor,
              obs_mask: float) -> BagState:
    """Empty the bags of envs selected by ``reset_mask`` (bag.py:24-26)."""
    fresh = init_bag(
        bag.obs.shape[0], bag.size, tuple(bag.obs.shape[2:]), bag.obs.dtype,
        obs_mask, bag.obs.device,
    )
    return where_batch(reset_mask, fresh, bag)


def bag_add(
    bag: BagState,
    obs: torch.Tensor,
    action: torch.Tensor,
    obs_idx: torch.Tensor,
    add_mask: torch.Tensor,
) -> Tuple[BagState, torch.Tensor]:
    """Try to append (obs, action) for envs where ``add_mask``; rejected when
    full (bag.py:28-36).  ``obs_idx`` is the evicted entry's episode
    observation index.  Returns (bag, accepted bool [E])."""
    accept = add_mask & ~bag.is_full
    slots = torch.arange(bag.size, device=bag.obs.device)
    # The one slot written per accepting env: its cursor (a full bag's
    # cursor is past the last slot, and accept is False there anyway).
    hit = (slots[None, :] == bag.pos[:, None]) & accept[:, None]

    def put(arr, val):
        val = val.to(arr.dtype)[:, None]
        return torch.where(
            hit.reshape(hit.shape + (1,) * (arr.dim() - 2)), val, arr
        )

    return (
        BagState(
            obs=put(bag.obs, obs),
            action=put(bag.action, action),
            obs_idx=put(bag.obs_idx, obs_idx),
            pos=bag.pos + accept.to(torch.int32),
        ),
        accept,
    )
