"""Multi-domain environment: a domain drawn per episode
(``dtqn_tpu/envs/multi.py``).

The reference takes several ``--envs`` and draws a fresh env at every
episode reset (run.py:287,295); the domains must share their observation and
action spaces (run.py:47).  Here the state carries a per-env domain index,
drawn at every reset.  As ``lax.switch`` under ``vmap`` computes every
branch, each member is reset or stepped on all E envs and each env keeps
its own domain's result: the members' states must share one structure and
shape (Gridverse members are built with a common ``pad_to``), and a member
stepped on another domain's env must stay in range (each member clamps what
it indexes with), since that result is discarded.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence

import torch

from dtqn_tpu_torch.envs.core import Environment, where_batch
from dtqn_tpu_torch.utils.rng import sharded_draw


@dataclasses.dataclass
class MultiDomainState:
    domain: torch.Tensor  # [E] int32: each env's member
    inner: Any  # the members' state (one shared structure)

    @property
    def t(self) -> torch.Tensor:
        return self.inner.t


def _select(domain: torch.Tensor, outs: List[tuple]) -> tuple:
    """Per env, the output of the member ``domain`` names: ``outs`` holds
    one tuple per member of tensors, states and info dicts."""
    picked = list(outs[0])
    for i, out in enumerate(outs[1:], 1):
        here = domain == i
        for j, (mine, other) in enumerate(zip(out, picked)):
            if isinstance(mine, dict):
                picked[j] = {k: where_batch(here, mine[k], other[k])
                             for k in mine}
            else:
                picked[j] = where_batch(here, mine, other)
    return tuple(picked)


class MultiDomainEnv(Environment):
    """Per-episode domain sampling over structurally identical envs."""

    def __init__(self, envs: Sequence[Environment]):
        if not envs:
            raise ValueError("need at least one env")
        first = envs[0]
        for e in envs[1:]:
            if (
                tuple(e.obs_shape) != tuple(first.obs_shape)
                or e.num_actions != first.num_actions
                or e.obs_kind != first.obs_kind
                or e.obs_mask != first.obs_mask
            ):
                raise ValueError(
                    "multi-domain envs must share observation/action spaces "
                    f"({e.name} differs from {first.name})"
                )
        self.envs: List[Environment] = list(envs)
        self.name = "+".join(e.name for e in envs)
        self.num_actions = first.num_actions
        self.obs_kind = first.obs_kind
        self.obs_shape = tuple(first.obs_shape)
        self.obs_dtype = first.obs_dtype
        # One shared time limit: the members' largest.
        self.max_episode_steps = max(e.max_episode_steps for e in envs)
        self._obs_mask = first.obs_mask

    @property
    def obs_mask(self) -> float:
        return self._obs_mask

    def reset_env(self, generator, num_envs: int, device):
        domain = sharded_draw(
            generator, (num_envs,), lambda g, s: torch.randint(
                0, len(self.envs), s, generator=g, device=device,
                dtype=torch.int32))
        obs, inner = _select(domain, [
            e.reset_env(generator, num_envs, device) for e in self.envs
        ])
        return obs, MultiDomainState(domain=domain, inner=inner)

    def step_env(self, generator, state: MultiDomainState, action):
        obs, inner, reward, terminated, info = _select(state.domain, [
            e.step_env(generator, state.inner, action) for e in self.envs
        ])
        return (obs, MultiDomainState(domain=state.domain, inner=inner),
                reward, terminated, info)
