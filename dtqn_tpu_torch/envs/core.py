"""Core environment API: batched pure-function POMDPs on the device.

Counterpart of ``dtqn_tpu/envs/core.py``.  Where the JAX package writes one
env and ``vmap``s it, here every function works on a batch dimension
written out: an env state is a dataclass of [E]-shaped tensors, and the
random draws come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Tuple

import torch


class ObsKind(enum.Enum):
    """Mirrors the reference's ObsType enum (utils/env_processing.py:59-62)."""

    DISCRETE = 0
    CONTINUOUS = 1
    IMAGE = 2


def batch_map(fn, trees):
    """``fn`` over the tensors at one place of several trees (dataclasses,
    named tuples, dicts) of one structure; other leaves come from the
    first tree."""
    first = trees[0]
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: batch_map(fn, [getattr(t, f.name) for t in trees])
            for f in dataclasses.fields(first)
        })
    if isinstance(first, dict):
        return {k: batch_map(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        items = [batch_map(fn, list(xs)) for xs in zip(*trees)]
        return type(first)(*items) if hasattr(first, "_fields") else tuple(items)
    return fn(trees) if isinstance(first, torch.Tensor) else first


def where_batch(cond: torch.Tensor, on_true, on_false):
    """Per-env select over tensors, or dataclasses or named tuples of
    tensors: cond is [E]."""

    def select(pair):
        t, f = pair
        return torch.where(
            cond.reshape(cond.shape + (1,) * (t.dim() - cond.dim())), t, f)

    return batch_map(select, [on_true, on_false])


def cat_batch(parts):
    """Batches of one structure, concatenated along the env axis."""
    return batch_map(torch.cat, parts)


def stack_batch(parts):
    """Trees of one structure, stacked along a new leading seed axis."""
    return batch_map(torch.stack, parts)


def per_seed(fn, generator, *batched):
    """``fn(generator, *batched)``.  With a list of S per-seed generators
    (a stacked run's envs, S blocks of E in one batch), ``fn`` runs once
    per seed on that seed's block of each batched argument, with that
    seed's generator, and the outputs are concatenated: each seed's envs
    draw what a run of its own draws."""
    if not isinstance(generator, list):
        return fn(generator, *batched)
    s = len(generator)
    outs = []
    for i, g in enumerate(generator):
        block = [batch_map(lambda xs: xs[0].chunk(s)[i], [b])
                 for b in batched]
        outs.append(fn(g, *block))
    return cat_batch(outs)


@dataclasses.dataclass
class Timestep:
    """One batched transition.

    ``terminated`` is a true environment termination; ``truncated`` is the
    time-limit cut.  ``done = terminated | truncated`` drives resets, while
    only ``terminated`` is stored as ``done`` in replay (run.py:371-374).
    """

    obs: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    info: Dict[str, torch.Tensor]

    @property
    def done(self) -> torch.Tensor:
        return self.terminated | self.truncated


class Environment:
    """Base class for batched environments.

    Subclasses implement ``reset_env`` and ``step_env`` over a batch; the
    time limit (gym-TimeLimit truncation) and auto-reset are layered on here.
    The state dataclass carries an int32 ``t`` counting steps this episode.
    """

    name: str = "Environment"
    num_actions: int = 0
    max_episode_steps: int = 0
    obs_kind: ObsKind = ObsKind.DISCRETE
    obs_shape: Tuple[int, ...] = ()
    obs_dtype: torch.dtype = torch.int32

    @property
    def obs_mask(self) -> float:
        """Padding sentinel for unseen observations."""
        raise NotImplementedError

    @property
    def obs_vocab_size(self) -> int:
        """Discrete token vocabulary including the mask token (= mask + 1)."""
        if self.obs_kind != ObsKind.DISCRETE:
            raise ValueError("vocab size only defined for discrete obs")
        return int(self.obs_mask) + 1

    @property
    def is_discrete(self) -> bool:
        return self.obs_kind == ObsKind.DISCRETE

    # ---- batched dynamics (override in subclasses) ----
    def reset_env(
        self, generator: torch.Generator, num_envs: int, device
    ) -> Tuple[torch.Tensor, Any]:
        """Returns (obs [E, ...], state) for ``num_envs`` fresh episodes."""
        raise NotImplementedError

    def step_env(
        self, generator: torch.Generator, state: Any, action: torch.Tensor
    ) -> Tuple[torch.Tensor, Any, torch.Tensor, torch.Tensor, Dict]:
        """Returns (obs, state, reward, terminated, info): no time limit."""
        raise NotImplementedError

    # ---- public API with time limit + auto-reset ----
    def step(self, generator, state, action):
        """Steps every env, applying the time limit; no auto-reset."""
        obs, new_state, reward, terminated, info = self.step_env(
            generator, state, action
        )
        terminated = terminated.to(torch.bool)
        truncated = (new_state.t >= self.max_episode_steps) & ~terminated
        ts = Timestep(
            obs=obs,
            reward=reward.to(torch.float32),
            terminated=terminated,
            truncated=truncated,
            info=info,
        )
        return obs, new_state, ts

    def step_autoreset(self, generator, state, action):
        """Steps every env and resets the finished ones in place.

        For a finished env the returned obs/state are the fresh episode's;
        the Timestep still reports the finished step, so the caller can
        record the transition before switching context.
        """
        obs, new_state, ts = self.step(generator, state, action)
        reset_obs, reset_state = self.reset_env(
            generator, obs.shape[0], obs.device
        )
        done = ts.done
        out_obs = where_batch(done, reset_obs, obs)
        out_state = where_batch(done, reset_state, new_state)
        return out_obs, out_state, ts

    # The JAX package's vectorized entry points; here the batch is native.
    def reset_vec(self, generator, num_envs: int, device):
        return self.reset_env(generator, num_envs, device)

    def step_vec(self, generator, state, action):
        return self.step_autoreset(generator, state, action)
