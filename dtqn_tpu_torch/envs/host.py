"""Host-side environment API (``dtqn_tpu/envs/host.py``): C-backed envs
that the device loop cannot absorb.

MiniHack (NetHack) and similar external engines run native host code per
step, so they cannot be batched tensor functions on the card.  The
reference steps ONE such env per Python-loop iteration
(run.py:356-377); the host loop (train/host_loop.py) keeps that boundary
but amortizes it over a vector of host envs stepped between device calls.

``HostEnvironment`` carries the static metadata of ``envs.core.Environment``
(a torch ``obs_dtype``, the port's ``ObsKind``, the mask, the vocabulary)
with numpy reset/step.  ``HostVecEnv`` layers gym-TimeLimit truncation and
auto-reset over a list of instances, with the terminated-vs-done split the
device path uses (run.py:371-374: truncation is not stored as done).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from dtqn_tpu_torch.envs.core import ObsKind


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (``torch.int32`` -> ``int32``)."""
    return torch.empty((), dtype=dtype).numpy().dtype


class HostEnvironment:
    """Base class for host-side (non-torch) environments.

    Static metadata as ``envs.core.Environment``; dynamics are plain
    numpy / python.  ``step`` returns the env's own termination only: the
    time limit is applied by ``HostVecEnv``.
    """

    name: str = "HostEnvironment"
    num_actions: int = 0
    max_episode_steps: int = 0
    obs_kind: ObsKind = ObsKind.DISCRETE
    obs_shape: Tuple[int, ...] = ()
    obs_dtype: torch.dtype = torch.int32

    @property
    def obs_mask(self) -> float:
        raise NotImplementedError

    @property
    def obs_vocab_size(self) -> int:
        if self.obs_kind != ObsKind.DISCRETE:
            raise ValueError("vocab size only defined for discrete obs")
        return int(self.obs_mask) + 1

    @property
    def is_discrete(self) -> bool:
        return self.obs_kind == ObsKind.DISCRETE

    def seed(self, seed: int) -> None:  # pragma: no cover - optional
        pass

    def reset(self) -> np.ndarray:
        raise NotImplementedError

    def step(
        self, action: int
    ) -> Tuple[np.ndarray, float, bool, Dict[str, Any]]:
        """Returns (obs, reward, terminated, info)."""
        raise NotImplementedError


class HostVecEnv:
    """A vector of host envs with TimeLimit + auto-reset bookkeeping.

    ``step`` returns everything the device's observe/reset path needs in
    one host round trip, as numpy arrays:
      next_obs    — the TRUE next observation (before the auto-reset)
      reward      — float32 [E]
      terminated  — env termination only (stored as buffer done)
      done        — terminated | time-limit truncation (drives resets)
      reset_obs   — observation after the auto-reset (next acting input)
      is_success  — info flag (run.py:232)
    """

    def __init__(self, envs: List[HostEnvironment]):
        if not envs:
            raise ValueError("need at least one env")
        self.envs = envs
        meta = envs[0]
        self.meta = meta
        self.num_envs = len(envs)
        # Steps of each env's current episode, for the time limit.
        self.episode_steps = np.zeros((self.num_envs,), np.int32)

    def reset_all(self) -> np.ndarray:
        self.episode_steps[:] = 0
        return np.stack([e.reset() for e in self.envs]).astype(
            numpy_dtype(self.meta.obs_dtype)
        )

    def step(self, actions: np.ndarray) -> Dict[str, np.ndarray]:
        e_count = self.num_envs
        next_obs = np.empty((e_count, *self.meta.obs_shape),
                            numpy_dtype(self.meta.obs_dtype))
        reset_obs = np.empty_like(next_obs)
        reward = np.zeros((e_count,), np.float32)
        terminated = np.zeros((e_count,), bool)
        done = np.zeros((e_count,), bool)
        success = np.zeros((e_count,), bool)
        for i, env in enumerate(self.envs):
            obs, r, term, info = env.step(int(actions[i]))
            self.episode_steps[i] += 1
            trunc = (not term) and (self.episode_steps[i]
                                    >= self.meta.max_episode_steps)
            next_obs[i] = obs
            reward[i] = r
            terminated[i] = term
            done[i] = term or trunc
            success[i] = bool(info.get("is_success", False))
            if done[i]:
                reset_obs[i] = env.reset()
                self.episode_steps[i] = 0
            else:
                reset_obs[i] = obs
        return {
            "next_obs": next_obs,
            "reward": reward,
            "terminated": terminated,
            "done": done,
            "reset_obs": reset_obs,
            "is_success": success,
        }
