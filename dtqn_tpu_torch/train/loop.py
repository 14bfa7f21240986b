"""Rollout + learn loop and prepopulation (``dtqn_tpu/train/loop.py``).

One iteration steps E envs in lockstep, writes the transitions into the
device replay ring, and runs ``updates_per_iter`` gradient steps (the
reference's 1 update per env step is ``updates_per_iter == num_envs``).
The JAX package scans these loops under ``jit``; here they are Python loops
over device work that never reads a value back to the host.  The scan
knobs (``unroll``, ``outer_unroll``, ``presample``) have no counterpart,
and evaluation waits for the runner slice (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Callable

import torch

from dtqn_tpu_torch.agents.base import Agent, AgentState
from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule


def env_step(
    agent: Agent,
    state: AgentState,
    random_only: bool = False,
    count_steps: bool = True,
) -> AgentState:
    """One lockstep env step: act, step, observe, reset bookkeeping
    (run.py:356-377 + 293-296), in place.

    ``count_steps=False`` leaves ``env_steps`` untouched: prepopulation
    stores experience without consuming training budget.
    """
    cfg, env = agent.config, agent.env
    if random_only:
        # Prepopulation uses uniformly random actions (run.py:380-405).
        actions = torch.randint(
            0, env.num_actions, (cfg.num_envs,), generator=state.generator,
            device=agent.device,
        )
    else:
        actions = agent.select_actions(state, state.epsilon)

    obs, state.env_state, ts = env.step_vec(
        state.generator, state.env_state, actions
    )
    state.obs = obs
    # TimeLimit truncation is not stored as done (run.py:371-374); ts.obs
    # is the TRUE next observation (before the auto-reset).
    agent.observe(state, actions, ts.obs, ts.reward, ts.terminated)
    agent.handle_resets(state, ts.done, obs)
    if count_steps:
        state.env_steps = state.env_steps + cfg.num_envs
    return state


def make_train_chunk_fn(
    agent: Agent,
    eps_schedule: EpsilonSchedule,
    updates_per_iter: int,
    iters_per_chunk: int,
) -> Callable[[AgentState], AgentState]:
    """``train_chunk(state)``: ``iters_per_chunk`` iterations of E env steps
    and ``updates_per_iter`` gradient steps each, in place."""

    def train_chunk(state: AgentState) -> AgentState:
        for _ in range(iters_per_chunk):
            env_step(agent, state)
            for _ in range(updates_per_iter):
                agent.learn(state)
            state.epsilon = eps_schedule.anneal(
                state.epsilon, agent.config.num_envs
            )
        return state

    return train_chunk


def make_prepopulate_fn(
    agent: Agent, iters: int
) -> Callable[[AgentState], AgentState]:
    """Random-action buffer prepopulation (run.py:380-405), in place."""

    def prepopulate(state: AgentState) -> AgentState:
        for _ in range(iters):
            env_step(agent, state, random_only=True, count_steps=False)
        return state

    return prepopulate
