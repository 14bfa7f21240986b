"""Rollout + learn loop and prepopulation (``dtqn_tpu/train/loop.py``).

One iteration steps E envs in lockstep, writes the transitions into the
device replay ring, and runs ``updates_per_iter`` gradient steps (the
reference's 1 update per env step is ``updates_per_iter == num_envs``).
The ``_fn`` bodies are Python loops over device work that never reads a
value back to the host (evaluation reads one flag every
``EVAL_EXIT_CHECK_EVERY`` steps, to stop once every episode is over).  The
JAX package wraps them in ``jax.jit`` with donated buffers
(``dtqn_tpu/train/loop.py:163-209``); the port's counterparts,
``make_train_chunk`` and ``make_prepopulate``, capture one iteration as a
CUDA graph on the card and replay it (``utils/graphs.py``), so a chunk
dispatches nothing from Python after its first iteration.  The graph holds
an iteration's whole chain of updates, which is what JAX's ``unroll`` works
toward: ``--unroll`` and ``--outer-unroll`` are accepted and ignored, and
``presample`` has no counterpart.  On the CPU both return the ``_fn``
bodies.

Each function also takes a stacked state (``Agent.init_sweep_state``): the
envs of S seeds step as one batch, ``env.step_vec`` running once per seed
on its block with its generator (``envs.core.per_seed``), and an
evaluation runs ``eval_episodes`` episodes per seed and returns [S]
results.

An agent on a mesh (``parallel/mesh.py``) steps its rank's block of the
envs; ``env_steps`` still counts all ``num_envs`` of the run.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from dtqn_tpu_torch import replay
from dtqn_tpu_torch.agents.base import Agent, AgentState
from dtqn_tpu_torch.envs.core import Environment, per_seed, where_batch
from dtqn_tpu_torch.models import zero_carry
from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule
from dtqn_tpu_torch.utils.graphs import GraphedStep
from dtqn_tpu_torch.utils.rng import folded_draw, seed_count

# Evaluation freezes finished episodes and could run all max_episode_steps
# steps without a host read, as the JAX scan does.  Reading
# ``finished.all()`` every this many steps lets it stop early with the same
# results; 0 never reads.
EVAL_EXIT_CHECK_EVERY = 10


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
    generator = agent.rank_generator(state.generator)
    if random_only:
        # Prepopulation uses uniformly random actions (run.py:380-405) and
        # leaves the act-time carry as it is.
        actions = folded_draw(
            generator, state.obs.shape[0], lambda g, n: torch.randint(
                0, env.num_actions, (n,), generator=g, device=agent.device))
    else:
        actions, state.carry = agent.select_actions(state, state.epsilon)

    obs, state.env_state, ts = per_seed(
        env.step_vec, generator, state.env_state, actions
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


def make_train_chunk(
    agent: Agent,
    eps_schedule: EpsilonSchedule,
    updates_per_iter: int,
    iters_per_chunk: int,
) -> Callable[[AgentState], AgentState]:
    """The compiled ``train_chunk`` (``dtqn_tpu/train/loop.py:163``): on the
    card a ``GraphedStep`` whose unit is one iteration (``env_step``, then
    ``updates_per_iter`` calls of ``learn``, then the epsilon anneal: the
    body of JAX's outer scan, its inner scan of updates fully unrolled),
    captured at its first call on a state and replayed ``iters_per_chunk``
    times per call; on the CPU ``make_train_chunk_fn``'s body.

    Three device loops stay eager: an agent on a mesh of several ranks
    (``parallel/mesh.py:make_distributed_train_chunk``: the gloo
    all-reduces are host calls, which a graph cannot hold, and the NCCL
    path has not run), the host loop (``train/host_loop.py``: host envs
    step between device calls) and evaluation (``make_evaluate_fn``: each
    call takes a fresh generator, and it reads one host flag every
    ``EVAL_EXIT_CHECK_EVERY`` steps)."""
    if agent.device.type != "cuda":
        return make_train_chunk_fn(agent, eps_schedule, updates_per_iter,
                                   iters_per_chunk)
    iteration = make_train_chunk_fn(agent, eps_schedule, updates_per_iter, 1)
    return GraphedStep("train_chunk iteration", iteration, agent,
                       iters_per_chunk)


def make_prepopulate(
    agent: Agent, iters: int
) -> Callable[[AgentState], AgentState]:
    """The compiled ``prepopulate`` (``dtqn_tpu/train/loop.py:205``): on the
    card one random-action ``env_step`` captured as a CUDA graph and
    replayed ``iters`` times; on the CPU ``make_prepopulate_fn``'s body."""
    if agent.device.type != "cuda":
        return make_prepopulate_fn(agent, iters)
    return GraphedStep("prepopulation step", make_prepopulate_fn(agent, 1),
                       agent, iters)


def make_evaluate_fn(
    agent: Agent, eval_env: Environment, eval_episodes: int
) -> Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Greedy-policy evaluation (run.py:187-243): ``evaluate(network,
    generator)`` runs ``eval_episodes`` parallel episodes on fresh contexts
    (and zero carries for the recurrent models) and returns (success_rate,
    mean_return, mean_ep_len) as device scalars.
    ``generator`` (on the agent's device) supplies every draw, so the
    training stream is left alone.  With a ``StackedNetwork`` and one
    generator per seed, each seed plays ``eval_episodes`` episodes of its
    own and the results are [S]."""
    cfg = agent.config
    n = eval_episodes
    max_steps = eval_env.max_episode_steps

    @torch.no_grad()
    def evaluate(network, generator):
        device = agent.device
        seeds = seed_count(generator)
        total = seeds * n
        obs, env_state = per_seed(
            lambda g: eval_env.reset_vec(g, n, device), generator)
        context = replay.init_context(
            generator, total, cfg.context_len, tuple(eval_env.obs_shape),
            eval_env.obs_dtype, eval_env.obs_mask, eval_env.num_actions, obs,
        )
        bag = (
            replay.init_bag(
                total, cfg.bag_size, tuple(eval_env.obs_shape),
                eval_env.obs_dtype, eval_env.obs_mask, device,
            )
            if agent.use_bag
            else None
        )
        carry = (zero_carry(total, cfg.inner_embed, device)
                 if cfg.kind == "recurrent" else None)
        finished = torch.zeros((total,), dtype=torch.bool, device=device)
        ep_reward = torch.zeros((total,), dtype=torch.float32, device=device)
        ep_len = torch.zeros((total,), dtype=torch.int32, device=device)
        success = torch.zeros((total,), dtype=torch.bool, device=device)

        for t in range(max_steps):
            actions, carry_t = agent.greedy_actions(network, context, bag,
                                                    carry, obs)
            obs_t, env_state_t, ts = per_seed(eval_env.step, generator,
                                              env_state, actions)
            live = ~finished
            ep_reward = ep_reward + ts.reward * live
            done_now = live & ts.done
            # success = is_success flag or positive return (run.py:232)
            succ = ts.info["is_success"] | (ep_reward > 0)
            context_t, ev_obs, ev_act, was_full = replay.add_transition(
                context, ts.obs, actions, ts.reward, ts.terminated
            )
            if agent.use_bag:
                # The evaluation's bag keeps the add/evict policy
                # (dtqn.py:116-157).
                need = was_full & live
                ev_idx = context_t.timestep - cfg.context_len
                bag_t, accepted = replay.bag_add(
                    bag, ev_obs, ev_act, ev_idx, need
                )
                bag_t = agent._bag_evict(
                    network, context_t, bag_t, ev_obs, ev_act, ev_idx,
                    need & ~accepted,
                )
                bag = where_batch(live, bag_t, bag)
            # Finished episodes stay frozen; live ones advance.
            context = where_batch(live, context_t, context)
            env_state = where_batch(live, env_state_t, env_state)
            obs = where_batch(live, obs_t, obs)
            if carry is not None:
                carry = where_batch(live, carry_t, carry)
            finished = finished | ts.done
            ep_len = ep_len + live.to(torch.int32)
            success = torch.where(done_now, succ, success)
            if (EVAL_EXIT_CHECK_EVERY and (t + 1) % EVAL_EXIT_CHECK_EVERY == 0
                    and bool(finished.all())):
                break

        episodes = max(n, 1)
        if isinstance(generator, torch.Generator):
            return (
                success.sum() / episodes,
                ep_reward.sum() / episodes,
                ep_len.sum() / episodes,
            )
        return tuple(x.reshape(seeds, n).sum(-1) / episodes
                     for x in (success, ep_reward, ep_len))

    return evaluate
