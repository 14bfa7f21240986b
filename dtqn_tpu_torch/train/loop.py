"""Rollout + learn loop, prepopulation and evaluation
(``dtqn_tpu/train/loop.py``).

One iteration steps E envs in lockstep, writes the transitions into the
device replay ring, and runs ``updates_per_iter`` gradient steps (the
reference's 1 update per env step is ``updates_per_iter == num_envs``).
The ``_fn`` bodies are Python loops over device work that never reads a
value back to the host (evaluation reads one flag every
``EVAL_EXIT_CHECK_EVERY`` steps, to stop once every episode is over).  The
JAX package wraps them in ``jax.jit`` with donated buffers
(``dtqn_tpu/train/loop.py:163-209``, ``:325``); the port's counterparts,
``make_train_chunk``, ``make_prepopulate`` and ``make_evaluate``, capture
their steps as CUDA graphs on the card and replay them
(``utils/graphs.py``): a chunk dispatches nothing from Python after its
first iteration, and an evaluation replays a reset and blocks of env steps
with one host read between blocks.  The graph holds an iteration's whole
chain of updates, which is what JAX's ``unroll`` works toward:
``--unroll`` and ``--outer-unroll`` are accepted and ignored, and
``presample`` has no counterpart.  On the CPU the three return the ``_fn``
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

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from dtqn_tpu_torch import replay
from dtqn_tpu_torch.agents.base import Agent, AgentState
from dtqn_tpu_torch.envs.core import Environment, per_seed, where_batch
from dtqn_tpu_torch.models import LSTMCarry, zero_carry
from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule
from dtqn_tpu_torch.utils.graphs import (
    GraphedStep,
    copy_states,
    fresh_buffers,
    own_generators,
    write_back,
)
from dtqn_tpu_torch.utils.profiling import phase
from dtqn_tpu_torch.utils.rng import folded_draw, seed_count

# Evaluation freezes finished episodes and could run all max_episode_steps
# steps without a host read, as the JAX scan does.  Reading
# ``finished.all()`` every this many steps lets it stop early with the same
# results; 0 never reads.
EVAL_EXIT_CHECK_EVERY = 10
# The env steps of one graphed evaluation block when no flag is read.
EVAL_BLOCK_STEPS = 10


def env_step(
    agent: Agent,
    state: AgentState,
    random_only: bool = False,
    count_steps: bool = True,
) -> AgentState:
    """One lockstep env step: act, step, observe, reset bookkeeping
    (run.py:356-377 + 293-296), in place.

    ``count_steps=False`` leaves ``env_steps`` untouched: prepopulation
    stores experience without consuming training budget.  Its phases
    (``utils/profiling.py``): ``act``, ``env``, then ``observe``'s and
    ``handle_resets``'.
    """
    cfg, env = agent.config, agent.env
    generator = agent.rank_generator(state.generator)
    with phase("act"):
        if random_only:
            # Prepopulation uses uniformly random actions (run.py:380-405)
            # and leaves the act-time carry as it is.
            actions = folded_draw(
                generator, state.obs.shape[0], lambda g, n: torch.randint(
                    0, env.num_actions, (n,), generator=g,
                    device=agent.device))
        else:
            actions, state.carry = agent.select_actions(state,
                                                        state.epsilon)

    with phase("env"):
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

    One device loop stays eager: an agent on a mesh of several ranks
    (``parallel/mesh.py:make_distributed_train_chunk``: the gloo
    all-reduces are host calls, which a graph cannot hold, and the NCCL
    path has not run).  The host loop graphs its device halves
    (``train/host_loop.py``) and evaluation its blocks
    (``make_evaluate``)."""
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


@dataclasses.dataclass
class EvalCarry:
    """An evaluation's loop-carried state: the episodes' envs, contexts,
    bags and carries, and their running results.  ``network`` and
    ``generator`` are what it reads: the network evaluated, and the
    generator (one, or one per seed) that every draw comes from."""

    network: Any
    generator: Any
    obs: Optional[torch.Tensor] = None
    env_state: Any = None
    context: Optional[replay.ContextState] = None
    bag: Optional[replay.BagState] = None
    carry: Optional[LSTMCarry] = None
    finished: Optional[torch.Tensor] = None  # [S*n] bool
    ep_reward: Optional[torch.Tensor] = None  # [S*n] float32
    ep_len: Optional[torch.Tensor] = None  # [S*n] int32
    success: Optional[torch.Tensor] = None  # [S*n] bool


def make_eval_steps(agent: Agent, eval_env: Environment, n: int):
    """The body of an evaluation of ``n`` episodes (per seed) as two steps
    over an ``EvalCarry``, in place: ``reset(c)`` starts the episodes from
    ``c.generator``'s draws, and ``steps(k)`` is the step that plays ``k``
    greedy env steps of every episode, finished ones frozen."""
    cfg = agent.config

    @torch.no_grad()
    def reset(c: EvalCarry) -> EvalCarry:
        device = agent.device
        total = seed_count(c.generator) * n
        c.obs, c.env_state = per_seed(
            lambda g: eval_env.reset_vec(g, n, device), c.generator)
        c.context = replay.init_context(
            c.generator, total, cfg.context_len, tuple(eval_env.obs_shape),
            eval_env.obs_dtype, eval_env.obs_mask, eval_env.num_actions,
            c.obs,
        )
        c.bag = (
            replay.init_bag(
                total, cfg.bag_size, tuple(eval_env.obs_shape),
                eval_env.obs_dtype, eval_env.obs_mask, device,
            )
            if agent.use_bag
            else None
        )
        c.carry = (zero_carry(total, cfg.inner_embed, device)
                   if cfg.kind == "recurrent" else None)
        c.finished = torch.zeros((total,), dtype=torch.bool, device=device)
        c.ep_reward = torch.zeros((total,), dtype=torch.float32,
                                  device=device)
        c.ep_len = torch.zeros((total,), dtype=torch.int32, device=device)
        c.success = torch.zeros((total,), dtype=torch.bool, device=device)
        return c

    @torch.no_grad()
    def one_step(c: EvalCarry) -> None:
        with phase("act"):
            actions, carry_t = agent.greedy_actions(
                c.network, c.context, c.bag, c.carry, c.obs)
        with phase("env"):
            obs_t, env_state_t, ts = per_seed(eval_env.step, c.generator,
                                              c.env_state, actions)
        live = ~c.finished
        c.ep_reward = c.ep_reward + ts.reward * live
        done_now = live & ts.done
        # success = is_success flag or positive return (run.py:232)
        succ = ts.info["is_success"] | (c.ep_reward > 0)
        with phase("replay_write"):
            context_t, ev_obs, ev_act, was_full = replay.add_transition(
                c.context, ts.obs, actions, ts.reward, ts.terminated
            )
        if agent.use_bag:
            # The evaluation's bag keeps the add/evict policy
            # (dtqn.py:116-157).
            with phase("evict"):
                need = was_full & live
                ev_idx = context_t.timestep - cfg.context_len
                bag_t, accepted = replay.bag_add(
                    c.bag, ev_obs, ev_act, ev_idx, need
                )
                bag_t = agent._bag_evict(
                    c.network, context_t, bag_t, ev_obs, ev_act, ev_idx,
                    need & ~accepted,
                )
                c.bag = where_batch(live, bag_t, c.bag)
        # Finished episodes stay frozen; live ones advance.
        c.context = where_batch(live, context_t, c.context)
        c.env_state = where_batch(live, env_state_t, c.env_state)
        c.obs = where_batch(live, obs_t, c.obs)
        if c.carry is not None:
            c.carry = where_batch(live, carry_t, c.carry)
        c.finished = c.finished | ts.done
        c.ep_len = c.ep_len + live.to(torch.int32)
        c.success = torch.where(done_now, succ, c.success)

    def steps(k: int):
        def run(c: EvalCarry) -> EvalCarry:
            for _ in range(k):
                one_step(c)
            return c

        return run

    return reset, steps


def eval_results(c: EvalCarry, n: int):
    """(success_rate, mean_return, mean_ep_len) of an evaluation's carry:
    device scalars for one generator, [S] for one per seed."""
    episodes = max(n, 1)
    if isinstance(c.generator, torch.Generator):
        return (
            c.success.sum() / episodes,
            c.ep_reward.sum() / episodes,
            c.ep_len.sum() / episodes,
        )
    seeds = seed_count(c.generator)
    return tuple(x.reshape(seeds, n).sum(-1) / episodes
                 for x in (c.success, c.ep_reward, c.ep_len))


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
    max_steps = eval_env.max_episode_steps
    reset, steps = make_eval_steps(agent, eval_env, eval_episodes)
    one_step = steps(1)

    def evaluate(network, generator):
        c = reset(EvalCarry(network, generator))
        for t in range(max_steps):
            one_step(c)
            if (EVAL_EXIT_CHECK_EVERY and (t + 1) % EVAL_EXIT_CHECK_EVERY == 0
                    and bool(c.finished.all())):
                break
        return eval_results(c, eval_episodes)

    return evaluate


class BlockedEvaluation:
    """``make_evaluate_fn``'s evaluation as steps over one ``EvalCarry``
    whose leaves stay put: the reset, then blocks of
    ``EVAL_EXIT_CHECK_EVERY`` env steps (``EVAL_BLOCK_STEPS`` when it is 0)
    and a last block of the cap's remainder, with ``finished.all()`` read
    on the host after each full block, where the plain loop reads it.
    ``graphed`` makes each step a ``GraphedStep`` (the reset and each block
    length a graph of its own); else each is ``write_back`` of the step,
    which the CPU tests hold against the plain loop.

    The steps draw from generators of their own (``own_generators``,
    registered with the graphs): each call loads the caller's generators'
    states into them, and copies the end states back.  The results and the
    caller's generators end as the plain evaluation leaves them."""

    def __init__(self, agent: Agent, eval_env: Environment,
                 eval_episodes: int, graphed: bool):
        self.agent = agent
        self.n = eval_episodes
        self.max_steps = eval_env.max_episode_steps
        self.graphed = graphed
        self.reset_step, self.steps = make_eval_steps(agent, eval_env,
                                                      eval_episodes)
        self.carry: Optional[EvalCarry] = None
        self.compiled: Dict[Any, Callable] = {}

    def _compiled(self, key, step, name: str):
        if key not in self.compiled:
            self.compiled[key] = (
                GraphedStep(name, step, self.agent, 1) if self.graphed
                else write_back(step))
        return self.compiled[key]

    def _block(self, k: int):
        return self._compiled(k, self.steps(k), f"evaluation block of {k}")

    def __call__(self, network, generator):
        c = self.carry
        if c is None or seed_count(c.generator) != seed_count(generator):
            # The buffers: one eager reset, outside any capture.
            c = EvalCarry(network, own_generators(generator,
                                                  self.agent.device))
            copy_states(generator, c.generator)
            self.carry = fresh_buffers(self.reset_step(c))
        c.network = network
        copy_states(generator, c.generator)
        self._compiled("reset", self.reset_step, "evaluation reset")(c)
        every = EVAL_EXIT_CHECK_EVERY
        full, rest = divmod(self.max_steps, every or EVAL_BLOCK_STEPS)
        for _ in range(full):
            self._block(every or EVAL_BLOCK_STEPS)(c)
            if every and bool(c.finished.all()):
                break
        else:
            if rest:
                self._block(rest)(c)
        copy_states(c.generator, generator)
        return eval_results(c, self.n)


def make_evaluate(
    agent: Agent, eval_env: Environment, eval_episodes: int
) -> Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The compiled evaluation (``dtqn_tpu/train/loop.py:325``, and the
    sweep's ``jax.jit(jax.vmap(...))``): on the card a
    ``BlockedEvaluation`` whose reset and blocks replay CUDA graphs; on the
    CPU ``make_evaluate_fn``'s body.  Called as ``make_evaluate_fn``'s
    evaluation is, with the same results and generators' end states."""
    if agent.device.type != "cuda":
        return make_evaluate_fn(agent, eval_env, eval_episodes)
    return BlockedEvaluation(agent, eval_env, eval_episodes, graphed=True)
