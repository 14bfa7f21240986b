"""Host-loop training (``dtqn_tpu/train/host_loop.py``): C-backed host envs
and a learner on the card.

MiniHack (and any ``HostEnvironment``) steps native host code, so the
device loop (train/loop.py) cannot absorb it.  This runner keeps the
reference's execution shape, host env steps with a device forward per step
(run.py:287-298, envs/mini_hack.py:21-76), but steps E host envs per
iteration and keeps everything else on the device: epsilon-greedy acting,
context and bag upkeep, the replay ring, DDQN learning and the
diagnostics.

One iteration crosses the host/device boundary twice: one device-to-host
copy of the actions [E] (``actions_to_host``), the host step, then one
host-to-device copy of each array of the step (``step_to_device``).  The
host reads no other device value inside an iteration; ``env_steps`` and
``nonfinite_grads`` are read once per chunk, as in the JAX package.

Evaluation runs ``eval_episodes`` host envs with greedy device acting
(run.py:187-243; success = is_success flag or positive return).  As the
JAX package's host evaluation, and unlike ``train/loop.make_evaluate_fn``,
the contexts of finished episodes keep rolling (their metrics are frozen
on the host), and the host reads its own ``finished`` flags every step.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from dtqn_tpu_torch import replay
from dtqn_tpu_torch.agents import Agent
from dtqn_tpu_torch.agents.base import AgentState
from dtqn_tpu_torch.config import ExperimentConfig
from dtqn_tpu_torch.envs.host import HostEnvironment, HostVecEnv
from dtqn_tpu_torch.models import zero_carry
from dtqn_tpu_torch.utils import checkpoint as ckpt
from dtqn_tpu_torch.utils.device import resolve_device
from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule
from dtqn_tpu_torch.utils.logging import get_logger, timestamp
from dtqn_tpu_torch.utils.rng import seed_everything

# The arrays of a host step that the device's observe/reset path takes.
STEP_KEYS = ("next_obs", "reward", "terminated", "done", "reset_obs")


def actions_to_host(actions: torch.Tensor) -> np.ndarray:
    """The device-to-host copy of an iteration: the actions [E]."""
    return actions.cpu().numpy()


def step_to_device(out: Dict[str, np.ndarray], device) -> List[torch.Tensor]:
    """The host-to-device copies of an iteration: each of ``STEP_KEYS``'s
    arrays of the host step ``out``."""
    return [torch.as_tensor(out[k], device=device) for k in STEP_KEYS]


def make_host_fns(agent: Agent, eps: EpsilonSchedule, updates_per_iter: int):
    """The device halves of the host loop: ``act(state)`` and
    ``act_random(state)`` return actions [E]; ``observe_only(state,
    actions, *step)`` and ``observe_and_learn(state, actions, *step)``
    (``step``: the device arrays of ``STEP_KEYS``) store the step.  All
    update ``state`` in place."""
    cfg = agent.config

    def act(state: AgentState) -> torch.Tensor:
        actions, state.carry = agent.select_actions(state, state.epsilon)
        return actions

    def act_random(state: AgentState) -> torch.Tensor:
        return torch.randint(0, agent.env.num_actions, (cfg.num_envs,),
                             generator=state.generator, device=agent.device)

    def observe_only(state, actions, next_obs, reward, terminated, done,
                     reset_obs):
        # Prepopulation stores without learning or counting env_steps
        # (run.py:380-405).
        agent.observe(state, actions, next_obs, reward, terminated)
        agent.handle_resets(state, done, reset_obs)
        state.obs = reset_obs
        return state

    def observe_and_learn(state, *step):
        observe_only(state, *step)
        for _ in range(updates_per_iter):
            agent.learn(state)
        state.epsilon = eps.anneal(state.epsilon, cfg.num_envs)
        state.env_steps = state.env_steps + cfg.num_envs
        return state

    return act, act_random, observe_only, observe_and_learn


def host_iteration(vec: HostVecEnv, state: AgentState, act_fn, update_fn):
    """One iteration: act on the device, step the host envs, store the step
    on the device (the host/device boundary of the module docstring)."""
    actions = act_fn(state)
    out = vec.step(actions_to_host(actions))
    return update_fn(state, actions, *step_to_device(out, actions.device))


def make_host_eval(agent: Agent, meta: HostEnvironment, n: int):
    """The device halves of host-side greedy evaluation over n envs:
    ``eval_init(generator, obs)`` -> (context, bag, carry), ``greedy``
    (``agent.greedy_actions``) and ``eval_observe(network, context, bag,
    next_obs, actions, reward, terminated, live)`` -> (context, bag)."""
    cfg, device = agent.config, agent.device

    def eval_init(generator, obs):
        context = replay.init_context(
            generator, n, cfg.context_len, tuple(meta.obs_shape),
            meta.obs_dtype, meta.obs_mask, meta.num_actions, obs,
        )
        bag = (
            replay.init_bag(n, cfg.bag_size, tuple(meta.obs_shape),
                            meta.obs_dtype, meta.obs_mask, device)
            if agent.use_bag
            else None
        )
        carry = (zero_carry(n, cfg.inner_embed, device)
                 if cfg.kind == "recurrent" else None)
        return context, bag, carry

    @torch.no_grad()
    def eval_observe(network, context, bag, next_obs, actions, reward,
                     terminated, live):
        context, ev_obs, ev_act, was_full = replay.add_transition(
            context, next_obs, actions, reward, terminated
        )
        if agent.use_bag:
            need = was_full & live
            ev_idx = context.timestep - cfg.context_len
            bag, accepted = replay.bag_add(bag, ev_obs, ev_act, ev_idx, need)
            bag = agent._bag_evict(network, context, bag, ev_obs, ev_act,
                                   ev_idx, need & ~accepted)
        return context, bag

    return eval_init, agent.greedy_actions, eval_observe


def evaluate_host(
    agent: Agent,
    network,
    make_one_env: Callable[[], HostEnvironment],
    n_episodes: int,
    generator: torch.Generator,
):
    """``n_episodes`` greedy host episodes (run.py:187-243): (success rate,
    mean return, mean length) as host floats.  ``generator`` (on the
    agent's device) draws the contexts' random actions."""
    vec = HostVecEnv([make_one_env() for _ in range(n_episodes)])
    meta, device = vec.meta, agent.device
    eval_init, greedy, eval_observe = make_host_eval(agent, meta, n_episodes)

    def to_device(x):
        return torch.as_tensor(x, device=device)

    obs = to_device(vec.reset_all())
    context, bag, carry = eval_init(generator, obs)
    finished = np.zeros((n_episodes,), bool)
    ep_reward = np.zeros((n_episodes,), np.float64)
    ep_len = np.zeros((n_episodes,), np.int64)
    success = np.zeros((n_episodes,), bool)

    for _ in range(meta.max_episode_steps):
        actions, carry = greedy(network, context, bag, carry, obs)
        out = vec.step(actions_to_host(actions))
        live = ~finished
        ep_reward[live] += out["reward"][live]
        ep_len[live] += 1
        done_now = live & out["done"]
        success[done_now] = (
            out["is_success"][done_now]
            | (ep_reward[done_now] > 0)  # run.py:232
        )
        context, bag = eval_observe(
            network, context, bag, to_device(out["next_obs"]), actions,
            to_device(out["reward"]), to_device(out["terminated"]),
            to_device(live),
        )
        finished |= out["done"]
        # Contexts of finished episodes keep rolling harmlessly; their
        # metrics are frozen above.
        obs = to_device(out["reset_obs"])
        if finished.all():
            break

    n = max(n_episodes, 1)
    return success.sum() / n, ep_reward.sum() / n, ep_len.sum() / n


def run_host_experiment(
    config: ExperimentConfig,
    env_factory: Optional[Callable[[str], HostEnvironment]] = None,
) -> dict:
    """Train on host environments (MH-* domains) per the config, on
    ``config.device`` (the card unless the config says ``cpu``).

    ``env_factory(name)`` defaults to the MiniHack adapter; injectable so
    the loop runs without the external package.  One domain per run, on
    one device: ``--dp-devices`` above 1 raises ``ValueError``.
    """
    start_time = time.time()
    if env_factory is None:
        from dtqn_tpu_torch.envs.minihack import make_host_env as env_factory

    if len(config.envs) != 1:
        raise ValueError(
            "host-loop training supports one domain per run "
            f"(got {config.envs})"
        )
    if config.dp_devices > 1:
        # The JAX host loop runs on one device and ignores the flag.
        raise ValueError(
            "--dp-devices applies to the device loop; the host loop runs on "
            "one device (ROADMAP.md: differences kept on purpose)"
        )
    device = resolve_device(config.device)
    name = config.envs[0]

    envs = [env_factory(name) for _ in range(config.num_envs)]
    for i, e in enumerate(envs):
        e.seed(config.seed + i)
    vec = HostVecEnv(envs)
    meta = vec.meta
    if config.max_episode_steps > 0:
        meta.max_episode_steps = config.max_episode_steps

    agent = Agent(config.agent_config(), meta, device=device)
    eps = EpsilonSchedule(1.0, 0.1, max(config.num_steps // 10, 1))

    obs0 = vec.reset_all()
    state = agent.init_state(seed_everything(config.seed), obs0)

    os.makedirs(config.policy_dir(), exist_ok=True)
    policy_path = config.policy_path()
    if config.verbose:
        print(
            f"[ {timestamp()} ] Creating {config.model} with "
            f"{state.params.numel()} parameters (host loop: {name})"
        )

    act, act_random, observe_only, observe_and_learn = make_host_fns(
        agent, eps, config.resolved_updates_per_iter
    )

    # Resume-or-prepopulate (run.py:471-495).
    mini = ckpt.load_mini_checkpoint(policy_path)
    wandb_kwargs = {}
    if mini is not None and mini["step"] >= config.num_steps:
        print(f"Found completed run ({mini['step']} steps); nothing to do.")
        return {"completed": True, "step": mini["step"]}
    if mini is not None and ckpt.has_checkpoint(policy_path):
        # The host envs' state is not in the checkpoint: they were reset
        # above, and the saved contexts and ring rows continue over fresh
        # episodes, as in the JAX package.  Their time limits count on from
        # the rows' write positions, so that no episode outgrows its ring
        # row (the JAX package's scatter drops the writes past a row's end;
        # an index past it raises here).
        state, _ = ckpt.load_checkpoint(policy_path, state)
        vec.episode_steps[:] = state.buffer.write_pos.cpu().numpy()
        wandb_kwargs = {"resume": "must", "id": mini.get("wandb_id")}
        print(f"Resumed from checkpoint at {int(state.env_steps)} steps.")
    else:
        for _ in range(max(config.prepop_steps // config.num_envs, 1)):
            host_iteration(vec, state, act_random, observe_only)

    logger = get_logger(policy_path, config, wandb_kwargs)
    wandb_id = getattr(getattr(logger, "run", None), "id", None)

    iters_per_chunk = config.resolved_iters_per_chunk
    time_budget = config.time_limit * 3600 if config.time_limit else None
    last_policy_save = int(state.env_steps)
    final_log = {}

    while int(state.env_steps) < config.num_steps:
        for _ in range(iters_per_chunk):
            host_iteration(vec, state, act, observe_and_learn)
        step = int(state.env_steps)
        hours = (time.time() - start_time) / 3600

        if int(state.nonfinite_grads) > 0:
            raise FloatingPointError(
                f"{int(state.nonfinite_grads)} non-finite gradient steps"
            )

        # The evaluation draws from a generator of its own, seeded by one
        # draw from the train stream (train/runner.py).
        eval_seed = int(torch.randint(
            0, 2**31 - 1, (), generator=state.generator, device=device
        ))
        sr, ret, ln = evaluate_host(
            agent, state.network, lambda: env_factory(name),
            config.eval_episodes,
            torch.Generator(device=device).manual_seed(eval_seed),
        )
        log_vals = {
            **{k: float(v) for k, v in state.diagnostics.means().items()},
            "losses/hours": hours,
            f"{name}/SuccessRate": float(sr),
            f"{name}/Return": float(ret),
            f"{name}/EpisodeLength": float(ln),
        }
        logger.log(log_vals, step=step)
        final_log = log_vals

        if config.verbose:
            print(
                f"[ {timestamp()} ] Steps: {step}, Env: {name}, "
                f"Success Rate: {sr:.2f}, Return: {ret:.2f}, "
                f"Episode Length: {ln:.2f}, Hours: {hours:.2f}"
            )

        if config.save_policy and step - last_policy_save >= 50_000:
            ckpt.save_policy(policy_path, state.network)
            last_policy_save = step

        if time_budget and time.time() - start_time >= time_budget:
            print(f"Reached time limit. Saving checkpoint at {step} steps.")
            ckpt.save_checkpoint(policy_path, state)
            ckpt.save_mini_checkpoint(policy_path, step, wandb_id)
            return final_log

    ckpt.save_mini_checkpoint(policy_path, int(state.env_steps), wandb_id)
    if config.save_policy:
        ckpt.save_policy(policy_path, state.network)
    return final_log
