"""Stacked multi-seed training: N seeds at once on one GPU
(``dtqn_tpu/train/sweep.py``).

The reference's curves average seeds 1-5, run as separate processes.  The
JAX package stacks the N ``AgentState``s along a leading seed axis and
``vmap``s the whole train chunk over it.  Here ``Agent.init_sweep_state``
stacks them: the networks run once for every seed (``models/stacked.py``),
the envs, contexts and replay rows of all seeds are one batch, and each
dispatched operation of the update serves every seed.  The eager port is
host-bound, so a loop over seeds would cost N times one seed; the stack
costs each operation once.

Each seed draws from a generator of its own, seeded as its single-seed run
seeds it, in that run's order: seed i of a sweep follows the run with
``--seed i`` up to the rounding of batched arithmetic, as ``jax.vmap`` over
per-seed keys gives the JAX package.

Host-side bookkeeping stays per seed: one CSV logger and one policy path
per seed (those a single-seed run uses), per-seed policy snapshots, each
loadable by a single network.  Checkpoint and resume use one stacked
checkpoint keyed by the seed list (``sweep_path``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Sequence

import torch

from dtqn_tpu_torch.agents import Agent
from dtqn_tpu_torch.config import ExperimentConfig
from dtqn_tpu_torch.train.loop import (
    make_evaluate,
    make_prepopulate,
    make_train_chunk,
)
from dtqn_tpu_torch.train.runner import build_envs
from dtqn_tpu_torch.utils import checkpoint as ckpt
from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule
from dtqn_tpu_torch.utils.logging import CSVLogger, timestamp
from dtqn_tpu_torch.utils.profiling import trace_chunks, tracing_on
from dtqn_tpu_torch.utils.rng import seed_everything


def sweep_path(config: ExperimentConfig, seeds: Sequence[int]) -> str:
    """Checkpoint key for the stacked sweep state."""
    tag = "-".join(str(s) for s in seeds)
    return config.policy_path() + f"_sweep{tag}"


def _save_policies(seed_cfgs, state) -> None:
    for i, c in enumerate(seed_cfgs):
        ckpt.save_policy(c.policy_path(), state.network.seed_state_dict(i))


def run_sweep(config: ExperimentConfig, seeds: Sequence[int]) -> dict:
    """Trains all ``seeds`` at once on ``config.device`` (the card unless
    the config says ``cpu``); returns {seed: final metrics}, or
    {"completed": True, "step": ...} for a sweep that had finished.  With
    ``--profile-dir`` tracing is on for the sweep, as in the runner."""
    with tracing_on(bool(config.profile_dir)):
        return _sweep(config, seeds)


def _sweep(config: ExperimentConfig, seeds: Sequence[int]) -> dict:
    start_time = time.time()
    if config.dp_devices > 1:
        # The JAX sweep runs on one device and ignores the flag.
        raise ValueError(
            "--dp-devices applies to one seed's run; a sweep over several "
            "seeds runs on one device (ROADMAP.md: differences kept on "
            "purpose)"
        )
    seeds = list(seeds)

    env, eval_envs = build_envs(config)
    if config.max_episode_steps > 0:
        env.max_episode_steps = config.max_episode_steps
        for e in eval_envs:
            e.max_episode_steps = config.max_episode_steps

    agent = Agent(config.agent_config(), env, device=config.device)
    device = agent.device
    eps = EpsilonSchedule(
        1.0, config.eps_min, max(config.num_steps // 10, 1)
    )
    state = agent.init_sweep_state([seed_everything(s) for s in seeds])

    # Per-seed host artifacts: the paths a single-seed run uses.
    seed_cfgs = [dataclasses.replace(config, seed=s) for s in seeds]
    os.makedirs(config.policy_dir(), exist_ok=True)
    loggers = [CSVLogger(c.policy_path(), c.envs) for c in seed_cfgs]

    if config.verbose:
        print(
            f"[ {timestamp()} ] Sweep over seeds {seeds}: {config.model}, "
            f"{state.params.shape[1]} parameters per seed"
        )

    ck_path = sweep_path(config, seeds)
    mini = ckpt.load_mini_checkpoint(ck_path)
    if mini is not None and mini["step"] >= config.num_steps:
        print(f"Found completed sweep ({mini['step']} steps); nothing to do.")
        return {"completed": True, "step": mini["step"]}
    if mini is not None and ckpt.has_checkpoint(ck_path):
        state, _ = ckpt.load_checkpoint(ck_path, state)
        print(f"Resumed sweep at {int(state.env_steps[0])} steps.")
    else:
        prepop_iters = max(config.prepop_steps // config.num_envs, 1)
        state = make_prepopulate(agent, prepop_iters)(state)

    chunk = make_train_chunk(
        agent,
        eps,
        config.resolved_updates_per_iter,
        config.resolved_iters_per_chunk,
    )
    evaluators = [
        make_evaluate(agent, e, config.eval_episodes) for e in eval_envs
    ]

    time_budget = config.time_limit * 3600 if config.time_limit else None
    last_policy_save = int(state.env_steps[0])
    final: dict = {s: {} for s in seeds}
    profiled = False

    while int(state.env_steps[0]) < config.num_steps:
        # --profile-dir: one chunk after the first, as in the runner.
        profile_now = (config.profile_dir and not profiled
                       and int(state.env_steps[0]) > 0)
        with trace_chunks(config.profile_dir if profile_now else None,
                          device, chunk):
            state = chunk(state)
        profiled = profiled or bool(profile_now)
        step = int(state.env_steps[0])
        hours = (time.time() - start_time) / 3600

        bad = state.nonfinite_grads.tolist()
        if any(bad):
            raise FloatingPointError(
                f"non-finite gradient steps per seed: {dict(zip(seeds, bad))}"
            )

        diag = {k: v.tolist() for k, v in state.diagnostics.means().items()}
        # Each seed's evaluation draws from generators seeded by one draw
        # from its train stream, as its single-seed run's does.
        eval_seeds = [
            int(torch.randint(0, 2**31 - 1, (), generator=g, device=device))
            for g in state.generator
        ]
        per_env = []
        for i_env, evaluate in enumerate(evaluators):
            gens = [torch.Generator(device=device).manual_seed(e + i_env)
                    for e in eval_seeds]
            per_env.append([x.tolist() for x in evaluate(state.network, gens)])

        for i, s in enumerate(seeds):
            log_vals = {
                **{k: v[i] for k, v in diag.items()},
                "losses/hours": hours,
            }
            for name, (sr, ret, ln) in zip(config.envs, per_env):
                log_vals[f"{name}/SuccessRate"] = sr[i]
                log_vals[f"{name}/Return"] = ret[i]
                log_vals[f"{name}/EpisodeLength"] = ln[i]
            loggers[i].log(log_vals, step=step)
            final[s] = log_vals

        if config.verbose:
            name = config.envs[-1]
            srs = " ".join(
                f"{s}:{final[s][f'{name}/SuccessRate']:.2f}" for s in seeds
            )
            print(
                f"[ {timestamp()} ] Steps: {step}, Env: {name}, "
                f"SuccessRate per seed: {srs}, Hours: {hours:.2f}"
            )

        if config.save_policy and step - last_policy_save >= 50_000:
            _save_policies(seed_cfgs, state)
            last_policy_save = step

        if time_budget and time.time() - start_time >= time_budget:
            print(f"Reached time limit. Saving sweep checkpoint at {step}.")
            ckpt.save_checkpoint(ck_path, state)
            ckpt.save_mini_checkpoint(ck_path, step, None)
            return final

    # The full stacked state at completion too: a finished sweep stays
    # extendable by a larger --num-steps.
    ckpt.save_checkpoint(ck_path, state)
    ckpt.save_mini_checkpoint(ck_path, int(state.env_steps[0]), None)
    if config.save_policy:
        _save_policies(seed_cfgs, state)
    return final
