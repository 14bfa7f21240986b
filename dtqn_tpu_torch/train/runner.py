"""Experiment orchestration: the host-side shell around the train loop
(``dtqn_tpu/train/runner.py``).

As the reference's run.py:408-529 (``run_experiment``): env construction,
seeding, agent build, resume-or-prepopulate, the train loop with periodic
evaluation / logging / policy saves, slurm-style time-limit checkpointing,
and the mini-checkpoint completion sentinel.

The host does config, logging and checkpoint I/O, and reads device values
only at chunk boundaries; each chunk of ``eval_frequency`` env steps is one
call of the train loop (train/loop.py).  On the card the prepopulation,
every chunk and every evaluation go through the compiled entry points
(``make_prepopulate``, ``make_train_chunk``: one iteration captured as a
CUDA graph and replayed; ``make_evaluate``: a reset and blocks of env
steps, each a graph); a resumed run loads its checkpoint into the state's
own tensors and captures after loading.  The mesh path and the enjoy
mode's rendered episode (``_render_episode``, not compiled in the JAX
package either) stay eager.

``--dp-devices N`` trains one run sharded over N ranks, one process each
(``parallel/``).  Outside a process group the runner starts the N ranks
itself (``parallel.distributed.spawn``); under ``torchrun`` each process
joins the launcher's group.  Every rank prepopulates or resumes the global
state and shards it, as the JAX runner does; only rank 0 evaluates and
writes CSVs, policies and checkpoints, and it decides the time-limit stop
for all ranks.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from dtqn_tpu_torch import replay
from dtqn_tpu_torch.agents import Agent
from dtqn_tpu_torch.config import ExperimentConfig
from dtqn_tpu_torch.envs import MultiDomainEnv, make_env, make_gridverse_env
from dtqn_tpu_torch.models import zero_carry
from dtqn_tpu_torch.parallel.distributed import (
    init_distributed,
    process_info,
    spawn,
)
from dtqn_tpu_torch.parallel.mesh import (
    check_replicated,
    make_distributed_train_chunk,
    make_mesh,
    shard_state,
)
from dtqn_tpu_torch.train.loop import (
    make_evaluate,
    make_prepopulate,
    make_train_chunk,
)
from dtqn_tpu_torch.utils import checkpoint as ckpt
from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule
from dtqn_tpu_torch.utils.logging import get_logger, timestamp
from dtqn_tpu_torch.utils.profiling import trace_chunks, tracing_on
from dtqn_tpu_torch.utils.rng import seed_everything


def _first_env(env_state):
    """The state of env 0 as scalars, for ``render_frame``."""
    return dataclasses.replace(env_state, **{
        f.name: getattr(env_state, f.name)[0].cpu()
        for f in dataclasses.fields(env_state)
    })


@torch.no_grad()
def _render_episode(agent, env, network, generator,
                    policy_path) -> Optional[str]:
    """Greedy rollout of one episode with per-step frames, saved as one
    vertical PNG strip (every 10th frame).  Headless stand-in for the
    reference's pyglet enjoy loop (run.py:463-467); the recurrent models
    step their carry from zeros."""
    try:
        from PIL import Image
    except ImportError:
        return None

    cfg = agent.config
    obs, env_state = env.reset_vec(generator, 1, agent.device)
    context = replay.init_context(
        generator, 1, cfg.context_len, tuple(env.obs_shape),
        env.obs_dtype, env.obs_mask, env.num_actions, obs,
    )
    carry = (zero_carry(1, cfg.inner_embed, agent.device)
             if cfg.kind == "recurrent" else None)
    frames = []
    for _ in range(env.max_episode_steps):
        frames.append(env.render_frame(_first_env(env_state)))
        actions, carry = agent.greedy_actions(network, context, None, carry,
                                              obs)
        obs, env_state, ts = env.step(generator, env_state, actions)
        context, *_ = replay.add_transition(
            context, ts.obs, actions, ts.reward, ts.terminated
        )
        if bool(ts.done[0]):
            frames.append(env.render_frame(_first_env(env_state)))
            break
    # Tail frame only when frames[::10] didn't already end on it.
    tail = frames[-1:] if (len(frames) - 1) % 10 else []
    strip = np.concatenate(frames[::10] + tail, axis=0)
    path = policy_path + "_enjoy.png"
    Image.fromarray(strip).save(path)
    return path


class HostRunningAverage:
    """Host-side windowed mean for eval metrics (logging_utils.py:10-24)."""

    def __init__(self, size: int, values=None):
        self.size = size
        self.q = deque(values or [], maxlen=size)

    def add(self, val: float) -> None:
        self.q.append(float(val))

    def mean(self) -> float:
        return sum(self.q) / max(len(self.q), 1)

    def to_list(self):
        return list(self.q)


def build_envs(config: ExperimentConfig):
    """(train_env, eval_envs) for the configured domain list.

    Several ``--envs`` draw a new domain per episode (run.py:287) through
    ``MultiDomainEnv``; Gridverse members of different sizes are padded to
    the largest grid so that their states share one shape, and each domain
    is evaluated on its own (padded) env.
    """
    names = config.envs
    if len(names) == 1:
        return make_env(names[0]), [make_env(names[0])]
    if all(n.startswith("gv_") for n in names):
        pad = max(int(n.split(".")[1].split("x")[0]) for n in names)
        members = [make_gridverse_env(n, pad_to=pad) for n in names]
        evals = [make_gridverse_env(n, pad_to=pad) for n in names]
    else:
        members = [make_env(n) for n in names]
        evals = [make_env(n) for n in names]
    return MultiDomainEnv(members), evals


def run_ranks(mesh, configs):
    """``run_experiment`` of each config in turn, on one rank of ``mesh``
    (the entry of the ranks ``spawn`` starts)."""
    del mesh  # each run finds this process's rank in the group
    return [run_experiment(c) for c in configs]


def run_experiment(config: ExperimentConfig) -> dict:
    """Train per the config; returns final metrics for programmatic use
    (rank 0's for a run over several ranks).

    Runs on ``config.device``: the card by default (raising when there is
    none), the CPU only when the config says ``cpu``.  With
    ``--dp-devices N`` rank r runs on ``cuda:(r % device_count)``.  With
    ``--profile-dir`` tracing is on for the run (``utils/profiling.py``):
    every graph it captures records the phases' boundaries.
    """
    with tracing_on(bool(config.profile_dir)):
        return _run(config)


def _run(config: ExperimentConfig) -> dict:
    # Enjoy mode only evaluates: one process does it.
    ranks = 1 if config.render else config.dp_devices
    if (ranks > 1 and not dist.is_initialized()
            and "WORLD_SIZE" not in os.environ):
        return spawn(run_ranks, ranks, ([config],),
                     device=config.device)[0][0]
    start_time = time.time()
    mesh = None
    if ranks > 1:
        init_distributed(device=config.device)
        mesh = make_mesh(ranks, device=config.device)
        if mesh.rank == 0:
            print(f"[dp] {mesh.size} ranks, backend {mesh.backend}: "
                  f"{process_info()}")
    lead = mesh is None or mesh.rank == 0

    env, eval_envs = build_envs(config)
    if config.max_episode_steps > 0:
        env.max_episode_steps = config.max_episode_steps
        for e in eval_envs:
            e.max_episode_steps = config.max_episode_steps

    agent = Agent(config.agent_config(), env,
                  device=mesh.device if mesh else config.device)
    device = agent.device
    # LinearAnneal(1.0, 0.1, num_steps/10) (run.py:420); --eps-min raises
    # the floor (default keeps the reference 0.1).
    eps = EpsilonSchedule(
        1.0, config.eps_min, max(config.num_steps // 10, 1)
    )

    state = agent.init_state(seed_everything(config.seed))

    os.makedirs(config.policy_dir(), exist_ok=True)
    policy_path = config.policy_path()

    if config.verbose and lead:
        print(
            f"[ {timestamp()} ] Creating {config.model} with "
            f"{state.params.numel()} parameters"
        )

    # Enjoy mode: load a saved policy and report greedy performance
    # (run.py:463-467).  Envs exposing ``render_frame`` (e.g. CarFlag)
    # additionally get an episode image strip saved next to the policy.
    if config.render:
        network = ckpt.load_policy(policy_path, state.network)
        ev = make_evaluate(agent, eval_envs[0], config.eval_episodes)
        sr, ret, ln = ev(
            network,
            torch.Generator(device=device).manual_seed(config.seed + 1),
        )
        print(
            f"[enjoy] SuccessRate={float(sr):.2f} Return={float(ret):.2f} "
            f"EpisodeLength={float(ln):.1f}"
        )
        out = {"success_rate": float(sr), "return": float(ret)}
        if hasattr(eval_envs[0], "render_frame") and not agent.use_bag:
            path = _render_episode(
                agent, eval_envs[0], network,
                torch.Generator(device=device).manual_seed(config.seed + 2),
                policy_path,
            )
            if path:
                print(f"[enjoy] episode strip saved to {path}")
                out["render_path"] = path
        return out

    mean_success_rate = HostRunningAverage(10)
    mean_reward = HostRunningAverage(10)
    mean_episode_length = HostRunningAverage(10)

    # Resume-or-exit protocol (run.py:471-495).
    mini = ckpt.load_mini_checkpoint(policy_path)
    wandb_kwargs = {}
    if mini is not None:
        if mini["step"] >= config.num_steps:
            print(
                f"Found completed run ({mini['step']} steps); nothing to do."
            )
            return {"completed": True, "step": mini["step"]}
        if ckpt.has_checkpoint(policy_path):
            state, extra = ckpt.load_checkpoint(policy_path, state)
            mean_success_rate = HostRunningAverage(
                10, extra.get("mean_success_rate")
            )
            mean_reward = HostRunningAverage(10, extra.get("mean_reward"))
            mean_episode_length = HostRunningAverage(
                10, extra.get("mean_episode_length")
            )
            wandb_kwargs = {"resume": "must", "id": mini.get("wandb_id")}
            if lead:
                print("Resumed from checkpoint at "
                      f"{int(state.env_steps)} steps.")
    else:
        # Prepopulate the replay buffer with random experience (run.py:495).
        prepop_iters = max(config.prepop_steps // config.num_envs, 1)
        state = make_prepopulate(agent, prepop_iters)(state)

    logger = get_logger(policy_path, config, wandb_kwargs) if lead else None
    # wandb run id rides the mini checkpoint so resume can reattach with
    # resume="must" (run.py:482-490, 527); None under CSV logging.
    wandb_id = getattr(getattr(logger, "run", None), "id", None)

    if mesh is not None:
        # Shard after resume or prepopulation (dtqn_tpu/train/runner.py).
        state = shard_state(agent, state, mesh)
        train_chunk = make_distributed_train_chunk(
            agent,
            eps,
            config.resolved_updates_per_iter,
            config.resolved_iters_per_chunk,
            mesh,
            state,
        )
    else:
        train_chunk = make_train_chunk(
            agent,
            eps,
            config.resolved_updates_per_iter,
            config.resolved_iters_per_chunk,
        )
    evaluators = [
        make_evaluate(agent, e, config.eval_episodes) for e in eval_envs
    ]

    time_budget = (
        config.time_limit * 3600 - (time.time() - start_time)
        if config.time_limit
        else None
    )

    last_policy_save = int(state.env_steps)
    final_log = {}
    profiled = False
    while int(state.env_steps) < config.num_steps:
        # With --profile-dir, trace the first chunk after the first (the
        # kernels are built and the caches warm by then), as the JAX
        # package traces its first post-compile chunk.  That chunk then
        # gets the evaluation and CSV row of any other, as in the JAX
        # sweep (the JAX runner skips them, leaving a gap in the curve).
        profile_now = (config.profile_dir and not profiled
                       and int(state.env_steps) > 0)
        with trace_chunks(config.profile_dir if profile_now else None,
                          device, train_chunk):
            state = train_chunk(state)
        profiled = profiled or bool(profile_now)
        step = int(state.env_steps)
        hours = (time.time() - start_time) / 3600
        if mesh is not None:
            check_replicated(state, mesh)

        if int(state.nonfinite_grads) > 0:
            # The reference's error_if_nonfinite grad clip fails loudly
            # (dqn.py:196-200); surface it here at the host boundary.
            raise FloatingPointError(
                f"{int(state.nonfinite_grads)} non-finite gradient steps"
            )

        log_vals = {
            **{k: float(v) for k, v in state.diagnostics.means().items()},
            "losses/hours": hours,
        }
        # Evaluation draws from generators of its own, seeded by one draw
        # from the train stream: that stream advances by the same amount
        # whatever the evaluation does.  Every rank draws it, and rank 0
        # evaluates the replicated network.
        eval_seed = int(torch.randint(
            0, 2**31 - 1, (), generator=state.generator, device=device
        ))
        for i, (name, evaluate) in enumerate(
                zip(config.envs, evaluators if lead else [])):
            sr, ret, ln = evaluate(
                state.network,
                torch.Generator(device=device).manual_seed(eval_seed + i),
            )
            log_vals[f"{name}/SuccessRate"] = float(sr)
            log_vals[f"{name}/Return"] = float(ret)
            log_vals[f"{name}/EpisodeLength"] = float(ln)
            mean_success_rate.add(float(sr))
            mean_reward.add(float(ret))
            mean_episode_length.add(float(ln))
        final_log = log_vals
        if lead:
            logger.log(log_vals, step=step)

        if config.verbose and lead:
            name = config.envs[-1]
            print(
                f"[ {timestamp()} ] Steps: {step}, "
                f"Env: {name}, "
                f"Success Rate: {log_vals[f'{name}/SuccessRate']:.2f}, "
                f"Return: {log_vals[f'{name}/Return']:.2f}, "
                f"Episode Length: {log_vals[f'{name}/EpisodeLength']:.2f}, "
                f"Hours: {hours:.2f}"
            )

        # Policy snapshot every 50k env steps (run.py:337-338).
        if config.save_policy and step - last_policy_save >= 50_000:
            if lead:
                ckpt.save_policy(policy_path, state.network)
            last_policy_save = step

        # Slurm-style time-limit checkpoint (run.py:340-353).
        if _stop_now(mesh, bool(time_budget)
                     and time.time() - start_time >= time_budget):
            if lead:
                print(
                    f"Reached time limit. Saving checkpoint at {step} steps."
                )
            ckpt.save_checkpoint(
                policy_path,
                state,
                extra={
                    "mean_success_rate": mean_success_rate.to_list(),
                    "mean_reward": mean_reward.to_list(),
                    "mean_episode_length": mean_episode_length.to_list(),
                },
                mesh=mesh,
            )
            if lead:
                ckpt.save_mini_checkpoint(policy_path, step, wandb_id)
            _written(mesh)
            return final_log

    # Completion sentinel (run.py:527-529).
    if lead:
        ckpt.save_mini_checkpoint(policy_path, int(state.env_steps),
                                  wandb_id)
        if config.save_policy:
            ckpt.save_policy(policy_path, state.network)
    _written(mesh)
    return final_log


def _written(mesh) -> None:
    """Returns on every rank once rank 0 has written its files: a run that
    follows in the same processes reads them complete."""
    if mesh is not None:
        mesh.broadcast(torch.zeros(1, device=mesh.device), src=0).item()


def _stop_now(mesh, decision) -> bool:
    """Rank 0's time-limit ``decision``, on every rank: the ranks' clocks
    differ, and a rank that stopped alone would leave the others waiting
    in a collective."""
    if mesh is None:
        return decision
    flag = torch.tensor([int(bool(decision))], device=mesh.device)
    return bool(mesh.broadcast(flag, src=0).item())
