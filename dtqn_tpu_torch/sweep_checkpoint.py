"""Build a resumable stacked sweep checkpoint from per-seed policy snapshots
(the JAX package's ``tools/seed_sweep_checkpoint.py``).

A sweep whose stacked checkpoint is missing (cut by a stall before its
time-limit save, or written by code that saved only per-seed policies)
cannot be extended past its ``--num-steps`` by a plain resume.  This tool
builds the stacked ``AgentState`` as ``run_sweep`` does, loads each seed's
saved ``_policy.pt`` into both ``params`` and ``target_params``,
prepopulates the replay rings with random experience, pins ``env_steps``
and ``train_steps`` at ``--at-step``, and writes the stacked checkpoint and
mini checkpoint under the sweep's key (``train/sweep.sweep_path``).
``python -m dtqn_tpu_torch.run --seeds ... --num-steps <larger>`` then
resumes from it.

The continuation is a warm restart of the same policies, not a bit-exact
resume: the replay rings and the optimizer state are built anew.

    python -m dtqn_tpu_torch.sweep_checkpoint --envs gv_memory.7x7.yaml \\
        --seeds 1 2 3 4 5 --at-step 2001792 [other run flags]

  --from-envs <name...>  load the per-seed policies saved under another
      env list's run name (obs and action shapes must match): a curriculum
      hand-off, trained on one distribution, fine-tuned on another.
  --from-project <name>  the project the source policies live under
      (default: the target ``--project-name``).
  --restart-epsilon <f>  epsilon at the restart (default: the fresh 1.0;
      a fine-tune wants the annealed floor 0.1).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from dtqn_tpu_torch.agents import Agent
from dtqn_tpu_torch.config import get_args
from dtqn_tpu_torch.train.loop import make_prepopulate
from dtqn_tpu_torch.train.runner import build_envs
from dtqn_tpu_torch.train.sweep import sweep_path
from dtqn_tpu_torch.utils import checkpoint as ckpt
from dtqn_tpu_torch.utils.rng import seed_everything


def main(argv=None) -> str:
    """Writes the checkpoint and returns its path (``sweep_path``)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--at-step", type=int, required=True)
    p.add_argument("--from-envs", nargs="+", default=None)
    p.add_argument("--from-project", default=None)
    p.add_argument("--restart-epsilon", type=float, default=None)
    args, run_argv = p.parse_known_args(argv)
    config = get_args(run_argv)
    seeds = list(config.seeds)
    if len(seeds) < 2:
        raise ValueError("needs --seeds with more than one seed")

    env, _ = build_envs(config)
    if config.max_episode_steps > 0:
        env.max_episode_steps = config.max_episode_steps
    agent = Agent(config.agent_config(), env, device=config.device)
    state = agent.init_sweep_state([seed_everything(s) for s in seeds])

    # Each seed's saved policy into params AND target_params; --from-envs
    # and --from-project redirect the source run name.
    names = [name for name, _ in state.network.named_parameters()]
    per_seed = []
    for s in seeds:
        c = dataclasses.replace(config, seed=s)
        if args.from_envs is not None:
            c = dataclasses.replace(c, envs=list(args.from_envs))
        if args.from_project is not None:
            c = dataclasses.replace(c, project_name=args.from_project)
        per_seed.append(ckpt.load_policy(c.policy_path(),
                                         agent.build_network()).state_dict())
    stacked = {n: torch.stack([w[n] for w in per_seed]) for n in names}
    state.network.load_stacked_state_dict(stacked)
    state.target_network.load_stacked_state_dict(stacked)

    prepop_iters = max(config.prepop_steps // config.num_envs, 1)
    make_prepopulate(agent, prepop_iters)(state)
    state.env_steps.fill_(args.at_step)
    state.train_steps.fill_(args.at_step)
    if args.restart_epsilon is not None:
        state.epsilon.fill_(args.restart_epsilon)

    ck_path = sweep_path(config, seeds)
    os.makedirs(config.policy_dir(), exist_ok=True)
    ckpt.save_checkpoint(ck_path, state)
    ckpt.save_mini_checkpoint(ck_path, args.at_step, None)
    print(
        f"stacked continuation checkpoint written at step {args.at_step} "
        f"for seeds {seeds}: {ck_path}"
    )
    return ck_path


if __name__ == "__main__":
    main()
