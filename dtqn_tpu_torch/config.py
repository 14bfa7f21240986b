"""Experiment configuration: typed dataclass + CLI (``dtqn_tpu/config.py``).

Every flag of the reference argparse CLI (run.py:16-184) and of the JAX
package's CLI, under the same names, so command lines carry over.  The
config-derived run name reproduces the reference's 13-field policy filename
(run.py:456-460) letter for letter, so a port run and a JAX run of one
configuration share a name.  Combinations the JAX package cannot run either
are refused when the run is built (by the runner, the agent, the network or
``make_env``); ``--attention``, ``--unroll`` and ``--outer-unroll`` are kept
and change nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional

from dtqn_tpu_torch.agents.base import AgentConfig


@dataclasses.dataclass
class ExperimentConfig:
    # Reference flags (run.py:16-184)
    project_name: str = "DTQN-test"
    disable_wandb: bool = True
    time_limit: Optional[float] = None  # hours
    model: str = "DTQN"
    envs: List[str] = dataclasses.field(
        default_factory=lambda: ["DiscreteCarFlag-v0"]
    )
    num_steps: int = 2_000_000
    tuf: int = 10_000
    lr: float = 3e-4
    batch: int = 32
    buf_size: int = 500_000
    eval_frequency: int = 5_000
    eval_episodes: int = 10
    device: str = "cuda"  # "cpu" is the only way onto the CPU
    context: int = 50
    obs_embed: int = 8
    a_embed: int = 0
    in_embed: int = 128
    max_episode_steps: int = -1
    seed: int = 1
    # Multi-seed sweep: several seeds train at once (train/sweep.py); one
    # listed seed replaces --seed.
    seeds: List[int] = dataclasses.field(default_factory=list)
    save_policy: bool = False
    verbose: bool = False
    render: bool = False
    history: int = 50
    heads: int = 8
    layers: int = 2
    dropout: float = 0.0
    discount: float = 0.99
    gate: str = "res"
    identity: bool = False
    pos: str = "learned"
    bag_size: int = 0
    bag_mask: bool = False  # ablation: mask padded bag slots (models/dtqn.py)
    bag_store: bool = False  # train on stored act-time bags (replay/buffer.py)
    slurm_job_id: str = "0"
    # Execution knobs
    num_envs: int = 32  # vectorized env instances
    updates_per_iter: int = -1  # -1 => num_envs (1 update per env step)
    iters_per_chunk: int = -1  # -1 => derived from eval_frequency
    prepop_steps: int = 50_000  # run.py:495
    # Kept so command lines carry over; they change nothing here: the
    # tensor's device picks the attention path, and on the card one CUDA
    # graph holds an iteration's whole chain of updates (train/loop.py).
    attention: str = "xla"
    unroll: int = 4
    outer_unroll: int = 1
    dp_devices: int = 1  # data-parallel ranks, one process each (parallel/)
    profile_dir: str = ""  # torch.profiler trace of one chunk
    bf16: bool = False  # bfloat16 compute, float32 parameters
    # Exploration floor (reference: 0.1, run.py:420).  Raising it is the
    # non-parity HeavenHell loiter-breaking mitigation (VERDICT r4 item 3).
    eps_min: float = 0.1

    def agent_config(self) -> AgentConfig:
        return AgentConfig(
            model=self.model,
            num_envs=self.num_envs,
            learning_rate=self.lr,
            batch_size=self.batch,
            context_len=self.context,
            history=self.history,
            gamma=self.discount,
            target_update_frequency=self.tuf,
            buffer_size=self.buf_size,
            embed_per_obs_dim=self.obs_embed,
            action_dim=self.a_embed,
            inner_embed=self.in_embed,
            num_heads=self.heads,
            num_layers=self.layers,
            dropout=self.dropout,
            gate=self.gate,
            identity=self.identity,
            pos=self.pos,
            bag_size=self.bag_size,
            bag_mask=self.bag_mask,
            bag_store=self.bag_store,
            bf16=self.bf16,
        )

    @property
    def resolved_updates_per_iter(self) -> int:
        return self.num_envs if self.updates_per_iter < 0 else self.updates_per_iter

    @property
    def resolved_iters_per_chunk(self) -> int:
        if self.iters_per_chunk > 0:
            return self.iters_per_chunk
        # One chunk per eval period, in units of vector iterations.
        return max(self.eval_frequency // self.num_envs, 1)

    def _env_names(self) -> List[str]:
        """Env names safe for file paths (``--envs foo/bar.pomdp`` is a
        path; flatten separators so run names/policy dirs stay flat)."""
        return [n.replace(os.sep, "_") for n in self.envs]

    def run_name(self) -> str:
        """13-field config-encoded run name (run.py:456-460)."""
        return (
            f"model={self.model}_envs={','.join(self._env_names())}"
            f"_obs_embed={self.obs_embed}_a_embed={self.a_embed}"
            f"_in_embed={self.in_embed}_context={self.context}"
            f"_heads={self.heads}_layers={self.layers}_batch={self.batch}"
            f"_gate={self.gate}_identity={self.identity}"
            f"_history={self.history}_pos={self.pos}_bag={self.bag_size}"
            + ("_bagmask=True" if self.bag_mask else "")
            + ("_bagstore=True" if self.bag_store else "")
            + (f"_epsmin={self.eps_min}" if self.eps_min != 0.1 else "")
            + f"_seed={self.seed}"
        )

    def policy_dir(self, root: Optional[str] = None) -> str:
        root = root or os.getcwd()
        return os.path.join(
            root, "policies", self.project_name, *self._env_names()
        )

    def policy_path(self, root: Optional[str] = None) -> str:
        return os.path.join(self.policy_dir(root), self.run_name())


def get_args(argv=None) -> ExperimentConfig:
    """CLI with flag names matching the reference (run.py:16-184)."""
    p = argparse.ArgumentParser(description="dtqn_tpu_torch experiment runner")
    d = ExperimentConfig()
    p.add_argument("--project-name", type=str, default=d.project_name)
    p.add_argument("--disable-wandb", action="store_true", default=d.disable_wandb)
    p.add_argument("--wandb", dest="disable_wandb", action="store_false",
                   help="Enable wandb logging (CSV is the default here).")
    p.add_argument("--time-limit", type=float, default=None,
                   help="Wall-clock limit in hours (slurm-style checkpointing).")
    p.add_argument("--model", type=str, default=d.model,
                   choices=["DTQN", "DTQN-bag", "ADRQN", "DRQN", "DARQN", "DQN"])
    p.add_argument("--envs", type=str, nargs="+", default=list(d.envs))
    p.add_argument("--num-steps", type=int, default=d.num_steps)
    p.add_argument("--tuf", type=int, default=d.tuf)
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--batch", type=int, default=d.batch)
    p.add_argument("--buf-size", type=int, default=d.buf_size)
    p.add_argument("--eval-frequency", type=int, default=d.eval_frequency)
    p.add_argument("--eval-episodes", type=int, default=d.eval_episodes)
    p.add_argument("--device", type=str, default=d.device,
                   help="cuda (default; fails when no GPU is found) or cpu.")
    p.add_argument("--context", type=int, default=d.context)
    p.add_argument("--obs-embed", type=int, default=d.obs_embed)
    p.add_argument("--a-embed", type=int, default=d.a_embed)
    p.add_argument("--in-embed", type=int, default=d.in_embed)
    p.add_argument("--max-episode-steps", type=int, default=d.max_episode_steps)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--seeds", type=int, nargs="+", default=list(d.seeds),
                   help="Train these seeds at once (stacked on one GPU); "
                        "one seed replaces --seed.")
    p.add_argument("--save-policy", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--render", action="store_true")
    p.add_argument("--history", type=int, default=d.history)
    p.add_argument("--heads", type=int, default=d.heads)
    p.add_argument("--layers", type=int, default=d.layers)
    p.add_argument("--dropout", type=float, default=d.dropout)
    p.add_argument("--discount", type=float, default=d.discount)
    p.add_argument("--gate", type=str, default=d.gate, choices=["res", "gru"])
    p.add_argument("--identity", action="store_true")
    p.add_argument("--pos", default=d.pos, choices=["learned", "sin", "none"])
    p.add_argument("--bag-size", type=int, default=d.bag_size)
    p.add_argument("--bag-mask", action="store_true",
                   help="Ablation: mask padded bag slots in the bag "
                        "cross-attention (reference attends over padding).")
    p.add_argument("--bag-store", action="store_true",
                   help="Train on stored ACT-TIME bags (eviction-policy "
                        "contents) instead of the reference's uniform "
                        "random pre-window subsets — closes the train/act "
                        "bag-distribution mismatch.")
    p.add_argument("--slurm-job-id", type=str, default=d.slurm_job_id)
    # Execution knobs
    p.add_argument("--num-envs", type=int, default=d.num_envs)
    p.add_argument("--updates-per-iter", type=int, default=d.updates_per_iter)
    p.add_argument("--iters-per-chunk", type=int, default=d.iters_per_chunk)
    p.add_argument("--prepop-steps", type=int, default=d.prepop_steps)
    p.add_argument("--attention", type=str, default=d.attention,
                   choices=["xla", "pallas"],
                   help="Accepted and ignored: a CUDA tensor launches the "
                        "CUDA attention kernels, a CPU tensor runs their "
                        "plain versions.")
    p.add_argument("--unroll", type=int, default=d.unroll,
                   help="Accepted and ignored: on the GPU one CUDA graph "
                        "holds an iteration's whole chain of updates.")
    p.add_argument("--outer-unroll", type=int, default=d.outer_unroll,
                   help="Accepted and ignored: on the GPU a chunk replays "
                        "the graph of one iteration.")
    p.add_argument("--dp-devices", type=int, default=d.dp_devices,
                   help="Train one run sharded over this many ranks, one "
                        "process each (started here, or by torchrun); a "
                        "sweep over several seeds refuses it.")
    p.add_argument("--profile-dir", type=str, default=d.profile_dir,
                   help="Write a torch.profiler trace (Chrome JSON) of one "
                        "train chunk under this directory.")
    p.add_argument("--bf16", action="store_true",
                   help="Compute in bfloat16 (activations, matmuls, the "
                        "attention kernels); parameters, optimizer state "
                        "and the loss stay float32.")
    p.add_argument("--eps-min", type=float, default=d.eps_min,
                   help="Epsilon anneal floor (reference: 0.1). Raising it "
                        "is the HeavenHell loiter-breaking mitigation.")

    ns = p.parse_args(argv)
    fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    return ExperimentConfig(
        **{k: v for k, v in vars(ns).items() if k in fields}
    )
