"""The system under test: ``dtqn_tpu_torch``'s training entry points, as
``python -m dtqn_tpu_torch.run`` reaches them (``Agent`` with
``init_state`` or ``init_sweep_state``, ``train/loop.py``'s
``make_prepopulate`` and ``make_train_chunk``), and what the comparison
reads of its state.  Nothing else of the program is used: not how a chunk
is built inside (its graphs, its unit), only the iterations a call runs.

``AgentConfig`` takes the configuration's training and model keys, and
every field of its optional ``"network"`` object as it stands (the fields
of a network that the common keys do not name).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

Layout = List[Tuple[str, int, Tuple[int, ...]]]  # (name, offset, shape)


class Program:
    """One training run of ``cfg`` over ``seeds`` (stacked when several)
    on ``device``."""

    def __init__(self, cfg: dict, traffic: dict, seeds: List[int], device):
        from dtqn_tpu_torch.agents import Agent, AgentConfig
        from dtqn_tpu_torch.envs import make_env
        from dtqn_tpu_torch.train.loop import make_prepopulate, \
            make_train_chunk
        from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule

        network = cfg.get("network", {})
        unknown = sorted(set(network) - {f.name for f in
                                         dataclasses.fields(AgentConfig)})
        if unknown:
            raise ValueError(f"the configuration's \"network\" sets "
                             f"{unknown}, which AgentConfig has no field for")
        config = AgentConfig(
            model=cfg["model"],
            num_envs=cfg["num_envs"],
            learning_rate=cfg["lr"],
            batch_size=cfg["batch_size"],
            context_len=cfg["context_len"],
            history=cfg["history"],
            gamma=cfg["gamma"],
            grad_norm_clip=cfg["grad_clip"],
            target_update_frequency=cfg["target_update"],
            buffer_size=cfg["buffer_size"],
            embed_per_obs_dim=cfg["embed_per_obs_dim"],
            action_dim=cfg["action_dim"],
            inner_embed=cfg["inner_embed"],
            num_heads=cfg["num_heads"],
            num_layers=cfg["num_layers"],
            bag_size=cfg["bag_size"],
            **network,
        )
        self.seeds = list(seeds)
        self.env = make_env(cfg["env"])
        self.agent = Agent(config, self.env, device=device)
        self.state = (self.agent.init_sweep_state(self.seeds)
                      if len(self.seeds) > 1
                      else self.agent.init_state(self.seeds[0]))
        self.iters_per_chunk = traffic["iters_per_chunk"]
        self.num_envs = cfg["num_envs"]
        self.prepopulate = make_prepopulate(
            self.agent, max(cfg["prepop_steps"] // cfg["num_envs"], 1))
        eps = EpsilonSchedule(cfg["eps_start"], cfg["eps_end"],
                              cfg["eps_duration"])
        upi = traffic["updates_per_env_step"] * cfg["num_envs"]
        # The window's chunk, and a chunk of one iteration of the same
        # state: the iterations the comparison and the trace take one at a
        # time.
        self.chunk = make_train_chunk(self.agent, eps, updates_per_iter=upi,
                                      iters_per_chunk=self.iters_per_chunk)
        self.step = make_train_chunk(self.agent, eps, updates_per_iter=upi,
                                     iters_per_chunk=1)

    @property
    def stacked(self) -> bool:
        return len(self.seeds) > 1

    def env_steps(self) -> List[int]:
        return self._per_seed(self.state.env_steps).tolist()

    def run(self, call, iterations: int) -> None:
        """``call`` (``chunk`` or ``step``) on the state, then a sync; the
        call has to run ``iterations`` iterations, or none (a state left
        unchanged, which the comparison judges).  Any other count is the
        harness's error, not the program's: the unit of a chunk changed."""
        before = self.env_steps()
        call(self.state)
        self.sync()
        ran = {(b - a) / self.num_envs for a, b in
               zip(before, self.env_steps())}
        if ran - {0, iterations}:
            raise RuntimeError(
                f"a call meant to run {iterations} iteration(s) ran "
                f"{sorted(ran)}: the chunk's unit is not what the harness "
                "drives")

    def generator_states(self) -> List[torch.Tensor]:
        """Each seed's generator state (the draws a reference continuing
        from this state has to make)."""
        gens = self.state.generator
        gens = gens if isinstance(gens, (list, tuple)) else [gens]
        return [g.get_state() for g in gens]

    def layout(self) -> Layout:
        """Where each parameter sits in the flat vector of one seed."""
        net = self.state.network
        module = net.module if self.stacked else net
        out, offset = [], 0
        for name, p in module.named_parameters():
            out.append((name, offset, tuple(p.shape)))
            offset += p.numel()
        return out

    def _per_seed(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.stacked else x.unsqueeze(0)

    def _leaves(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        flat = self._per_seed(flat)
        return {name: flat[:, o:o + _numel(shape)].reshape(-1, *shape)
                for name, o, shape in self.layout()}

    @torch.no_grad()
    def set_weights(self, weights: Dict[str, torch.Tensor]) -> None:
        """Writes ``weights`` (name -> [S, *shape]) as the initial policy
        and target weights."""
        flat = torch.cat([weights[name].reshape(len(self.seeds), -1)
                          for name, _, _ in self.layout()], dim=1)
        self.state.params.copy_(flat.reshape(self.state.params.shape))
        self.state.target_params.copy_(self.state.params)

    def sync(self) -> None:
        """Waits for the whole learn chain: reads values that depend on it
        (as every runner chunk ends)."""
        _ = self.state.train_steps.tolist()
        _ = self.state.params.reshape(-1)[0].item()

    def train_steps(self) -> List[int]:
        return self._per_seed(self.state.train_steps).tolist()

    def nonfinite(self) -> int:
        return int(self.state.nonfinite_grads.sum())

    def flushed(self) -> List[int]:
        return self._per_seed(self.state.buffer.flushed_total).tolist()

    @torch.no_grad()
    def observables(self) -> Dict[str, torch.Tensor]:
        """Copies, on the host, of what ``perfbench.compare`` reads."""
        st = self.state
        out = {}

        def put(prefix, obj, rename=None):
            for f in dataclasses.fields(obj):
                value = getattr(obj, f.name)
                if isinstance(value, torch.Tensor):
                    name = (rename or {}).get(f.name, f.name)
                    out[f"{prefix}{name}"] = value

        put("env.", st.env_state)
        out["obs"] = st.obs
        put("context.", st.context)
        put("replay.", st.buffer, {"flushed_total": "flushed"})
        out["replay.flushed"] = self._per_seed(out["replay.flushed"])
        for k in ("bag_idx", "bag_act"):
            out.pop(f"replay.{k}", None)
        if st.bag is not None:
            put("bag.", st.bag)
        out.update({
            "env_steps": self._per_seed(st.env_steps),
            "train_steps": self._per_seed(st.train_steps),
            "epsilon": self._per_seed(st.epsilon),
            "nonfinite": self._per_seed(st.nonfinite_grads),
            "adam_count": self._per_seed(st.opt_state.count),
        })
        out.update({f"params.{k}": v
                    for k, v in self._leaves(st.params).items()})
        for prefix, flat in (("target.", st.target_params),
                             ("mu.", st.opt_state.mu),
                             ("nu.", st.opt_state.nu)):
            out.update({prefix + k: v for k, v in self._leaves(flat).items()})
        ring = st.diagnostics.averages
        buf = ring.buf if self.stacked else ring.buf.unsqueeze(0)
        idx = self._per_seed(ring.idx)
        window = buf.shape[1]
        # Oldest to newest (the ring is full after a chunk of updates).
        slots = (idx[:, None] + torch.arange(window, device=idx.device)) \
            % window
        seed_rows = torch.arange(buf.shape[0], device=idx.device)[:, None]
        out["losses"] = buf[seed_rows, slots, 0]
        out["gnorms"] = buf[seed_rows, slots, 1]
        return {k: v.detach().to("cpu", copy=True) for k, v in out.items()}

    def close(self) -> None:
        """Drops the program's state, graphs and agent."""
        self.state = self.chunk = self.step = self.prepopulate = None
        self.agent = None


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n
