"""Plain DDQN training of a Q-network (kevslinger/DTQN
``dtqn/agents/dqn.py``, ``dtqn/agents/dtqn.py``, ``run.py``) for S seeds
at once, float32.  The network is the configuration's own: ``Net`` and
``param_spec`` of the reference module its ``"reference"`` names; the
learner, the envs, the replay and the bag are shared.

A run of ``cfg`` from ``seeds`` and the given initial weights: the envs
start, the replay is filled by ``prepop_steps`` env steps of uniformly
random actions, and then each iteration takes one epsilon-greedy env step
in every env and ``updates_per_iter`` DDQN updates.  Acting: the greedy
action is the argmax of Q at the context's newest step; epsilon anneals
multiplicatively toward its floor (``val - (val - min) / duration`` each
env step).  With a bag, an entry evicted from a full context goes into the
bag while it has room; else the bag keeps, of its ``bag_size + 1``
possible contents (the newcomer in each slot, or not at all), the first
with the largest mean over the steps of the largest Q.  An update: the
target is r + gamma (1 - done) Q_target(s', argmax_a Q(s', a)), the loss
the mean squared TD error over the last ``history`` steps of each window,
the gradient clipped to global norm 1 (unchanged below it), then Adam
(0.9, 0.999, 1e-8); an update is applied only where more than
``batch_size`` episodes have finished and the gradient's norm is finite;
the target network takes the weights every ``target_update`` applied
updates.

The run records, per update, each seed's TD loss and gradient norm, and
its state is what ``observables`` reads.
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict, List

import torch

from perfbench.reference import replay as rp
from perfbench.reference.envs import make_env, per_seed_cat, select, \
    step_autoreset
from perfbench.reference.precision import Precision

ADAM = (0.9, 0.999, 1e-8)


class ReferenceRun:
    def __init__(self, cfg: dict, model: ModuleType, seeds: List[int],
                 weights: Dict[str, torch.Tensor], device,
                 prec: Precision, half_batch: bool = False):
        """``model``: the configuration's reference module (``Net``,
        ``param_spec``).  ``weights``: name -> [S, *shape], as
        ``param_spec`` names them.  ``half_batch`` (a planted fault, for
        the checks of the comparison) trains on the first half of each
        batch, the mean taken over it."""
        if cfg.get("action_dim", 0):
            raise ValueError("the plain reference has no action embedding")
        self.cfg = cfg
        self.env = make_env(cfg["env"])
        self.device = torch.device(device)
        self.gens = [torch.Generator(device=self.device).manual_seed(s)
                     for s in seeds]
        self.s, self.e = len(seeds), cfg["num_envs"]
        self.net = model.Net(cfg, self.env, prec)
        self.half_batch = half_batch
        # Whether a full bag scores its candidates (``evict``); else it
        # keeps its contents, and only its fill is tracked.
        self.evicts = True
        self.names = [name for name, _, _ in model.param_spec(cfg, self.env)]
        env, e, dev = self.env, self.e, self.device
        self.obs, self.env_state = env.reset(self.gens, e, dev)
        self.ctx = rp.new_context(self.gens, e, cfg["context_len"], env,
                                  self.obs)
        self.rb = rp.stack_replays([
            rp.new_replay(e, cfg["buffer_size"], env.max_steps, env, dev)
            for _ in seeds])
        rp.replay_start_episode(
            self.rb, self.obs,
            torch.ones((self.s * e,), dtype=torch.bool, device=dev),
            env.obs_mask)
        self.bag = (rp.new_bag(self.s * e, cfg["bag_size"], env, dev)
                    if cfg["bag_size"] else None)
        self.params = {k: weights[k].clone().to(dev) for k in self.names}
        self.target = {k: v.clone() for k, v in self.params.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}

        def per_seed(value, dtype):
            return torch.full((self.s,), value, dtype=dtype, device=dev)

        self.count = per_seed(0, torch.int32)
        self.train_steps = per_seed(0, torch.int32)
        self.env_steps = per_seed(0, torch.int64)
        self.nonfinite = per_seed(0, torch.int32)
        self.epsilon = per_seed(cfg["eps_start"], torch.float32)
        # The last evict's candidates and scores, and the episodes the last
        # env step ended (what the comparison reads of the replay's step).
        self.last_evict = self.last_done = None
        self.last_greedy = 0  # envs that acted greedily at the last step
        self.losses: List[torch.Tensor] = []  # [S] per update
        self.gnorms: List[torch.Tensor] = []

    # ------------------------------------------------------------- acting
    def _seeded(self, x):
        """[S*n, ...] seed-major -> [S, n, ...]."""
        return x.reshape(self.s, -1, *x.shape[1:])

    def q(self, params, obs, bag_obs=None):
        """Q of [S*n, L, ...] windows: [S*n, L, A]."""
        q = self.net(params, self._seeded(obs),
                     None if bag_obs is None else self._seeded(bag_obs))
        return q.reshape(-1, *q.shape[2:])

    @torch.no_grad()
    def greedy(self):
        q = self.q(self.params, self.ctx["obs"],
                   None if self.bag is None else self.bag["obs"])
        e = torch.arange(q.shape[0], device=self.device)
        return torch.argmax(q[e, rp.last_row(self.ctx)], dim=-1)

    @torch.no_grad()
    def evict(self, ev_obs, ev_act, ev_idx, need):
        bag = self.bag
        cand = rp.bag_candidates(bag, ev_obs, ev_act, ev_idx)
        n, c = cand["action"].shape[:2]
        q = self.q(self.params,
                   self.ctx["obs"].repeat_interleave(c, dim=0),
                   cand["obs"].reshape(n * c, *cand["obs"].shape[2:]))
        scores = q.amax(-1).mean(-1).reshape(n, c)
        best = torch.argmax(scores, dim=-1)
        e = torch.arange(n, device=self.device)
        chosen = {k: cand[k][e, best] for k in cand}
        kept = select(need, chosen, {k: bag[k] for k in chosen})
        self.bag = dict(kept, pos=bag["pos"])
        # The last choice, for the comparison: every candidate and its
        # score, and where a choice was made.
        self.last_evict = dict(cand, scores=scores, need=need)

    def env_step(self, random_only: bool):
        cfg, env, e, dev, gens = self.cfg, self.env, self.e, self.device, \
            self.gens
        if random_only:
            actions = per_seed_cat(gens, lambda g: torch.randint(
                0, env.num_actions, (e,), generator=g, device=dev))
        else:
            greedy = self.greedy()
            u = per_seed_cat(gens, lambda g: torch.rand((e,), generator=g,
                                                        device=dev))
            randoms = per_seed_cat(gens, lambda g: torch.randint(
                0, env.num_actions, (e,), generator=g, device=dev))
            explore = (u.reshape(self.s, e) < self.epsilon[:, None]).reshape(-1)
            actions = torch.where(explore, randoms, greedy)
            self.last_greedy = int((~explore).sum())
        obs, self.env_state, next_obs, reward, term, done = step_autoreset(
            env, gens, e, self.env_state, actions, dev)
        self.obs = obs
        self.ctx, ev_obs, ev_act, full = rp.context_add(
            self.ctx, next_obs, actions, reward, term)
        if self.bag is not None:
            ev_idx = self.ctx["timestep"] - cfg["context_len"]
            self.bag, accepted = rp.bag_add(self.bag, ev_obs, ev_act, ev_idx,
                                            full)
            if self.evicts:
                self.evict(ev_obs, ev_act, ev_idx, full & ~accepted)
        rp.replay_store(self.rb, next_obs, actions, reward, term)
        self.last_done = done
        rp.replay_finish(self.rb, done)
        rp.replay_start_episode(self.rb, obs, done, env.obs_mask)
        fresh = rp.new_context(gens, e, cfg["context_len"], env, obs)
        self.ctx = select(done, fresh, self.ctx)
        if self.bag is not None:
            self.bag = select(done, rp.new_bag(self.s * e, cfg["bag_size"],
                                               env, dev), self.bag)
        if not random_only:
            self.env_steps = self.env_steps + e

    # ----------------------------------------------------------- learning
    def update(self):
        cfg, s = self.cfg, self.s
        b = rp.sample(self.rb, self.gens, cfg["batch_size"],
                      cfg["context_len"], cfg["bag_size"], self.env.obs_mask)
        if self.half_batch:
            half = cfg["batch_size"] // 2

            def first_half(x):
                x = self._seeded(x)[:, :half]
                return torch.cat([x, x], 1).reshape(-1, *x.shape[2:])

            b = {k: first_half(v) for k, v in b.items()}
        ok = self.rb["flushed"] > cfg["batch_size"]
        bag = b.get("bag_obs")
        with torch.no_grad():
            next_act = torch.argmax(self.q(self.params, b["next_obs"], bag),
                                    dim=-1)
            next_q = torch.gather(self.q(self.target, b["next_obs"], bag), -1,
                                  next_act[..., None])[..., 0]
            targets = (b["reward"] + (1.0 - b["done"].to(torch.float32))
                       * cfg["gamma"] * next_q)
        leaves = {k: v.detach().requires_grad_() for k, v in
                  self.params.items()}
        q_all = self.q(leaves, b["obs"], bag)
        q_taken = torch.gather(q_all, -1, b["action"].long()[..., None])[..., 0]
        hist = cfg["history"]
        err = torch.square(q_taken[:, -hist:] - targets[:, -hist:])
        td = err.reshape(s, -1).mean(-1)
        grads = torch.autograd.grad(td.sum(), [leaves[k] for k in self.names])
        grads = dict(zip(self.names, grads))
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.square(g).reshape(s, -1).sum(-1)
                                   for g in grads.values()))
            finite = torch.isfinite(gnorm)
            apply = ok & finite
            b1, b2, eps = ADAM
            count = self.count + 1
            countf = count.to(torch.float32)
            for k in self.names:
                shape = (s,) + (1,) * (grads[k].dim() - 1)
                g = grads[k]
                g = torch.where((gnorm < cfg["grad_clip"]).reshape(shape), g,
                                g / gnorm.reshape(shape) * cfg["grad_clip"])
                mu = (1 - b1) * g + b1 * self.mu[k]
                nu = (1 - b2) * g * g + b2 * self.nu[k]
                mu_hat = mu / (1 - torch.pow(b1, countf)).reshape(shape)
                nu_hat = nu / (1 - torch.pow(b2, countf)).reshape(shape)
                new = self.params[k] - cfg["lr"] * (
                    mu_hat / (torch.sqrt(nu_hat) + eps))
                gate = apply.reshape(shape)
                self.params[k] = torch.where(gate, new, self.params[k])
                self.mu[k] = torch.where(gate, mu, self.mu[k])
                self.nu[k] = torch.where(gate, nu, self.nu[k])
            self.count = torch.where(apply, count, self.count)
            self.train_steps = self.train_steps + apply.to(torch.int32)
            swap = apply & (self.train_steps % cfg["target_update"] == 0)
            for k in self.names:
                shape = (s,) + (1,) * (self.params[k].dim() - 1)
                self.target[k] = torch.where(swap.reshape(shape),
                                             self.params[k], self.target[k])
            self.nonfinite = self.nonfinite + (ok & ~finite).to(torch.int32)
            self.losses.append(torch.where(apply, td.detach(),
                                           torch.full_like(td, float("nan"))))
            self.gnorms.append(torch.where(apply, gnorm,
                                           torch.full_like(gnorm, float("nan"))))

    # -------------------------------------------------------------- driving
    def prepopulate(self):
        for _ in range(max(self.cfg["prepop_steps"] // self.e, 1)):
            self.env_step(random_only=True)

    def iteration(self, updates: int):
        self.env_step(random_only=False)
        for _ in range(updates):
            self.update()
        decay = (1.0 - 1.0 / self.cfg["eps_duration"]) ** self.e
        floor = self.cfg["eps_end"]
        self.epsilon = torch.clamp_min(
            floor + (self.epsilon - floor) * decay, floor)

    def take_learned_state(self, obs: Dict[str, torch.Tensor]) -> None:
        """Continues from another run's learned state, as ``observables``
        names it: its weights, target weights, Adam moments and count, and
        its bags; the envs, contexts, replay, counters and generators stay
        this run's own."""
        dev = self.device
        for k in self.names:
            self.params[k] = obs[f"params.{k}"].to(dev).clone()
            self.target[k] = obs[f"target.{k}"].to(dev).clone()
            self.mu[k] = obs[f"mu.{k}"].to(dev).clone()
            self.nu[k] = obs[f"nu.{k}"].to(dev).clone()
        self.count = obs["adam_count"].to(dev).clone()
        if self.bag is not None:
            self.bag = {k: obs[f"bag.{k}"].to(dev).clone() for k in self.bag}

    def take_full_state(self, obs: Dict[str, torch.Tensor],
                        generator_states: List[torch.Tensor]) -> None:
        """Continues from another run's whole state: its learned state, and
        its envs, contexts, replay, counters and generators too (each of
        this run's own tensors taken, by the name ``observables`` gives
        it)."""
        dev = self.device

        def load(prefix, mine):
            return {k: obs[prefix + k].to(dev).clone() for k in mine}

        self.env_state = load("env.", self.env_state)
        self.obs = obs["obs"].to(dev).clone()
        self.ctx = load("context.", self.ctx)
        self.rb = load("replay.", self.rb)
        if self.bag is not None:
            self.bag = load("bag.", self.bag)
        self.env_steps = obs["env_steps"].to(dev).clone()
        self.train_steps = obs["train_steps"].to(dev).clone()
        self.epsilon = obs["epsilon"].to(dev).clone()
        self.nonfinite = obs["nonfinite"].to(dev).clone()
        self.take_learned_state(obs)
        for g, state in zip(self.gens, generator_states):
            g.set_state(state)

    def observables(self) -> Dict[str, torch.Tensor]:
        """What the comparison reads, as ``perfbench.compare`` names it."""
        out = {f"env.{k}": v for k, v in self.env_state.items()}
        out["obs"] = self.obs
        out.update({f"context.{k}": v for k, v in self.ctx.items()})
        out.update({f"replay.{k}": v for k, v in self.rb.items()})
        if self.bag is not None:
            out.update({f"bag.{k}": v for k, v in self.bag.items()})
        out.update({"env_steps": self.env_steps,
                    "train_steps": self.train_steps,
                    "epsilon": self.epsilon, "nonfinite": self.nonfinite,
                    "adam_count": self.count})
        for k in self.names:
            out[f"params.{k}"] = self.params[k]
            out[f"target.{k}"] = self.target[k]
            out[f"mu.{k}"] = self.mu[k]
            out[f"nu.{k}"] = self.nu[k]
        out["losses"] = torch.stack(self.losses, -1)  # [S, U]
        out["gnorms"] = torch.stack(self.gnorms, -1)
        return {k: v.detach().to("cpu", copy=True) for k, v in out.items()}
