"""DDQN agent core: act / observe / learn (``dtqn_tpu/agents/base.py``).

One agent for every model, its behaviour picked by the model's kind:

  - "transformer" (DTQN, DTQN-bag): acts on the full context window and
    takes the argmax of the newest timestep's Q (dtqn.py:76-107); trains
    seq-to-seq with the DDQN target and loss over the last ``history``
    timesteps (dtqn.py:162-269).  With a bag, the (obs, action) pair that
    the context evicts goes into the persistent-memory bag, and a full bag
    keeps the best of its ``bag_size + 1`` candidate contents by Q
    (dtqn.py:125-157).
  - "feedforward" (DQN): context length 1 (agent_utils.py:109-110); acts on
    the current observation.
  - "recurrent" (DRQN, ADRQN, DARQN): acts one step at a time, carrying the
    LSTM state in ``AgentState.carry`` (agents/drqn.py:88-112); trains over
    whole windows with the outputs past the episode's length masked
    (agents/drqn.py:114-210).

With dropout, the update's three forwards (the policy and target
next-Q lanes and the loss forward) run in train mode, each with masks of its
own from the agent's generator; acting, evaluation and the evict forward
stay deterministic (agents/base.py:245-257, 480-512).

Everything stays on the device and no step reads a value back to the host:
the update is gated by ``can_sample & isfinite(grad_norm)`` with
``torch.where``, and clip + Adam are written out over one flat parameter
vector (as ``optax.flatten`` does) so the gate covers the optimizer state
too.  The state is updated in place.

``init_sweep_state(seeds)`` stacks S seeds into one state, the port's
counterpart of ``jax.vmap`` over stacked ``AgentState``s
(``dtqn_tpu/train/sweep.py``): parameters, target and Adam moments [S, P]
behind a ``StackedNetwork``; counters, epsilon and diagnostics [S]; the S*E
envs, contexts, bags, carries and replay rows one batch, seed-major; one
generator per seed, from which each seed draws what its own run draws, in
the same order.  Every function below takes either state; each dispatched
operation then serves all S seeds.

An agent built with a ``mesh`` of several ranks (``parallel/mesh.py``) acts
and learns on one rank's part of a sharded state: its envs' draws are the
rank's slices of the global draws, it samples the global batch and trains
on its share, and it all-reduces the gradient before the clip.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from dtqn_tpu_torch import replay
from dtqn_tpu_torch.envs.core import (
    Environment,
    cat_batch,
    stack_batch,
    where_batch,
)
from dtqn_tpu_torch.models import (
    MODEL_MAP,
    RECURRENT_MODELS,
    LSTMCarry,
    build_network,
    zero_carry,
)
from dtqn_tpu_torch.models.dropout import DropoutDraws
from dtqn_tpu_torch.models.stacked import StackedNetwork
from dtqn_tpu_torch.ops import cuda_optimizer
from dtqn_tpu_torch.utils.device import resolve_device
from dtqn_tpu_torch.utils.metrics import TrainDiagnostics
from dtqn_tpu_torch.utils.profiling import phase
from dtqn_tpu_torch.utils.rng import ShardedGenerator, folded_draw

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam defaults


@dataclasses.dataclass(frozen=True)
class AgentConfig:
    """Static hyperparameters (reference defaults from run.py:16-184)."""

    model: str = "DTQN"
    num_envs: int = 1
    # Learning (dqn.py:35-41)
    learning_rate: float = 3e-4
    batch_size: int = 32
    context_len: int = 50
    history: int = 50
    gamma: float = 0.99
    grad_norm_clip: float = 1.0
    target_update_frequency: int = 10_000
    buffer_size: int = 500_000
    # Architecture (run.py:92-175)
    embed_per_obs_dim: int = 8
    action_dim: int = 0
    inner_embed: int = 128
    num_heads: int = 8
    num_layers: int = 2
    dropout: float = 0.0
    gate: str = "res"
    identity: bool = False
    pos: str = "learned"
    bag_size: int = 0
    bag_mask: bool = False  # masked-bag-attention ablation (models/dtqn.py)
    # Train on stored act-time bags instead of random pre-window subsets
    # (replay/buffer.py sample_with_stored_bag).
    bag_store: bool = False
    # bfloat16 compute dtype (the JAX package's set_compute_dtype): the
    # networks' activations and products in bf16, parameters, Adam moments,
    # gradients and the Bellman tail in float32.
    bf16: bool = False

    @property
    def kind(self) -> str:
        if "DTQN" in self.model:
            return "transformer"
        if self.model in RECURRENT_MODELS:
            return "recurrent"
        return "feedforward"


@dataclasses.dataclass
class AdamState:
    """optax.adam's state over the flat parameter vector."""

    mu: torch.Tensor  # [P] f32
    nu: torch.Tensor  # [P] f32
    count: torch.Tensor  # int32 scalar


@dataclasses.dataclass
class AgentState:
    """Complete on-device learner+actor state.

    ``network`` / ``target_network`` are the policy and target networks;
    their parameters are views into the flat vectors ``params`` /
    ``target_params``.  ``carry`` is the recurrent models' act-time LSTM
    state (None for the others).  A stacked state (``init_sweep_state``)
    holds ``StackedNetwork``s, [S, P] vectors, [S] scalars, S*E envs and a
    list of S generators.
    """

    network: nn.Module
    target_network: nn.Module
    params: torch.Tensor  # [P] f32
    target_params: torch.Tensor  # [P] f32
    opt_state: AdamState
    buffer: replay.BufferState
    context: replay.ContextState
    bag: Optional[replay.BagState]
    carry: Optional[LSTMCarry]
    env_state: Any
    obs: torch.Tensor  # [E, *obs_shape] current observations
    generator: Any  # torch.Generator, or one per seed (stacked)
    env_steps: torch.Tensor  # int64 scalar
    train_steps: torch.Tensor  # int32 scalar: gradient updates applied
    epsilon: torch.Tensor  # f32 scalar
    diagnostics: TrainDiagnostics
    nonfinite_grads: torch.Tensor  # int32 scalar

    @property
    def seed_shape(self):
        """() for one seed, (S,) for a stacked state."""
        return self.train_steps.shape


def flatten_parameters(module: nn.Module) -> torch.Tensor:
    """Moves every parameter of ``module`` into one flat vector, returned;
    the parameters become views of it."""
    params = list(module.parameters())
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    offset = 0
    for p in params:
        n = p.numel()
        p.data = flat[offset:offset + n].view_as(p)
        offset += n
    return flat


def clip_adam_update(
    params: torch.Tensor,
    grads: torch.Tensor,
    gnorm: torch.Tensor,
    opt: AdamState,
    apply: torch.Tensor,
    learning_rate: float,
    max_norm: float,
) -> None:
    """``optax.chain(clip_by_global_norm, adam)`` then ``apply_updates``,
    written into ``params`` and ``opt`` only where ``apply`` (device bool).

    ``gnorm`` is the global norm of ``grads``.  The clip leaves g as it is
    when gnorm < max_norm, else scales it by max_norm / gnorm (no epsilon,
    unlike ``clip_grad_norm_``).  Stacked, ``params`` and ``grads`` are
    [S, P] and ``gnorm``, ``apply`` and the count [S]: each seed clips by
    its own norm and is gated on its own.
    """
    def col(x):  # a per-seed value against [S, P]
        return x[..., None] if params.dim() > 1 else x

    g = torch.where(col(gnorm < max_norm), grads,
                    grads / col(gnorm) * max_norm)
    count = opt.count + 1
    mu = (1 - ADAM_B1) * g + ADAM_B1 * opt.mu
    nu = (1 - ADAM_B2) * g * g + ADAM_B2 * opt.nu
    countf = col(count.to(torch.float32))
    mu_hat = mu / (1 - torch.pow(ADAM_B1, countf))
    nu_hat = nu / (1 - torch.pow(ADAM_B2, countf))
    new_params = params + (-learning_rate) * (
        mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)
    )
    gate = col(apply)
    params.copy_(torch.where(gate, new_params, params))
    opt.mu.copy_(torch.where(gate, mu, opt.mu))
    opt.nu.copy_(torch.where(gate, nu, opt.nu))
    opt.count = torch.where(apply, count, opt.count)


def gated_adam_step(state: AgentState, flat_grads: torch.Tensor,
                    gnorm: torch.Tensor, ok: torch.Tensor,
                    learning_rate: float, max_norm: float,
                    target_update_frequency: int) -> torch.Tensor:
    """The plain chain from the global norm on: the clip and Adam where the
    step is legal (``ok``) and its norm finite, the step counters, the hard
    target swap every ``target_update_frequency`` applied steps
    (dqn.py:205-210) and the count of non-finite gradients.  Returns the
    gate, ``apply``."""
    seeds = state.seed_shape
    finite = torch.isfinite(gnorm)
    apply = ok & finite  # apply only when sampling was legal
    clip_adam_update(
        state.params, flat_grads, gnorm, state.opt_state, apply,
        learning_rate, max_norm,
    )
    state.train_steps = state.train_steps + apply.to(torch.int32)
    swap = apply & (state.train_steps % target_update_frequency == 0)
    state.target_params.copy_(torch.where(
        swap[..., None] if seeds else swap, state.params,
        state.target_params))
    state.nonfinite_grads = state.nonfinite_grads + (
        ok & ~finite
    ).to(torch.int32)
    return apply


def optimizer_step(state: AgentState, flat_grads: torch.Tensor,
                   ok: torch.Tensor, learning_rate: float, max_norm: float,
                   target_update_frequency: int):
    """The step after the gradient (``flat_grads``, [P] or [S, P]):
    (gnorm, apply).  A CPU tensor takes the plain chain
    (``torch.linalg.vector_norm``, ``gated_adam_step``); a CUDA tensor the
    two kernels of ``ops/cuda_optimizer.py``, which round every element
    as the chain does and sum the norm in another order."""
    if flat_grads.device.type == "cpu":
        gnorm = torch.linalg.vector_norm(
            flat_grads, dim=-1 if state.seed_shape else None)
        return gnorm, gated_adam_step(
            state, flat_grads, gnorm, ok, learning_rate, max_norm,
            target_update_frequency)
    opt = state.opt_state
    gnorm, apply, opt.count, state.train_steps, state.nonfinite_grads = (
        cuda_optimizer.clip_adam_apply(
            state.params, flat_grads, opt.mu, opt.nu, opt.count, ok,
            state.train_steps, state.nonfinite_grads, state.target_params,
            learning_rate, max_norm, target_update_frequency,
            ADAM_B1, ADAM_B2, ADAM_EPS))
    return gnorm, apply


class Agent:
    """Builds the act / observe / learn functions for a config + env pair.

    Runs on ``cuda`` unless ``device`` says otherwise; raises when no GPU
    is found and the caller did not ask for the CPU.  With a ``mesh`` of
    several ranks, it runs one rank's part (``parallel/mesh.py``).
    """

    def __init__(self, config: AgentConfig, env: Environment,
                 device: Optional[str] = None, mesh=None):
        if config.model not in MODEL_MAP:
            raise KeyError(
                f"Unknown model {config.model!r}; choices: "
                f"{sorted(MODEL_MAP)}"
            )
        if config.model == "DQN" and config.context_len != 1:
            # The factory forces context 1 for DQN (agent_utils.py:109-110).
            config = dataclasses.replace(config, context_len=1)
        if not 1 <= config.history <= config.context_len:
            # Clip history into [1, context_len] (agent_utils.py:101-105).
            config = dataclasses.replace(
                config,
                history=int(min(max(config.history, 1), config.context_len)),
            )
        if env.num_actions < 1:
            # The JAX package's agent gets as far as its first greedy act,
            # an argmax over no actions; here the random context actions of
            # ``init_state`` already have no range to come from.
            raise ValueError(
                f"{env.name} has no discrete actions: the Q agents need "
                "them"
            )
        self.config = config
        self.env = env
        self.device = resolve_device(device)
        self.use_bag = config.kind == "transformer" and config.bag_size > 0
        self.store_act_bags = self.use_bag and config.bag_store
        # A mesh of one rank issues no collective: the one-device path.
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        # The memory pool that every CUDA graph of this agent's steps shares
        # (``utils/graphs.py``), made at the first capture.
        self.graph_pool = None

    def rank_generator(self, generator):
        """``generator`` as this rank's env-indexed draws take it: their
        slices of the global draws over a mesh, else itself."""
        if self.mesh is None:
            return generator
        return ShardedGenerator(generator, self.mesh)

    # ------------------------------------------------------------------ init
    def build_network(self, generator: Optional[torch.Generator] = None):
        """A fresh network on the CPU, weights drawn from ``generator``."""
        cfg = self.config
        return build_network(
            cfg.model,
            self.env,
            embed_per_obs_dim=cfg.embed_per_obs_dim,
            action_dim=cfg.action_dim,
            inner_embed=cfg.inner_embed,
            num_heads=cfg.num_heads,
            num_layers=cfg.num_layers,
            context_len=cfg.context_len,
            dropout=cfg.dropout,
            gate=cfg.gate,
            identity=cfg.identity,
            pos=cfg.pos,
            bag_size=cfg.bag_size,
            bag_mask=cfg.bag_mask,
            generator=generator,
            compute_dtype=torch.bfloat16 if cfg.bf16 else None,
        )

    def init_state(self, seed: int, external_obs=None) -> AgentState:
        """Initial state: weights from a CPU generator seeded with ``seed``
        (device-independent), run-time draws from a device generator.

        ``external_obs`` serves HOST environments (train/host_loop.py): the
        caller gives the reset observations [E, *obs_shape] (numpy or a
        tensor), they go to the device, and ``env_state`` stays None (the
        env's state lives on the host); ``env.reset_vec`` is not called."""
        cfg, env, device = self.config, self.env, self.device
        network = self.build_network(
            torch.Generator().manual_seed(seed)
        ).to(device)
        target_network = copy.deepcopy(network)
        params = flatten_parameters(network)
        target_params = flatten_parameters(target_network)
        generator = torch.Generator(device=device).manual_seed(seed)
        if external_obs is None:
            obs, env_state = env.reset_vec(generator, cfg.num_envs, device)
        else:
            obs, env_state = torch.as_tensor(external_obs, device=device), None
        context = replay.init_context(
            generator, cfg.num_envs, cfg.context_len, tuple(env.obs_shape),
            env.obs_dtype, env.obs_mask, env.num_actions, obs,
        )
        buffer = replay.init_buffer(
            num_envs=cfg.num_envs,
            buffer_size=cfg.buffer_size,
            max_episode_steps=env.max_episode_steps,
            context_len=cfg.context_len,
            obs_shape=tuple(env.obs_shape),
            obs_dtype=env.obs_dtype,
            obs_mask=env.obs_mask,
            device=device,
            act_bag_size=cfg.bag_size if self.store_act_bags else 0,
        )
        bag = (
            replay.init_bag(
                cfg.num_envs, cfg.bag_size, tuple(env.obs_shape),
                env.obs_dtype, env.obs_mask, device,
            )
            if self.use_bag
            else None
        )
        replay.store_first_obs(
            buffer, obs,
            torch.ones((cfg.num_envs,), dtype=torch.bool, device=device),
            env.obs_mask,
        )

        def scalar(value, dtype):
            return torch.tensor(value, dtype=dtype, device=device)

        return AgentState(
            network=network,
            target_network=target_network,
            params=params,
            target_params=target_params,
            opt_state=AdamState(
                mu=torch.zeros_like(params),
                nu=torch.zeros_like(params),
                count=scalar(0, torch.int32),
            ),
            buffer=buffer,
            context=context,
            bag=bag,
            carry=(zero_carry(cfg.num_envs, cfg.inner_embed, device)
                   if cfg.kind == "recurrent" else None),
            env_state=env_state,
            obs=obs,
            generator=generator,
            env_steps=scalar(0, torch.int64),
            train_steps=scalar(0, torch.int32),
            epsilon=scalar(1.0, torch.float32),
            diagnostics=TrainDiagnostics.create(100, device),
            nonfinite_grads=scalar(0, torch.int32),
        )

    def init_sweep_state(self, seeds) -> AgentState:
        """The seeds' initial states stacked into one (the JAX sweep's
        ``jax.vmap(agent._init_state_impl)``): seed i's part is bit for bit
        ``init_state(seeds[i])``, its weights and its generator included."""
        states = [self.init_state(seed) for seed in seeds]
        first = states[0]

        def cat(name):
            parts = [getattr(st, name) for st in states]
            return None if parts[0] is None else cat_batch(parts)

        def stack(name):
            return stack_batch([getattr(st, name) for st in states])

        params, target_params = stack("params"), stack("target_params")
        return AgentState(
            network=StackedNetwork(first.network, params),
            target_network=StackedNetwork(first.target_network,
                                          target_params),
            params=params,
            target_params=target_params,
            opt_state=stack("opt_state"),
            buffer=replay.stack_buffers([st.buffer for st in states]),
            context=cat("context"),
            bag=cat("bag"),
            carry=cat("carry"),
            env_state=cat("env_state"),
            obs=cat("obs"),
            generator=[st.generator for st in states],
            env_steps=stack("env_steps"),
            train_steps=stack("train_steps"),
            epsilon=stack("epsilon"),
            diagnostics=stack("diagnostics"),
            nonfinite_grads=stack("nonfinite_grads"),
        )

    # ------------------------------------------------------------ forwards
    @staticmethod
    def _bag_in(bag):
        """The network's bag arguments: () without a bag."""
        return () if bag is None else (bag.obs, bag.action)

    def _q_context(self, network, obs_seq, act_seq, bag_in=(), ep_len=None,
                   draws: Optional[DropoutDraws] = None):
        """Seq-to-seq Q over [B, L] windows: [B, L, A].  ``draws`` makes
        the transformer's forward a train-mode one (the reference's
        net.train(), dqn.py:113-115)."""
        kind = self.config.kind
        if kind == "transformer":
            return network(obs_seq, act_seq, *bag_in, draws=draws)
        if kind == "feedforward":
            return network(obs_seq)
        q, _ = network(obs_seq, act_seq, episode_lengths=ep_len)
        return q

    # ------------------------------------------------------------- acting
    @torch.no_grad()
    def greedy_actions(
        self, network: nn.Module, context: replay.ContextState,
        bag: Optional[replay.BagState] = None,
        carry: Optional[LSTMCarry] = None,
        obs: Optional[torch.Tensor] = None,
    ):
        """Greedy action [E] per env, and the carry after it: (actions,
        carry).

        Transformer: Q of the newest row of the full padded context
        (causality makes this the reference's truncated forward).
        Feedforward: Q of the current observations ``obs``.  Recurrent: one
        step of the LSTM from ``carry`` on (``obs``, the context's newest
        action) (agents/drqn.py:88-107).
        """
        kind = self.config.kind
        if kind == "feedforward":
            return torch.argmax(network(obs[:, None])[:, 0], dim=-1), carry
        e = torch.arange(context.obs.shape[0], device=context.obs.device)
        rows = context.last_index.to(torch.int64)
        if kind == "transformer":
            q = network(context.obs, context.action, *self._bag_in(bag))
            return torch.argmax(q[e, rows], dim=-1), carry
        q, carry = network(obs[:, None], context.action[e, rows][:, None],
                           carry=carry)
        return torch.argmax(q[:, 0], dim=-1), carry

    def select_actions(self, state: AgentState, epsilon):
        """Epsilon-greedy (dqn.py:117-131): (actions, carry).  The carry
        steps whether the draw explores or not.  Stacked, ``epsilon`` is
        per seed."""
        gen, device = self.rank_generator(state.generator), self.device
        greedy, carry = self.greedy_actions(
            state.network, state.context, state.bag, state.carry, state.obs
        )
        n = greedy.shape[0]
        u = folded_draw(gen, n, lambda g, k: torch.rand(
            (k,), generator=g, device=device))
        randoms = folded_draw(gen, n, lambda g, k: torch.randint(
            0, self.env.num_actions, (k,), generator=g, device=device))
        explore = (u.reshape(epsilon.shape + (-1,))
                   < epsilon[..., None]).reshape(-1)
        return torch.where(explore, randoms, greedy), carry

    # ------------------------------------------------------------ bag logic
    @torch.no_grad()
    def _bag_evict(
        self, network: nn.Module, context: replay.ContextState,
        bag: replay.BagState, evicted_obs, evicted_act, evicted_idx, need,
    ) -> replay.BagState:
        """Q-driven bag eviction (dtqn/agents/dtqn.py:125-157), batched.

        For envs where the bag rejected the evicted pair, score bag_size+1
        candidate bags (candidate i puts the evictee into slot i, the last
        one drops it) by the mean over the sequence of the max over actions
        of Q, and keep the first best.  ``evicted_idx`` is the evictee's
        episode obs index, tracked alongside for --bag-store.  The
        candidates of every env are scored in one forward at batch
        E * (bag_size + 1), at every step and with no host read; ``need``
        [E] bool says where the choice is applied.
        """
        e_count, bag_size = bag.obs.shape[0], bag.size
        n_cand = bag_size + 1
        device = bag.obs.device
        # replace[i, j]: candidate i holds the evictee in slot j.
        replace = (torch.arange(n_cand, device=device)[:, None]
                   == torch.arange(bag_size, device=device)[None, :])[None]
        obs_nd = (1,) * (bag.obs.dim() - 2)
        # [E, n_cand, bag, ...]
        cand_obs = torch.where(
            replace.reshape(1, n_cand, bag_size, *obs_nd),
            evicted_obs.to(bag.obs.dtype)[:, None, None],
            bag.obs[:, None],
        )
        cand_act = torch.where(
            replace, evicted_act.to(bag.action.dtype)[:, None, None],
            bag.action[:, None],
        )
        cand_idx = torch.where(
            replace, evicted_idx.to(bag.obs_idx.dtype)[:, None, None],
            bag.obs_idx[:, None],
        )

        def tile(x):
            return x.repeat_interleave(n_cand, dim=0)

        q = network(
            tile(context.obs),
            tile(context.action),
            cand_obs.reshape(e_count * n_cand, bag_size, *bag.obs.shape[2:]),
            cand_act.reshape(e_count * n_cand, bag_size),
        )
        score = q.amax(dim=-1).mean(dim=-1).reshape(e_count, n_cand)
        best = torch.argmax(score, dim=-1)  # [E], the first maximum
        e = torch.arange(e_count, device=device)
        return replay.BagState(
            obs=where_batch(need, cand_obs[e, best], bag.obs),
            action=where_batch(need, cand_act[e, best], bag.action),
            obs_idx=where_batch(need, cand_idx[e, best], bag.obs_idx),
            pos=bag.pos,
        )

    # ----------------------------------------------------------- observing
    def observe(self, state: AgentState, action, next_obs, reward,
                buffer_done) -> AgentState:
        """Context append + bag insertion + replay store (dtqn.py:116-160):
        phases ``replay_write``, ``evict`` (with a bag), ``replay_write``."""
        with phase("replay_write"):
            state.context, ev_obs, ev_act, was_full = replay.add_transition(
                state.context, next_obs, action, reward, buffer_done
            )
        if self.use_bag:
            with phase("evict"):
                # The evicted entry is the context's oldest: episode obs
                # index t - L, where t is the transition count just
                # incremented.
                ev_idx = state.context.timestep - self.config.context_len
                bag, accepted = replay.bag_add(
                    state.bag, ev_obs, ev_act, ev_idx, was_full
                )
                state.bag = self._bag_evict(
                    state.network, state.context, bag, ev_obs, ev_act,
                    ev_idx, was_full & ~accepted,
                )
        with phase("replay_write"):
            replay.store_step(state.buffer, next_obs, action, reward,
                              buffer_done)
            if self.store_act_bags:
                replay.store_act_bag(state.buffer, state.bag.obs_idx,
                                     state.bag.action)
        return state

    def handle_resets(self, state: AgentState, done,
                      reset_obs) -> AgentState:
        """Flush finished episodes and start fresh contexts, bags and
        carries (run.py:293-296 + context_reset dtqn.py:109-114): phase
        ``replay_write``."""
        with phase("replay_write"):
            replay.flush(state.buffer, done, self.mesh)
            replay.store_first_obs(state.buffer, reset_obs, done,
                                   self.env.obs_mask)
            state.context = replay.reset_context(
                state.context, self.rank_generator(state.generator),
                reset_obs, done, self.env.obs_mask, self.env.num_actions,
            )
            if self.use_bag:
                state.bag = replay.reset_bag(state.bag, done,
                                             self.env.obs_mask)
            if state.carry is not None:
                state.carry = where_batch(
                    done, zero_carry(*state.carry.c.shape, self.device),
                    state.carry,
                )
        return state

    # ------------------------------------------------------------- learning
    def sample_batch(self, buffer: replay.BufferState,
                     generator: torch.Generator) -> replay.Batch:
        """The batch of one update: over a mesh, this rank's share of the
        global batch."""
        cfg = self.config
        if self.store_act_bags:
            return replay.sample_with_stored_bag(
                buffer, generator, cfg.batch_size, cfg.context_len,
                self.env.obs_mask, self.mesh,
            )
        if self.use_bag:
            return replay.sample_with_bag(
                buffer, generator, cfg.batch_size, cfg.context_len,
                cfg.bag_size, self.env.obs_mask, self.mesh,
            )
        return replay.sample(buffer, generator, cfg.batch_size,
                             cfg.context_len, self.mesh)

    def learn(self, state: AgentState) -> AgentState:
        """One gated DDQN gradient step (dtqn.py:162-269, dqn.py:142-206):
        phases ``sample`` and ``update``."""
        with phase("sample"):
            batch = self.sample_batch(state.buffer, state.generator)
        with phase("update"):
            return self.apply_update(state, batch)

    def dropout_draws(self, state: AgentState, masks=None, window=None):
        """The masks of one train-mode forward: None without dropout (or
        outside DTQN, whose option it is: the other models ignore it, as in
        the JAX package), else drawn from the agent's generator or, for
        tests, the given ones.  A stacked state draws them here, for a
        forward over ``window`` = (S*B, L): each seed's masks from its own
        generator, site by site in the order a forward's sites draw them.
        Over a mesh, each site's mask is drawn over the global batch and
        this rank keeps its share."""
        if self.config.dropout <= 0.0 or self.config.kind != "transformer":
            return None
        if masks is not None:
            return DropoutDraws(masks=masks)
        gen = state.generator
        keep = 1.0 - self.config.dropout
        if self.mesh is not None:
            shapes = state.network.dropout_shapes(self.config.batch_size,
                                                  window[1])
            return DropoutDraws(masks=[self.mesh.share(torch.rand(
                shape, generator=gen, device=self.device) < keep)
                for shape in shapes])
        if isinstance(gen, torch.Generator):
            return DropoutDraws(generator=gen)
        total, length = window
        shapes = state.network.module.dropout_shapes(total // len(gen),
                                                     length)
        return DropoutDraws(masks=[
            folded_draw(gen, total, lambda g, n, shape=shape: torch.rand(
                (n, *shape[1:]), generator=g, device=self.device) < keep)
            for shape in shapes])

    def apply_update(self, state: AgentState, batch: replay.Batch,
                     masks=None):
        """The gradient step on a given batch (dtqn.py:196-269).  With
        dropout, ``masks`` may give each forward's masks in call order, as
        (policy next-Q, target next-Q, loss) lists.  Stacked, the batch is
        S seed-major blocks of B windows and each seed's loss, gradient,
        clip, Adam step, gate and target swap are its own.  Over a mesh,
        the batch is this rank's share of the global one."""
        cfg = self.config
        seeds = state.seed_shape
        ok = replay.can_sample(state.buffer, cfg.batch_size)
        hist = cfg.history
        window = batch.obs.shape[:2]
        bag_in = (batch.bag_obs, batch.bag_action) if self.use_bag else ()
        policy_masks, target_masks, loss_masks = masks or (None,) * 3

        # DDQN target: policy-net argmax selector, target-net value
        # (dtqn.py:221-238), both without gradients, each lane with masks
        # of its own.
        with torch.no_grad():
            next_q_policy, next_q_target = (
                self._q_context(net, batch.next_obs, batch.next_action,
                                bag_in, batch.ep_len,
                                self.dropout_draws(state, lane_masks, window))
                for net, lane_masks in (
                    (state.network, policy_masks),
                    (state.target_network, target_masks))
            )
            next_act = torch.argmax(next_q_policy, dim=-1)
            next_q = torch.gather(
                next_q_target, -1, next_act[..., None]
            )[..., 0].to(torch.float32)
            dones = batch.done.to(torch.float32)
            targets = batch.reward + (1.0 - dones) * cfg.gamma * next_q

        q_all = self._q_context(state.network, batch.obs, batch.action,
                                bag_in, batch.ep_len,
                                self.dropout_draws(state, loss_masks, window))
        q_taken = torch.gather(
            q_all, -1, batch.action.to(torch.int64)[..., None]
        )[..., 0].to(torch.float32)
        q_h = q_taken[:, -hist:]
        t_h = targets[:, -hist:]
        if seeds:
            # Seeds share no term: each seed's slice of the gradient of the
            # sum is the gradient of its own loss.
            td = torch.square(q_h - t_h).reshape(seeds + (-1,)).mean(-1)
            loss = td.sum()
        elif self.mesh is not None:
            # This rank's share of the global mean: summed over the ranks
            # with the gradient, it is the one-device loss.
            td = loss = torch.square(q_h - t_h).sum() / (
                cfg.batch_size * q_h.shape[1])
        else:
            td = loss = torch.mean(torch.square(q_h - t_h))
        params = list(state.network.parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        flat_grads = torch.cat([
            (g if g is not None else torch.zeros_like(p)).reshape(
                seeds + (-1,))
            for g, p in zip(grads, params)
        ], dim=-1)
        if self.mesh is not None:
            self.mesh.all_reduce(flat_grads)

        with torch.no_grad():
            gnorm, apply = optimizer_step(
                state, flat_grads, ok, cfg.learning_rate, cfg.grad_norm_clip,
                cfg.target_update_frequency)
            state.diagnostics.update(
                apply, td=td.detach(), gnorm=gnorm, q=q_h.detach(),
                targets=t_h, mesh=self.mesh,
            )
        return state
