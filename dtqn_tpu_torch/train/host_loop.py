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

The JAX package jits the device halves between those copies
(``make_host_fns``, ``make_host_eval``).  On the card the port captures
each as a CUDA graph (``compiled_host_fns``, ``compiled_host_eval``) over
static buffers: the host's arrays are copied into them through pinned
staging buffers before a replay (``StagedInputs``), and the actions leave
the act graph in a buffer that ``actions_to_host`` copies after it.  An
iteration then runs two graph replays and the host step.  On the CPU the
functions are the plain bodies.

Evaluation runs ``eval_episodes`` host envs with greedy device acting
(run.py:187-243; success = is_success flag or positive return).  As the
JAX package's host evaluation, and unlike ``train/loop.make_evaluate``,
the contexts of finished episodes keep rolling (their metrics are frozen
on the host), and the host reads its own ``finished`` flags every step.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

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
from dtqn_tpu_torch.utils.graphs import (
    GraphedStep,
    copy_states,
    fresh_buffers,
    own_generators,
    write_back,
)
from dtqn_tpu_torch.utils.logging import get_logger, timestamp
from dtqn_tpu_torch.utils.profiling import phase
from dtqn_tpu_torch.utils.rng import seed_everything
from dtqn_tpu_torch.utils.tree import leaves

# The arrays of a host step that the device's observe/reset path takes.
STEP_KEYS = ("next_obs", "reward", "terminated", "done", "reset_obs")


class StagedInputs:
    """Static device buffers, by name, that host arrays are copied into
    through pinned host buffers of their own: the inputs that a graph of
    the host loop reads, filled before its replay.  A copy does not wait
    for the card; the loops that load read a device value (the actions)
    between two loads of one name, so a pinned buffer is rewritten only
    after the copy out of it has run.  On the CPU the copy is direct."""

    def __init__(self, specs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
                 device):
        self.buffers = {name: torch.empty(shape, dtype=dtype, device=device)
                        for name, (shape, dtype) in specs.items()}
        self.staging = (
            {name: torch.empty(shape, dtype=dtype, pin_memory=True)
             for name, (shape, dtype) in specs.items()}
            if torch.device(device).type == "cuda" else None)

    def load(self, name: str, array) -> torch.Tensor:
        host = torch.as_tensor(array)
        if self.staging is not None:
            host = self.staging[name].copy_(host)
        return self.buffers[name].copy_(host, non_blocking=True)


def actions_to_host(actions: torch.Tensor) -> np.ndarray:
    """The device-to-host copy of an iteration: the actions [E]."""
    return actions.cpu().numpy()


def to_device(array, device, inputs: Optional[StagedInputs] = None,
              name: Optional[str] = None) -> torch.Tensor:
    """One host-to-device copy: into the static buffer ``name`` of
    ``inputs`` where given, else into a new tensor."""
    if inputs is None:
        return torch.as_tensor(array, device=device)
    return inputs.load(name, array)


def step_to_device(out: Dict[str, np.ndarray], device,
                   inputs: Optional[StagedInputs] = None
                   ) -> List[torch.Tensor]:
    """The host-to-device copies of an iteration: each of ``STEP_KEYS``'s
    arrays of the host step ``out`` (into ``inputs``' buffers where
    given)."""
    return [to_device(out[k], device, inputs, k) for k in STEP_KEYS]


def _compile(agent: Agent, name: str, step, graphed: bool):
    """``step`` as a CUDA graph (``GraphedStep``), or written back."""
    return GraphedStep(name, step, agent, 1) if graphed else write_back(step)


def _load(target, given) -> None:
    """Copies ``given`` (a tensor or a tree of them) into ``target``, the
    buffer it stands for, unless it is that buffer."""
    if given is target:
        return
    if isinstance(target, torch.Tensor):
        target.copy_(given)
        return
    for (_, t), (_, g) in zip(leaves(target), leaves(given), strict=True):
        t.copy_(g)


class HostFns(NamedTuple):
    """The device halves of the host loop (``make_host_fns``), and the
    static buffers that ``step_to_device`` fills for them (None for the
    plain bodies, which take new tensors)."""

    act: Callable
    act_random: Callable
    observe_only: Callable
    observe_and_learn: Callable
    inputs: Optional[StagedInputs] = None


def make_host_bodies(agent: Agent, eps: EpsilonSchedule,
                     updates_per_iter: int) -> HostFns:
    """The plain device halves of the host loop: ``act(state)`` and
    ``act_random(state)`` return actions [E]; ``observe_only(state,
    actions, *step)`` and ``observe_and_learn(state, actions, *step)``
    (``step``: the device arrays of ``STEP_KEYS``) store the step.  All
    update ``state`` in place."""
    cfg = agent.config

    def act(state: AgentState) -> torch.Tensor:
        with phase("act"):
            actions, state.carry = agent.select_actions(state,
                                                        state.epsilon)
        return actions

    def act_random(state: AgentState) -> torch.Tensor:
        with phase("act"):
            return torch.randint(0, agent.env.num_actions, (cfg.num_envs,),
                                 generator=state.generator,
                                 device=agent.device)

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

    return HostFns(act, act_random, observe_only, observe_and_learn)


@dataclasses.dataclass
class HostIO:
    """What the graphs of the host loop's training halves read and write:
    the agent's state, the actions [E] and a host step's arrays
    (``STEP_KEYS``), the last six static buffers."""

    state: Any
    actions: torch.Tensor
    next_obs: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor
    done: torch.Tensor
    reset_obs: torch.Tensor


def compiled_host_fns(agent: Agent, bodies: HostFns, graphed: bool
                      ) -> HostFns:
    """``bodies`` as steps over one ``HostIO`` whose buffers stay put:
    each a ``GraphedStep`` where ``graphed`` (``act`` and ``act_random``
    leave the actions in their buffer, which the functions return), else
    written back, as the CPU tests run them.  The functions are called as
    the bodies are; an argument that is not the buffer it stands for is
    copied into it.  Each function's ``graph`` is the step it runs."""
    e, env = agent.config.num_envs, agent.env
    obs = ((e, *env.obs_shape), env.obs_dtype)
    inputs = StagedInputs(dict(
        actions=((e,), torch.int64), next_obs=obs,
        reward=((e,), torch.float32), terminated=((e,), torch.bool),
        done=((e,), torch.bool), reset_obs=obs), agent.device)
    io = HostIO(None, **inputs.buffers)

    def acting(name, body):
        def step(io: HostIO) -> HostIO:
            io.actions = body(io.state)
            return io

        compiled = _compile(agent, name, step, graphed)

        def call(state):
            io.state = state
            compiled(io)
            return io.actions

        call.graph = compiled
        return call

    def observing(name, body):
        def step(io: HostIO) -> HostIO:
            body(io.state, io.actions, *(getattr(io, k) for k in STEP_KEYS))
            return io

        compiled = _compile(agent, name, step, graphed)

        def call(state, actions, *arrays):
            io.state = state
            for k, given in zip(("actions",) + STEP_KEYS, (actions, *arrays),
                                strict=True):
                _load(getattr(io, k), given)
            compiled(io)
            return state

        call.graph = compiled
        return call

    return HostFns(
        acting("host act", bodies.act),
        acting("host random act", bodies.act_random),
        observing("host observe", bodies.observe_only),
        observing("host observe and learn", bodies.observe_and_learn),
        inputs)


def make_host_fns(agent: Agent, eps: EpsilonSchedule,
                  updates_per_iter: int) -> HostFns:
    """The compiled device halves of the host loop
    (``dtqn_tpu/train/host_loop.py:41``): on the card each of the four is a
    CUDA graph, ``observe_and_learn`` whole (observe, resets, the updates,
    the epsilon anneal and ``env_steps``: JAX's scan of updates unrolled);
    on the CPU the plain bodies (``make_host_bodies``)."""
    bodies = make_host_bodies(agent, eps, updates_per_iter)
    if agent.device.type != "cuda":
        return bodies
    return compiled_host_fns(agent, bodies, graphed=True)


def host_iteration(vec: HostVecEnv, state: AgentState, act_fn, update_fn,
                   inputs: Optional[StagedInputs] = None):
    """One iteration: act on the device, step the host envs, store the step
    on the device (the host/device boundary of the module docstring;
    ``inputs``: the compiled functions' buffers)."""
    actions = act_fn(state)
    out = vec.step(actions_to_host(actions))
    return update_fn(state, actions,
                     *step_to_device(out, actions.device, inputs))


class HostEvalFns(NamedTuple):
    """The device halves of host-side evaluation (``make_host_eval``), and
    the static buffers that their host arrays are loaded into (None for the
    plain bodies)."""

    eval_init: Callable
    greedy: Callable
    eval_observe: Callable
    inputs: Optional[StagedInputs] = None


def make_host_eval_bodies(agent: Agent, meta: HostEnvironment,
                          n: int) -> HostEvalFns:
    """The plain device halves of host-side greedy evaluation over n envs:
    ``eval_init(generator, obs)`` -> (context, bag, carry), ``greedy``
    (``agent.greedy_actions``) and ``eval_observe(network, context, bag,
    next_obs, actions, reward, terminated, live)`` -> (context, bag)."""
    cfg, device = agent.config, agent.device

    @torch.no_grad()
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

    def greedy(*args):
        with phase("act"):
            return agent.greedy_actions(*args)

    @torch.no_grad()
    def eval_observe(network, context, bag, next_obs, actions, reward,
                     terminated, live):
        with phase("replay_write"):
            context, ev_obs, ev_act, was_full = replay.add_transition(
                context, next_obs, actions, reward, terminated
            )
        if agent.use_bag:
            with phase("evict"):
                need = was_full & live
                ev_idx = context.timestep - cfg.context_len
                bag, accepted = replay.bag_add(bag, ev_obs, ev_act, ev_idx,
                                               need)
                bag = agent._bag_evict(network, context, bag, ev_obs,
                                       ev_act, ev_idx, need & ~accepted)
        return context, bag

    return HostEvalFns(eval_init, greedy, eval_observe)


@dataclasses.dataclass
class HostEvalIO:
    """What the graphs of host-side evaluation read and write: the network,
    the generator the contexts draw from (the graphs' own), the contexts,
    bags and carries, and the static buffers of the host arrays."""

    network: Any
    generator: Any
    obs: torch.Tensor
    actions: torch.Tensor
    next_obs: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor
    live: torch.Tensor
    context: Any = None
    bag: Any = None
    carry: Any = None


def compiled_host_eval(agent: Agent, meta: HostEnvironment, n: int,
                       bodies: HostEvalFns, graphed: bool) -> HostEvalFns:
    """``bodies`` as steps over one ``HostEvalIO`` whose buffers stay put,
    each a ``GraphedStep`` where ``graphed``, else written back.  The
    functions are called as the bodies are and return the buffers;
    ``eval_init`` draws from a generator of its own, loaded with the
    caller's state and copied back after the replay.  Each function's
    ``graph`` is the step it runs."""
    obs = ((n, *meta.obs_shape), meta.obs_dtype)
    flags = ((n,), torch.bool)
    inputs = StagedInputs(dict(
        obs=obs, actions=((n,), torch.int64), next_obs=obs,
        reward=((n,), torch.float32), terminated=flags, live=flags),
        agent.device)
    io = HostEvalIO(None, None, **inputs.buffers)

    def init_step(io: HostEvalIO) -> HostEvalIO:
        io.context, io.bag, io.carry = bodies.eval_init(io.generator, io.obs)
        return io

    def greedy_step(io: HostEvalIO) -> HostEvalIO:
        io.actions, io.carry = bodies.greedy(io.network, io.context, io.bag,
                                             io.carry, io.obs)
        return io

    def observe_step(io: HostEvalIO) -> HostEvalIO:
        io.context, io.bag = bodies.eval_observe(
            io.network, io.context, io.bag, io.next_obs, io.actions,
            io.reward, io.terminated, io.live)
        return io

    init_c, greedy_c, observe_c = (
        _compile(agent, name, step, graphed) for name, step in (
            ("host evaluation reset", init_step),
            ("host greedy act", greedy_step),
            ("host evaluation observe", observe_step)))

    def eval_init(generator, obs):
        # The reset reads no network: its graph is bound to none.
        io.network = None
        _load(io.obs, obs)
        if io.context is None:
            # The buffers: one eager call, outside any capture.
            io.generator = own_generators(generator, agent.device)
            copy_states(generator, io.generator)
            init_step(io)
            io.context, io.bag, io.carry = (
                None if x is None else fresh_buffers(x)
                for x in (io.context, io.bag, io.carry))
        copy_states(generator, io.generator)
        init_c(io)
        copy_states(io.generator, generator)
        return io.context, io.bag, io.carry

    def greedy(network, context, bag, carry, obs):
        io.network = network
        for name, given in (("context", context), ("bag", bag),
                            ("carry", carry), ("obs", obs)):
            _load(getattr(io, name), given)
        greedy_c(io)
        return io.actions, io.carry

    def eval_observe(network, context, bag, next_obs, actions, reward,
                     terminated, live):
        io.network = network
        for name, given in (("context", context), ("bag", bag),
                            ("next_obs", next_obs), ("actions", actions),
                            ("reward", reward), ("terminated", terminated),
                            ("live", live)):
            _load(getattr(io, name), given)
        observe_c(io)
        return io.context, io.bag

    eval_init.graph, greedy.graph, eval_observe.graph = (
        init_c, greedy_c, observe_c)
    return HostEvalFns(eval_init, greedy, eval_observe, inputs)


def make_host_eval(agent: Agent, meta: HostEnvironment, n: int
                   ) -> HostEvalFns:
    """The compiled device halves of host-side evaluation
    (``dtqn_tpu/train/host_loop.py:99``): on the card ``eval_init``,
    ``greedy`` and ``eval_observe`` replay CUDA graphs; on the CPU the
    plain bodies (``make_host_eval_bodies``)."""
    bodies = make_host_eval_bodies(agent, meta, n)
    if agent.device.type != "cuda":
        return bodies
    return compiled_host_eval(agent, meta, n, bodies, graphed=True)


def evaluate_host(
    agent: Agent,
    network,
    make_one_env: Callable[[], HostEnvironment],
    n_episodes: int,
    generator: torch.Generator,
    fns: Optional[HostEvalFns] = None,
):
    """``n_episodes`` greedy host episodes (run.py:187-243): (success rate,
    mean return, mean length) as host floats.  ``generator`` (on the
    agent's device) draws the contexts' random actions.  ``fns``: the
    device halves (``make_host_eval`` of ``n_episodes`` envs; made here
    when not given), which a run keeps across its evaluations."""
    vec = HostVecEnv([make_one_env() for _ in range(n_episodes)])
    meta, device = vec.meta, agent.device
    if fns is None:
        fns = make_host_eval(agent, meta, n_episodes)
    eval_init, greedy, eval_observe, inputs = fns

    def load(name, x):
        return to_device(x, device, inputs, name)

    obs = load("obs", vec.reset_all())
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
            network, context, bag, load("next_obs", out["next_obs"]),
            actions, load("reward", out["reward"]),
            load("terminated", out["terminated"]), load("live", live),
        )
        finished |= out["done"]
        # Contexts of finished episodes keep rolling harmlessly; their
        # metrics are frozen above.
        obs = load("obs", out["reset_obs"])
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

    fns = make_host_fns(agent, eps, config.resolved_updates_per_iter)
    # Made once: its graphs serve every evaluation of the run.
    eval_fns = make_host_eval(agent, meta, config.eval_episodes)

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
            host_iteration(vec, state, fns.act_random, fns.observe_only,
                           fns.inputs)

    logger = get_logger(policy_path, config, wandb_kwargs)
    wandb_id = getattr(getattr(logger, "run", None), "id", None)

    iters_per_chunk = config.resolved_iters_per_chunk
    time_budget = config.time_limit * 3600 if config.time_limit else None
    last_policy_save = int(state.env_steps)
    final_log = {}

    while int(state.env_steps) < config.num_steps:
        for _ in range(iters_per_chunk):
            host_iteration(vec, state, fns.act, fns.observe_and_learn,
                           fns.inputs)
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
            eval_fns,
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
