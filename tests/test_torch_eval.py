"""Port evaluation vs the JAX package's: the same parameters (through the
bridge) and the same start states (the JAX run's reset states, patched into
the port env's ``reset_vec``) must give the same greedy action at every
step and the same (success rate, return, length): counts exact, return
atol 1e-5.  CarFlag's dynamics are deterministic, so the start states fix
the whole episode; for Memory Cards and the tabular POMDPs the JAX run's
draws of every step (the next card revealed, the next state and
observation) are injected as well.  The cases run through
``make_evaluate_fn``, and again through ``make_evaluate`` and the blocked
evaluation that the card replays as CUDA graphs.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dtqn_tpu import replay as jax_replay
from dtqn_tpu.agents import Agent as JaxAgent
from dtqn_tpu.agents import AgentConfig as JaxConfig
from dtqn_tpu.envs import make_env as jax_make_env
from dtqn_tpu.models import zero_carry as jax_zero_carry
from dtqn_tpu.train.loop import make_evaluate as jax_make_evaluate
from dtqn_tpu_torch.agents import Agent, AgentConfig
from dtqn_tpu_torch.bridge import params_from_jax
from dtqn_tpu_torch.envs import make_env
from dtqn_tpu_torch.envs.car_flag import CarFlagState
from dtqn_tpu_torch.envs.memory_cards import MemoryCards
from dtqn_tpu_torch.envs.pomdp import TabularPOMDP
from dtqn_tpu_torch.train import loop
from dtqn_tpu_torch.train.loop import make_evaluate, make_evaluate_fn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICY = glob.glob(os.path.join(
    REPO, "policies", "**",
    "model=DTQN_*in_embed=64_*_seed=1_policy.msgpack",
), recursive=True)
ENV = "DiscreteCarFlag-v0"


def jax_rollout(jagent, jenv, params, key, n):
    """The JAX evaluation's episodes (its own key use), stepped one by one:
    the start (obs, state) it resets to, and per step the greedy actions,
    which episodes were live, and the env's next state and obs (numpy)."""
    cfg = jagent.config
    k_env, k_ctx, k_loop = jax.random.split(key, 3)
    obs, env_state = jenv.reset_vec(jax.random.split(k_env, n))
    context = jax_replay.init_context(
        k_ctx, n, cfg.context_len, tuple(jenv.obs_shape), jenv.obs_dtype,
        jenv.obs_mask, jenv.num_actions, obs,
    )
    carry = (jax_zero_carry(n, cfg.inner_embed)
             if cfg.kind == "recurrent" else None)
    start = (np.asarray(obs), jax.tree_util.tree_map(np.asarray, env_state))

    @jax.jit
    def step(context, env_state, carry, obs, key_t):
        actions, carry = jagent.greedy_actions(params, context, None, carry,
                                               obs)
        obs, new_state, ts = jax.vmap(jenv.step)(
            jax.random.split(key_t, n), env_state, actions)
        context, *_ = jax_replay.add_transition(
            context, ts.obs, actions, ts.reward, ts.terminated
        )
        return context, new_state, carry, obs, actions, ts.done

    finished = np.zeros(n, bool)
    steps = []
    for key_t in jax.random.split(k_loop, jenv.max_episode_steps):
        *new, actions, done = step(context, env_state, carry, obs, key_t)
        live = ~finished
        steps.append((np.asarray(actions), live.copy(),
                      jax.tree_util.tree_map(np.asarray, new[1]),
                      np.asarray(new[3])))
        # Freeze what has finished, as the evaluation's done-latch does.
        keep = lambda o, nw: jnp.where(  # noqa: E731
            live.reshape((-1,) + (1,) * (nw.ndim - 1)), nw, o)
        context, env_state, carry, obs = jax.tree_util.tree_map(
            keep, (context, env_state, carry, obs), tuple(new))
        finished |= np.asarray(done)
    return start, steps


def inject(env, start, steps, monkeypatch):
    """The port env resets to the JAX run's start and, where its dynamics
    draw, takes the JAX run's outcome of each step."""
    obs0, s0 = start
    t = torch.tensor
    if isinstance(env, TabularPOMDP):
        first = env.reset_with(t(s0.s), t(obs0[:, 0]))
    elif isinstance(env, MemoryCards):
        first = env.reset_with(t(s0.values), t(s0.current_card))
    else:
        state = CarFlagState(position=t(s0.position), velocity=t(s0.velocity),
                             heaven=t(s0.heaven), t=t(s0.t))
        first = env._observe(state), state
    monkeypatch.setattr(env, "reset_vec", lambda *a: first)
    count = iter(range(len(steps)))

    def outcome():
        _, _, state, obs = steps[next(count)]
        return state, obs

    if isinstance(env, TabularPOMDP):
        def step_env(generator, state, action):
            nxt, obs = outcome()
            return env.step_with(state, action, t(nxt.s), t(obs[:, 0]))
        monkeypatch.setattr(env, "step_env", step_env)
    elif isinstance(env, MemoryCards):
        monkeypatch.setattr(env, "_reveal",
                            lambda *a: t(outcome()[0].current_card))


def port_evaluate(agent, env, network, start, steps, n, monkeypatch,
                  make=make_evaluate_fn):
    """The port's evaluation (``make(agent, env, n)``) from the JAX run's
    start and draws, with the greedy actions of every step recorded."""
    inject(env, start, steps, monkeypatch)
    recorded = []
    greedy = type(agent).greedy_actions.__get__(agent)

    def recording(network, context, *args):
        actions, carry = greedy(network, context, *args)
        recorded.append(actions.numpy().copy())
        return actions, carry

    monkeypatch.setattr(agent, "greedy_actions", recording)
    evaluate = make(agent, env, n)
    out = evaluate(network, torch.Generator().manual_seed(0))
    return [float(x) for x in out], recorded


def compare(jagent, jenv, params, agent, env, network, n, monkeypatch,
            key=7, makes=(make_evaluate_fn,)):
    """The JAX evaluation against the port's, through each of ``makes``."""
    key = jax.random.key(key)
    sr, ret, ln = (float(x) for x in
                   jax_make_evaluate(jagent, jenv, n)(params, key))
    start, steps = jax_rollout(jagent, jenv, params, key, n)
    for make in makes:
        out = compare_one(sr, ret, ln, start, steps, agent, env, network, n,
                          monkeypatch, make)
    return out


def compare_one(sr, ret, ln, start, steps, agent, env, network, n,
                monkeypatch, make):
    (t_sr, t_ret, t_ln), actions = port_evaluate(
        agent, env, network, start, steps, n, monkeypatch, make)
    # The port stops once every episode is over; up to there, every live
    # episode takes the JAX package's greedy action.
    assert 0 < len(actions) <= len(steps)
    for got, (want, live, *_) in zip(actions, steps):
        np.testing.assert_array_equal(got[live], want[live])
    assert not any(live.any() for _, live, *_ in steps[len(actions):])
    # Counts exact (successes, summed steps); their float32 means may round
    # the division by n differently, by an ulp.
    assert round(t_sr * n) == round(sr * n)
    assert round(t_ln * n) == round(ln * n)
    np.testing.assert_allclose([t_sr, t_ln], [sr, ln], rtol=1e-6)
    np.testing.assert_allclose(t_ret, ret, atol=1e-5)
    return sr, ret, ln, len(actions)


def fresh_network_case(monkeypatch, makes=(make_evaluate_fn,)):
    kw = dict(inner_embed=16, num_heads=2, num_layers=2, context_len=8,
              history=8)
    jenv, env = jax_make_env(ENV), make_env(ENV)
    jenv.max_episode_steps = env.max_episode_steps = 60
    jagent = JaxAgent(JaxConfig(model="DTQN", num_envs=4, **kw), jenv)
    agent = Agent(AgentConfig(model="DTQN", num_envs=4, **kw), env,
                  device="cpu")
    params = jagent.network.init(
        jax.random.key(3), jnp.zeros((2, 8, 3)), jnp.zeros((2, 8), jnp.int32))
    # Larger weights than the N(0, 0.02) init, so actions vary over time.
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.3 * rng.standard_normal(x.shape))
        .astype(np.float32), params)
    network = agent.build_network()
    network.load_state_dict(params_from_jax(params), strict=True)
    sr, ret, ln, steps = compare(jagent, jenv, params, agent, env, network,
                                 6, monkeypatch, makes=makes)
    assert 1.0 <= ln <= 60.0 and 0.0 <= sr <= 1.0


def test_eval_matches_jax_fresh_network(monkeypatch):
    fresh_network_case(monkeypatch)


@pytest.mark.skipif(not POLICY, reason="trained CarFlag DTQN policy absent")
def test_eval_matches_jax_trained_policy(monkeypatch):
    with open(POLICY[0], "rb") as f:
        params = serialization.msgpack_restore(f.read())
    kw = dict(inner_embed=64, num_heads=8, num_layers=2, context_len=50)
    jenv, env = jax_make_env(ENV), make_env(ENV)
    jagent = JaxAgent(JaxConfig(model="DTQN", num_envs=4, **kw), jenv)
    agent = Agent(AgentConfig(model="DTQN", num_envs=4, **kw), env,
                  device="cpu")
    network = agent.build_network()
    network.load_state_dict(params_from_jax(params), strict=True)
    sr, ret, ln, steps = compare(jagent, jenv, params, agent, env, network,
                                 5, monkeypatch)
    # The trained policy does reach a flag, and evaluation stops early.
    assert ln < 200.0 and steps < 200


R4 = os.path.join(REPO, "policies", "r4family")
# The in-repo JAX-trained policies of the paper's other model families and
# domains: (model, env, in_embed).
TRAINED = [
    ("DTQN", "POMDP-hallway-episodic-v0", 64),
    ("DARQN", "DiscreteCarFlag-v0", 64),
    ("DQN", "Memory-5-v0", 128),
]


def r4_policy(model, env, width):
    return glob.glob(os.path.join(
        R4, env,
        f"model={model}_envs={env}_*in_embed={width}_*_seed=1_policy.msgpack",
    ))


@pytest.mark.parametrize("model,env_name,width", TRAINED,
                         ids=[m for m, _, _ in TRAINED])
def test_eval_matches_jax_trained_policies(model, env_name, width,
                                           monkeypatch):
    """The JAX-trained policy through the bridge picks the JAX package's
    greedy action at every evaluation step, on the recurrent (DARQN),
    feedforward (DQN) and tabular-POMDP (DTQN on Hallway) paths."""
    trained_policy_case(model, env_name, width, monkeypatch)


def trained_policy_case(model, env_name, width, monkeypatch,
                        makes=(make_evaluate_fn,)):
    path = r4_policy(model, env_name, width)
    assert path, f"{model} {env_name} policy absent from {R4}"
    with open(path[0], "rb") as f:
        params = serialization.msgpack_restore(f.read())
    kw = dict(inner_embed=width, num_heads=8, num_layers=2, context_len=50,
              history=50)
    jenv, env = jax_make_env(env_name), make_env(env_name)
    jagent = JaxAgent(JaxConfig(model=model, num_envs=4, **kw), jenv)
    agent = Agent(AgentConfig(model=model, num_envs=4, **kw), env,
                  device="cpu")
    network = agent.build_network()
    network.load_state_dict(params_from_jax(params), strict=True)
    sr, ret, ln, steps = compare(jagent, jenv, params, agent, env, network,
                                 6, monkeypatch, makes=makes)
    assert 1.0 <= ln <= env.max_episode_steps and 0.0 <= sr <= 1.0
    assert steps >= 2


def blocked(agent, env, n):
    """The blocked evaluation that the card replays as graphs, each step
    written back."""
    return loop.BlockedEvaluation(agent, env, n, graphed=False)


# The compiled entry point (on the CPU, the plain body) and the form its
# graphs take on the card.
COMPILED = (make_evaluate, blocked)


@pytest.mark.parametrize("case", ["fresh"] + [m for m, _, _ in TRAINED])
def test_eval_matches_jax_through_make_evaluate(case, monkeypatch):
    """The injected-draw cases above, through ``make_evaluate`` and the
    blocked evaluation that it replays on the card."""
    if case == "fresh":
        fresh_network_case(monkeypatch, makes=COMPILED)
    else:
        trained_policy_case(*next(t for t in TRAINED if t[0] == case),
                            monkeypatch, makes=COMPILED)


def small_agent(env_name=ENV, max_steps=60):
    env = make_env(env_name)
    env.max_episode_steps = max_steps
    cfg = AgentConfig(num_envs=3, inner_embed=16, num_heads=2, context_len=6,
                      history=6, embed_per_obs_dim=4)
    agent = Agent(cfg, env, device="cpu")
    return agent, env, agent.build_network(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("env_name", [ENV, "Memory-5-v0"])
def test_early_exit_changes_no_result(monkeypatch, env_name):
    """Reading ``finished.all()`` every step, every 10 steps or never gives
    the same three numbers: finished episodes are frozen either way."""
    agent, env, network = small_agent(env_name)
    if env_name == ENV:
        # Drive right always: every episode ends well before the cap.
        monkeypatch.setattr(
            agent, "greedy_actions",
            lambda net, ctx, bag, carry, obs: (
                torch.full((5,), 2, dtype=torch.int64), carry))
    calls, results = [], []
    step = env.step
    monkeypatch.setattr(
        env, "step", lambda *a: calls.append(1) or step(*a))
    for every in (0, 1, 10):
        monkeypatch.setattr(loop, "EVAL_EXIT_CHECK_EVERY", every)
        del calls[:]
        out = make_evaluate_fn(agent, env, 5)(
            network, torch.Generator().manual_seed(4))
        results.append([float(x) for x in out] + [len(calls)])
    assert results[0][:3] == results[1][:3] == results[2][:3]
    assert results[0][3] == 60
    assert results[1][3] <= results[2][3] <= 60
    if env_name == ENV:
        assert results[2][3] < 60 and 0.0 < results[0][0] < 1.0
        assert results[0][2] <= results[1][3]  # mean length <= longest
    else:
        # A constant pick cannot clear the table: all 60 steps, -1 each
        # apart from the rare lucky pair.
        assert results[0][2] == 60.0 and results[0][1] <= -55.0


def test_eval_returns_device_scalars_and_leaves_training_alone():
    agent, env, _ = small_agent()
    state = agent.init_state(0)
    before = state.generator.get_state().clone()
    context = state.context.obs.clone()
    out = make_evaluate_fn(agent, env, 4)(
        state.network, torch.Generator().manual_seed(1))
    assert all(isinstance(x, torch.Tensor) and x.shape == () for x in out)
    assert torch.equal(state.generator.get_state(), before)
    assert torch.equal(state.context.obs, context)
    assert int(state.env_steps) == 0
    # The same generator seed gives the same evaluation.
    again = make_evaluate_fn(agent, env, 4)(
        state.network, torch.Generator().manual_seed(1))
    assert [float(x) for x in out] == [float(x) for x in again]
