"""Several domains (``MultiDomainEnv``, ``build_envs``) and continuous Car
Flag in the port vs the JAX package.

- the refusal of members whose spaces differ, one per kind of difference;
- both domains drawn, and every env stepped as its own domain's member
  would step it, from the JAX wrapper's states (exact), with members whose
  states a foreign domain's lane would index out of range;
- ``build_envs``: padded Gridverse members and their evaluation envs, the
  per-domain CSV headers (byte for byte) and the run name and policy path,
  against the JAX runner's;
- the in-repo JAX-trained four-rooms 7x7 + 9x9 policy picks the JAX
  package's greedy action at every evaluation step of each member;
- 200 steps of random forces of continuous Car Flag (flags and rewards
  exact, states within 1e-6: XLA fuses a multiply-add), and the Q agents
  refusing it in both packages.
"""

import dataclasses
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
from dtqn_tpu.config import ExperimentConfig as JaxExperimentConfig
from dtqn_tpu.envs import make_env as jax_make_env
from dtqn_tpu.envs.gridverse import make_gridverse_env as jax_make_gridverse_env
from dtqn_tpu.envs.multi import MultiDomainEnv as JaxMultiDomainEnv
from dtqn_tpu.train.loop import make_evaluate as jax_make_evaluate
from dtqn_tpu.train.loop import make_prepopulate_fn as jax_prepopulate
from dtqn_tpu.train.loop import make_train_chunk_fn as jax_train_chunk
from dtqn_tpu.train.runner import build_envs as jax_build_envs
from dtqn_tpu.utils.epsilon import EpsilonSchedule as JaxEpsilon
from dtqn_tpu.utils.logging import CSVLogger as JaxCSVLogger
from dtqn_tpu_torch.agents import Agent, AgentConfig
from dtqn_tpu_torch.bridge import params_from_jax
from dtqn_tpu_torch.config import ExperimentConfig
from dtqn_tpu_torch.envs import (
    CarFlagState,
    GridverseState,
    MultiDomainEnv,
    MultiDomainState,
    TabularPOMDP,
    make_env,
    make_gridverse_env,
)
from dtqn_tpu_torch.train.loop import make_evaluate_fn
from dtqn_tpu_torch.train.runner import build_envs
from dtqn_tpu_torch.utils.logging import CSVLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOUR_ROOMS = ["gv_memory_four_rooms.7x7.yaml", "gv_memory_four_rooms.9x9.yaml"]
POLICY = glob.glob(os.path.join(
    REPO, "policies", "validation", *FOUR_ROOMS,
    "model=DTQN_*in_embed=128_*_seed=1_policy.msgpack"))


def port_gridverse_state(jstate):
    return GridverseState(**{
        f.name: torch.tensor(np.asarray(getattr(jstate, f.name)))
        for f in dataclasses.fields(GridverseState)})


MISMATCHED = [
    ("ImageMaze-9-v0", "Memory-5-v0"),  # observation shape and kind
    ("DiscreteCarFlag-v0", "CarFlag-continuous-v0"),  # actions
    ("POMDP-hallway-episodic-v0", "POMDP-heavenhell_3-episodic-v0"),  # mask
]


@pytest.mark.parametrize("names", MISMATCHED, ids=["obs", "actions", "mask"])
def test_mismatched_members_are_refused(names):
    with pytest.raises(ValueError, match="share observation/action"):
        JaxMultiDomainEnv([jax_make_env(n) for n in names])
    with pytest.raises(ValueError, match="share observation/action"):
        MultiDomainEnv([make_env(n) for n in names])


def test_both_domains_drawn_and_each_env_stepped_as_its_member():
    """From the JAX wrapper's reset states: every env steps as its domain's
    member steps it alone, and the port's own resets draw both domains."""
    names = ["gv_memory.5x5.yaml", "gv_memory.7x7.yaml"]
    jenv = JaxMultiDomainEnv([jax_make_gridverse_env(n, pad_to=7)
                              for n in names])
    members = [make_gridverse_env(n, pad_to=7) for n in names]
    env = MultiDomainEnv(members)
    assert env.name == "+".join(names) == jenv.name
    assert env.max_episode_steps == 250
    e = 32
    jobs, jstate = jax.vmap(jenv.reset_env)(
        jax.random.split(jax.random.key(0), e))
    domain = torch.tensor(np.asarray(jstate.domain))
    assert set(domain.tolist()) == {0, 1}
    state = MultiDomainState(domain=domain,
                             inner=port_gridverse_state(jstate.inner))
    # The observation depends on the state alone, whatever the member.
    np.testing.assert_array_equal(members[0]._observe(state.inner).numpy(),
                                  np.asarray(jobs))
    jstep = jax.jit(jax.vmap(jenv.step_env, in_axes=(None, 0, 0)))
    actions = np.random.default_rng(0).integers(0, 6, (40, e))
    for a in actions:
        jobs, jstate, jrew, jterm, _ = jstep(jax.random.key(1), jstate,
                                             jnp.asarray(a))
        own = [m.step_env(None, state.inner, torch.tensor(a))
               for m in members]
        obs, state, rew, term, info = env.step_env(None, state,
                                                   torch.tensor(a))
        for i, out in enumerate(own):
            lanes = domain == i
            assert torch.equal(obs[lanes], out[0][lanes])
            assert torch.equal(rew[lanes], out[2][lanes])
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
        np.testing.assert_array_equal(state.inner.pos.numpy(),
                                      np.asarray(jstate.inner.pos))
        assert torch.equal(state.domain, domain)
    _, own = env.reset_env(torch.Generator().manual_seed(0), 256, "cpu")
    counts = torch.bincount(own.domain, minlength=2)
    assert counts.min() > 80 and own.domain.dtype == torch.int32


def random_pomdp(name, states, seed):
    """A small episodic POMDP: 2 actions, 2 observations."""
    rng = np.random.default_rng(seed)
    T = rng.random((states, 2, states)).astype(np.float32)
    O = rng.random((2, states, 2)).astype(np.float32)
    return TabularPOMDP(
        name, T / T.sum(-1, keepdims=True), O / O.sum(-1, keepdims=True),
        rng.standard_normal((states, 2, states)).astype(np.float32),
        np.full(states, 1.0 / states, np.float32),
        np.arange(states) == states - 1, None, max_episode_steps=20)


def test_foreign_lanes_stay_in_range():
    """A 3-state and a 6-state POMDP share their spaces: the small one,
    stepped on the large one's envs, clamps its states (as a JAX gather
    does) and the result is discarded."""
    env = MultiDomainEnv([random_pomdp("small", 3, 0),
                          random_pomdp("large", 6, 1)])
    gen = torch.Generator().manual_seed(0)
    obs, state = env.reset_env(gen, 64, "cpu")
    for _ in range(30):
        obs, state, ts = env.step_autoreset(
            gen, state, torch.randint(0, 2, (64,), generator=gen))
        small = state.domain == 0
        assert (state.inner.s[small] < 3).all()
        assert (state.inner.s[~small] < 6).all()
    assert (state.inner.s[~(state.domain == 0)] >= 3).any()


def test_build_envs_matches_the_jax_runner(tmp_path):
    names = ["gv_memory.5x5.yaml", "gv_memory_four_rooms.9x9.yaml"]
    env, evals = build_envs(ExperimentConfig(envs=names))
    jenv, jevals = jax_build_envs(JaxExperimentConfig(envs=names))
    assert isinstance(env, MultiDomainEnv)
    assert [m.pad for m in env.envs] == [e.pad for e in evals] == [9, 9]
    assert [m.pad for m in jenv.envs] == [9, 9]
    assert [e.name for e in evals] == [e.name for e in jevals] == names
    assert all(e is not m for e, m in zip(evals, env.envs))
    assert (env.name, env.max_episode_steps, env.obs_shape) == (
        jenv.name, jenv.max_episode_steps, tuple(jenv.obs_shape))
    # Other members are built as they are.
    env, evals = build_envs(ExperimentConfig(
        envs=["DiscreteCarFlag-v0", "DiscreteCarFlag-v0"]))
    assert env.name == "DiscreteCarFlag-v0+DiscreteCarFlag-v0"
    assert len(evals) == 2 and evals[0] is not evals[1]
    # The results CSV: a SuccessRate / EpisodeLength / Return triple per
    # domain, byte for byte the JAX logger's.
    CSVLogger(str(tmp_path / "port"), FOUR_ROOMS)
    JaxCSVLogger(str(tmp_path / "jax"), FOUR_ROOMS)
    for suffix in ("_results.csv", "_losses.csv"):
        with open(tmp_path / f"port{suffix}", "rb") as f:
            port = f.read()
        with open(tmp_path / f"jax{suffix}", "rb") as f:
            assert port == f.read()
    cfg = ExperimentConfig(envs=FOUR_ROOMS, in_embed=128)
    jcfg = JaxExperimentConfig(envs=FOUR_ROOMS, in_embed=128)
    assert cfg.run_name() == jcfg.run_name()
    assert cfg.policy_path("/r") == jcfg.policy_path("/r")
    assert POLICY and os.path.basename(POLICY[0]) == (
        cfg.run_name() + "_policy.msgpack")


def jax_start_and_actions(jagent, jenv, params, key, n):
    """The JAX evaluation's start states and, per step, the greedy actions
    and which episodes were live (gridverse steps draw nothing)."""
    cfg = jagent.config
    k_env, k_ctx, k_loop = jax.random.split(key, 3)
    obs, env_state = jenv.reset_vec(jax.random.split(k_env, n))
    context = jax_replay.init_context(
        k_ctx, n, cfg.context_len, tuple(jenv.obs_shape), jenv.obs_dtype,
        jenv.obs_mask, jenv.num_actions, obs)
    start = env_state

    @jax.jit
    def step(context, env_state, key_t):
        actions, _ = jagent.greedy_actions(params, context, None, None, None)
        obs, new_state, ts = jax.vmap(jenv.step)(
            jax.random.split(key_t, n), env_state, actions)
        context, *_ = jax_replay.add_transition(
            context, ts.obs, actions, ts.reward, ts.terminated)
        return context, new_state, actions, ts.done

    finished = np.zeros(n, bool)
    steps = []
    for key_t in jax.random.split(k_loop, jenv.max_episode_steps):
        new_ctx, new_state, actions, done = step(context, env_state, key_t)
        live = ~finished
        steps.append((np.asarray(actions), live.copy()))
        keep = lambda o, nw: jnp.where(  # noqa: E731
            live.reshape((-1,) + (1,) * (nw.ndim - 1)), nw, o)
        context, env_state = jax.tree_util.tree_map(
            keep, (context, env_state), (new_ctx, new_state))
        finished |= np.asarray(done)
        if finished.all():
            break
    return start, steps


@pytest.mark.skipif(not POLICY, reason="four-rooms validation policy absent")
@pytest.mark.parametrize("member", [0, 1], ids=["7x7", "9x9"])
def test_four_rooms_policy_matches_jax_greedy_actions(member, monkeypatch):
    """Each domain's own padded evaluation env, as the runners build it."""
    with open(POLICY[0], "rb") as f:
        params = serialization.msgpack_restore(f.read())
    kw = dict(inner_embed=128, num_heads=8, num_layers=2, context_len=50,
              history=50)
    jenv = jax_build_envs(JaxExperimentConfig(envs=FOUR_ROOMS))[1][member]
    env = build_envs(ExperimentConfig(envs=FOUR_ROOMS))[1][member]
    n = 3
    jagent = JaxAgent(JaxConfig(model="DTQN", num_envs=n, **kw), jenv)
    agent = Agent(AgentConfig(model="DTQN", num_envs=n, **kw), env,
                  device="cpu")
    network = agent.build_network()
    network.load_state_dict(params_from_jax(params), strict=True)
    key = jax.random.key(21)
    sr, _, ln = (float(x) for x in jax_make_evaluate(jagent, jenv, n)(
        params, key))
    start, steps = jax_start_and_actions(jagent, jenv, params, key, n)
    state = port_gridverse_state(start)
    first = (env._observe(state), state)
    monkeypatch.setattr(env, "reset_vec", lambda *a: first)
    recorded = []
    greedy = agent.greedy_actions

    def recording(network, context, *args):
        actions, carry = greedy(network, context, *args)
        recorded.append(actions.numpy().copy())
        return actions, carry

    monkeypatch.setattr(agent, "greedy_actions", recording)
    t_sr, _, t_ln = (float(x) for x in make_evaluate_fn(agent, env, n)(
        network, torch.Generator().manual_seed(0)))
    assert 0 < len(steps) <= len(recorded)
    for got, (want, live) in zip(recorded, steps):
        np.testing.assert_array_equal(got[live], want[live])
    assert round(t_sr * n) == round(sr * n)
    assert round(t_ln * n) == round(ln * n)


def test_continuous_car_flag_steps_match_jax():
    jenv, env = (jax_make_env("CarFlag-continuous-v0"),
                 make_env("CarFlag-continuous-v0"))
    assert (env.name, env.num_actions, env.obs_shape) == (
        jenv.name, jenv.num_actions, tuple(jenv.obs_shape)) == (
        "CarFlag-continuous-v0", 0, (3,))
    e = 8
    _, jstate = jax.vmap(jenv.reset_env)(
        jax.random.split(jax.random.key(0), e))
    state = CarFlagState(**{f.name: torch.tensor(np.asarray(
        getattr(jstate, f.name))) for f in dataclasses.fields(CarFlagState)})
    jstep = jax.jit(jax.vmap(jenv.step_env, in_axes=(None, 0, 0)))
    forces = np.random.default_rng(0).uniform(
        -1.5, 1.5, (200, e, 1)).astype(np.float32)
    ended = 0
    for f in forces:
        # Lanes that ended restart from their state, as both packages' raw
        # step_env does; the clip of forces beyond +-1 is exercised too.
        jobs, jstate, jrew, jterm, _ = jstep(jax.random.key(0), jstate,
                                             jnp.asarray(f))
        obs, state, rew, term, _ = env.step_env(None, state, torch.tensor(f))
        # XLA contracts velocity + force * power into one fused
        # multiply-add, PyTorch rounds twice: the states agree within a few
        # ulps; the flags and rewards exactly.
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0,
                                   atol=1e-6)
        for field in ("position", "velocity"):
            np.testing.assert_allclose(
                getattr(state, field).numpy(),
                np.asarray(getattr(jstate, field)), rtol=0, atol=1e-6)
        for field in ("heaven", "t"):
            np.testing.assert_array_equal(
                getattr(state, field).numpy(),
                np.asarray(getattr(jstate, field)))
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
        ended += int(term.sum())
    assert ended > 0


def test_q_agents_refuse_continuous_car_flag():
    """Neither package's Q agents act on a continuous action space: the
    JAX agent fails at its first greedy act (an argmax over no actions);
    the port's refuses at construction, as its random context actions
    have no range to come from."""
    small = dict(num_envs=2, inner_embed=16, num_heads=2, context_len=4,
                 history=4, batch_size=2, buffer_size=400)
    jagent = JaxAgent(JaxConfig(**small), jax_make_env(
        "CarFlag-continuous-v0"))
    jstate = jax_prepopulate(jagent, 3)(jagent.init_state(jax.random.key(0)))
    with pytest.raises(ValueError, match="argmax of an empty sequence"):
        jax_train_chunk(jagent, JaxEpsilon(), 1, 1)(jstate)
    with pytest.raises(ValueError, match="no discrete actions"):
        Agent(AgentConfig(**small), make_env("CarFlag-continuous-v0"),
              device="cpu")
