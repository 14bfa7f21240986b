"""Port DQN / DRQN / ADRQN / DARQN vs the JAX package on bridged parameters,
and the agent's feedforward and recurrent branches.

At narrow widths (in_embed 16-32, L <= 8, batch 4), float32, the JAX side
at "highest" matmul precision: Q and carry atol 2e-5, gradients atol 5e-5
(different summation order); one ``apply_update`` at rtol 1e-4 (atol 1e-7
for parameters that sit at zero), as the transformer's.  The bridge's round
trip and the parameter counts are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtqn_tpu import replay as jax_replay
from dtqn_tpu.agents import Agent as JaxAgent
from dtqn_tpu.agents import AgentConfig as JaxConfig
from dtqn_tpu.envs import make_env as jax_make_env
from dtqn_tpu.models import build_network as jax_build_network
from dtqn_tpu_torch import replay
from dtqn_tpu_torch.agents import Agent, AgentConfig
from dtqn_tpu_torch.bridge import params_from_jax, params_to_jax
from dtqn_tpu_torch.envs import make_env
from dtqn_tpu_torch.models import (
    MODEL_MAP,
    LSTMCarry,
    build_network,
    zero_carry,
)
from dtqn_tpu_torch.models.recurrent import LSTMCell
from dtqn_tpu_torch.train.loop import make_prepopulate_fn, make_train_chunk_fn
from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule

MODELS = ("DQN", "DRQN", "ADRQN", "DARQN")
RECURRENT = ("DRQN", "ADRQN", "DARQN")
ENVS = ("Memory-5-v0", "DiscreteCarFlag-v0")
Q_ATOL, GRAD_ATOL = 2e-5, 5e-5


def inputs(env, seed, b, length):
    rng = np.random.default_rng(seed)
    if env.is_discrete:
        obs = rng.integers(0, env.obs_vocab_size,
                           (b, length, *env.obs_shape)).astype(np.int32)
    else:
        obs = rng.uniform(-1.1, 1.1,
                          (b, length, *env.obs_shape)).astype(np.float32)
    actions = rng.integers(0, env.num_actions, (b, length)).astype(np.int32)
    return obs, actions


def pair(model, env_name, width=16, seed=0, length=8):
    """A flax network with random (not init-valued) parameters and the
    port's network holding them through the bridge."""
    jenv, env = jax_make_env(env_name), make_env(env_name)
    jnet = jax_build_network(model, jenv, inner_embed=width)
    obs, actions = inputs(env, 0, 2, 1 if model == "DQN" else length)
    args = (obs,) if model == "DQN" else (obs, actions)
    params = jnet.init(jax.random.key(seed), *args)
    rng = np.random.default_rng(seed + 1)
    # Non-zero biases and larger weights, so every gate is exercised.
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.2 * rng.standard_normal(x.shape))
        .astype(np.float32), params)
    net = build_network(model, env, inner_embed=width)
    net.load_state_dict(params_from_jax(params), strict=True)
    return jnet, params, net, env


def close(a, b, atol, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0, err_msg=msg)


@pytest.mark.parametrize("env_name", ENVS)
@pytest.mark.parametrize("model", MODELS)
def test_bridge_round_trip_and_parameter_count(model, env_name):
    _, params, net, _ = pair(model, env_name)
    state = params_from_jax(params)
    assert sum(t.numel() for t in net.parameters()) == sum(
        x.size for x in jax.tree_util.tree_leaves(params))
    back = params_to_jax(state)
    flat_a = jax.tree_util.tree_leaves_with_path(params["params"])
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model,env_name,width,count", [
    # The in-repo JAX-trained policies' configurations, and the README's
    # DRQN line (in_embed 128 on Memory-5-v0).
    ("DQN", "Memory-5-v0", 128, 28_234),
    ("DRQN", "Memory-5-v0", 128, 159_818),
    ("ADRQN", "POMDP-hallway-episodic-v0", 64, None),
    ("DARQN", "DiscreteCarFlag-v0", 64, None),
])
def test_full_width_parameter_count_equals_flax(model, env_name, width,
                                                count):
    """The port trains exactly flax's parameter set: one flat Adam vector
    of the same length (no second LSTM bias)."""
    jenv, env = jax_make_env(env_name), make_env(env_name)
    jnet = jax_build_network(model, jenv, inner_embed=width)
    obs, actions = inputs(env, 0, 2, 1 if model == "DQN" else 50)
    args = (obs,) if model == "DQN" else (obs, actions)
    shapes = jax.eval_shape(jnet.init, jax.random.key(0), *args)
    want = sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes))
    net = build_network(model, env, inner_embed=width)
    assert sum(t.numel() for t in net.parameters()) == want
    if count is not None:
        assert want == count
    assert not any(isinstance(m, torch.nn.LSTM) for m in net.modules())


@pytest.mark.parametrize("model,env_name,with_lengths", [
    (m, e, w) for m in MODELS for e in ENVS
    for w in ((False,) if m == "DQN" else (False, True))
])
def test_forward_and_carry_match_flax(model, env_name, with_lengths):
    """DQN takes no episode lengths (its window is one step)."""
    jnet, params, net, env = pair(model, env_name, width=24)
    length = 1 if model == "DQN" else 8
    obs, actions = inputs(env, 3, 4, length)
    lengths = np.array([1, 3, 8, 5], np.int32)
    if model == "DQN":
        q_jax = jnet.apply(params, obs)
        with torch.no_grad():
            q_t = net(torch.tensor(obs))
        close(q_t, q_jax, Q_ATOL)
        return
    kw = dict(episode_lengths=lengths) if with_lengths else {}
    q_jax, (c_jax, h_jax) = jnet.apply(params, obs, actions, **kw)
    kw_t = ({"episode_lengths": torch.tensor(lengths)} if with_lengths
            else {})
    with torch.no_grad():
        q_t, carry = net(torch.tensor(obs), torch.tensor(actions), **kw_t)
    assert isinstance(carry, LSTMCarry)
    close(q_t, q_jax, Q_ATOL, "Q")
    close(carry.c, c_jax, Q_ATOL, "c")
    close(carry.h, h_jax, Q_ATOL, "h")
    if with_lengths:
        # Past an episode's length the head sees zeros: Q is the head's
        # output at the zero vector.
        with torch.no_grad():
            q0 = net.q_head(torch.zeros(net.inner_embed))
        close(q_t[0, 1:], q0.expand(7, -1), 1e-6)


@pytest.mark.parametrize("model", RECURRENT)
def test_carry_in_and_out_matches_flax(model):
    """A given (c, h) carry in, the one after L steps out."""
    jnet, params, net, env = pair(model, "Memory-5-v0", width=16)
    obs, actions = inputs(env, 4, 4, 6)
    rng = np.random.default_rng(5)
    c0, h0 = (rng.standard_normal((4, 16)).astype(np.float32)
              for _ in range(2))
    q_jax, (c_jax, h_jax) = jnet.apply(params, obs, actions,
                                       carry=(c0, h0))
    with torch.no_grad():
        q_t, carry = net(torch.tensor(obs), torch.tensor(actions),
                         carry=LSTMCarry(torch.tensor(c0), torch.tensor(h0)))
    close(q_t, q_jax, Q_ATOL)
    close(carry.c, c_jax, Q_ATOL)
    close(carry.h, h_jax, Q_ATOL)


@pytest.mark.parametrize("model", ["DRQN", "DARQN"])
def test_stepwise_acting_equals_the_sequence_forward(model):
    """L = 1 calls threading the carry give the sequence forward's Q at
    every step and its final carry."""
    _, _, net, env = pair(model, "DiscreteCarFlag-v0", width=16)
    obs, actions = (torch.tensor(x) for x in inputs(env, 6, 4, 8))
    with torch.no_grad():
        q_seq, carry_seq = net(obs, actions)
        carry = zero_carry(4, 16)
        for t in range(8):
            q_t, carry = net(obs[:, t:t + 1], actions[:, t:t + 1],
                             carry=carry)
            close(q_t[:, 0], q_seq[:, t], 1e-6, f"step {t}")
    close(carry.c, carry_seq.c, 1e-6)
    close(carry.h, carry_seq.h, 1e-6)


def test_adrqn_stepwise_matches_flax():
    """ADRQN at L = 1 embeds the given action without the right shift, as
    the act path feeds it the context's newest action."""
    jnet, params, net, env = pair("ADRQN", "Memory-5-v0", width=16)
    obs, actions = inputs(env, 7, 4, 5)
    carry_j = None
    carry_t = None
    for t in range(5):
        q_j, carry_j = jnet.apply(params, obs[:, t:t + 1],
                                  actions[:, t:t + 1], carry=carry_j)
        with torch.no_grad():
            q_t, carry_t = net(torch.tensor(obs[:, t:t + 1]),
                               torch.tensor(actions[:, t:t + 1]),
                               carry=carry_t)
        close(q_t, q_j, Q_ATOL, f"step {t}")
        close(carry_t.h, carry_j[1], Q_ATOL, f"step {t}")


@pytest.mark.parametrize("env_name", ENVS)
@pytest.mark.parametrize("model", MODELS)
def test_gradients_match_flax(model, env_name):
    jnet, params, net, env = pair(model, env_name, width=16)
    length = 1 if model == "DQN" else 6
    obs, actions = inputs(env, 8, 4, length)
    lengths = np.array([6, 2, 4, 1], np.int32)
    g = np.random.default_rng(9).standard_normal(
        (4, length, env.num_actions)).astype(np.float32)

    def q_of(p):
        if model == "DQN":
            return jnet.apply(p, obs)
        return jnet.apply(p, obs, actions, episode_lengths=lengths)[0]

    grads_jax = jax.grad(lambda p: jnp.sum(q_of(p) * g))(params)
    if model == "DQN":
        q_t = net(torch.tensor(obs))
    else:
        q_t, _ = net(torch.tensor(obs), torch.tensor(actions),
                     episode_lengths=torch.tensor(lengths))
    (q_t * torch.tensor(g)).sum().backward()
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, grads_jax))
    for name, p in net.named_parameters():
        close(p.grad, ref[name], GRAD_ATOL, name)


def test_lstm_cell_init_follows_flax_families():
    """Input kernels LeCun-normal (truncated at 2 sd, variance 1/fan_in),
    recurrent kernels orthogonal per gate, biases zero."""
    cell = LSTMCell(64, 32, torch.Generator().manual_seed(0))
    w_in = cell.input_proj.weight.detach()
    assert w_in.shape == (128, 64)
    assert abs(float(w_in.var()) - 1.0 / 64) < 0.15 / 64
    assert float(w_in.abs().max()) <= 2.0 * (1.0 / 64) ** 0.5 / 0.8796 + 1e-6
    for k in range(4):
        block = cell.hidden_proj.weight.detach()[32 * k:32 * (k + 1)]
        close(block @ block.T, torch.eye(32), 1e-5, f"gate {k}")
    assert not cell.hidden_proj.bias.detach().any()


# ------------------------------------------------------------------ agent
def agent_pair(model, env_name="Memory-5-v0", **kw):
    cfg = dict(num_envs=3, inner_embed=16, context_len=6, history=6,
               batch_size=4, buffer_size=600, target_update_frequency=10)
    cfg.update(kw)
    jagent = JaxAgent(JaxConfig(model=model, **cfg), jax_make_env(env_name))
    agent = Agent(AgentConfig(model=model, **cfg), make_env(env_name),
                  device="cpu")
    return jagent, agent


@pytest.mark.parametrize("model", MODELS + ("DTQN", "DTQN-bag"))
def test_agent_kind_and_context(model):
    jagent, agent = agent_pair(model, num_heads=2, bag_size=2)
    assert agent.config.kind == jagent.config.kind
    assert agent.config.context_len == jagent.config.context_len
    assert agent.config.history == jagent.config.history
    assert agent.use_bag == jagent.use_bag == ("DTQN" in model)
    assert set(MODEL_MAP) == {"DTQN", "DTQN-bag", "DQN", "DRQN", "ADRQN",
                              "DARQN"}
    state = agent.init_state(0)
    if agent.config.kind == "recurrent":
        assert isinstance(state.carry, LSTMCarry)
        assert state.carry.c.shape == (3, 16) and not state.carry.h.any()
    else:
        assert state.carry is None
    with pytest.raises(KeyError, match="Unknown model"):
        Agent(AgentConfig(model="LSTM"), make_env("Memory-5-v0"),
              device="cpu")


def contexts(env, seed, e, length):
    obs, action = inputs(env, seed, e, length)
    timestep = np.random.default_rng(seed).integers(
        0, 2 * length, e).astype(np.int32)
    zeros = np.zeros((e, length), np.float32)
    jctx = jax_replay.ContextState(
        obs=jnp.asarray(obs), action=jnp.asarray(action),
        reward=jnp.asarray(zeros), done=jnp.ones((e, length), bool),
        timestep=jnp.asarray(timestep))
    tctx = replay.ContextState(
        obs=torch.tensor(obs), action=torch.tensor(action),
        reward=torch.tensor(zeros), done=torch.ones(e, length, dtype=bool),
        timestep=torch.tensor(timestep))
    return jctx, tctx


@pytest.mark.parametrize("model", MODELS)
def test_greedy_actions_match_jax(model):
    """Feedforward acts on the current observations; recurrent steps the
    carry once on (current obs, the context's newest action)."""
    jagent, agent = agent_pair(model, num_envs=8)
    env = agent.env
    jparams = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.3 * np.random.default_rng(0)
                   .standard_normal(x.shape)).astype(np.float32),
        jagent.init_state(jax.random.key(0)).params)
    net = agent.build_network()
    net.load_state_dict(params_from_jax(jparams), strict=True)
    jctx, tctx = contexts(env, 1, 8, agent.config.context_len)
    obs = inputs(env, 2, 8, 1)[0][:, 0]
    rng = np.random.default_rng(3)
    carry = (None if agent.config.kind != "recurrent" else
             tuple(rng.standard_normal((8, 16)).astype(np.float32)
                   for _ in range(2)))
    a_jax, c_jax = jagent.greedy_actions(jparams, jctx, None, carry, obs)
    a_t, c_t = agent.greedy_actions(
        net, tctx, None,
        None if carry is None else LSTMCarry(*map(torch.tensor, carry)),
        torch.tensor(obs))
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_jax))
    if carry is None:
        assert c_t is None and c_jax is None
    else:
        close(c_t.c, c_jax[0], Q_ATOL)
        close(c_t.h, c_jax[1], Q_ATOL)


def test_carry_resets_for_finished_envs_only():
    _, agent = agent_pair("DRQN")
    state = agent.init_state(0)
    state.carry = LSTMCarry(torch.ones(3, 16), torch.full((3, 16), 2.0))
    done = torch.tensor([False, True, False])
    agent.handle_resets(state, done, state.obs)
    assert not state.carry.c[1].any() and not state.carry.h[1].any()
    assert (state.carry.c[[0, 2]] == 1).all()
    assert (state.carry.h[[0, 2]] == 2).all()


def test_prepopulation_leaves_the_carry_and_acting_moves_it():
    _, agent = agent_pair("DARQN", "DiscreteCarFlag-v0", num_envs=4,
                          buffer_size=2000)
    state = agent.init_state(0)
    make_prepopulate_fn(agent, 10)(state)
    assert not state.carry.c.any() and not state.carry.h.any()
    make_train_chunk_fn(agent, EpsilonSchedule(1.0, 0.1, 100), 0, 3)(state)
    assert state.carry.h.abs().sum() > 0


def update_batch(env, seed, b, length):
    rng = np.random.default_rng(seed)
    obs, act = inputs(env, seed, b, length + 1)
    return dict(
        obs=obs[:, :-1], action=act[:, :-1], next_obs=obs[:, 1:],
        next_action=act[:, 1:],
        reward=rng.choice([-1.0, 0.0, 0.0, 1.0],
                          (b, length)).astype(np.float32),
        done=rng.random((b, length)) < 0.1,
        ep_len=rng.integers(1, length + 1, b).astype(np.int32),
    )


@pytest.mark.parametrize("model,env_name", [
    ("DRQN", "Memory-5-v0"), ("DQN", "Memory-5-v0"),
    ("ADRQN", "POMDP-hallway-episodic-v0"),
    ("DARQN", "DiscreteCarFlag-v0"),
])
def test_apply_update_matches_jax(model, env_name):
    jagent, agent = agent_pair(model, env_name, batch_size=4)
    jstate = jagent.init_state(jax.random.key(0))
    state = agent.init_state(0)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    state.network.load_state_dict(params_from_jax(params))
    state.target_network.load_state_dict(params_from_jax(params))
    state.buffer.flushed_total.fill_(100)
    jstate = jstate.replace(buffer=jstate.buffer.replace(
        flushed_total=jnp.int32(100)))
    arrays = update_batch(agent.env, 1, 4, agent.config.context_len)
    jb = jax_replay.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tb = replay.Batch(**{k: torch.tensor(v) for k, v in arrays.items()})
    for step in range(3):
        jstate = jax.jit(jagent.apply_update)(jstate, jb,
                                              jax.random.key(step))
        agent.apply_update(state, tb)
    assert int(jstate.train_steps) == int(state.train_steps) == 3
    d = jstate.diagnostics
    jax_vals = [float(getattr(d, f).buf[2]) for f in (
        "td_error", "grad_norm", "q_max", "q_mean", "q_min",
        "target_max", "target_mean", "target_min")]
    np.testing.assert_allclose(state.diagnostics.averages.buf[2].numpy(),
                               jax_vals, rtol=1e-4, atol=1e-7)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    for name, value in state.network.state_dict().items():
        np.testing.assert_allclose(value.numpy(), ref[name].numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=name)


def test_context_and_ring_at_context_1_match_jax():
    """DQN's only window length: the context rolls, evicts and writes at
    L = 1, and the ring's windows of one step, as the JAX package's."""
    from dtqn_tpu.replay import buffer as jbuf
    from dtqn_tpu.replay import context as jctx
    from dtqn_tpu_torch.replay import buffer as tbuf
    from dtqn_tpu_torch.replay import context as tctx

    e = 6
    rng = np.random.default_rng(11)
    jc, tc = contexts(make_env("DiscreteCarFlag-v0"), 12, e, 1)
    for t in range(4):
        obs = rng.standard_normal((e, 3)).astype(np.float32)
        act = rng.integers(0, 3, e).astype(np.int32)
        rew = rng.standard_normal(e).astype(np.float32)
        done = rng.random(e) < 0.3
        jout = jctx.add_transition(jc, obs, act, rew, done)
        tout = tctx.add_transition(tc, torch.tensor(obs), torch.tensor(act),
                                   torch.tensor(rew), torch.tensor(done))
        for f in ("obs", "action", "reward", "done", "timestep"):
            np.testing.assert_array_equal(getattr(tout[0], f),
                                          getattr(jout[0], f))
        for a, b in zip(tout[1:], jout[1:]):  # the evicted entry, was_full
            np.testing.assert_array_equal(a, b)
        assert tout[3].all()
        np.testing.assert_array_equal(tout[0].last_index, 0)
        jc, tc = jout[0], tout[0]

    kw = dict(num_envs=2, buffer_size=200, max_episode_steps=10,
              context_len=1, obs_shape=(3,), obs_mask=-5.0)
    jb = jbuf.init_buffer(obs_dtype=jnp.float32, **kw)
    tb = tbuf.init_buffer(obs_dtype=torch.float32, device="cpu", **kw)
    first = rng.standard_normal((2, 3)).astype(np.float32)
    jb = jbuf.store_first_obs(jb, first, np.ones(2, bool), -5.0)
    tbuf.store_first_obs(tb, torch.tensor(first), torch.ones(2, dtype=bool),
                         -5.0)
    for t in range(25):
        obs = rng.standard_normal((2, 3)).astype(np.float32)
        act = rng.integers(0, 3, 2).astype(np.int32)
        done = (rng.random(2) < 0.2) | (tb.write_pos.numpy() + 1 >= 10)
        jb = jbuf.store_step(jb, obs, act, np.ones(2, np.float32), done)
        tbuf.store_step(tb, torch.tensor(obs), torch.tensor(act),
                        torch.ones(2), torch.tensor(done))
        jb = jbuf.store_first_obs(jbuf.flush(jb, done), obs, done, -5.0)
        tbuf.store_first_obs(tbuf.flush(tb, torch.tensor(done)),
                             torch.tensor(obs), torch.tensor(done), -5.0)
    valid = np.flatnonzero(tb.ep_valid.numpy())
    rows = rng.choice(valid, 8).astype(np.int32)
    starts = (rng.random(8) * tb.ep_len.numpy()[rows]).astype(np.int32)
    obs_s, act_s, rew, done = jbuf._gather_windows(
        jb, jnp.asarray(rows), jnp.asarray(starts), 1)
    tw = tbuf._window_batch(tb, torch.tensor(rows), torch.tensor(starts), 1)
    want = dict(obs=obs_s[:, :1], action=act_s[:, :1], reward=rew,
                next_obs=obs_s[:, 1:], next_action=act_s[:, 1:], done=done,
                ep_len=np.clip(np.asarray(jb.ep_len)[rows], 0, 1))
    for f, value in want.items():
        np.testing.assert_array_equal(getattr(tw, f), value)
    assert tw.obs.shape == (8, 1, 3) and (tw.ep_len == 1).all()
    batch = tbuf.sample(tb, torch.Generator().manual_seed(0), 8, 1)
    assert batch.next_obs.shape == (8, 1, 3)
