"""Port Memory Cards and the discrete-observation DTQN vs the JAX package on
the same inputs.  The env's random draws (the deal, the card revealed next)
are taken from the JAX run and injected, so every content is exactly equal;
the network agrees within Q atol 2e-5 / grads atol 5e-5 (float32, different
summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtqn_tpu.envs import make_env as jax_make_env
from dtqn_tpu.models import build_network as jax_build_network
from dtqn_tpu_torch.agents import Agent, AgentConfig
from dtqn_tpu_torch.bridge import params_from_jax, params_to_jax
from dtqn_tpu_torch.envs import make_env
from dtqn_tpu_torch.envs.core import ObsKind
from dtqn_tpu_torch.models import build_network
from dtqn_tpu_torch.models.embeddings import DiscreteObsEmbedding
from dtqn_tpu_torch.train.loop import (
    make_prepopulate_fn,
    make_train_chunk_fn,
)
from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule

ENV = "Memory-5-v0"


def eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_env_interface_matches_jax():
    jenv, env = jax_make_env(ENV), make_env(ENV)
    assert env.obs_kind == ObsKind.DISCRETE and env.is_discrete
    assert env.obs_dtype == torch.int32
    for attr in ("name", "num_actions", "max_episode_steps", "obs_mask",
                 "obs_vocab_size", "num_pairs", "num_cards"):
        assert getattr(env, attr) == getattr(jenv, attr), attr
    assert tuple(env.obs_shape) == tuple(jenv.obs_shape) == (10,)
    with pytest.raises(ValueError, match="discrete"):
        make_env("DiscreteCarFlag-v0").obs_vocab_size


def scripted_actions(rng, values, removed, current, t):
    """Per env: the pair-mate of the revealed card (right), the revealed
    card itself, a removed card where there is one, or any card."""
    actions = rng.integers(0, values.shape[1], len(values))
    for e in range(len(values)):
        mode = (e + t) % 4
        mates = np.flatnonzero(values[e] == values[e, current[e]])
        if mode in (0, 1):
            actions[e] = mates[mates != current[e]][0]
        elif mode == 2:
            actions[e] = current[e]
        elif removed[e].any():
            actions[e] = np.flatnonzero(removed[e])[0]
    return actions.astype(np.int32)


def test_step_and_obs_match_jax_over_scripted_episode(monkeypatch):
    n, steps = 16, 30
    jenv, env = jax_make_env(ENV), make_env(ENV)
    jobs, jstate = jenv.reset_vec(jax.random.split(jax.random.key(0), n))
    obs, state = env.reset_with(torch.tensor(np.asarray(jstate.values)),
                                torch.tensor(np.asarray(jstate.current_card)))
    eq(obs, jobs)
    assert obs.dtype == torch.int32
    rng = np.random.default_rng(1)
    step = jax.jit(jax.vmap(jenv.step))
    seen_terminated = seen_removed_pick = False
    for t in range(steps):
        actions = scripted_actions(
            rng, np.asarray(jstate.values), np.asarray(jstate.removed),
            np.asarray(jstate.current_card), t,
        )
        picked_removed = np.asarray(jstate.removed)[np.arange(n), actions]
        seen_removed_pick |= bool(picked_removed.any())
        keys = jax.random.split(jax.random.key(100 + t), n)
        jobs, jnew, jts = step(keys, jstate, actions)
        # The card the JAX env revealed next is the port's injected draw.
        revealed = torch.tensor(np.asarray(jnew.current_card))
        monkeypatch.setattr(env, "_reveal", lambda gen, removed: revealed)
        obs, new, ts = env.step(None, state, torch.tensor(actions))
        eq(obs, jobs)
        eq(ts.obs, jts.obs)
        eq(ts.reward, jts.reward)
        eq(ts.terminated, jts.terminated)
        eq(ts.truncated, jts.truncated)
        eq(ts.info["is_success"], jts.info["is_success"])
        for f in ("values", "removed", "current_card", "t"):
            eq(getattr(new, f), getattr(jnew, f))
            assert getattr(new, f).dtype == getattr(state, f).dtype
        assert ts.reward.dtype == torch.float32
        seen_terminated |= bool(ts.terminated.any())
        # Finished games stay finished in both: carry on with the rest.
        jstate, state = jnew, new
    assert seen_terminated and seen_removed_pick


def test_own_draws_deal_and_reveal():
    env = make_env(ENV)
    gen = torch.Generator().manual_seed(0)
    obs, state = env.reset_vec(gen, 256, "cpu")
    assert obs.shape == (256, 10) and obs.dtype == torch.int32
    # Every deal holds each value exactly twice; deals differ between envs.
    assert (torch.sort(state.values, dim=1).values
            == torch.arange(1, 6).repeat_interleave(2)).all()
    assert len({tuple(v) for v in state.values.tolist()}) > 200
    # The observation shows the revealed card's value and hides the rest.
    shown = obs.gather(1, state.current_card.to(torch.int64)[:, None])[:, 0]
    eq(shown, state.values.gather(
        1, state.current_card.to(torch.int64)[:, None])[:, 0])
    assert ((obs != 0).sum(dim=1) == 1).all()
    assert len(set(state.current_card.tolist())) == 10
    # A reveal never lands on a removed card.
    removed = torch.rand((256, 10), generator=gen) < 0.7
    removed[:, 3] = False
    picks = env._reveal(gen, removed).to(torch.int64)
    assert not removed.gather(1, picks[:, None]).any()


def test_step_autoreset_deals_again():
    env = make_env(ENV)
    gen = torch.Generator().manual_seed(1)
    _, state = env.reset_vec(gen, 8, "cpu")
    state.t = torch.tensor([49, 0, 49, 3, 49, 49, 7, 49], dtype=torch.int32)
    obs, new, ts = env.step_vec(gen, state, state.current_card)
    eq(ts.truncated, state.t == 49)
    eq(ts.reward, np.full(8, -1.0, np.float32))
    assert (new.t[ts.done] == 0).all() and (new.t[~ts.done] > 0).all()
    assert not new.removed.any()
    assert ((obs != 0).sum(dim=1) == 1).all()


def jax_net_and_params(seed=0, **kw):
    net = jax_build_network("DTQN", jax_make_env(ENV), **kw)
    ctx = kw.get("context_len", 50)
    params = net.init(jax.random.key(seed), jnp.zeros((2, ctx, 10), jnp.int32),
                      jnp.zeros((2, ctx), jnp.int32))
    rng = np.random.default_rng(seed + 1)
    # Non-zero positions and biases, so their gradients are exercised.
    return net, jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.02 * rng.standard_normal(x.shape))
        .astype(np.float32), params,
    )


def tokens(seed, b, length):
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 8, (b, length, 10)).astype(np.int32)  # 7 = mask
    actions = rng.integers(0, 10, (b, length)).astype(np.int32)
    return obs, actions


def test_bridge_round_trip_discrete():
    _, params = jax_net_and_params(inner_embed=32, num_heads=4,
                                   context_len=10, embed_per_obs_dim=4)
    state = params_from_jax(params)
    assert state["obs_embedding.embedding.weight"].shape == (8, 4)
    assert state["obs_embedding.dense_0.weight"].shape == (32, 40)
    back = params_to_jax(state)
    flat_a = jax.tree_util.tree_leaves_with_path(params["params"])
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    net = build_network("DTQN", make_env(ENV), inner_embed=32, num_heads=4,
                        context_len=10, embed_per_obs_dim=4)
    net.load_state_dict(state, strict=True)


def test_discrete_obs_embedding_matches_jax():
    from dtqn_tpu.models.embeddings import (
        DiscreteObsEmbedding as JaxDiscreteObsEmbedding,
    )

    jmod = JaxDiscreteObsEmbedding(vocab_size=8, obs_dim=10,
                                   embed_per_obs_dim=8, features=24)
    obs, _ = tokens(0, 3, 6)
    params = jmod.init(jax.random.key(0), obs)
    params = jax.tree_util.tree_map(np.asarray, params)
    mod = DiscreteObsEmbedding(8, 10, 8, 24)
    p = params["params"]
    mod.load_state_dict({
        "embedding.weight": torch.tensor(p["Embed_0"]["embedding"]),
        "dense_0.weight": torch.tensor(p["Dense_0"]["kernel"].T),
        "dense_0.bias": torch.tensor(p["Dense_0"]["bias"]),
    })
    out = mod(torch.tensor(obs))  # int32 tokens, as the context holds them
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jmod.apply(params, obs)), atol=2e-5)
    # A fresh module draws N(0, 0.02) weights from the given generator.
    fresh = DiscreteObsEmbedding(8, 10, 8, 24,
                                 torch.Generator().manual_seed(0))
    assert 0.01 < fresh.embedding.weight.std() < 0.03
    assert (fresh.dense_0.bias == 0).all()


@pytest.mark.parametrize("action_dim", [0, 4])
def test_discrete_dtqn_forward_and_grads_match_jax(action_dim):
    kw = dict(inner_embed=32, num_heads=4, context_len=10,
              action_dim=action_dim, embed_per_obs_dim=4)
    jnet, params = jax_net_and_params(seed=action_dim, **kw)
    tnet = build_network("DTQN", make_env(ENV), **kw)
    tnet.load_state_dict(params_from_jax(params), strict=True)
    obs, actions = tokens(2, 4, 10)
    g = np.random.default_rng(3).standard_normal((4, 10, 10)).astype(
        np.float32)

    grads_jax = jax.grad(
        lambda p: jnp.sum(jnet.apply(p, obs, actions) * g)
    )(params)
    q_jax = jnet.apply(params, obs, actions)
    q_t = tnet(torch.tensor(obs), torch.tensor(actions))
    (q_t * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(q_t.detach().numpy(), np.asarray(q_jax),
                               atol=2e-5)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, grads_jax))
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   atol=5e-5, err_msg=name)


def test_agent_trains_on_memory_cards():
    """The discrete path end to end: int32 tokens stay int32 in the context
    and the ring, padding is the mask token, and every update applies."""
    env = make_env(ENV)
    cfg = AgentConfig(num_envs=4, inner_embed=16, num_heads=2, context_len=6,
                      history=6, batch_size=4, buffer_size=400,
                      embed_per_obs_dim=4)
    agent = Agent(cfg, env, device="cpu")
    state = agent.init_state(0)
    assert state.context.obs.dtype == torch.int32
    assert state.buffer.obs.dtype == torch.int32
    assert (state.context.obs[:, 1:] == 7).all()
    make_prepopulate_fn(agent, 120)(state)
    before = state.params.clone()
    make_train_chunk_fn(agent, EpsilonSchedule(1.0, 0.1, 100), 4, 3)(state)
    assert int(state.train_steps) == 12
    assert int(state.nonfinite_grads) == 0
    assert int(state.env_steps) == 12
    assert not torch.equal(before, state.params)
    assert int(state.buffer.obs.max()) <= 7 and int(state.buffer.obs.min()) >= 0
    assert state.obs.dtype == torch.int32
