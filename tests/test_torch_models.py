"""Port DTQN vs the JAX package on bridged parameters: the bridge, the
forward Q, the parameter gradients of a scalar loss, and the trained
seed-1 CarFlag policy at full width.

Tolerances: Q atol 2e-5 / grads atol 5e-5 at the small width (float32,
different summation order); the full-width trained policy atol 1e-4.
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
from dtqn_tpu.models import build_network as jax_build_network
from dtqn_tpu_torch import replay
from dtqn_tpu_torch.agents import Agent, AgentConfig
from dtqn_tpu_torch.bridge import params_from_jax, params_to_jax
from dtqn_tpu_torch.envs import make_env
from dtqn_tpu_torch.models import build_network
from dtqn_tpu_torch.models.transformer import LAYERNORM_EPS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICY = glob.glob(os.path.join(
    REPO, "policies", "tuf1000", "DiscreteCarFlag-v0",
    "model=DTQN_*in_embed=64_*_seed=1_policy.msgpack",
))


def jax_net_and_params(seed=0, **kw):
    net = jax_build_network("DTQN", jax_make_env("DiscreteCarFlag-v0"), **kw)
    ctx = kw.get("context_len", 50)
    params = net.init(jax.random.key(seed), jnp.zeros((2, ctx, 3)),
                      jnp.zeros((2, ctx), jnp.int32))
    return net, jax.tree_util.tree_map(np.asarray, params)


def torch_net(params, **kw):
    net = build_network("DTQN", make_env("DiscreteCarFlag-v0"), **kw)
    net.load_state_dict(params_from_jax(params), strict=True)
    return net


def inputs(seed, b, length):
    rng = np.random.default_rng(seed)
    obs = rng.uniform(-1.1, 1.1, (b, length, 3)).astype(np.float32)
    actions = rng.integers(0, 3, (b, length)).astype(np.int32)
    return obs, actions


def test_bridge_round_trip_and_count():
    _, params = jax_net_and_params(inner_embed=64, num_heads=8,
                                   context_len=50)
    state = params_from_jax(params)
    assert sum(t.numel() for t in state.values()) == 107_779
    back = params_to_jax(state)
    flat_a = jax.tree_util.tree_leaves_with_path(params["params"])
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    assert state["layers.0.attention.qkv.weight"].shape == (192, 64)
    assert state["position.embedding"].shape == (1, 50, 64)


def test_bridge_accepts_separate_qkv():
    _, params = jax_net_and_params(inner_embed=32, num_heads=4,
                                   context_len=20)
    tree = jax.tree_util.tree_map(lambda x: x, params["params"])
    for name in ("layer_0", "layer_1"):
        qkv = tree[name]["attention"].pop("qkv")
        for i, part in enumerate(("query", "key", "value")):
            tree[name]["attention"][part] = {
                leaf: np.split(qkv[leaf], 3, axis=-1)[i]
                for leaf in ("kernel", "bias")
            }
    fused, split = params_from_jax(params), params_from_jax(tree)
    assert fused.keys() == split.keys()
    for k in fused:
        assert torch.equal(fused[k], split[k])


def test_layernorm_eps_is_flax_default():
    net = build_network("DTQN", make_env("DiscreteCarFlag-v0"),
                        inner_embed=32, num_heads=4, context_len=20)
    assert LAYERNORM_EPS == 1e-6
    assert all(m.eps == 1e-6 for m in net.modules()
               if isinstance(m, torch.nn.LayerNorm))


@pytest.mark.parametrize("action_dim", [0, 4])
def test_dtqn_forward_and_grads_match_jax(action_dim):
    kw = dict(inner_embed=32, num_heads=4, context_len=20,
              action_dim=action_dim)
    jnet, params = jax_net_and_params(seed=action_dim, **kw)
    # Non-zero positions and biases, so their gradients are exercised.
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda x: (x + 0.02 * rng.standard_normal(x.shape)).astype(np.float32),
        params,
    )
    tnet = torch_net(params, **kw)
    obs, actions = inputs(2, 4, 20)
    g = np.random.default_rng(3).standard_normal((4, 20, 3)).astype(np.float32)

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


def test_variant_options_and_envs_build():
    """Each variant builds and gives finite Q; the image maze and the
    continuous Car Flag are registered."""
    env = make_env("DiscreteCarFlag-v0")
    obs, actions = (torch.tensor(x) for x in inputs(5, 2, 4))
    for kw in (dict(gate="gru"), dict(identity=True), dict(pos="sin"),
               dict(pos="none"), dict(dropout=0.1)):
        net = build_network("DTQN", env, inner_embed=16, num_heads=2,
                            context_len=4, **kw)
        q = net(obs, actions)
        assert q.shape == (2, 4, 3) and torch.isfinite(q).all()
    for name in ("ImageMaze-9-v0", "CarFlag-continuous-v0"):
        assert make_env(name).name == name


def _contexts(seed, e, length):
    """Realistic CarFlag contexts: newest row at min(t, L-1), the rows after
    it padded with the obs mask."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.1, 1.1, (e, length))
    vel = rng.uniform(-0.07, 0.07, (e, length))
    hint = rng.choice([-1.0, 0.0, 1.0], (e, length))
    obs = np.stack([pos, vel, hint], -1).astype(np.float32)
    timestep = rng.integers(0, 2 * length, e).astype(np.int32)
    last = np.minimum(timestep, length - 1)
    pad = np.arange(length)[None, :] > last[:, None]
    obs[pad] = -5.0
    action = rng.integers(0, 3, (e, length)).astype(np.int32)
    return obs, action, timestep


@pytest.mark.skipif(not POLICY, reason="trained CarFlag DTQN policy absent")
def test_trained_policy_q_and_greedy_actions_match():
    with open(POLICY[0], "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    kw = dict(inner_embed=64, num_heads=8, num_layers=2, context_len=50)
    jcfg = JaxConfig(model="DTQN", num_envs=32, **kw)
    jagent = JaxAgent(jcfg, jax_make_env("DiscreteCarFlag-v0"))
    agent = Agent(AgentConfig(model="DTQN", num_envs=32, **kw),
                  make_env("DiscreteCarFlag-v0"), device="cpu")
    tnet = agent.build_network()
    tnet.load_state_dict(params_from_jax(tree), strict=True)

    obs, action, timestep = _contexts(5, 32, 50)
    q_jax = jagent.network.apply(tree, obs, action)
    with torch.no_grad():
        q_t = tnet(torch.tensor(obs), torch.tensor(action))
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_jax), atol=1e-4)

    zeros_f = np.zeros((32, 50), np.float32)
    jctx = jax_replay.ContextState(
        obs=jnp.asarray(obs), action=jnp.asarray(action),
        reward=jnp.asarray(zeros_f), done=jnp.ones((32, 50), bool),
        timestep=jnp.asarray(timestep),
    )
    tctx = replay.ContextState(
        obs=torch.tensor(obs), action=torch.tensor(action),
        reward=torch.tensor(zeros_f), done=torch.ones(32, 50, dtype=bool),
        timestep=torch.tensor(timestep),
    )
    greedy_jax, _ = jagent.greedy_actions(tree, jctx, None, None, None)
    greedy_t, _ = agent.greedy_actions(tnet, tctx)
    np.testing.assert_array_equal(greedy_t.numpy(), np.asarray(greedy_jax))
