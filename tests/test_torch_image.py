"""The image path of the port vs the JAX package: ImageMaze and the CNN
embedder.

- ImageMaze resets built from the JAX reset's outcomes (``reset_with``) and
  60 steps of random actions: observations, states, rewards and flags
  exact; the port's own resets in distribution;
- DTQN with ``ImageObsEmbedding`` on bridged parameters (flax's HWIO conv
  kernels as OIHW, its NHWC flatten order): Q within 2e-5 and parameter
  gradients within 5e-5 relative to their scale (the pixels are 0 or 255);
- the in-repo JAX-trained ImageMaze policy picks the JAX package's greedy
  action at every evaluation step, from the JAX run's start states.
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
from dtqn_tpu.train.loop import make_evaluate as jax_make_evaluate
from dtqn_tpu_torch.agents import Agent, AgentConfig
from dtqn_tpu_torch.bridge import params_from_jax, params_to_jax
from dtqn_tpu_torch.envs import ImageMaze, make_env
from dtqn_tpu_torch.models import build_network
from dtqn_tpu_torch.models.embeddings import ImageObsEmbedding
from dtqn_tpu_torch.train.loop import make_evaluate_fn

ENV = "ImageMaze-9-v0"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICY = glob.glob(os.path.join(
    REPO, "policies", "validation", ENV,
    "model=DTQN_*in_embed=128_*_seed=1_policy.msgpack"))


def injected_reset(env, jstate):
    """The port's episodes from a (batched) JAX ImageMaze state: the pillars
    kept are the walls on even-even cells, the cells y * N + x."""
    n = env.size
    t = torch.tensor

    def cell(yx):
        return t(yx[:, 0] * n + yx[:, 1])

    return env.reset_with(t(np.asarray(jstate.walls)),
                          cell(np.asarray(jstate.goal)),
                          cell(np.asarray(jstate.pos)))


def assert_state_equal(state, jstate):
    for field in ("walls", "goal", "pos", "t"):
        np.testing.assert_array_equal(getattr(state, field).numpy(),
                                      np.asarray(getattr(jstate, field)),
                                      err_msg=field)


def test_image_maze_reset_and_steps_match_jax():
    jenv, env = jax_make_env(ENV), make_env(ENV)
    assert isinstance(env, ImageMaze)
    assert (env.obs_shape, env.num_actions, env.max_episode_steps,
            env.obs_mask, env.obs_dtype) == ((3, 9, 9), 4, 100, 0.0,
                                             torch.uint8)
    e = 16
    jobs, jstate = jax.vmap(jenv.reset_env)(
        jax.random.split(jax.random.key(0), e))
    obs, state = injected_reset(env, jstate)
    assert obs.dtype == torch.uint8 and obs.shape == (e, 3, 9, 9)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    assert_state_equal(state, jstate)
    jstep = jax.jit(jax.vmap(jenv.step_env, in_axes=(None, 0, 0)))
    actions = np.random.default_rng(0).integers(0, 4, (60, e))
    reached = 0
    for a in actions:
        jobs, jstate, jrew, jterm, jinfo = jstep(jax.random.key(1), jstate,
                                                 jnp.asarray(a))
        obs, state, rew, term, info = env.step_env(None, state,
                                                   torch.tensor(a))
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
        assert_state_equal(state, jstate)
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
        np.testing.assert_array_equal(info["is_success"].numpy(),
                                      np.asarray(jinfo["is_success"]))
        reached += int(term.sum())
    assert reached > 0  # the goal was reached on some lane


def test_image_maze_own_resets_in_distribution():
    env = make_env(ENV)
    e = 512
    obs, state = env.reset_env(torch.Generator().manual_seed(0), e, "cpu")
    n = env.size
    yy, xx = np.mgrid[0:n, 0:n]
    walls = state.walls.numpy()
    border = (yy == 0) | (xx == 0) | (yy == n - 1) | (xx == n - 1)
    pillars = (yy % 2 == 0) & (xx % 2 == 0)
    assert walls[:, border].all()
    assert not walls[:, ~border & ~pillars].any()
    inner_pillars = walls[:, pillars & ~border]
    assert 0.45 < inner_pillars.mean() < 0.55  # Bernoulli(0.5)
    e_idx = np.arange(e)
    goal, pos = state.goal.numpy(), state.pos.numpy()
    assert not walls[e_idx, goal[:, 0], goal[:, 1]].any()
    assert not walls[e_idx, pos[:, 0], pos[:, 1]].any()
    assert (goal != pos).any(axis=-1).all()
    assert len({tuple(g) for g in goal}) > 20  # spread over the free cells
    # The agent always shows; the goal only when within radius 2.
    assert (obs[:, 2].reshape(e, -1) == 255).sum(-1).eq(1).all()
    near = np.abs(goal - pos).max(-1) <= 2
    np.testing.assert_array_equal(
        obs[:, 1].reshape(e, -1).amax(-1).numpy() == 255, near)


def image_nets(seed=0, **kw):
    kw = dict(inner_embed=16, num_heads=2, context_len=4, **kw)
    jnet = jax_build_network("DTQN", jax_make_env(ENV), **kw)
    params = jnet.init(jax.random.key(seed),
                       jnp.zeros((2, 4, 3, 9, 9), jnp.uint8),
                       jnp.zeros((2, 4), jnp.int32))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.01 * rng.standard_normal(x.shape))
        .astype(np.float32), params)
    tnet = build_network("DTQN", make_env(ENV), **kw)
    tnet.load_state_dict(params_from_jax(params), strict=True)
    return jnet, params, tnet


def test_image_dtqn_q_and_grads_match_flax():
    jnet, params, tnet = image_nets()
    assert isinstance(tnet.obs_embedding, ImageObsEmbedding)
    tree = params["params"]["ImageObsEmbedding_0"]
    assert tree["Conv_1"]["kernel"].shape == (3, 3, 64, 64)  # HWIO
    assert tnet.obs_embedding.conv_1.weight.shape == (64, 64, 3, 3)
    assert tree["Dense_0"]["kernel"].shape == (2 * 2 * 128, 12 + 4)
    back = params_to_jax(tnet.state_dict())
    for i in range(5):
        np.testing.assert_array_equal(
            back["ImageObsEmbedding_0"][f"Conv_{i}"]["kernel"],
            tree[f"Conv_{i}"]["kernel"])
    rng = np.random.default_rng(1)
    obs = (rng.random((2, 4, 3, 9, 9)) < 0.3).astype(np.uint8) * 255
    actions = rng.integers(0, 4, (2, 4)).astype(np.int32)
    g = rng.standard_normal((2, 4, 4)).astype(np.float32)
    def loss(p):
        return jnp.sum(jnet.apply(p, obs, actions) * g)

    q_jax = jax.jit(jnet.apply)(params, obs, actions)
    grads = jax.jit(jax.grad(loss))(params)
    q = tnet(torch.tensor(obs), torch.tensor(actions))
    (q * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(q_jax),
                               atol=2e-5)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    for name, p in tnet.named_parameters():
        scale = max(float(np.abs(ref[name].numpy()).max()), 1.0)
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   atol=5e-5 * scale, err_msg=name)


def test_image_embedder_reads_features_in_flax_order():
    """A Dense kernel that reads one feature: the same one in both
    packages, so an NCHW flatten would fail here."""
    emb = ImageObsEmbedding((3, 9, 9), 1)
    x = torch.rand(2, 3, 9, 9) * 255
    with torch.no_grad():
        emb.dense_0.weight.zero_()
        emb.dense_0.weight[0, 5] = 1.0  # NHWC feature 5: (0, 0), channel 5
        h = x
        for i in range(5):
            h = torch.relu(torch.nn.functional.conv2d(
                h, getattr(emb, f"conv_{i}").weight,
                getattr(emb, f"conv_{i}").bias,
                stride=(2, 1, 2, 1, 2)[i], padding=1))
        want = h[:, 5, 0, 0]
        np.testing.assert_allclose(emb(x)[:, 0].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)


def jax_rollout(jagent, jenv, params, key, n):
    """The JAX evaluation's episodes (its own key use), stepped one by one:
    the start state, and per step the greedy actions and which episodes
    were live."""
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


@pytest.mark.skipif(not POLICY, reason="ImageMaze validation policy absent")
def test_trained_image_maze_policy_matches_jax_greedy_actions(monkeypatch):
    with open(POLICY[0], "rb") as f:
        params = serialization.msgpack_restore(f.read())
    kw = dict(inner_embed=128, num_heads=8, num_layers=2, context_len=50,
              history=50)
    jenv, env = jax_make_env(ENV), make_env(ENV)
    n = 4
    jagent = JaxAgent(JaxConfig(model="DTQN", num_envs=n, **kw), jenv)
    agent = Agent(AgentConfig(model="DTQN", num_envs=n, **kw), env,
                  device="cpu")
    network = agent.build_network()
    network.load_state_dict(params_from_jax(params), strict=True)
    key = jax.random.key(11)
    sr, _, ln = (float(x) for x in jax_make_evaluate(jagent, jenv, n)(
        params, key))
    start, steps = jax_rollout(jagent, jenv, params, key, n)
    first = injected_reset(env, start)
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
    # The port reads its early exit every 10 steps: it runs on, with no
    # live episode, to the next such read.
    assert 0 < len(steps) <= len(recorded)
    for got, (want, live) in zip(recorded, steps):
        np.testing.assert_array_equal(got[live], want[live])
    assert round(t_sr * n) == round(sr * n)
    assert round(t_ln * n) == round(ln * n)
    assert sr > 0  # the trained policy does reach a goal
