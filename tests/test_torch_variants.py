"""DTQN's variants in the port vs the JAX package, on bridged parameters:
the GRU gate, the identity (pre-LN) layer, sin / none positions, dropout in
its three places and ``attention_weights``.

Tolerances: Q atol 2e-5, parameter gradients atol 5e-5 (float32, another
order of summation); attention maps atol 2e-6 (probabilities in [0, 1]);
one ``apply_update`` with dropout at rtol 1e-4 (atol 1e-7 for parameters at
zero), as ``tests/test_torch_agent.py`` holds the flagless one.  Dropout
draws cannot match across frameworks: flax's own masks are recorded (by
wrapping the ``bernoulli`` its ``Dropout`` calls) and injected into the
port, or, in the update, the test's masks injected into both.
"""

import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtqn_tpu import replay as jax_replay
from dtqn_tpu.agents import Agent as JaxAgent
from dtqn_tpu.agents import AgentConfig as JaxConfig
from dtqn_tpu.envs import make_env as jax_make_env
from dtqn_tpu.models import attention_weights as jax_attention_weights
from dtqn_tpu.models import build_network as jax_build_network
from dtqn_tpu_torch import replay
from dtqn_tpu_torch.agents import Agent, AgentConfig
from dtqn_tpu_torch.bridge import params_from_jax
from dtqn_tpu_torch.envs import make_env
from dtqn_tpu_torch.models import attention_weights, build_network
from dtqn_tpu_torch.models.dropout import DropoutDraws
from dtqn_tpu_torch.models.gates import GRUGate

ENV = "DiscreteCarFlag-v0"
SMALL = dict(inner_embed=16, num_heads=2, context_len=4)
B, L = 3, 4


def nets(seed=0, **kw):
    """The JAX network with perturbed parameters (so that every gradient is
    exercised) and the port's network holding the same parameters."""
    kw = dict(SMALL, **kw)
    jnet = jax_build_network("DTQN", jax_make_env(ENV), **kw)
    bag = kw.get("bag_size", 0)
    args = [jnp.zeros((2, kw["context_len"], 3)),
            jnp.zeros((2, kw["context_len"]), jnp.int32)]
    if bag:
        args += [jnp.zeros((2, bag, 3)), jnp.zeros((2, bag), jnp.int32)]
    params = jnet.init(jax.random.key(seed), *args)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), params)
    tnet = build_network("DTQN", make_env(ENV), **kw)
    tnet.load_state_dict(params_from_jax(params), strict=True)
    return jnet, params, tnet


def inputs(seed, bag=0):
    rng = np.random.default_rng(seed)
    obs = rng.uniform(-1.1, 1.1, (B, L, 3)).astype(np.float32)
    actions = rng.integers(0, 3, (B, L)).astype(np.int32)
    if not bag:
        return obs, actions
    bag_obs = rng.uniform(-1.1, 1.1, (B, bag, 3)).astype(np.float32)
    return obs, actions, bag_obs, rng.integers(0, 3, (B, bag)).astype(
        np.int32)


def assert_grads_match(tnet, jax_grads):
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_grads))
    assert set(ref) == {n for n, _ in tnet.named_parameters()}
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   atol=5e-5, err_msg=name)


VARIANTS = [(g, i, p) for g in ("res", "gru") for i in (False, True)
            for p in ("learned", "sin", "none")]


@pytest.mark.parametrize("gate,identity,pos", VARIANTS,
                         ids=[f"{g}-{i}-{p}" for g, i, p in VARIANTS])
def test_variant_q_and_grads_match_jax(gate, identity, pos):
    """The 12 combinations of ``tests/test_models.py:81-87``: the same
    parameter set as flax's, Q within 2e-5 and gradients within 5e-5."""
    jnet, params, tnet = nets(gate=gate, identity=identity, pos=pos)
    assert sum(t.numel() for t in tnet.parameters()) == sum(
        x.size for x in jax.tree_util.tree_leaves(params))
    obs, actions = inputs(1)
    g = np.random.default_rng(2).standard_normal((B, L, 3)).astype(np.float32)
    q_jax = jnet.apply(params, obs, actions)
    grads = jax.grad(lambda p: jnp.sum(jnet.apply(p, obs, actions) * g))(
        params)
    q = tnet(torch.tensor(obs), torch.tensor(actions))
    (q * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(q_jax),
                               atol=2e-5)
    assert_grads_match(tnet, grads)


def test_gru_gate_init_and_full_width_parameter_count():
    gate = GRUGate(64, torch.Generator().manual_seed(0))
    assert torch.equal(gate.w_z.bias, torch.full((64,), -2.0))
    for name in ("u_z", "w_r", "u_r", "w_g", "u_g"):
        assert getattr(gate, name).bias is None
    weights = torch.cat([p.reshape(-1) for n, p in gate.named_parameters()
                         if n.endswith("weight")])
    assert abs(float(weights.detach().std()) - 0.02) < 1e-3
    kw = dict(inner_embed=64, num_heads=8, context_len=50, gate="gru",
              identity=True, pos="sin")
    _, params, tnet = nets(**kw)
    n = sum(x.size for x in jax.tree_util.tree_leaves(params))
    assert sum(t.numel() for t in tnet.parameters()) == n == 203_139
    # The fixed tables are no parameters and no policy entries.
    assert not any("position" in k for k in tnet.state_dict())
    assert tnet.position.table.shape == (1, 50, 64)


@pytest.fixture
def recorded(monkeypatch):
    """Every mask flax's ``Dropout`` draws while the fixture lives."""
    masks = []
    real = flax_stochastic.random.bernoulli

    def recording(key, p=0.5, shape=None):
        mask = real(key, p, shape)
        masks.append(mask)
        return mask

    monkeypatch.setattr(flax_stochastic.random, "bernoulli", recording)
    return masks


@pytest.mark.parametrize("kw", [
    dict(), dict(gate="gru", identity=True, pos="sin", bag_size=2),
], ids=["post-ln", "gru-identity-sin-bag"])
def test_dropout_with_flax_masks_matches_jax(kw, recorded):
    """Dropout on the input, the attention probabilities and the FFN output
    (and the bag attention's probabilities): flax's masks injected into the
    port in call order give its Q and gradients."""
    jnet, params, tnet = nets(dropout=0.3, **kw)
    args = inputs(3, kw.get("bag_size", 0))
    g = np.random.default_rng(4).standard_normal((B, L, 3)).astype(np.float32)
    rngs = {"dropout": jax.random.key(5)}
    q_jax = jnet.apply(params, *args, deterministic=False, rngs=rngs)
    masks = [np.asarray(m) for m in recorded]
    sites = 1 + 2 * 2 + bool(kw.get("bag_size"))
    assert len(masks) == sites
    assert masks[1].shape == (B, 2, L, L)  # the attention probabilities
    grads = jax.grad(lambda p: jnp.sum(jnet.apply(
        p, *args, deterministic=False, rngs=rngs) * g))(params)
    q = tnet(*map(torch.tensor, args),
             draws=DropoutDraws(masks=map(torch.tensor, masks)))
    (q * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(q_jax),
                               atol=2e-5)
    assert_grads_match(tnet, grads)
    # The masks did act: the train-mode Q is not the eval-mode one.
    assert not np.allclose(np.asarray(q_jax), np.asarray(
        jnet.apply(params, *args)), atol=1e-3)


def test_dropout_zero_and_eval_mode():
    """Rate 0 gives train == eval; at rate 0.3 an eval-mode forward (no
    draws) is the JAX package's deterministic one, and train-mode forwards
    from the generator differ by draw but repeat from one state."""
    obs, actions = (torch.tensor(x) for x in inputs(6))
    _, _, tnet = nets()
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(tnet(obs, actions),
                       tnet(obs, actions, draws=DropoutDraws(gen)))
    jnet, params, tnet = nets(dropout=0.3)
    np.testing.assert_allclose(
        tnet(obs, actions).detach().numpy(),
        np.asarray(jnet.apply(params, obs.numpy(), actions.numpy())),
        atol=2e-5)
    start = gen.get_state()
    first = tnet(obs, actions, draws=DropoutDraws(gen))
    second = tnet(obs, actions, draws=DropoutDraws(gen))
    gen.set_state(start)
    again = tnet(obs, actions, draws=DropoutDraws(gen))
    assert not torch.equal(first, second) and torch.equal(first, again)


@pytest.mark.parametrize("bag", [0, 2], ids=["no-bag", "bag"])
def test_attention_weights_match_jax(bag):
    """The head-averaged maps sorted by module path (``bag_attention``
    first), and the ordinary forward's Q."""
    jnet, params, tnet = nets(bag_size=bag, num_layers=2)
    args = inputs(7, bag)
    q_jax, maps_jax = jax_attention_weights(jnet, params, *args)
    with torch.no_grad():
        q, maps = attention_weights(tnet, *map(torch.tensor, args))
        q_plain = tnet(*map(torch.tensor, args))
    assert len(maps) == len(maps_jax) == 2 + bool(bag)
    for got, want in zip(maps, maps_jax):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    if bag:
        assert maps[0].shape == (B, L, bag)  # the bag's map comes first
    np.testing.assert_allclose(q.numpy(), np.asarray(q_jax), atol=2e-5)
    assert torch.equal(q, q_plain)
    assert all(m.maps is None for m in tnet.modules() if hasattr(m, "maps"))


def test_apply_update_with_dropout_matches_jax(monkeypatch):
    """One gated DDQN step at dropout 0.2: the JAX update (jitted) with the
    masks of its every dropout site injected, in trace order (the policy
    and target next-Q lanes under ``vmap``, which share a mask there, then
    the loss forward), against the port's update given the same masks."""
    kw = dict(num_envs=2, inner_embed=16, num_heads=2, num_layers=2,
              context_len=6, history=4, batch_size=4, buffer_size=400,
              dropout=0.2)
    jagent = JaxAgent(JaxConfig(model="DTQN", **kw), jax_make_env(ENV))
    jstate = jagent.init_state(jax.random.key(0))
    agent = Agent(AgentConfig(model="DTQN", **kw), make_env(ENV),
                  device="cpu")
    state = agent.init_state(0)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    state.network.load_state_dict(params_from_jax(params))
    state.target_network.load_state_dict(params_from_jax(params))
    state.buffer.flushed_total.fill_(100)
    jstate = jstate.replace(buffer=jstate.buffer.replace(
        flushed_total=jnp.int32(100)))

    rng = np.random.default_rng(8)
    obs = rng.uniform(-1.1, 1.1, (4, 7, 3)).astype(np.float32)
    act = rng.integers(0, 3, (4, 7)).astype(np.int32)
    arrays = dict(
        obs=obs[:, :-1], action=act[:, :-1], next_obs=obs[:, 1:],
        next_action=act[:, 1:],
        reward=rng.choice([-1.0, 0.0, 1.0], (4, 6)).astype(np.float32),
        done=rng.random((4, 6)) < 0.1,
        ep_len=rng.integers(1, 7, 4).astype(np.int32),
    )
    # Per forward: the input [B, L, F], then per layer the attention
    # probabilities [B, H, L, L] and the FFN output.
    shapes = [(4, 6, 16)] + [(4, 2, 6, 6), (4, 6, 16)] * 2
    lanes, loss = ([rng.random(s) < 0.8 for s in shapes] for _ in range(2))
    queue = lanes + loss

    def injected(key, p=0.5, shape=None):
        mask = queue.pop(0)
        assert mask.shape == tuple(shape) and p == pytest.approx(0.8)
        return jnp.asarray(mask)

    monkeypatch.setattr(flax_stochastic.random, "bernoulli", injected)
    jnew = jax.jit(jagent.apply_update)(
        jstate, jax_replay.Batch(**{k: jnp.asarray(v)
                                    for k, v in arrays.items()}),
        jax.random.key(1))
    assert not queue  # every site of the three forwards took its mask
    to_t = lambda ms: [torch.tensor(m) for m in ms]  # noqa: E731
    agent.apply_update(
        state, replay.Batch(**{k: torch.tensor(v) for k, v in arrays.items()}),
        masks=(to_t(lanes), to_t(lanes), to_t(loss)))
    assert int(jnew.train_steps) == int(state.train_steps) == 1
    d = jnew.diagnostics
    want = [float(getattr(d, f).buf[0]) for f in (
        "td_error", "grad_norm", "q_max", "q_mean", "q_min", "target_max",
        "target_mean", "target_min")]
    np.testing.assert_allclose(state.diagnostics.averages.buf[0].numpy(),
                               want, rtol=1e-4)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jnew.params))
    for name, value in state.network.state_dict().items():
        np.testing.assert_allclose(value.numpy(), ref[name].numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=name)


def test_dropout_update_draws_per_lane_from_the_generator():
    """Without injected masks each forward of the update draws its own from
    the agent's generator, and the update repeats bit for bit from one
    generator state; the recurrent models ignore dropout."""
    kw = dict(num_envs=2, inner_embed=16, num_heads=2, num_layers=1,
              context_len=4, history=4, batch_size=4, buffer_size=400,
              dropout=0.1)
    agent = Agent(AgentConfig(**kw), make_env(ENV), device="cpu")
    state = agent.init_state(0)
    state.buffer.flushed_total.fill_(100)
    arrays = dict(
        obs=torch.rand(4, 4, 3), action=torch.randint(0, 3, (4, 4)),
        next_obs=torch.rand(4, 4, 3), next_action=torch.randint(0, 3, (4, 4)),
        reward=torch.rand(4, 4), done=torch.zeros(4, 4, dtype=torch.bool),
        ep_len=torch.full((4,), 4, dtype=torch.int32))
    params, gen = state.params.clone(), state.generator.get_state()
    drawn = []
    real = DropoutDraws.__call__

    def noting(self, x, rate):
        drawn.append(self)
        return real(self, x, rate)

    DropoutDraws.__call__ = noting
    try:
        agent.apply_update(state, replay.Batch(**arrays))
    finally:
        DropoutDraws.__call__ = real
    # Three forwards of three sites each, one set of draws per forward.
    assert len(drawn) == 9 and len(set(map(id, drawn))) == 3
    first = state.params.clone()
    state.params.copy_(params)
    state.opt_state.mu.zero_(), state.opt_state.nu.zero_()
    state.opt_state.count.zero_(), state.train_steps.zero_()
    state.generator.set_state(gen)
    agent.apply_update(state, replay.Batch(**arrays))
    assert torch.equal(state.params, first)
    # The other models ignore the option, as in the JAX package.
    drqn = Agent(AgentConfig(model="DRQN", dropout=0.1), make_env(ENV),
                 device="cpu")
    assert drqn.dropout_draws(state) is None
