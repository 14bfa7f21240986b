"""The port's DTQN-bag path vs the JAX package on the same numpy inputs.

Data movement (the bag, the stored act-time bags, bag sampling with the JAX
run's draws injected, the eviction's choice) must be exactly equal.  The
network agrees within Q atol 1e-5 / gradients atol 1e-4 (float32, different
summation order), under the JAX package's XLA attention and its Pallas
kernels in interpret mode; one ``apply_update`` on a bag batch within atol
1e-5 on the parameters.  Small sizes: 2 layers, in_embed 16, 2 heads,
context 4-6, bag 3, 4 envs.
"""

import dataclasses

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
from dtqn_tpu.ops.attention import get_attention_impl, set_attention_impl
from dtqn_tpu.replay import bag as jbag
from dtqn_tpu.replay import buffer as jbuf
from dtqn_tpu_torch import replay, run
from dtqn_tpu_torch.agents import Agent, AgentConfig
from dtqn_tpu_torch.bridge import params_from_jax, params_to_jax
from dtqn_tpu_torch.config import ExperimentConfig, get_args
from dtqn_tpu_torch.envs import make_env
from dtqn_tpu_torch.models import build_network
from dtqn_tpu_torch.ops import cuda_attention
from dtqn_tpu_torch.replay import bag as tbag
from dtqn_tpu_torch.replay import buffer as tbuf
from dtqn_tpu_torch.train.loop import (
    make_evaluate_fn,
    make_prepopulate_fn,
    make_train_chunk_fn,
)
from dtqn_tpu_torch.train.runner import run_experiment
from dtqn_tpu_torch.utils import checkpoint as ckpt
from dtqn_tpu_torch.utils.checkpoint import _leaves
from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule

ENV = "gv_memory.5x5.yaml"
MASK = 25  # gv_memory's padding token
Q_ATOL, GRAD_ATOL, PARAM_ATOL = 1e-5, 1e-4, 1e-5
BAG_FIELDS = ("obs", "action", "obs_idx", "pos")


def eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def assert_bags_equal(tb, jb):
    for f in BAG_FIELDS:
        eq(getattr(tb, f), getattr(jb, f))
        assert getattr(tb, f).dtype == torch.int32


# ------------------------------------------------------------------ the bag
def test_bag_add_and_reset_match_jax():
    e, size = 6, 3
    jb = jbag.init_bag(e, size, (6,), jnp.int32, MASK)
    tb = tbag.init_bag(e, size, (6,), torch.int32, MASK, "cpu")
    assert_bags_equal(tb, jb)
    rng = np.random.default_rng(0)
    rejected = reset_seen = False
    for step in range(12):
        obs = rng.integers(0, 25, (e, 6)).astype(np.int32)
        act = rng.integers(0, 6, e).astype(np.int32)
        idx = rng.integers(0, 50, e).astype(np.int32)
        add = rng.random(e) < 0.7
        jb, jacc = jbag.bag_add(jb, obs, act, idx, add)
        before = tb
        tb, tacc = tbag.bag_add(tb, torch.tensor(obs), torch.tensor(act),
                                torch.tensor(idx), torch.tensor(add))
        eq(tacc, jacc)
        assert_bags_equal(tb, jb)
        eq(tb.is_full, jb.is_full)
        # A new state every time: the one before is left as it was.
        assert before.obs is not tb.obs
        rejected |= bool((add & ~np.asarray(jacc)).any())
        if step in (5, 9):
            reset = rng.random(e) < 0.4
            reset_seen |= bool(reset.any())
            jb = jbag.reset_bag(jb, reset, MASK)
            tb = tbag.reset_bag(tb, torch.tensor(reset), MASK)
            assert_bags_equal(tb, jb)
    assert rejected and reset_seen and tb.size == 3


# ---------------------------------------------------------- replay with bags
BUF_KW = dict(num_envs=4, buffer_size=480, max_episode_steps=24,
              context_len=5, obs_shape=(6,), obs_mask=MASK)
BUF_FIELDS = ("obs", "action", "reward", "done", "ep_len", "ep_valid",
              "write_pos", "ep_count", "flushed_total", "bag_idx", "bag_act")
BAG = 3


def filled_buffers(seed=7, steps=90):
    """The same first-obs / step / act-bag / flush writes on both rings."""
    e, t = BUF_KW["num_envs"], BUF_KW["max_episode_steps"]
    jb = jbuf.init_buffer(obs_dtype=jnp.int32, act_bag_size=BAG, **BUF_KW)
    tb = tbuf.init_buffer(obs_dtype=torch.int32, device="cpu",
                          act_bag_size=BAG, **BUF_KW)
    rng = np.random.default_rng(seed)

    def first(mask):
        nonlocal jb
        obs = rng.integers(0, 25, (e, 6)).astype(np.int32)
        jb = jbuf.store_first_obs(jb, obs, mask, MASK)
        tbuf.store_first_obs(tb, torch.tensor(obs), torch.tensor(mask), MASK)

    first(np.ones(e, bool))
    for _ in range(steps):
        obs = rng.integers(0, 25, (e, 6)).astype(np.int32)
        act = rng.integers(0, 6, e).astype(np.int32)
        rew = rng.standard_normal(e).astype(np.float32)
        term = rng.random(e) < 0.03
        jb = jbuf.store_step(jb, obs, act, rew, term)
        tbuf.store_step(tb, torch.tensor(obs), torch.tensor(act),
                        torch.tensor(rew), torch.tensor(term))
        # An act-time bag of pre-window indices: below the step's index
        # less the context, -1 where the slot is still empty.
        pos = tb.write_pos.numpy()
        room = np.maximum(pos - BUF_KW["context_len"], 0)
        idx = np.where(
            np.arange(BAG)[None, :] < room[:, None],
            (rng.random((e, BAG)) * np.maximum(room, 1)[:, None]).astype(
                np.int32),
            -1,
        ).astype(np.int32)
        bact = rng.integers(0, 6, (e, BAG)).astype(np.int32)
        jb = jbuf.store_act_bag(jb, idx, bact)
        tbuf.store_act_bag(tb, torch.tensor(idx), torch.tensor(bact))
        done = term | (pos >= t)
        jb = jbuf.flush(jb, done)
        tbuf.flush(tb, torch.tensor(done))
        first(done)
        for f in BUF_FIELDS:
            eq(getattr(tb, f), getattr(jb, f))
    return tb, jb


def assert_batches_equal(tbatch, jbatch):
    for f in dataclasses.fields(tbatch):
        eq(getattr(tbatch, f.name), getattr(jbatch, f.name))
    assert tbatch.bag_obs.dtype == torch.int32
    assert tbatch.bag_action.dtype == torch.int32


def test_store_act_bag_and_cleanse_match_jax():
    tb, jb = filled_buffers()
    assert tb.bag_idx.shape == (20, 24, BAG) and tb.bag_idx.dtype == torch.int32
    assert int(tb.flushed_total) > 8
    assert (tb.bag_idx >= 0).any() and (tb.bag_idx == -1).any()
    # A ring without --bag-store carries no bag storage.
    plain = tbuf.init_buffer(obs_dtype=torch.int32, device="cpu", **BUF_KW)
    assert plain.bag_idx is None and plain.bag_act is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_with_bag_matches_jax_with_injected_draws(seed):
    tb, jb = filled_buffers()
    b, length = 16, BUF_KW["context_len"]
    key = jax.random.key(seed)
    jbatch = jbuf.sample_with_bag(jb, key, b, length, BAG, MASK)
    # The draws the JAX function made, by its own key discipline.
    k_draw, k_bag = jax.random.split(key)
    rows, starts = jbuf._draw_windows(jb, k_draw, b, length)
    scores = jax.random.uniform(k_bag, (b, BUF_KW["max_episode_steps"]))
    rows_t, starts_t = (torch.tensor(np.asarray(x)) for x in (rows, starts))
    bag_obs, bag_act = tbuf.random_bags(
        tb, rows_t, starts_t, torch.tensor(np.asarray(scores)), BAG, MASK)
    tbatch = tbuf._window_batch(tb, rows_t, starts_t, length, bag_obs,
                                bag_act)
    assert_batches_equal(tbatch, jbatch)
    starts = np.asarray(starts)
    # Windows with fewer pre-window slots than the bag pad the rest; windows
    # with more draw a subset: both occur.
    assert (starts < BAG).any() and (starts > BAG).any()
    padded = (tbatch.bag_obs == MASK).all(dim=-1).sum(dim=-1).numpy()
    eq(padded, np.maximum(BAG - starts, 0))
    assert (tbatch.bag_action[tbatch.bag_obs[..., 0] == MASK] == 0).all()


def test_random_bags_ties_never_decide_a_valid_entry():
    """Scores tie only at 2.0, among invalid slots: whatever order the sort
    gives them, every valid pre-window slot of a short prefix is taken and
    the rest is padding, as in the JAX package."""
    tb, jb = filled_buffers()
    long_enough = np.flatnonzero((tb.ep_valid & (tb.ep_len >= 3)).numpy())
    rows = np.resize(long_enough, 8).astype(np.int32)
    starts = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.int32)
    # Equal scores everywhere: valid slots tie too, the hardest case.
    for scores in (np.full((8, 24), 0.5, np.float32),
                   np.random.default_rng(0).random((8, 24), np.float32)):
        bag_obs, bag_act = tbuf.random_bags(
            tb, torch.tensor(rows), torch.tensor(starts),
            torch.tensor(scores), BAG, MASK)
        for i, (r, s) in enumerate(zip(rows, starts)):
            got = {tuple(o) for o in bag_obs[i].tolist()
                   if o != [MASK] * 6}
            assert got == {tuple(o) for o in tb.obs[r, :s].tolist()}
            assert (bag_obs[i] == MASK).all(dim=-1).sum() == BAG - s
        # The same scores through the JAX function's body.
        jscores = jnp.where(jnp.arange(24)[None] < starts[:, None],
                            jnp.asarray(scores), 2.0)
        order = np.asarray(jnp.argsort(jscores, axis=1)[:, :BAG])
        torder = torch.argsort(torch.tensor(np.asarray(jscores)), dim=1,
                               stable=True)[:, :BAG]
        eq(torder, order)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_with_stored_bag_matches_jax_with_injected_draws(seed):
    tb, jb = filled_buffers()
    b, length = 16, BUF_KW["context_len"]
    key = jax.random.key(seed)
    jbatch = jbuf.sample_with_stored_bag(jb, key, b, length, MASK)
    rows, starts = jbuf._draw_windows(jb, key, b, length)
    rows_t, starts_t = (torch.tensor(np.asarray(x)) for x in (rows, starts))
    bag_obs, bag_act = tbuf.stored_bags(tb, rows_t, starts_t, length, MASK)
    tbatch = tbuf._window_batch(tb, rows_t, starts_t, length, bag_obs,
                                bag_act)
    assert_batches_equal(tbatch, jbatch)
    assert (tbatch.bag_obs != MASK).any() and (tbatch.bag_obs == MASK).any()


def test_own_draws_give_pre_window_bags():
    tb, _ = filled_buffers()
    gen = torch.Generator().manual_seed(0)
    length = BUF_KW["context_len"]
    for batch in (tbuf.sample_with_bag(tb, gen, 32, length, BAG, MASK),
                  tbuf.sample_with_stored_bag(tb, gen, 32, length, MASK)):
        assert batch.bag_obs.shape == (32, BAG, 6)
        assert batch.bag_action.shape == (32, BAG)
        assert batch.obs.shape == (32, length, 6)
        assert ((batch.bag_obs >= 0) & (batch.bag_obs <= MASK)).all()
    assert tbuf.sample(tb, gen, 4, length).bag_obs is None


# -------------------------------------------------------------- the network
NET = dict(inner_embed=16, num_heads=2, num_layers=2, context_len=6,
           embed_per_obs_dim=4, bag_size=BAG)


def jax_net_and_params(seed=0, **kw):
    kw = dict(NET, **kw)
    net = jax_build_network("DTQN-bag", jax_make_env(ENV), **kw)
    ctx, bag = kw["context_len"], kw["bag_size"]
    params = net.init(
        jax.random.key(seed), jnp.zeros((2, ctx, 6), jnp.int32),
        jnp.zeros((2, ctx), jnp.int32), jnp.zeros((2, bag, 6), jnp.int32),
        jnp.zeros((2, bag), jnp.int32))
    rng = np.random.default_rng(seed + 1)
    # Non-zero positions and biases, so their gradients are exercised.
    return net, jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.02 * rng.standard_normal(x.shape))
        .astype(np.float32), params)


def net_inputs(seed, b, ctx=6, bag=BAG):
    """Token windows and bags; bag rows: full, one empty, partly padded."""
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 25, (b, ctx, 6)).astype(np.int32)
    act = rng.integers(0, 6, (b, ctx)).astype(np.int32)
    bag_obs = rng.integers(0, 25, (b, bag, 6)).astype(np.int32)
    bag_act = rng.integers(0, 6, (b, bag)).astype(np.int32)
    bag_obs[1] = MASK
    bag_act[1] = 0
    bag_obs[2, 1:] = MASK
    bag_act[2, 1:] = 0
    # An observation with some, not all, elements at the mask is no padding.
    bag_obs[3, 0, :3] = MASK
    return obs, act, bag_obs, bag_act


@pytest.fixture
def attention_impl():
    before = get_attention_impl()
    yield set_attention_impl
    set_attention_impl(before)


def test_bridge_round_trip_bag():
    _, params = jax_net_and_params(action_dim=4)
    state = params_from_jax(params)
    assert state["bag_attention.query.weight"].shape == (16, 16)
    assert "bag_attention.qkv.weight" not in state
    assert state["layers.0.attention.qkv.weight"].shape == (48, 16)
    assert state["head_hidden.weight"].shape == (16, 32)
    back = params_to_jax(state)
    flat_a = jax.tree_util.tree_leaves_with_path(params["params"])
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    net = build_network("DTQN-bag", make_env(ENV), action_dim=4, **NET)
    net.load_state_dict(state, strict=True)


@pytest.mark.parametrize("bag_mask,impl,action_dim", [
    (False, "xla", 0), (False, "pallas", 0), (False, "xla", 4),
    (False, "pallas", 4), (True, "xla", 0), (True, "xla", 4),
])
def test_dtqn_bag_forward_and_grads_match_jax(bag_mask, impl, action_dim,
                                              attention_impl):
    kw = dict(bag_mask=bag_mask, action_dim=action_dim)
    jnet, params = jax_net_and_params(seed=action_dim, **kw)
    tnet = build_network("DTQN-bag", make_env(ENV), **dict(NET, **kw))
    tnet.load_state_dict(params_from_jax(params), strict=True)
    obs, act, bag_obs, bag_act = net_inputs(2, 5)
    g = np.random.default_rng(3).standard_normal((5, 6, 6)).astype(np.float32)

    attention_impl(impl)
    q_jax = jnet.apply(params, obs, act, bag_obs, bag_act)
    grads_jax = jax.grad(
        lambda p: jnp.sum(jnet.apply(p, obs, act, bag_obs, bag_act) * g)
    )(params)

    cuda_attention.reset_launch_counts()
    q_t = tnet(*(torch.tensor(x) for x in (obs, act, bag_obs, bag_act)))
    (q_t * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(q_t.detach().numpy(), np.asarray(q_jax),
                               atol=Q_ATOL)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, grads_jax))
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   atol=GRAD_ATOL, err_msg=name)
    assert tnet.bag_attention.query.weight.grad.abs().max() > 0
    assert not any(cuda_attention.launch_counts.values())


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_lookup_gradient_is_a_fixed_order_sum(dtype):
    """The embedders' table lookup: the stock embedding's values, and a
    table gradient that is one matrix product (equal tokens summed in a
    fixed order) and so repeats bit for bit."""
    from dtqn_tpu_torch.models.embeddings import lookup

    gen = torch.Generator().manual_seed(0)
    table = torch.randn((26, 8), generator=gen, requires_grad=True)
    tokens = torch.randint(0, 26, (5, 7, 6), generator=gen).to(dtype)
    g = torch.randn((5, 7, 6, 8), generator=gen)
    out = lookup(table, tokens)
    ref = torch.nn.functional.embedding(tokens, table)
    assert torch.equal(out, ref)
    (grad,) = torch.autograd.grad(out, table, g)
    (again,) = torch.autograd.grad(lookup(table, tokens), table, g)
    (ref_grad,) = torch.autograd.grad(ref, table, g)
    assert torch.equal(grad, again)
    np.testing.assert_allclose(grad.numpy(), ref_grad.numpy(), atol=1e-5)
    # Every token occurs several times: the sum over equal tokens is real.
    assert (torch.bincount(tokens.reshape(-1).long(), minlength=26) > 1).all()


def test_bag_mask_hides_padding_and_zeroes_an_empty_bag():
    _, params = jax_net_and_params()
    nets = {}
    for bag_mask in (False, True):
        nets[bag_mask] = build_network("DTQN-bag", make_env(ENV),
                                       **dict(NET, bag_mask=bag_mask))
        nets[bag_mask].load_state_dict(params_from_jax(params))
    obs, act, bag_obs, bag_act = (torch.tensor(x) for x in net_inputs(4, 5))
    with torch.no_grad():
        q_plain = nets[False](obs, act, bag_obs, bag_act)
        q_mask = nets[True](obs, act, bag_obs, bag_act)
        # The padded slots' contents do not reach a masked network.
        other = bag_act.clone()
        other[2, 1:] = 5
        q_mask_other = nets[True](obs, act, bag_obs, other)
        q_plain_other = nets[False](obs, act, bag_obs, other)
    # Row 0's bag is full: the mask changes nothing there.
    np.testing.assert_allclose(q_mask[0].numpy(), q_plain[0].numpy(),
                               atol=Q_ATOL)
    assert (q_mask[1] - q_plain[1]).abs().max() > 1e-4
    assert torch.equal(q_mask, q_mask_other)
    assert torch.equal(q_plain[:2], q_plain_other[:2])
    with pytest.raises(ValueError, match="requires bag_obss"):
        nets[False](obs, act)
    with pytest.raises(ValueError, match="discrete-observation env"):
        build_network("DTQN-bag", make_env("DiscreteCarFlag-v0"),
                      bag_size=3, bag_mask=True)


# ---------------------------------------------------------------- the agent
AGENT = dict(num_envs=4, inner_embed=16, num_heads=2, num_layers=2,
             context_len=4, history=4, batch_size=4, buffer_size=500,
             embed_per_obs_dim=4, bag_size=BAG,
             target_update_frequency=10_000)


def make_pair(**kw):
    kw = dict(AGENT, **kw)
    jagent = JaxAgent(JaxConfig(model="DTQN-bag", **kw), jax_make_env(ENV))
    jstate = jagent.init_state(jax.random.key(0))
    agent = Agent(AgentConfig(model="DTQN-bag", **kw), make_env(ENV),
                  device="cpu")
    state = agent.init_state(0)
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), jstate.params)
    jstate = jstate.replace(
        params=params,
        target_params=jax.tree_util.tree_map(jnp.copy, params))
    state.network.load_state_dict(params_from_jax(params))
    state.target_network.load_state_dict(params_from_jax(params))
    return jagent, jstate, agent, state


def both(cls_j, cls_t, **fields):
    return (cls_j(**{k: jnp.asarray(v) for k, v in fields.items()}),
            cls_t(**{k: torch.tensor(v) for k, v in fields.items()}))


def context_and_bag(seed, e, length):
    rng = np.random.default_rng(seed)
    ctx = both(
        jax_replay.ContextState, replay.ContextState,
        obs=rng.integers(0, 25, (e, length, 6)).astype(np.int32),
        action=rng.integers(0, 6, (e, length)).astype(np.int32),
        reward=rng.standard_normal((e, length)).astype(np.float32),
        done=np.zeros((e, length), bool),
        timestep=rng.integers(length, 3 * length, e).astype(np.int32),
    )
    bag = both(
        jax_replay.BagState, replay.BagState,
        obs=rng.integers(0, 25, (e, BAG, 6)).astype(np.int32),
        action=rng.integers(0, 6, (e, BAG)).astype(np.int32),
        obs_idx=rng.integers(0, 9, (e, BAG)).astype(np.int32),
        pos=np.full(e, BAG, np.int32),
    )
    return ctx, bag


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bag_evict_makes_the_jax_choice(seed):
    jagent, jstate, agent, state = make_pair(num_envs=8)
    (jctx, tctx), (jb, tb) = context_and_bag(seed, 8, 4)
    rng = np.random.default_rng(100 + seed)
    ev_obs = rng.integers(0, 25, (8, 6)).astype(np.int32)
    ev_act = rng.integers(0, 6, 8).astype(np.int32)
    ev_idx = rng.integers(9, 20, 8).astype(np.int32)
    need = np.array([True] * 6 + [False] * 2)
    jout = jagent._bag_evict(jstate.params, jctx, jb, ev_obs, ev_act, ev_idx,
                             need)
    tout = agent._bag_evict(state.network, tctx, tb, torch.tensor(ev_obs),
                            torch.tensor(ev_act), torch.tensor(ev_idx),
                            torch.tensor(need))
    assert_bags_equal(tout, jout)
    # Where it was not needed the bag is as before; elsewhere the evictee
    # was either dropped or put into one slot.
    eq(tout.obs[6:], tb.obs[6:])
    changed = (tout.obs_idx != tb.obs_idx).sum(dim=-1)
    assert (changed <= 1).all() and (changed[6:] == 0).all()


def test_greedy_actions_with_bag_match_jax():
    jagent, jstate, agent, state = make_pair()
    (jctx, tctx), (jb, tb) = context_and_bag(3, 4, 4)
    greedy_jax, _ = jagent.greedy_actions(jstate.params, jctx, jb, None, None)
    eq(agent.greedy_actions(state.network, tctx, tb)[0], greedy_jax)


@pytest.mark.parametrize("bag_store", [False, True])
def test_observe_lockstep_matches_jax(bag_store):
    """Twelve lockstep ``observe`` calls from the same start: the context
    fills, the bag fills, then the eviction chooses; context, bag and the
    ring (with the stored act-time bags) stay exactly equal."""
    jagent, jstate, agent, state = make_pair(bag_store=bag_store)
    rng = np.random.default_rng(11)
    start_actions = rng.integers(0, 6, (4, 4)).astype(np.int32)
    first = rng.integers(0, 25, (4, 6)).astype(np.int32)
    jctx = jstate.context.replace(
        action=jnp.asarray(start_actions),
        obs=jstate.context.obs.at[:, 0].set(first))
    jbuffer = jbuf.store_first_obs(jstate.buffer, first, np.ones(4, bool),
                                   MASK)
    jstate = jstate.replace(context=jctx, buffer=jbuffer)
    state.context.action = torch.tensor(start_actions)
    state.context.obs[:, 0] = torch.tensor(first)
    tbuf.store_first_obs(state.buffer, torch.tensor(first),
                         torch.ones(4, dtype=torch.bool), MASK)
    observe = jax.jit(jagent.observe)
    evicted = False
    for step in range(12):
        obs = rng.integers(0, 25, (4, 6)).astype(np.int32)
        act = rng.integers(0, 6, 4).astype(np.int32)
        rew = rng.standard_normal(4).astype(np.float32)
        done = np.zeros(4, bool)
        before = np.asarray(jstate.bag.obs_idx)
        jstate = observe(jstate, act, obs, rew, done)
        agent.observe(state, torch.tensor(act), torch.tensor(obs),
                      torch.tensor(rew), torch.tensor(done))
        assert_bags_equal(state.bag, jstate.bag)
        for f in ("obs", "action", "reward", "done", "timestep"):
            eq(getattr(state.context, f), getattr(jstate.context, f))
        fields = BUF_FIELDS if bag_store else BUF_FIELDS[:-2]
        for f in fields:
            eq(getattr(state.buffer, f), getattr(jstate.buffer, f))
        full_before = (before >= 0).all(axis=-1)
        evicted |= bool(
            (full_before & (before != np.asarray(jstate.bag.obs_idx))
             .any(axis=-1)).any())
    assert (state.bag.pos == BAG).all() and evicted
    if bag_store:
        # Slot p holds the bag after transition p + 1.
        eq(state.buffer.bag_idx[state.buffer.current_rows, 11],
           state.bag.obs_idx)
    else:
        assert state.buffer.bag_idx is None
    # A reset empties the bags of the finished envs only.
    done = torch.tensor([True, False, True, False])
    agent.handle_resets(state, done, torch.tensor(first))
    assert (state.bag.pos == torch.tensor([0, BAG, 0, BAG])).all()
    assert (state.bag.obs[0] == MASK).all() and (state.bag.obs_idx[2] == -1).all()


def bag_batch(seed, b, length):
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 25, (b, length + 1, 6)).astype(np.int32)
    act = rng.integers(0, 6, (b, length + 1)).astype(np.int32)
    _, _, bag_obs, bag_act = net_inputs(seed, b, length, BAG)
    return dict(
        obs=obs[:, :-1], action=act[:, :-1], next_obs=obs[:, 1:],
        next_action=act[:, 1:],
        reward=rng.choice([-0.05, -0.05, 4.95, -5.05],
                          (b, length)).astype(np.float32),
        done=rng.random((b, length)) < 0.1,
        ep_len=rng.integers(1, length + 1, b).astype(np.int32),
        bag_obs=bag_obs, bag_action=bag_act,
    )


@pytest.mark.parametrize("bag_mask", [False, True])
def test_apply_update_with_bag_batch_matches_jax(bag_mask):
    jagent, jstate, agent, state = make_pair(bag_mask=bag_mask, batch_size=8)
    state.buffer.flushed_total.fill_(100)
    jstate = jstate.replace(
        buffer=jstate.buffer.replace(flushed_total=jnp.int32(100)))
    arrays = bag_batch(1, 8, 4)
    jb, tb = both(jax_replay.Batch, replay.Batch, **arrays)
    before = state.params.clone()
    jnew = jax.jit(jagent.apply_update)(jstate, jb, jax.random.key(1))
    agent.apply_update(state, tb)
    assert int(jnew.train_steps) == int(state.train_steps) == 1
    assert int(state.nonfinite_grads) == 0
    assert not torch.equal(before, state.params)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jnew.params))
    for name, value in state.network.state_dict().items():
        np.testing.assert_allclose(value.numpy(), ref[name].numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)
    # One Adam step moves every weight that has a gradient by about lr:
    # the bag attention's among them.
    moved = (state.network.bag_attention.key.weight
             - torch.tensor(np.asarray(
                 jstate.params["params"]["bag_attention"]["key"]["kernel"]).T))
    assert moved.abs().max() > 1e-4
    np.testing.assert_allclose(
        float(state.diagnostics.averages.buf[0][0]),
        float(jnew.diagnostics.td_error.buf[0]), rtol=1e-4)


# ------------------------------------------------- training, eval, runner
@pytest.mark.parametrize("kw", [dict(), dict(bag_mask=True),
                                dict(bag_store=True)],
                         ids=["bag", "bag-mask", "bag-store"])
def test_agent_trains_and_evaluates_with_bag(kw):
    env = make_env(ENV)
    env.max_episode_steps = 12
    cfg = AgentConfig(model="DTQN-bag", **dict(AGENT, **kw))
    agent = Agent(cfg, env, device="cpu")
    state = agent.init_state(0)
    assert state.bag.obs.shape == (4, BAG, 6)
    assert (state.buffer.bag_idx is not None) == bool(kw.get("bag_store"))
    make_prepopulate_fn(agent, 60)(state)
    before = state.params.clone()
    make_train_chunk_fn(agent, EpsilonSchedule(1.0, 0.1, 100), 4, 6)(state)
    assert int(state.train_steps) == 24 and int(state.nonfinite_grads) == 0
    assert not torch.equal(before, state.params)
    # Bags hold pre-context entries of the running episode and nothing else.
    t = state.context.timestep
    room = torch.clamp_min(t - cfg.context_len + 1, 0)
    assert (state.bag.pos == torch.clamp_max(room, BAG)).all()
    assert (state.bag.obs_idx < room[:, None]).all()
    out = make_evaluate_fn(agent, env, 3)(
        state.network, torch.Generator().manual_seed(1))
    sr, ret, length = (float(x) for x in out)
    assert 0.0 <= sr <= 1.0 and 1.0 <= length <= 12.0 and -6.0 <= ret <= 5.0


def test_evaluation_early_exit_keeps_the_bag_frozen(monkeypatch):
    """Reading the exit flag every step, every 10 steps or never gives the
    same evaluation: finished episodes' bags are latched like the rest."""
    from dtqn_tpu_torch.train import loop

    env = make_env(ENV)
    env.max_episode_steps = 14
    agent = Agent(AgentConfig(model="DTQN-bag", **AGENT), env, device="cpu")
    network = agent.build_network(torch.Generator().manual_seed(3))
    outs = []
    for every in (1, 10, 0):
        monkeypatch.setattr(loop, "EVAL_EXIT_CHECK_EVERY", every)
        out = make_evaluate_fn(agent, env, 6)(
            network, torch.Generator().manual_seed(2))
        outs.append([float(x) for x in out])
    assert outs[0] == outs[1] == outs[2]


def test_checkpoint_round_trip_holds_the_bag(tmp_path):
    env = make_env(ENV)
    env.max_episode_steps = 12
    agent = Agent(AgentConfig(model="DTQN-bag",
                              **dict(AGENT, bag_store=True)), env,
                  device="cpu")
    state = agent.init_state(0)
    make_prepopulate_fn(agent, 40)(state)
    names = [n for n, _ in _leaves(state)]
    assert {"bag.obs", "bag.action", "bag.obs_idx", "bag.pos",
            "buffer.bag_idx", "buffer.bag_act"} <= set(names)
    path = str(tmp_path / "run")
    ckpt.save_checkpoint(path, state)
    restored, _ = ckpt.load_checkpoint(path, agent.init_state(9))
    for (name, a), (_, b) in zip(_leaves(state), _leaves(restored)):
        if isinstance(a, torch.Generator):
            a, b = a.get_state(), b.get_state()
        assert torch.equal(a, b), name
    chunk = make_train_chunk_fn(agent, EpsilonSchedule(1.0, 0.1, 100), 2, 3)
    chunk(state)
    chunk(restored)
    assert torch.equal(state.params, restored.params)
    assert torch.equal(state.bag.obs_idx, restored.bag.obs_idx)
    # A checkpoint with a bag does not fit a configuration without one.
    bagless = Agent(AgentConfig(model="DTQN", **dict(AGENT, bag_size=0)), env,
                    device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        ckpt.load_checkpoint(path, bagless.init_state(0))


def runner_config(**kw):
    cfg = ExperimentConfig(
        envs=[ENV], model="DTQN-bag", bag_size=BAG, device="cpu",
        num_steps=240, num_envs=4, in_embed=16, heads=2, layers=2, context=4,
        history=4, batch=4, buf_size=1000, eval_frequency=80,
        eval_episodes=2, prepop_steps=300, updates_per_iter=2,
        max_episode_steps=12, obs_embed=4, project_name="bag-test",
        save_policy=True,
    )
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def test_bag_store_run_cut_and_resumed_is_bit_equal(tmp_path, monkeypatch,
                                                    capsys):
    (tmp_path / "whole").mkdir()
    (tmp_path / "cut").mkdir()
    monkeypatch.chdir(tmp_path / "whole")
    cfg = runner_config(bag_store=True)
    assert "_bag=3_bagstore=True_" in cfg.run_name()
    run_experiment(cfg)
    whole = torch.load(cfg.policy_path() + "_policy.pt", weights_only=True)
    whole_rows = open(cfg.policy_path() + "_results.csv").read().splitlines()

    monkeypatch.chdir(tmp_path / "cut")
    run_experiment(runner_config(bag_store=True, time_limit=1e-9))
    assert "Saving checkpoint at 80" in capsys.readouterr().out
    payload = torch.load(cfg.policy_path() + "_checkpoint.pt",
                         weights_only=True)
    assert payload["bag.obs"].shape == (4, BAG, 6)
    assert payload["buffer.bag_idx"].shape[1:] == (12, BAG)
    run_experiment(runner_config(bag_store=True))
    assert "Resumed from checkpoint at 80 steps." in capsys.readouterr().out
    cut = torch.load(cfg.policy_path() + "_policy.pt", weights_only=True)
    assert list(cut) == list(whole)
    for name in whole:
        assert torch.equal(cut[name], whole[name]), name
    cut_rows = open(cfg.policy_path() + "_results.csv").read().splitlines()
    assert ([r.split(",")[1:] for r in cut_rows]
            == [r.split(",")[1:] for r in whole_rows])
    assert len(cut_rows) == 4


CLI = ["--device", "cpu", "--model", "DTQN-bag", "--bag-size", "3", "--envs",
       ENV, "--in-embed", "16", "--heads", "2", "--context", "4",
       "--history", "4", "--num-envs", "4", "--batch", "4", "--buf-size",
       "1000", "--prepop-steps", "300", "--eval-frequency", "40",
       "--num-steps", "80", "--max-episode-steps", "12", "--obs-embed", "4",
       "--save-policy"]


@pytest.mark.parametrize("flags", [[], ["--bag-mask"], ["--bag-store"]],
                         ids=["bag", "bag-mask", "bag-store"])
def test_run_module_trains_evaluates_logs_and_resumes(flags, tmp_path,
                                                      monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    cfg = get_args(CLI + flags)
    # Cut after the first chunk, then resumed by the same command line.
    run.main(CLI + flags + ["--time-limit", "1e-9"])
    assert ckpt.has_checkpoint(cfg.policy_path())
    out = run.main(CLI + flags)
    assert "Resumed from checkpoint at 40 steps." in capsys.readouterr().out
    assert f"{ENV}/SuccessRate" in out and np.isfinite(out["losses/TD_Error"])
    rows = open(cfg.policy_path() + "_results.csv").read().splitlines()
    assert [r.split(",")[1] for r in rows[1:]] == ["40", "80"]
    assert ckpt.load_mini_checkpoint(cfg.policy_path())["step"] == 80
    assert run.main(CLI + flags) == {"completed": True, "step": 80}
    # Enjoy mode evaluates with the bag and saves no strip.
    enjoyed = run.main(CLI + flags + ["--render"])
    assert set(enjoyed) == {"success_rate", "return"}


def test_bag_mask_on_continuous_env_raises_from_the_cli(tmp_path,
                                                        monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = [a if a != ENV else "DiscreteCarFlag-v0" for a in CLI]
    with pytest.raises(ValueError, match="discrete-observation env"):
        run.main(argv + ["--bag-mask"])
    assert not list(tmp_path.iterdir())  # refused before anything is written


def test_bench_bag_prints_one_json_line(monkeypatch, capsys):
    import json

    from dtqn_tpu_torch import bench

    # The script at a small size: 8 envs and a short prepopulation (an
    # episode ends after 250 steps at the latest, so 40 are flushed).
    monkeypatch.setattr(bench, "NUM_ENVS", 8)
    monkeypatch.setattr(bench, "PREPOP_STEPS", 10_000)
    line = bench.main(["--device", "cpu", "--iters", "1", "--bag", "3"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 1 and json.loads(printed[0]) == line
    assert line["metric"] == (
        "gv7x7_dtqn_bag3_torch_env_steps_per_s_1to1_updates")
    assert line["device"] == "cpu" and line["value"] > 0
    assert "vs_baseline" not in line
