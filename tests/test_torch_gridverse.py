"""Port Gridverse vs the JAX package: a scripted episode per variant with the
JAX run's reset outcomes injected, every tensor of observation, reward, done
and state compared exactly at every step; then the port's own draws.
"""

import jax
import numpy as np
import pytest
import torch

from dtqn_tpu.envs import make_env as jax_make_env
from dtqn_tpu.envs.gridverse import make_gridverse_env as jax_make_gridverse
from dtqn_tpu_torch.agents import Agent, AgentConfig
from dtqn_tpu_torch.envs import make_env
from dtqn_tpu_torch.envs.core import ObsKind
from dtqn_tpu_torch.envs.gridverse import (
    BEACON,
    EXIT,
    FLOOR,
    HIDDEN,
    SPAWN_OFFSETS,
    SUM_HIDDEN_TOKEN,
    make_gridverse_env,
)
from dtqn_tpu_torch.train.loop import (
    make_prepopulate_fn,
    make_train_chunk_fn,
)
from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule

VARIANTS = [
    "gv_memory.5x5.yaml",
    "gv_memory.7x7.yaml",
    "gv_memory_four_rooms.7x7.yaml",
    "gv_memory.7x7.yaml+fspawn",
    "gv_memory.7x7.yaml+walkbeacon",
    "gv_memory.7x7.yaml+sumenc",
    "gv_memory.7x7.yaml+oracle",
    "gv_memory_four_rooms.7x7.yaml+fspawn+walkbeacon+sumenc+oracle",
    "gv_memory_four_rooms.9x9.yaml",
]
STATE_FIELDS = ("grid_type", "grid_color", "good_color", "pos", "direction",
                "t")


def eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def assert_states_equal(state, jstate):
    for f in STATE_FIELDS:
        eq(getattr(state, f), getattr(jstate, f))
        assert getattr(state, f).dtype == torch.int32, f


def cells_of(grid, kind):
    """[E, k, 2]: the cells of each env's grid that hold ``kind``."""
    e = grid.shape[0]
    found = np.argwhere(grid == kind)
    return found[:, 1:].reshape(e, -1, 2)


def reset_outcomes(env, jstate):
    """The random outcomes behind a JAX reset, read back from its state, in
    the form ``reset_with`` takes them."""
    gtype = np.asarray(jstate.grid_type)
    gcolor = np.asarray(jstate.grid_color)
    good = np.asarray(jstate.good_color)
    pos = np.asarray(jstate.pos)
    e, n, p = len(good), env.size, env.pad
    exits = cells_of(gtype, EXIT)
    beacon = cells_of(gtype, BEACON)[:, 0]
    assert exits.shape == (e, 2, 2)
    exit_colors = gcolor[np.arange(e)[:, None], exits[..., 0], exits[..., 1]]
    first_is_good = exit_colors[:, 0] == good
    assert (exit_colors[:, 0] != exit_colors[:, 1]).all()
    good_exit = np.where(first_is_good[:, None], exits[:, 0], exits[:, 1])
    bad_exit = np.where(first_is_good[:, None], exits[:, 1], exits[:, 0])
    bad = np.where(first_is_good, exit_colors[:, 1], exit_colors[:, 0])
    out = dict(colors=np.stack([good - 1, bad - 1], -1))
    if env.four_rooms:
        def corner(cell):
            return 2 * (cell[:, 0] == n - 2) + (cell[:, 1] == n - 2)

        out["corner_order"] = np.stack(
            [corner(good_exit), corner(bad_exit), corner(beacon)], -1)
        out["swap"] = np.zeros(e, bool)
    else:
        out["swap"] = good_exit[:, 1] == n - 2
    if env.front_spawn:
        offsets = np.array(SPAWN_OFFSETS)
        hits = (beacon[:, None, :] + offsets[None] == pos[:, None, :]).all(-1)
        assert (hits.sum(-1) == 1).all()
        out["spawn"] = hits.argmax(-1)
    else:
        out["spawn"] = pos[:, 0] * p + pos[:, 1]
        out["direction"] = np.asarray(jstate.direction)
    return {k: torch.tensor(v) for k, v in out.items()}


@pytest.mark.parametrize("name", VARIANTS)
def test_interface_matches_jax(name):
    jenv, env = jax_make_env(name), make_env(name)
    assert env.obs_kind == ObsKind.DISCRETE and env.obs_dtype == torch.int32
    for attr in ("name", "num_actions", "max_episode_steps", "obs_mask",
                 "obs_vocab_size", "size", "pad", "four_rooms"):
        assert getattr(env, attr) == getattr(jenv, attr), attr
    assert tuple(env.obs_shape) == tuple(jenv.obs_shape)
    eq(env._base_grid("cpu"), jenv._base_grid()[0])


@pytest.mark.parametrize("name", VARIANTS)
def test_scripted_episode_matches_jax(name):
    n, steps = 48, 60
    jenv, env = jax_make_env(name), make_env(name)
    jobs, jstate = jenv.reset_vec(jax.random.split(jax.random.key(0), n))
    obs, state = env.reset_with(**reset_outcomes(env, jstate))
    eq(obs, jobs)
    assert obs.dtype == torch.int32
    assert_states_equal(state, jstate)

    rng = np.random.default_rng(1)
    step = jax.jit(jax.vmap(jenv.step))
    hidden = SUM_HIDDEN_TOKEN if env.sum_encoding else HIDDEN
    rewards, corner_hidden, corner_shown, blocked = set(), False, False, False
    for t in range(steps):
        # Mostly moves, some turns; every action occurs.
        actions = rng.choice(6, n, p=[0.4, 0.1, 0.1, 0.1, 0.15, 0.15]).astype(
            np.int32)
        keys = jax.random.split(jax.random.key(100 + t), n)
        jobs, jnew, jts = step(keys, jstate, actions)
        obs, new, ts = env.step(None, state, torch.tensor(actions))
        eq(obs, jobs)
        eq(ts.obs, jts.obs)
        eq(ts.reward, jts.reward)
        eq(ts.terminated, jts.terminated)
        eq(ts.truncated, jts.truncated)
        eq(ts.info["is_success"], jts.info["is_success"])
        assert_states_equal(new, jnew)
        assert ts.reward.dtype == torch.float32 and obs.dtype == torch.int32
        rewards |= set(np.round(ts.reward.numpy().astype(np.float64),
                                2).tolist())
        corners = obs[:, [0, 2]]
        corner_hidden |= bool((corners == hidden).any())
        corner_shown |= bool((corners != hidden).any())
        moved = torch.tensor(actions < 4)
        blocked |= bool((moved & (new.pos == state.pos).all(-1)).any())
        # Finished episodes stay where they are in both: carry on.
        jstate, state = jnew, new
    # Both exits were reached, walls were run into, and ahead corners were
    # seen both hidden (behind two walls, or off the grid) and shown.
    assert rewards == {-0.05, 4.95, -5.05}
    assert corner_hidden and corner_shown and blocked
    assert (state.t == steps).all()


def test_padded_grid_matches_jax():
    """A 5x5 room on a 7x7 grid (``pad_to``), as several gridverse domains
    share one state structure."""
    name = "gv_memory.5x5.yaml"
    jenv, env = jax_make_gridverse(name, pad_to=7), make_gridverse_env(
        name, pad_to=7)
    assert env.pad == 7 and env.size == 5
    n = 16
    jobs, jstate = jenv.reset_vec(jax.random.split(jax.random.key(2), n))
    obs, state = env.reset_with(**reset_outcomes(env, jstate))
    eq(obs, jobs)
    assert_states_equal(state, jstate)
    assert state.grid_type.shape == (n, 7, 7)
    rng = np.random.default_rng(3)
    for t in range(30):
        actions = rng.integers(0, 6, n).astype(np.int32)
        keys = jax.random.split(jax.random.key(t), n)
        jobs, jstate, jts = jax.vmap(jenv.step)(keys, jstate, actions)
        obs, state, ts = env.step(None, state, torch.tensor(actions))
        eq(obs, jobs)
        eq(ts.reward, jts.reward)
        assert_states_equal(state, jstate)


@pytest.mark.parametrize("name", [
    "gv_memory.7x7.yaml", "gv_memory_four_rooms.7x7.yaml",
    "gv_memory.7x7.yaml+fspawn", "gv_memory_four_rooms.9x9.yaml+fspawn",
])
def test_own_draws(name):
    env = make_env(name)
    gen = torch.Generator().manual_seed(0)
    e, n = 512, env.size
    obs, state = env.reset_vec(gen, e, "cpu")
    assert obs.shape == (e, *env.obs_shape) and obs.dtype == torch.int32
    gtype, gcolor = state.grid_type.numpy(), state.grid_color.numpy()
    idx = np.arange(e)
    # Two exits of distinct colors in 1..4, one beacon of the good color.
    exits, beacon = cells_of(gtype, EXIT), cells_of(gtype, BEACON)
    assert exits.shape == (e, 2, 2) and beacon.shape == (e, 1, 2)
    colors = gcolor[idx[:, None], exits[..., 0], exits[..., 1]]
    assert (colors[:, 0] != colors[:, 1]).all()
    assert ((colors >= 1) & (colors <= 4)).all()
    good = state.good_color.numpy()
    assert ((colors == good[:, None]).sum(-1) == 1).all()
    eq(gcolor[idx, beacon[:, 0, 0], beacon[:, 0, 1]], good)
    assert set(good.tolist()) == {1, 2, 3, 4}
    # Either exit is the good one about half the time.
    first_good = (colors[:, 0] == good).mean()
    assert 0.4 < first_good < 0.6
    if env.four_rooms:
        corners = {(1, 1), (1, n - 2), (n - 2, 1), (n - 2, n - 2)}
        assert {tuple(c) for c in beacon[:, 0].tolist()} == corners
        assert {tuple(c) for c in exits.reshape(-1, 2).tolist()} == corners
    # The agent stands on plain floor.
    pos = state.pos.numpy()
    assert (gtype[idx, pos[:, 0], pos[:, 1]] == FLOOR).all()
    if env.front_spawn:
        # Next to the beacon and facing it: the beacon's token is ahead.
        assert (np.abs(pos - beacon[:, 0]).sum(-1) == 1).all()
        ahead = obs[:, 1].numpy()
        eq(ahead, BEACON * 5 + good)
    else:
        floor_cells = int((env._base_grid("cpu") == FLOOR).sum()) - 3
        seen = {tuple(p) for p in pos.tolist()}
        assert len(seen) == floor_cells or env.four_rooms
        assert set(state.direction.tolist()) == {0, 1, 2, 3}
    assert (state.t == 0).all()


def test_step_autoreset_starts_fresh_episodes():
    env = make_env("gv_memory.5x5.yaml")
    gen = torch.Generator().manual_seed(1)
    _, state = env.reset_vec(gen, 8, "cpu")
    state.t = torch.tensor([249, 0, 249, 3, 249, 249, 7, 249],
                           dtype=torch.int32)
    turn = torch.full((8,), 4)
    obs, new, ts = env.step_vec(gen, state, turn)
    eq(ts.truncated, state.t == 249)
    assert not ts.terminated.any()
    np.testing.assert_allclose(ts.reward.numpy(), -0.05)
    assert (new.t[ts.done] == 0).all() and (new.t[~ts.done] > 0).all()
    eq(new.direction[~ts.done], (state.direction[~ts.done] + 3) % 4)


def test_names_and_tags():
    assert make_env("gv_memory.7x7").name == "gv_memory.7x7.yaml"
    env = make_env("gv_memory.7x7.yaml+oracle+sumenc")
    assert env.name == "gv_memory.7x7.yaml+sumenc+oracle"
    assert env.obs_shape == (7,) and env.obs_mask == 21.0
    with pytest.raises(KeyError, match="variant tags"):
        make_env("gv_memory.7x7.yaml+teleport")
    with pytest.raises(KeyError, match="Unknown gridverse env"):
        make_env("gv_keydoor.7x7.yaml")
    with pytest.raises(ValueError, match="odd"):
        make_env("gv_memory.6x6.yaml")
    with pytest.raises(ValueError, match="pad_to"):
        make_gridverse_env("gv_memory.7x7.yaml", pad_to=5)


def test_agent_trains_on_gridverse():
    """Gridverse without a bag: int32 tokens through the discrete embedder,
    padding is the mask token, every update applies."""
    env = make_env("gv_memory.5x5.yaml")
    env.max_episode_steps = 15
    cfg = AgentConfig(num_envs=4, inner_embed=16, num_heads=2, context_len=6,
                      history=6, batch_size=4, buffer_size=600,
                      embed_per_obs_dim=4)
    agent = Agent(cfg, env, device="cpu")
    state = agent.init_state(0)
    assert state.context.obs.dtype == torch.int32 and state.bag is None
    assert (state.context.obs[:, 1:] == 25).all()
    make_prepopulate_fn(agent, 80)(state)
    before = state.params.clone()
    make_train_chunk_fn(agent, EpsilonSchedule(1.0, 0.1, 100), 4, 3)(state)
    assert int(state.train_steps) == 12 and int(state.nonfinite_grads) == 0
    assert not torch.equal(before, state.params)
    assert 0 <= int(state.buffer.obs.min()) and int(state.buffer.obs.max()) <= 25
