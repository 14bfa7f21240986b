"""Port CarFlag, context and replay ring vs the JAX package on the same
inputs.  Random draws made by a framework's own generator are injected
(CarFlag resets) or compared by range only (the context's random initial
actions).  Everything else is data movement or exact float32 arithmetic on
the same values, so it must be exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dtqn_tpu.envs.car_flag import CarFlag as JaxCarFlag
from dtqn_tpu.envs.car_flag import CarFlagState as JaxCarFlagState
from dtqn_tpu.replay import buffer as jbuf
from dtqn_tpu.replay import context as jctx
from dtqn_tpu_torch.envs import make_env
from dtqn_tpu_torch.envs.car_flag import CarFlagState
from dtqn_tpu_torch.replay import buffer as tbuf
from dtqn_tpu_torch.replay import context as tctx


def eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def car_states(seed, n):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.1, 1.1, n).astype(np.float32)
    vel = rng.uniform(-0.07, 0.07, n).astype(np.float32)
    # Edge cases: sticky left wall, both flags, priest zone, the step cap.
    pos[:6] = [-1.1, -1.09, 0.99, -0.99, 0.5, 0.0]
    vel[:6] = [-0.07, -0.07, 0.07, -0.07, 0.0, 0.0]
    heaven = rng.choice([-1.0, 1.0], n).astype(np.float32)
    t = rng.integers(0, 200, n).astype(np.int32)
    t[5] = 199
    actions = rng.integers(0, 3, n).astype(np.int32)
    return pos, vel, heaven, t, actions


def test_carflag_step_matches_jax():
    pos, vel, heaven, t, actions = car_states(0, 256)
    jenv, env = JaxCarFlag(), make_env("DiscreteCarFlag-v0")
    jstate = JaxCarFlagState(position=pos, velocity=vel, heaven=heaven, t=t)
    keys = jax.random.split(jax.random.key(0), len(pos))
    jobs, jnew, jts = jax.vmap(jenv.step)(keys, jstate, actions)
    state = CarFlagState(*(torch.tensor(x) for x in (pos, vel, heaven, t)))
    obs, new, ts = env.step(None, state, torch.tensor(actions))
    eq(obs, jobs)
    eq(ts.reward, jts.reward)
    eq(ts.terminated, jts.terminated)
    eq(ts.truncated, jts.truncated)
    eq(ts.info["is_success"], jts.info["is_success"])
    for f in ("position", "velocity", "heaven", "t"):
        eq(getattr(new, f), getattr(jnew, f))
    # The edge cases really occur in this batch.
    assert ts.terminated.any() and ts.truncated.any()
    assert new.velocity[0] == 0.0 and new.position[0] == torch.tensor(-1.1)


def test_carflag_reset_matches_jax_with_injected_draws():
    jenv, env = JaxCarFlag(), make_env("DiscreteCarFlag-v0")
    jobs, jstate = jenv.reset_vec(jax.random.split(jax.random.key(1), 64))
    heaven = np.asarray(jstate.heaven)
    obs, state = env.reset_with(torch.tensor(heaven < 0),
                                torch.tensor(np.asarray(jstate.position)))
    eq(obs, jobs)
    for f in ("position", "velocity", "heaven", "t"):
        eq(getattr(state, f), getattr(jstate, f))
    # The port's own draws land in the same ranges.
    obs, state = env.reset_vec(torch.Generator().manual_seed(0), 512,
                               "cpu")
    assert obs.shape == (512, 3) and obs.dtype == torch.float32
    assert (state.position.abs() <= 0.2).all()
    assert set(state.heaven.tolist()) == {-1.0, 1.0}


def test_carflag_step_autoreset():
    pos, vel, heaven, t, actions = car_states(2, 128)
    env = make_env("DiscreteCarFlag-v0")
    state = CarFlagState(*(torch.tensor(x) for x in (pos, vel, heaven, t)))
    gen = torch.Generator().manual_seed(0)
    obs_plain, new_plain, ts_plain = env.step(None, state,
                                              torch.tensor(actions))
    obs, new, ts = env.step_vec(gen, state, torch.tensor(actions))
    done = ts.done
    assert done.any() and (~done).any()
    eq(ts.obs, obs_plain)
    eq(obs[~done], obs_plain[~done])
    eq(new.t[~done], new_plain.t[~done])
    assert (new.t[done] == 0).all() and (new.velocity[done] == 0).all()
    assert (new.position[done].abs() <= 0.2).all()


def contexts(seed, e, length):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.standard_normal((e, length, 3)).astype(np.float32),
        action=rng.integers(0, 3, (e, length)).astype(np.int32),
        reward=rng.standard_normal((e, length)).astype(np.float32),
        done=rng.random((e, length)) < 0.5,
        timestep=rng.integers(0, 2 * length, e).astype(np.int32),
    )


def test_add_transition_matches_jax():
    e, length = 16, 6
    fields = contexts(3, e, length)
    rng = np.random.default_rng(4)
    new_obs = rng.standard_normal((e, 3)).astype(np.float32)
    act = rng.integers(0, 3, e).astype(np.int32)
    rew = rng.standard_normal(e).astype(np.float32)
    done = rng.random(e) < 0.5
    jc = jctx.ContextState(**{k: jnp.asarray(v) for k, v in fields.items()})
    tc = tctx.ContextState(**{k: torch.tensor(v) for k, v in fields.items()})
    jout = jctx.add_transition(jc, new_obs, act, rew, done)
    tout = tctx.add_transition(tc, torch.tensor(new_obs), torch.tensor(act),
                               torch.tensor(rew), torch.tensor(done))
    for f in fields:
        eq(getattr(tout[0], f), getattr(jout[0], f))
    for a, b in zip(tout[1:], jout[1:]):
        eq(a, b)
    assert tout[3].any() and (~tout[3]).any()
    eq(tout[0].last_index, jout[0].last_index)


def test_reset_context_matches_jax():
    e, length = 16, 6
    fields = contexts(5, e, length)
    rng = np.random.default_rng(6)
    first = rng.standard_normal((e, 3)).astype(np.float32)
    mask = rng.random(e) < 0.5
    jc = jctx.ContextState(**{k: jnp.asarray(v) for k, v in fields.items()})
    tc = tctx.ContextState(**{k: torch.tensor(v) for k, v in fields.items()})
    jout = jctx.reset_context(jc, jax.random.key(0), first, mask, -5.0, 3)
    tout = tctx.reset_context(tc, torch.Generator().manual_seed(0),
                              torch.tensor(first), torch.tensor(mask), -5.0, 3)
    for f in ("obs", "reward", "done", "timestep"):
        eq(getattr(tout, f), getattr(jout, f))
    # Initial actions come from each framework's own generator: exact for
    # the envs kept, in range for the envs reset.
    eq(tout.action[~mask], np.asarray(jout.action)[~mask])
    reset_actions = tout.action[torch.tensor(mask)]
    assert reset_actions.dtype == torch.int32
    assert ((reset_actions >= 0) & (reset_actions < 3)).all()


BUF_KW = dict(num_envs=4, buffer_size=400, max_episode_steps=20,
              context_len=5, obs_shape=(3,), obs_mask=-5.0)
BUF_FIELDS = ("obs", "action", "reward", "done", "ep_len", "ep_valid",
              "write_pos", "ep_count", "flushed_total")


def assert_buffers_equal(tb, jb):
    for f in BUF_FIELDS:
        eq(getattr(tb, f), getattr(jb, f))


def filled_buffers(seed=7, steps=60):
    """The same sequence of first-obs / step / flush writes on both."""
    e, t = BUF_KW["num_envs"], BUF_KW["max_episode_steps"]
    jb = jbuf.init_buffer(obs_dtype=jnp.float32, **BUF_KW)
    tb = tbuf.init_buffer(obs_dtype=torch.float32, device="cpu", **BUF_KW)
    rng = np.random.default_rng(seed)
    first = rng.standard_normal((e, 3)).astype(np.float32)
    all_envs = np.ones(e, bool)
    jb = jbuf.store_first_obs(jb, first, all_envs, -5.0)
    tbuf.store_first_obs(tb, torch.tensor(first), torch.tensor(all_envs), -5.0)
    assert_buffers_equal(tb, jb)
    for _ in range(steps):
        obs = rng.standard_normal((e, 3)).astype(np.float32)
        act = rng.integers(0, 3, e).astype(np.int32)
        rew = rng.standard_normal(e).astype(np.float32)
        term = rng.random(e) < 0.1
        jb = jbuf.store_step(jb, obs, act, rew, term)
        tbuf.store_step(tb, torch.tensor(obs), torch.tensor(act),
                        torch.tensor(rew), torch.tensor(term))
        done = term | (tb.write_pos.numpy() >= t) | (rng.random(e) < 0.05)
        reset_obs = rng.standard_normal((e, 3)).astype(np.float32)
        jb = jbuf.store_first_obs(jbuf.flush(jb, done), reset_obs, done, -5.0)
        tbuf.store_first_obs(tbuf.flush(tb, torch.tensor(done)),
                             torch.tensor(reset_obs), torch.tensor(done), -5.0)
        assert_buffers_equal(tb, jb)
    return tb, jb


def test_buffer_writes_match_jax():
    tb, jb = filled_buffers()
    assert int(tb.flushed_total) > 4
    eq(tbuf.can_sample(tb, 4), jbuf.can_sample(jb, 4))
    eq(tbuf.can_sample(tb, 1000), jbuf.can_sample(jb, 1000))
    # 400 // 20 = 20 rows [R, T+1], a ring of 5 rows per env.
    assert tb.obs.shape == (20, 21, 3) and tb.ep_len.dtype == torch.int32


def test_gather_windows_match_jax_for_injected_windows():
    tb, jb = filled_buffers(seed=8)
    length = BUF_KW["context_len"]
    valid = np.flatnonzero(tb.ep_valid.numpy())
    rng = np.random.default_rng(9)
    rows = rng.choice(valid, 16).astype(np.int32)
    max_start = np.maximum(0, tb.ep_len.numpy()[rows] - length)
    starts = (rng.random(16) * (max_start + 1)).astype(np.int32)
    jout = jbuf._gather_windows(jb, jnp.asarray(rows), jnp.asarray(starts),
                                length)
    tout = tbuf._gather_windows(tb, torch.tensor(rows), torch.tensor(starts),
                                length)
    for a, b in zip(tout, jout):
        eq(a, b)


def test_draw_windows_and_sample_shapes():
    tb, _ = filled_buffers(seed=10)
    length = BUF_KW["context_len"]
    gen = torch.Generator().manual_seed(0)
    rows, starts = tbuf._draw_windows(tb, gen, 256, length)
    assert tb.ep_valid[rows].all()
    max_start = torch.clamp_min(tb.ep_len[rows] - length, 0)
    assert ((starts >= 0) & (starts <= max_start)).all()
    batch = tbuf.sample(tb, gen, 8, length)
    assert batch.obs.shape == (8, length, 3)
    assert batch.next_action.shape == (8, length)
    assert batch.done.dtype == torch.bool
    assert (batch.ep_len <= length).all()


def test_argmax_takes_first_max():
    """The act path and the DDQN selector take the first maximum, as
    jnp.argmax does (agents/base.py:287,498)."""
    q = np.array([[1.0, 3.0, 3.0], [2.0, 2.0, 2.0], [0.0, -1.0, 0.0]],
                 np.float32)
    eq(torch.argmax(torch.tensor(q), dim=-1), jnp.argmax(q, axis=-1))
