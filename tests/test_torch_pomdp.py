"""Port tabular POMDPs and the Cassandra parser vs the JAX package.

The table makers, both parsers, the terminal detection, the writer and
the registry's lookups must give bit-equal arrays.  Draws cannot match
across frameworks, so the engines are compared with the JAX run's outcomes
injected (``reset_with`` / ``step_with``): every reward, flag, observation
and state then agrees exactly.  The port's own draws are held against the
tables in distribution: each empirical frequency within 5 standard errors
(plus 1/N) of its probability, and never on a zero-probability outcome.
"""

import os

import jax
import numpy as np
import pytest
import torch

from dtqn_tpu.envs import make_env as jax_make_env
from dtqn_tpu.envs import pomdp as jax_pomdp
from dtqn_tpu.envs import pomdp_parser as jax_parser
from dtqn_tpu_torch.envs import make_env
from dtqn_tpu_torch.envs import pomdp, pomdp_parser
from dtqn_tpu_torch.envs.core import ObsKind

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HALLWAY_FILE = os.path.join(REPO, "data", "hallway.pomdp")
HALLWAY, HEAVENHELL = ("POMDP-hallway-episodic-v0",
                       "POMDP-heavenhell_3-episodic-v0")
TABLES = ("T", "O", "R", "start", "terminal", "init_obs")


def eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def jax_tables(jenv):
    return {k: np.asarray(getattr(jenv, "_" + k)) for k in TABLES}


def assert_same_env(env, jenv):
    for attr in ("name", "num_states", "num_actions", "num_obs",
                 "max_episode_steps", "obs_mask", "obs_vocab_size",
                 "success_reward_threshold"):
        assert getattr(env, attr) == getattr(jenv, attr), attr
    assert tuple(env.obs_shape) == tuple(jenv.obs_shape) == (1,)
    assert env.obs_kind == ObsKind.DISCRETE and env.obs_dtype == torch.int32
    want = jax_tables(jenv)
    for k in TABLES:
        assert env.tables[k].dtype == want[k].dtype, k
        eq(env.tables[k], want[k])


@pytest.mark.parametrize("maker,args", [
    ("make_heavenhell", (3,)), ("make_heavenhell", (2, 30)),
    ("make_hallway", ()),
])
def test_table_makers_are_bit_equal(maker, args):
    assert_same_env(getattr(pomdp, maker)(*args),
                    getattr(jax_pomdp, maker)(*args))


@pytest.mark.parametrize("name", [HALLWAY, HEAVENHELL, HALLWAY_FILE])
def test_registry_matches_jax(name):
    env, jenv = make_env(name), jax_make_env(name)
    assert_same_env(env, jenv)
    assert env.max_episode_steps == (40 if name == HEAVENHELL else 100)


def test_registry_dims_and_vocabulary():
    hallway, heavenhell = make_env(HALLWAY), make_env(HEAVENHELL)
    assert (hallway.num_states, hallway.num_actions, hallway.num_obs) == (
        60, 5, 21)
    assert hallway.obs_vocab_size == 22 and heavenhell.obs_vocab_size == 13
    # Hallway is the repo's data/hallway.pomdp, not the reconstruction.
    parsed = pomdp_parser.parse_pomdp_file(HALLWAY_FILE)
    eq(hallway.tables["T"], parsed.T)
    with pytest.raises(FileNotFoundError):
        make_env("absent.pomdp")
    with pytest.raises(KeyError, match="Unknown environment"):
        make_env("NoSuchEnv-v0")


def test_hallway_lookup_order(tmp_path, monkeypatch):
    """DTQN_TPU_POMDP_DIR first, then the working directory, then data/."""
    heaven = pomdp.make_heavenhell(3)
    t = heaven.tables
    text = pomdp_parser.pomdp_to_cassandra(t["T"], t["O"], t["R"],
                                           t["start"])
    (tmp_path / "env").mkdir()
    (tmp_path / "cwd").mkdir()
    (tmp_path / "env" / "hallway.pomdp").write_text(text)
    monkeypatch.chdir(tmp_path / "cwd")
    monkeypatch.setenv("DTQN_TPU_POMDP_DIR", str(tmp_path / "env"))
    env, jenv = make_env(HALLWAY), jax_make_env(HALLWAY)
    assert env.num_states == heaven.num_states
    assert_same_env(env, jenv)
    monkeypatch.delenv("DTQN_TPU_POMDP_DIR")
    (tmp_path / "cwd" / "hallway.pomdp").write_text(
        text.replace("discount: 0.95", "discount: 0.9"))
    assert_same_env(make_env(HALLWAY), jax_make_env(HALLWAY))
    assert make_env(HALLWAY).num_states == heaven.num_states
    os.remove(tmp_path / "cwd" / "hallway.pomdp")
    assert make_env(HALLWAY).num_states == 60


PARSED = ("T", "O", "R", "start")


def assert_same_parse(a, b):
    for k in PARSED:
        assert getattr(a, k).dtype == getattr(b, k).dtype == np.float32
        eq(getattr(a, k), getattr(b, k))
    assert a.discount == b.discount
    assert (a.states, a.actions, a.observations) == (
        b.states, b.actions, b.observations)


@pytest.mark.parametrize("prefer_native", [True, False])
def test_parse_hallway_file_matches_jax(prefer_native):
    assert_same_parse(
        pomdp_parser.parse_pomdp_file(HALLWAY_FILE, prefer_native),
        jax_parser.parse_pomdp_file(HALLWAY_FILE, prefer_native))


def test_native_and_python_parsers_agree():
    if not pomdp_parser.native_parser_loads():
        pytest.skip("native/libpomdp_parser.so does not load here")
    with open(HALLWAY_FILE) as f:
        text = f.read()
    native = pomdp_parser.parse_pomdp_text_native(text)
    python = pomdp_parser.parse_pomdp_text(text)
    for k in PARSED:
        eq(getattr(native, k), getattr(python, k))
    assert native.discount == pytest.approx(python.discount)


def test_python_parser_serves_when_the_library_does_not_load(tmp_path,
                                                             monkeypatch):
    bogus = tmp_path / "libpomdp_parser.so"
    bogus.write_bytes(b"not a shared library")
    monkeypatch.setattr(pomdp_parser, "_NATIVE_PATH", str(bogus))
    monkeypatch.setattr(pomdp_parser, "_native_lib", None)
    assert not pomdp_parser.native_parser_loads()
    assert pomdp_parser.parse_pomdp_text_native("states: 2") is None
    assert_same_parse(pomdp_parser.parse_pomdp_file(HALLWAY_FILE),
                      jax_parser.parse_pomdp_file(HALLWAY_FILE, False))


GRAMMAR = """# a tiny POMDP in every form the grammar takes
discount: 0.9
values: cost
states: left right gone
actions: 2
observations: 3
start: left right
T: 0
identity
T: 1 : left
0.0 0.5 0.5
T: 1 : right : gone 1.0
T: 1 : gone
0 0 1
O: *
uniform
O: 1 : gone : 2 1.0
O: 1 : left
0.5 0.5 0.0
R: 1 : * : gone : * 2.0
R: 0 : left : left : * 0.5
"""


def test_grammar_forms_match_jax():
    mine = pomdp_parser.parse_pomdp_text(GRAMMAR)
    assert_same_parse(mine, jax_parser.parse_pomdp_text(GRAMMAR))
    eq(mine.R[0, 1, 2], -2.0)  # values: cost negates
    eq(mine.start, [0.5, 0.5, 0.0])


@pytest.mark.parametrize("name", [HALLWAY, HEAVENHELL])
def test_absorbing_states_and_writer_round_trip(name):
    env = make_env(name)
    t = env.tables
    text = pomdp_parser.pomdp_to_cassandra(t["T"], t["O"], t["R"],
                                           t["start"], header="x\ny")
    assert text == jax_parser.pomdp_to_cassandra(
        t["T"], t["O"], t["R"], t["start"], header="x\ny")
    parsed = pomdp_parser.parse_pomdp_text(text)
    for k in ("T", "O", "R", "start"):
        eq(getattr(parsed, k), t[k])
    absorbing = pomdp_parser.absorbing_states(parsed)
    eq(absorbing, jax_parser.absorbing_states(
        jax_parser.parse_pomdp_text(text)))
    if name == HALLWAY:
        # The goal's four states: every action self-loops, no reward.
        eq(absorbing, t["terminal"])
    env2 = pomdp_parser.make_tabular_env(parsed, name="x", max_episode_steps=7,
                                         terminal_states=[0, 2])
    eq(np.flatnonzero(env2.tables["terminal"]), [0, 2])
    assert env2.max_episode_steps == 7


# ------------------------------------------------------------ the engine
def jax_reset(jenv, key, n):
    obs, state = jenv.reset_vec(jax.random.split(key, n))
    return np.asarray(obs), np.asarray(state.s)


@pytest.mark.parametrize("name", [HALLWAY, HEAVENHELL])
def test_episode_with_injected_outcomes_matches_jax(name, monkeypatch):
    """100 steps of scripted actions without resets: the JAX run's next
    states and observations injected, everything else computed."""
    n, steps = 16, 100
    jenv, env = jax_make_env(name), make_env(name)
    jenv.max_episode_steps = env.max_episode_steps = 1000
    jobs, js = jax_reset(jenv, jax.random.key(0), n)
    obs, state = env.reset_with(torch.tensor(js), torch.tensor(jobs[:, 0]))
    eq(obs, jobs)
    jstate = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(0), n))[1]
    step = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(1)
    seen = {"terminated": False, "reward": False}
    for t in range(steps):
        actions = rng.integers(0, env.num_actions, n).astype(np.int32)
        jobs, jstate, jts = step(jax.random.split(jax.random.key(t + 1), n),
                                 jstate, actions)
        s2, o = (torch.tensor(np.asarray(x)) for x in (jstate.s, jobs[:, 0]))
        monkeypatch.setattr(
            env, "step_env",
            lambda gen, st, a: env.step_with(st, a, s2, o))
        obs, state, ts = env.step(None, state, torch.tensor(actions))
        eq(obs, jobs)
        eq(state.s, jstate.s)
        eq(state.t, jstate.t)
        assert state.s.dtype == state.t.dtype == torch.int32
        for f in ("reward", "terminated", "truncated"):
            eq(getattr(ts, f), getattr(jts, f))
        eq(ts.info["is_success"], jts.info["is_success"])
        assert ts.reward.dtype == torch.float32
        seen["terminated"] |= bool(ts.terminated.any())
        seen["reward"] |= bool((ts.reward != 0).any())
    assert all(seen.values()), seen


@pytest.mark.parametrize("name", [HALLWAY, HEAVENHELL])
def test_step_autoreset_at_the_time_limit_matches_jax(name, monkeypatch):
    """``step_autoreset`` with a 7-step cap: the JAX step's and reset's
    outcomes (its own key split) injected; the auto-reset output, the
    truncation and the fresh episodes' states agree."""
    n, cap = 12, 7
    jenv, env = jax_make_env(name), make_env(name)
    jenv.max_episode_steps = env.max_episode_steps = cap
    keys = jax.random.split(jax.random.key(3), n)
    jobs, jstate = jax.vmap(jenv.reset)(keys)
    obs, state = env.reset_with(torch.tensor(np.asarray(jstate.s)),
                                torch.tensor(np.asarray(jobs[:, 0])))
    step_vec = jax.jit(jenv.step_vec)
    step, reset = jax.vmap(jenv.step), jax.vmap(jenv.reset_env)
    rng = np.random.default_rng(2)
    truncations = resets = 0
    for t in range(40):
        actions = rng.integers(0, env.num_actions, n).astype(np.int32)
        keys = jax.random.split(jax.random.key(100 + t), n)
        k_step, k_reset = jax.vmap(jax.random.split, out_axes=1)(keys)
        sobs, sstate, _ = step(k_step, jstate, actions)
        robs, rstate = reset(k_reset)
        jobs, jnew, jts = step_vec(keys, jstate, actions)
        injected = [torch.tensor(np.asarray(x)) for x in (
            sstate.s, sobs[:, 0], rstate.s, robs[:, 0])]
        monkeypatch.setattr(env, "step_env", lambda gen, st, a: env.step_with(
            st, a, injected[0], injected[1]))
        monkeypatch.setattr(env, "reset_env", lambda gen, e, dev: env.reset_with(
            injected[2], injected[3]))
        obs, state, ts = env.step_autoreset(None, state, torch.tensor(actions))
        eq(obs, jobs)
        eq(ts.obs, jts.obs)
        eq(state.s, jnew.s)
        eq(state.t, jnew.t)
        for f in ("reward", "terminated", "truncated"):
            eq(getattr(ts, f), getattr(jts, f))
        truncations += int(ts.truncated.sum())
        resets += int(ts.done.sum())
        jstate = jnew
    assert truncations > 0 and resets > truncations


def frequencies(draws, size):
    return np.bincount(np.asarray(draws).reshape(-1), minlength=size) / (
        np.asarray(draws).size)


def assert_follows(freq, p, n):
    """Within 5 standard errors plus 1/N of p; never where p is zero."""
    p = np.asarray(p, np.float64)
    assert (freq[p == 0] == 0).all()
    tol = 5 * np.sqrt(p * (1 - p) / n) + 1.0 / n
    assert (np.abs(freq - p) <= tol).all(), (freq, p)


def test_own_draws_follow_the_tables():
    env = make_env(HALLWAY)
    t = env.tables
    n = 40_000
    gen = torch.Generator().manual_seed(0)
    obs, state = env.reset_env(gen, n, "cpu")
    assert obs.shape == (n, 1) and obs.dtype == torch.int32
    assert_follows(frequencies(state.s, env.num_states), t["start"], n)
    # The first observation given the start state, for the commonest one.
    s0 = int(np.bincount(state.s.numpy()).argmax())
    picked = obs[state.s == s0, 0]
    assert_follows(frequencies(picked, env.num_obs), t["init_obs"][s0],
                   len(picked))
    # A noisy forward move from a corridor state, and the observation of
    # the commonest next state.
    s, a = 5, 1
    start = pomdp.TabularState(
        s=torch.full((n,), s, dtype=torch.int32),
        t=torch.zeros(n, dtype=torch.int32))
    obs, new, reward, terminated, info = env.step_env(
        gen, start, torch.full((n,), a))
    assert (t["T"][s, a] > 0).sum() >= 3  # a stochastic row
    assert_follows(frequencies(new.s, env.num_states), t["T"][s, a], n)
    s2 = int(np.bincount(new.s.numpy()).argmax())
    picked = obs[new.s == s2, 0]
    assert_follows(frequencies(picked, env.num_obs), t["O"][a, s2],
                   len(picked))
    eq(reward, t["R"][s, a, new.s.numpy()])
    eq(terminated, t["terminal"][new.s.numpy()])
    assert (new.t == 1).all()


def test_zero_probability_outcome_is_never_drawn():
    """Gumbel-max over log(p + 1e-30): at the uniform's extremes (0 clamped
    to the smallest normal float, and the largest float below 1) every
    row still picks an outcome of positive probability."""
    env = make_env(HEAVENHELL)
    logits = env._on("cpu")["log_T"].reshape(-1, env.num_states)
    p = env.tables["T"].reshape(-1, env.num_states)
    tiny = torch.finfo(torch.float32).tiny
    below_one = 1.0 - 2.0 ** -24
    rows = torch.arange(len(p))
    for u in (tiny, below_one):
        # The extreme on every zero-probability entry, the other extreme on
        # the rest: the most a draw can favour an impossible outcome.
        other = below_one if u == tiny else tiny
        uniform = torch.where(torch.tensor(p) > 0, other, u)
        picked = pomdp.categorical(logits, uniform.to(torch.float32))
        assert (p[rows, picked] > 0).all()
    # And in distribution over many rows of the deterministic T-maze.
    gen = torch.Generator().manual_seed(1)
    draws = pomdp.draw(gen, logits.repeat(200, 1))
    assert (p[rows.repeat(200), draws] == 1.0).all()
