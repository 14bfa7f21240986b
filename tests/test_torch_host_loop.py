"""The port's host loop (``train/host_loop.py``, ``envs/host.py``,
``envs/minihack.py``) against the JAX package's, on the CPU at small
widths.

MiniHack itself is an external C package that is not installed here, so
the loop runs on an in-repo cue task (``tests/test_host_loop.py``'s
``CueHostEnv``), one class per package over the same numpy dynamics; the
real-MiniHack tests are gated on the import, as the JAX package's are.

- ``HostVecEnv`` (time limit, termination, auto-reset): every array of 20
  steps equal to the JAX package's, exactly;
- ``MH_SPECS`` and ``DES_MAZE_V0`` equal to the JAX tables; the refusals
  (``KeyError``, then ``ImportError`` with the reference's message);
- ``Agent.init_state(seed, external_obs)``: context, ring and obs equal to
  the JAX ``init_state(key, obs0)``'s, the context's random actions
  injected from the JAX draw;
- one prepopulation iteration then one ``observe_and_learn`` iteration from
  equal states, on one injected batch: context, ring, epsilon and
  ``env_steps`` exact, parameters within the update tolerance of
  ``tests/test_torch_agent.py`` (rtol 1e-4, atol 1e-7);
- ``evaluate_host`` with the JAX-trained ``MH-CueHost-v0`` policy through
  the bridge: the greedy action of every step and (SR, return, length)
  equal to the JAX ``evaluate_host``'s on the same env seeds, with the
  contexts' draws injected; SR > 0.8;
- ``run_host_experiment`` end to end: the JAX package's three runner tests
  ported, and one bf16 run;
- the functions that the card replays as CUDA graphs (``compiled_host_fns``,
  ``compiled_host_eval``), each step written back and fed from its static
  buffers: bit-equal to the plain bodies over prepopulation, learning and
  two evaluations (DTQN, DRQN, DTQN-bag), with no host read, tensor made
  from Python data or data-sized output in a step; the JAX-trained
  evaluation through them; each of the seven graphs captured once over a
  run (a stand-in capture); on the CPU ``make_host_fns`` and
  ``make_host_eval`` are the plain bodies and touch no ``torch.cuda``.
"""

import glob
import itertools
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
from dtqn_tpu.envs import minihack as jax_minihack
from dtqn_tpu.envs.core import ObsKind as JaxObsKind
from dtqn_tpu.envs.host import HostEnvironment as JaxHostEnvironment
from dtqn_tpu.envs.host import HostVecEnv as JaxHostVecEnv
from dtqn_tpu.train import host_loop as jax_host_loop
from dtqn_tpu.utils.epsilon import EpsilonSchedule as JaxEpsilon
from dtqn_tpu_torch import replay
from dtqn_tpu_torch.agents import Agent, AgentConfig
from dtqn_tpu_torch.bridge import params_from_jax
from dtqn_tpu_torch.config import ExperimentConfig
from dtqn_tpu_torch.envs import minihack
from dtqn_tpu_torch.envs.core import ObsKind
from dtqn_tpu_torch.envs.host import HostEnvironment, HostVecEnv
from dtqn_tpu_torch.train import host_loop
from dtqn_tpu_torch.train.host_loop import (
    STEP_KEYS,
    evaluate_host,
    make_host_fns,
    run_host_experiment,
    step_to_device,
)
from dtqn_tpu_torch.utils import checkpoint as ckpt
from dtqn_tpu_torch.utils import graphs
from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUE_POLICY = glob.glob(os.path.join(
    REPO, "policies", "validation", "MH-CueHost-v0", "*_policy.msgpack"))


class CueDynamics:
    """``tests/test_host_loop.py``'s cue task: observe a cue token at t=0,
    then blanks; acting ``cue`` terminates with +1 (else -0.1 a step until
    the time limit)."""

    name = "CueHost-v0"
    num_actions = 2
    max_episode_steps = 8
    obs_shape = (1,)

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)
        self.cue = 0
        self.t = 0

    @property
    def obs_mask(self) -> float:
        return 3.0  # tokens {0, 1, 2}; mask one past

    def seed(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def reset(self):
        self.cue = int(self.rng.integers(0, 2))
        self.t = 0
        return np.array([self.cue], np.int32)

    def step(self, action):
        self.t += 1
        if action == self.cue:
            return np.array([2], np.int32), 1.0, True, {"is_success": True}
        return np.array([2], np.int32), -0.1, False, {}


class JaxCueHostEnv(CueDynamics, JaxHostEnvironment):
    obs_kind = JaxObsKind.DISCRETE
    obs_dtype = np.int32


class CueHostEnv(CueDynamics, HostEnvironment):
    obs_kind = ObsKind.DISCRETE
    obs_dtype = torch.int32


@pytest.fixture(autouse=True)
def one_thread():
    """These sizes gain nothing from intra-op threads; one keeps the tests
    from competing for the cores with the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cue_actions(vec, wrong):
    """Each env's cue, or the other action where ``wrong``."""
    return np.array([e.cue ^ int(w) for e, w in zip(vec.envs, wrong)],
                    np.int64)


# --------------------------------------------------------------- the envs
def test_host_vec_env_matches_jax():
    vec = HostVecEnv([CueHostEnv(seed=i) for i in range(3)])
    jvec = JaxHostVecEnv([JaxCueHostEnv(seed=i) for i in range(3)])
    obs = vec.reset_all()
    np.testing.assert_array_equal(obs, jvec.reset_all())
    assert obs.dtype == np.int32
    rng = np.random.default_rng(0)
    seen = {"done": 0, "terminated": 0}
    for t in range(20):
        # Env 0 always acts wrong (its episodes hit the time limit), env 1
        # right every third step, env 2 at random.
        actions = cue_actions(vec, [True, t % 3 != 2, rng.random() < 0.5])
        out, jout = vec.step(actions), jvec.step(actions)
        assert set(out) == set(jout)
        for k in out:
            assert out[k].dtype == jout[k].dtype, k
            np.testing.assert_array_equal(out[k], jout[k], err_msg=k)
        seen["done"] += int(out["done"].sum())
        seen["terminated"] += int(out["terminated"].sum())
    # Both ways of ending an episode happened: the time limit (done, not
    # terminated) and the env's own termination.
    assert seen["done"] > seen["terminated"] > 0


def test_minihack_tables_match_jax():
    assert minihack.MH_SPECS == jax_minihack.MH_SPECS
    assert len(minihack.MH_SPECS) == 20
    assert minihack.DES_MAZE_V0 == jax_minihack.DES_MAZE_V0
    assert minihack.minihack_available() == jax_minihack.minihack_available()


@pytest.mark.parametrize("name", ["MH-Room-5x5-v0", "MH-Room-5-v0"])
def test_host_minihack_refuses_as_jax(name):
    """An unknown name raises KeyError; a known one ImportError with the
    reference's message while ``minihack`` is missing (it builds where the
    package is installed)."""
    if name in minihack.MH_SPECS and minihack.minihack_available():
        assert minihack.make_host_env(name).obs_shape
        return
    with pytest.raises((KeyError, ImportError)) as want:
        jax_minihack.HostMiniHack(name)
    with pytest.raises(want.type) as got:
        minihack.make_host_env(name)
    assert str(got.value) == str(want.value)
    assert (got.type is KeyError) == (name not in minihack.MH_SPECS)


def mh_cfg(**kw):
    return host_cfg(**dict(dict(envs=["MH-Room-5-v0"], num_steps=200,
                                num_envs=2, prepop_steps=50,
                                eval_frequency=100, eval_episodes=2), **kw))


def test_real_minihack_room_smoke(tmp_path, monkeypatch):
    """``tests/test_host_loop.py``'s ``TestRealMiniHack``: runs where the
    package is installed."""
    if not minihack.minihack_available():
        pytest.skip("minihack not installed")
    monkeypatch.chdir(tmp_path)
    out = run_host_experiment(mh_cfg())
    assert "MH-Room-5-v0/SuccessRate" in out


def test_real_minihack_specs_resolve():
    if not minihack.minihack_available():
        pytest.skip("minihack not installed")
    for name in minihack.MH_SPECS:
        env = minihack.HostMiniHack(name)
        assert env.reset().shape == env.obs_shape


# ------------------------------------------------------------ the agent
SMALL = dict(model="DTQN", num_envs=4, inner_embed=16, num_heads=2,
             num_layers=1, context_len=8, history=8, batch_size=2,
             buffer_size=800)


def jax_leaves(tree):
    return {k: np.asarray(getattr(tree, k)) for k in tree.__dataclass_fields__
            if getattr(tree, k) is not None}


def assert_tree_equal(port, jax_tree, what):
    want = jax_leaves(jax_tree)
    got = {k: getattr(port, k) for k in want}
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v,
                                      err_msg=f"{what}.{k}")


def inject_context_actions(monkeypatch, draws):
    """The port's fresh contexts take their random actions from
    ``draws["action"]`` (the JAX run's), wherever ``reset_context`` or
    ``init_context`` makes them."""
    real_init, real_reset = replay.init_context, replay.reset_context

    def init_context(*args):
        ctx = real_init(*args)
        ctx.action = torch.tensor(draws["action"])
        return ctx

    def reset_context(ctx, generator, first_obs, mask, *rest):
        out = real_reset(ctx, generator, first_obs, mask, *rest)
        out.action = torch.where(mask[:, None], torch.tensor(draws["action"]),
                                 out.action)
        return out

    monkeypatch.setattr(replay, "init_context", init_context)
    monkeypatch.setattr(replay, "reset_context", reset_context)


def make_pair(monkeypatch):
    """The JAX and the port agent on equal states from one reset of equal
    host envs, the port's context draws injected from the JAX state's."""
    vec = HostVecEnv([CueHostEnv(seed=i) for i in range(4)])
    jvec = JaxHostVecEnv([JaxCueHostEnv(seed=i) for i in range(4)])
    obs0 = vec.reset_all()
    np.testing.assert_array_equal(obs0, jvec.reset_all())
    jagent = JaxAgent(JaxConfig(**SMALL), jvec.meta)
    jstate = jagent.init_state(jax.random.key(3), obs0)
    draws = {"action": np.asarray(jstate.context.action)}
    inject_context_actions(monkeypatch, draws)
    agent = Agent(AgentConfig(**SMALL), vec.meta, device="cpu")
    state = agent.init_state(3, obs0)
    weights = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                     jstate.params))
    state.network.load_state_dict(weights)
    state.target_network.load_state_dict(weights)
    return vec, jvec, jagent, jstate, agent, state, draws


def assert_states_equal(state, jstate, what):
    assert_tree_equal(state.context, jstate.context, f"{what} context")
    assert_tree_equal(state.buffer, jstate.buffer, f"{what} buffer")
    np.testing.assert_array_equal(state.obs.numpy(), np.asarray(jstate.obs))


def test_init_state_with_external_obs_matches_jax(monkeypatch):
    vec, _, _, jstate, agent, state, _ = make_pair(monkeypatch)
    assert state.env_state is None and jstate.env_state is None
    assert state.obs.dtype == torch.int32
    assert_states_equal(state, jstate, "init")
    # The reset observations head every context and the ring's first row.
    assert bool((state.context.obs[:, 0] == state.obs).all())
    assert int(state.env_steps) == int(jstate.env_steps) == 0
    assert float(state.epsilon) == float(jstate.epsilon) == 1.0


def test_observe_and_learn_matches_jax(monkeypatch):
    """One prepopulation iteration (every env acts its cue: four episodes
    flushed, so the update may sample) and one ``observe_and_learn``
    iteration (two envs right, two wrong), both packages on one injected
    batch."""
    vec, jvec, jagent, jstate, agent, state, draws = make_pair(monkeypatch)
    rng = np.random.default_rng(5)
    b, length = SMALL["batch_size"], SMALL["context_len"]
    tokens = rng.integers(0, 4, (b, length + 1, 1)).astype(np.int32)
    acts = rng.integers(0, 2, (b, length + 1)).astype(np.int32)
    arrays = dict(
        obs=tokens[:, :-1], action=acts[:, :-1], next_obs=tokens[:, 1:],
        next_action=acts[:, 1:],
        reward=rng.choice([-0.1, 1.0], (b, length)).astype(np.float32),
        done=rng.random((b, length)) < 0.2,
        ep_len=rng.integers(1, length + 1, b).astype(np.int32),
    )
    jagent.sample_batch = lambda buffer, key: jax_replay.Batch(
        **{k: jnp.asarray(v) for k, v in arrays.items()})
    batch = replay.Batch(**{k: torch.tensor(v) for k, v in arrays.items()})
    monkeypatch.setattr(agent, "sample_batch", lambda buffer, gen: batch)

    jfns = jax_host_loop.make_host_fns(jagent, JaxEpsilon(1.0, 0.1, 300), 1)
    fns = make_host_fns(agent, EpsilonSchedule(1.0, 0.1, 300), 1)
    for i, wrong in ((2, [0, 0, 0, 0]), (3, [0, 1, 0, 1])):
        actions = cue_actions(vec, wrong)
        out, jout = vec.step(actions), jvec.step(actions)
        jstate = jfns[i](jstate, jnp.asarray(actions),
                         *(jnp.asarray(jout[k]) for k in STEP_KEYS))
        # The fresh contexts of the envs that were done draw the JAX run's
        # random actions.
        draws["action"] = np.asarray(jstate.context.action)
        fns[i](state, torch.as_tensor(actions),
               *step_to_device(out, agent.device))
        assert_states_equal(state, jstate, f"after iteration {i - 1}")
    assert int(state.buffer.flushed_total) == 6
    assert int(state.env_steps) == int(jstate.env_steps) == 4
    assert int(state.train_steps) == int(jstate.train_steps) == 1
    assert (state.epsilon.numpy().tobytes()
            == np.asarray(jstate.epsilon).tobytes())
    assert float(state.epsilon) < 1.0
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    moved = 0.0
    for name, value in state.network.state_dict().items():
        np.testing.assert_allclose(value.numpy(), ref[name].numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
        moved = max(moved, float((value - state.target_network.state_dict()
                                  [name]).abs().max()))
    assert moved > 0.0  # the update was applied


# ------------------------------------------------------------- evaluation
def recording(monkeypatch, module):
    """Patches ``module.HostVecEnv`` to record the actions of every step."""
    steps = []
    base = module.HostVecEnv

    class Recording(base):
        def step(self, actions):
            steps.append(np.asarray(actions).copy())
            return super().step(actions)

    monkeypatch.setattr(module, "HostVecEnv", Recording)
    return steps


@pytest.mark.skipif(not CUE_POLICY, reason="JAX-trained CueHost policy absent")
def test_evaluate_host_matches_jax_trained_policy(monkeypatch):
    """The JAX-trained ``MH-CueHost-v0`` policy (in_embed 32, context 8, 8
    heads) through the bridge takes the JAX package's greedy action at
    every evaluation step, on the same env seeds."""
    trained_cue_case(monkeypatch, compiled=False)


@pytest.mark.skipif(not CUE_POLICY, reason="JAX-trained CueHost policy absent")
def test_compiled_evaluate_host_matches_jax_trained_policy(monkeypatch):
    """The same through the functions that the card replays as graphs
    (``compiled_host_eval``, each step written back)."""
    trained_cue_case(monkeypatch, compiled=True)


def trained_cue_case(monkeypatch, compiled):
    with open(CUE_POLICY[0], "rb") as f:
        params = serialization.msgpack_restore(f.read())
    kw = dict(model="DTQN", num_envs=32, inner_embed=32, num_heads=8,
              num_layers=2, context_len=8, history=8)
    n, key = 10, jax.random.key(11)
    jagent = JaxAgent(JaxConfig(**kw), JaxCueHostEnv())
    agent = Agent(AgentConfig(**kw), CueHostEnv(), device="cpu")
    network = agent.build_network()
    network.load_state_dict(params_from_jax(params), strict=True)

    def factory(cls):
        seeds = itertools.count()
        return lambda: cls(seed=next(seeds))

    # The JAX evaluation's context draws, for the port's contexts.
    obs0 = JaxHostVecEnv([JaxCueHostEnv(seed=i) for i in range(n)]
                         ).reset_all()
    eval_init = jax_host_loop.make_host_eval(jagent, JaxCueHostEnv(), n)[0]
    inject_context_actions(monkeypatch, {"action": np.asarray(
        eval_init(key, jnp.asarray(obs0))[0].action)})

    jsteps = recording(monkeypatch, jax_host_loop)
    want = jax_host_loop.evaluate_host(jagent, params,
                                       factory(JaxCueHostEnv), n, key)
    steps = recording(monkeypatch, host_loop)
    fns = host_loop.make_host_eval_bodies(agent, CueHostEnv(), n)
    if compiled:
        fns = host_loop.compiled_host_eval(agent, CueHostEnv(), n, fns,
                                           graphed=False)
    got = evaluate_host(agent, network, factory(CueHostEnv), n,
                        torch.Generator().manual_seed(0), fns)
    assert len(steps) == len(jsteps) >= 1
    for a, b in zip(steps, jsteps):
        np.testing.assert_array_equal(a, b)
    assert [float(x) for x in got] == [float(x) for x in want]
    assert got[0] > 0.8


# ------------------------------------------------ the compiled functions
# On the card the host loop's device halves replay CUDA graphs over static
# buffers (``compiled_host_fns``, ``compiled_host_eval``); here each step is
# written back, fed from the static buffers that ``step_to_device`` and
# ``to_device`` fill.
MODELS = {"DTQN": {}, "DRQN": dict(model="DRQN"),
          "DTQN-bag": dict(model="DTQN-bag", bag_size=3)}


def host_run(kw, compiled, iters=(12, 4)):
    """A state trained by ``iters`` (prepopulation, learning) iterations
    of the host functions, plain or compiled, on 4 cue envs; then two
    evaluations of 5 envs from one generator: (state, results, the
    generator's end state, the functions)."""
    vec = HostVecEnv([CueHostEnv(seed=i) for i in range(4)])
    agent = Agent(AgentConfig(**{**SMALL, **kw}), vec.meta, device="cpu")
    state = agent.init_state(3, vec.reset_all())
    fns = host_loop.make_host_bodies(agent, EpsilonSchedule(1.0, 0.1, 300), 2)
    eval_fns = host_loop.make_host_eval_bodies(agent, vec.meta, 5)
    if compiled:
        fns = host_loop.compiled_host_fns(agent, fns, graphed=False)
        eval_fns = host_loop.compiled_host_eval(agent, vec.meta, 5, eval_fns,
                                                graphed=False)
    for _ in range(iters[0]):
        host_loop.host_iteration(vec, state, fns.act_random,
                                 fns.observe_only, fns.inputs)
    for i in range(iters[1]):
        # The first learning iteration passes new tensors, which the
        # compiled functions copy into their buffers.
        host_loop.host_iteration(vec, state, fns.act, fns.observe_and_learn,
                                 fns.inputs if i else None)
    generator = torch.Generator().manual_seed(4)
    results = []
    for _ in range(2):
        seeds = itertools.count()
        results.append(evaluate_host(
            agent, state.network, lambda: CueHostEnv(seed=next(seeds)), 5,
            generator, eval_fns))
    return state, results, generator.get_state(), fns, eval_fns


def checkpointed(state):
    return {k: v.get_state() if isinstance(v, torch.Generator) else v
            for k, v in ckpt._leaves(state)}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_compiled_host_functions_equal_the_plain_ones(model):
    """Written back and fed from static buffers, the host functions train
    the state the plain ones train, bit for bit, each leaf staying in its
    storage; their evaluation gives the same results and leaves the
    generator in the same state."""
    plain, want, gen_plain, *_ = host_run(MODELS[model], compiled=False)
    state, got, gen, fns, _ = host_run(MODELS[model], compiled=True)
    a, b = checkpointed(plain), checkpointed(state)
    assert a.keys() == b.keys()
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    assert not differ, f"leaves differ: {differ}"
    assert int(state.train_steps) == 8 and int(state.env_steps) == 16
    assert [list(map(float, r)) for r in got] == [
        list(map(float, r)) for r in want]
    assert torch.equal(gen, gen_plain)
    # The actions and the step land in the functions' static buffers.
    assert fns.inputs.buffers["reset_obs"].data_ptr() != (
        state.obs.data_ptr())
    assert torch.equal(fns.inputs.buffers["reset_obs"], state.obs)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_compiled_host_functions_read_nothing_back(model):
    """After a warm-up, the host functions' steps (fed their own buffers,
    as the loops feed them) read no device value, make no tensor from
    Python data and size nothing by the data."""
    from test_torch_graphs import FORBIDDEN, OpNames

    state, _, _, fns, eval_fns = host_run(MODELS[model], compiled=True,
                                          iters=(12, 1))
    buffers = fns.inputs.buffers
    step = [buffers[k] for k in STEP_KEYS]
    ev = eval_fns.inputs.buffers
    network = state.network
    generator = torch.Generator().manual_seed(9)
    with OpNames() as ops:
        actions = fns.act_random(state)
        fns.observe_only(state, actions, *step)
        actions = fns.act(state)
        fns.observe_and_learn(state, actions, *step)
        context, bag, carry = eval_fns.eval_init(generator, ev["obs"])
        actions, carry = eval_fns.greedy(network, context, bag, carry,
                                         ev["obs"])
        eval_fns.eval_observe(network, context, bag, ev["next_obs"], actions,
                              ev["reward"], ev["terminated"], ev["live"])
    assert ops.calls > 100
    found = sorted(n for n in ops.names if n.startswith(FORBIDDEN))
    assert not found, f"{model}: {found} in a host function"


@pytest.mark.parametrize("model", sorted(MODELS))
def test_compiled_host_evaluation_takes_copies_of_its_buffers(model):
    """The compiled evaluation's functions called with copies of their
    buffers act as with the buffers themselves."""
    state, _, _, _, eval_fns = host_run(MODELS[model], compiled=True,
                                        iters=(12, 1))
    obs = eval_fns.inputs.buffers["obs"]
    context, bag, carry = eval_fns.eval_init(torch.Generator().manual_seed(1),
                                             obs.clone())
    copies = [cloned(x) for x in (context, bag, carry)]
    want, _ = eval_fns.greedy(state.network, context, bag, carry, obs)
    want = want.clone()
    got, _ = eval_fns.greedy(state.network, *copies, obs.clone())
    assert torch.equal(got, want)


def cloned(tree):
    """A dataclass or named tuple of tensors (or None), each cloned."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(t.clone() for t in tree))
    return type(tree)(**{k: v.clone() for k, v in vars(tree).items()})


def stand_in_captures(monkeypatch):
    """``GraphedStep.capture`` replaced by a stand-in that runs the step
    (the warm-up) and binds a graph that replays nothing (the CPU cannot
    capture); returns the captures by step name."""
    from test_torch_graphs import StandInGraph

    counts = {}

    def capture(self, tree):
        self.step(tree)
        self.graph = graphs.CountedGraph(StandInGraph(), {})
        self.bound = graphs.addresses(tree)
        counts[self.name] = counts.get(self.name, 0) + 1

    monkeypatch.setattr(graphs.GraphedStep, "capture", capture)
    return counts


def test_each_host_graph_is_captured_once(monkeypatch):
    """Over iterations and evaluations of one state and network, each of
    the seven graphs is captured once: nothing a call rebinds moves a
    graph's leaves."""
    counts = stand_in_captures(monkeypatch)
    vec = HostVecEnv([CueHostEnv(seed=i) for i in range(4)])
    agent = Agent(AgentConfig(**SMALL), vec.meta, device="cpu")
    state = agent.init_state(3, vec.reset_all())
    fns = host_loop.compiled_host_fns(
        agent, host_loop.make_host_bodies(agent, EpsilonSchedule(), 1),
        graphed=True)
    eval_fns = host_loop.compiled_host_eval(
        agent, vec.meta, 3, host_loop.make_host_eval_bodies(agent, vec.meta,
                                                            3),
        graphed=True)
    for _ in range(3):
        for act, update in ((fns.act_random, fns.observe_only),
                            (fns.act, fns.observe_and_learn)):
            host_loop.host_iteration(vec, state, act, update, fns.inputs)
        evaluate_host(agent, state.network, CueHostEnv, 3,
                      torch.Generator().manual_seed(0), eval_fns)
    assert counts == dict.fromkeys(
        ["host random act", "host observe", "host act",
         "host observe and learn", "host evaluation reset",
         "host greedy act", "host evaluation observe"], 1)


def test_cpu_host_functions_are_the_plain_bodies(monkeypatch):
    from test_torch_graphs import NoCuda

    NoCuda(monkeypatch)
    vec = HostVecEnv([CueHostEnv(seed=i) for i in range(4)])
    agent = Agent(AgentConfig(**SMALL), vec.meta, device="cpu")
    fns = make_host_fns(agent, EpsilonSchedule(1.0, 0.1, 300), 1)
    eval_fns = host_loop.make_host_eval(agent, vec.meta, 3)
    assert fns.inputs is None and eval_fns.inputs is None
    state = agent.init_state(3, vec.reset_all())
    for act, update in ((fns.act_random, fns.observe_only),
                        (fns.act, fns.observe_and_learn)):
        host_loop.host_iteration(vec, state, act, update)
    evaluate_host(agent, state.network, CueHostEnv, 3,
                  torch.Generator().manual_seed(0), eval_fns)
    assert int(state.env_steps) == 4 and agent.graph_pool is None


# ---------------------------------------------------------------- runner
def host_cfg(**kw):
    """``tests/test_host_loop.py``'s configuration, on the CPU."""
    fields = dict(
        envs=["CueHost-v0"], num_steps=300, num_envs=4, in_embed=16,
        heads=2, layers=1, context=8, history=8, batch=4, buf_size=800,
        eval_frequency=150, eval_episodes=3, prepop_steps=100,
        updates_per_iter=1, project_name="host-test", device="cpu",
    )
    return ExperimentConfig(**dict(fields, **kw))


def cue_factory(name):
    return CueHostEnv()


def test_trains_end_to_end(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = host_cfg()
    out = run_host_experiment(cfg, env_factory=cue_factory)
    assert "CueHost-v0/SuccessRate" in out
    assert np.isfinite(out["losses/TD_Error"])
    p = cfg.policy_path()
    assert os.path.exists(p + "_results.csv")
    assert os.path.exists(p + "_losses.csv")
    # Chunks of 37 iterations of 4 envs: the run ends at 3 * 148 steps.
    assert ckpt.load_mini_checkpoint(p) == {"step": 444, "wandb_id": None}
    assert not ckpt.has_checkpoint(p)  # only a cut run writes one
    assert run_host_experiment(cfg, env_factory=cue_factory) == {
        "completed": True, "step": 444}


def test_time_limit_checkpoint_then_resume(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    cfg = host_cfg(time_limit=1e-9, num_steps=600)
    run_host_experiment(cfg, env_factory=cue_factory)
    assert ckpt.has_checkpoint(cfg.policy_path())
    assert ckpt.load_mini_checkpoint(cfg.policy_path())["step"] == 148
    out = run_host_experiment(host_cfg(num_steps=600),
                              env_factory=cue_factory)
    assert "Resumed from checkpoint at 148 steps." in capsys.readouterr().out
    assert ckpt.load_mini_checkpoint(cfg.policy_path())["step"] >= 600
    assert "CueHost-v0/SuccessRate" in out


def test_learns_cue_task(tmp_path, monkeypatch):
    """The loop learns: the cue task is solvable from the context."""
    monkeypatch.chdir(tmp_path)
    cfg = host_cfg(num_steps=3000, eval_frequency=1500, eval_episodes=10,
                   prepop_steps=400)
    out = run_host_experiment(cfg, env_factory=cue_factory)
    assert out["CueHost-v0/SuccessRate"] >= 0.7


def test_bf16_host_run_is_finite(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = run_host_experiment(host_cfg(bf16=True, num_steps=160,
                                       eval_frequency=80),
                              env_factory=cue_factory)
    assert out["losses/Grad_Norm"] > 0.0
    assert all(np.isfinite(v) for v in out.values())


def test_refusals(tmp_path, monkeypatch):
    """One domain per run, on one device; nothing is written."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="one domain"):
        run_host_experiment(host_cfg(envs=["CueHost-v0", "CueHost-v0"]),
                            env_factory=cue_factory)
    with pytest.raises(ValueError, match="dp-devices"):
        run_host_experiment(host_cfg(dp_devices=2), env_factory=cue_factory)
    assert not os.listdir(tmp_path)
