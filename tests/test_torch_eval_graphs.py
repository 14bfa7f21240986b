"""The port's compiled evaluation (``train/loop.py``: ``make_evaluate``,
``BlockedEvaluation``; ``utils/graphs.py``) on the CPU, at narrow widths.

On the card an evaluation replays a graph of its reset and graphs of
blocks of env steps, reading ``finished.all()`` on the host between blocks,
and draws from generators of its own.  So:
- (a) the blocked evaluation, each step written back (``graphed=False``),
  equals ``make_evaluate_fn``'s bit for bit: its three results and the
  end state of every generator it was given, for a cap that is a multiple
  of the block and one that is not, with ``EVAL_EXIT_CHECK_EVERY`` 0, 1
  and 10, and again on a second call (the buffers reused);
- (b) it stops where the plain loop stops;
- (c) a second call reads nothing back, makes no tensor from Python data
  and sizes nothing by the data, with no host read between blocks
  (``EVAL_EXIT_CHECK_EVERY = 0``): the reset and the blocks, over every
  env family's ``reset_vec`` and ``step`` on the evaluation's path;
- (d) on a CPU agent ``make_evaluate`` is ``make_evaluate_fn``'s body and
  touches nothing of ``torch.cuda``.

Over the flagless DTQN, DTQN-bag, DRQN, 2 stacked seeds, bf16, ImageMaze,
Gridverse, two domains (four rooms 7x7 and 9x9, each evaluated on its own
padded env) and, for (c), Hallway.  On the card ``chip_smoke.py`` phases
8 and 22 hold graphed evaluations against eager ones.
"""

import pytest
import torch

from dtqn_tpu_torch.agents import Agent, AgentConfig
from dtqn_tpu_torch.config import ExperimentConfig
from dtqn_tpu_torch.train import loop
from dtqn_tpu_torch.train.runner import build_envs
from dtqn_tpu_torch.utils import graphs
from test_torch_graphs import FORBIDDEN, NoCuda, OpNames

EPISODES = 3
# (envs, AgentConfig fields, seeds)
CONFIGS = {
    "flagless": (["DiscreteCarFlag-v0"], {}, None),
    "bag": (["gv_memory.7x7.yaml"], dict(model="DTQN-bag", bag_size=3),
            None),
    "drqn": (["Memory-5-v0"], dict(model="DRQN"), None),
    "two_seeds": (["DiscreteCarFlag-v0"], {}, [3, 4]),
    "bf16": (["DiscreteCarFlag-v0"], dict(bf16=True), None),
    "image": (["ImageMaze-9-v0"], {}, None),
    "gridverse": (["gv_memory.7x7.yaml"], {}, None),
    "two_domains": (["gv_memory_four_rooms.7x7.yaml",
                     "gv_memory_four_rooms.9x9.yaml"], {}, None),
}
HYGIENE = {**CONFIGS,
           "hallway": (["POMDP-hallway-episodic-v0"], {}, None)}
CAPS = (20, 23)  # two blocks of 10; two and a remainder of 3
EVERY = (0, 1, 10)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def build(configs, name, cap):
    """(agent, its network, the eval envs, the seeds) of a configuration,
    every env capped at ``cap`` steps."""
    envs, fields, seeds = configs[name]
    train_env, eval_envs = build_envs(ExperimentConfig(envs=envs))
    for env in (train_env, *eval_envs):
        env.max_episode_steps = cap
    cfg = AgentConfig(**{**dict(
        num_envs=4, batch_size=4, context_len=8, history=8, inner_embed=16,
        num_heads=2, num_layers=1, buffer_size=400), **fields})
    agent = Agent(cfg, train_env, device="cpu")
    state = agent.init_sweep_state(seeds) if seeds else agent.init_state(0)
    return agent, state.network, eval_envs, seeds


def generator(seeds, offset):
    """What ``evaluate`` takes: one CPU generator, or one per seed."""
    if seeds is None:
        return torch.Generator().manual_seed(offset)
    return [torch.Generator().manual_seed(s + offset) for s in seeds]


def states(gen):
    return [g.get_state() for g in (gen if isinstance(gen, list) else [gen])]


def assert_same(plain, blocked, what):
    (out_p, gen_p), (out_b, gen_b) = plain, blocked
    assert all(torch.equal(a, b) for a, b in zip(out_p, out_b, strict=True)), (
        f"{what}: {[x.tolist() for x in out_p]} != "
        f"{[x.tolist() for x in out_b]}")
    assert all(torch.equal(a, b) for a, b in zip(gen_p, gen_b, strict=True)), (
        f"{what}: the generators' end states differ")


def evaluated(evaluate, network, seeds, offset):
    gen = generator(seeds, offset)
    out = evaluate(network, gen)
    return out, states(gen)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_blocked_evaluation_equals_the_plain_one(name, cap, monkeypatch):
    agent, network, eval_envs, seeds = build(CONFIGS, name, cap)
    for env in eval_envs:
        plain = loop.make_evaluate_fn(agent, env, EPISODES)
        blocked = loop.BlockedEvaluation(agent, env, EPISODES, graphed=False)
        for every in EVERY:
            monkeypatch.setattr(loop, "EVAL_EXIT_CHECK_EVERY", every)
            for offset in (5, 6):  # a first call, then the buffers reused
                what = f"{name} {env.name} cap {cap} every {every} #{offset}"
                assert_same(evaluated(plain, network, seeds, offset),
                            evaluated(blocked, network, seeds, offset), what)
        # One set of buffers, one step per block length and the reset.
        lengths = {k for k in blocked.compiled if k != "reset"}
        assert lengths == {1, 10} | ({cap % 10} if cap % 10 else set())


@pytest.mark.parametrize("every", EVERY)
def test_blocked_evaluation_stops_where_the_plain_one_does(every,
                                                           monkeypatch):
    """Driving right ends every Car Flag episode well before the cap of
    60: both forms step the envs as often."""
    agent, network, (env,), _ = build(CONFIGS, "flagless", 60)
    monkeypatch.setattr(
        agent, "greedy_actions",
        lambda net, ctx, bag, carry, obs: (
            torch.full((EPISODES,), 2, dtype=torch.int64), carry))
    monkeypatch.setattr(loop, "EVAL_EXIT_CHECK_EVERY", every)
    calls = []
    step = env.step
    monkeypatch.setattr(env, "step", lambda *a: calls.append(1) or step(*a))
    seen = []
    for evaluate in (loop.make_evaluate_fn(agent, env, EPISODES),
                     loop.BlockedEvaluation(agent, env, EPISODES, False)):
        del calls[:]
        seen.append((evaluated(evaluate, network, None, 2), len(calls)))
    (plain, n_plain), (blocked, n_blocked) = seen
    assert_same(plain, blocked, f"every {every}")
    assert n_plain == n_blocked
    assert (n_plain < 60) == bool(every)


@pytest.mark.parametrize("name", sorted(HYGIENE))
def test_an_evaluation_reads_nothing_back_and_copies_nothing_in(
        name, monkeypatch):
    agent, network, eval_envs, seeds = build(HYGIENE, name, 13)
    monkeypatch.setattr(loop, "EVAL_EXIT_CHECK_EVERY", 0)
    for env in eval_envs:
        evaluate = loop.BlockedEvaluation(agent, env, EPISODES, False)
        evaluate(network, generator(seeds, 1))  # the warm-up: constants
        with OpNames() as ops:
            evaluate(network, generator(seeds, 2))
        assert ops.calls > 100  # the mode saw the steps' operations
        found = sorted(n for n in ops.names if n.startswith(FORBIDDEN))
        assert not found, f"{name} {env.name}: {found} in an evaluation"


@pytest.mark.parametrize("name", ["flagless", "two_seeds"])
def test_cpu_make_evaluate_is_the_plain_body(name, monkeypatch):
    agent, network, (env,), seeds = build(CONFIGS, name, 23)
    NoCuda(monkeypatch)
    evaluate = loop.make_evaluate(agent, env, EPISODES)
    assert not isinstance(evaluate, loop.BlockedEvaluation)
    assert_same(evaluated(loop.make_evaluate_fn(agent, env, EPISODES),
                          network, seeds, 3),
                evaluated(evaluate, network, seeds, 3), name)
    assert agent.graph_pool is None


def test_each_evaluation_graph_is_captured_once(monkeypatch):
    """Evaluations of one network capture the reset and each block length
    once; a new network is captured anew."""
    from test_torch_host_loop import stand_in_captures

    counts = stand_in_captures(monkeypatch)
    agent, network, (env,), _ = build(CONFIGS, "flagless", 23)
    evaluate = loop.BlockedEvaluation(agent, env, EPISODES, graphed=True)
    for offset in range(3):
        evaluate(network, generator(None, offset))
    assert counts == {"evaluation reset": 1, "evaluation block of 10": 1,
                      "evaluation block of 3": 1}
    evaluate(agent.build_network(), generator(None, 0))
    assert counts == {"evaluation reset": 2, "evaluation block of 10": 2,
                      "evaluation block of 3": 2}


def test_a_graph_is_bound_to_the_network_it_reads():
    """A carry whose network changed is captured anew: the graph reads the
    network's parameters at their addresses."""
    agent, network, (env,), _ = build(CONFIGS, "flagless", 20)
    carry = loop.EvalCarry(network, torch.Generator())
    bound = graphs.addresses(carry)
    assert graphs.addresses(carry) == bound
    carry.network = agent.build_network()
    assert graphs.addresses(carry) != bound


def test_owned_generators_take_and_give_back_the_callers_state():
    callers = [torch.Generator().manual_seed(s) for s in (1, 2)]
    owned = graphs.own_generators(callers, "cpu")
    assert len(owned) == 2 and all(g is not c
                                   for g, c in zip(owned, callers))
    graphs.copy_states(callers, owned)
    draws = [torch.rand(3, generator=g) for g in owned]
    graphs.copy_states(owned, callers)
    fresh = [torch.Generator().manual_seed(s) for s in (1, 2)]
    for g, d in zip(fresh, draws):
        assert torch.equal(torch.rand(3, generator=g), d)
    assert all(torch.equal(a, b)
               for a, b in zip(states(fresh), states(callers)))
    one = graphs.own_generators(torch.Generator(), "cpu")
    assert isinstance(one, torch.Generator)
