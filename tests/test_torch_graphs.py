"""The port's compiled entry points (``train/loop.py``: ``make_train_chunk``,
``make_prepopulate``; ``utils/graphs.py``) on the CPU, at narrow widths.

A CUDA graph replays one iteration at fixed addresses, so:
- (a) an iteration through ``graphs.write_back`` equals the plain eager
  iteration bit for bit, in every leaf of the state (what a checkpoint
  saves) and in the generators' states, and leaves every tensor leaf in
  its storage;
- (b) after a warm-up iteration, an iteration reads no device value on the
  host (``aten._local_scalar_dense``), makes no tensor from Python data
  (``aten.lift_fresh*``: a host-to-device copy on the card) and runs no
  operation whose output shape depends on the data;
- (c) on a CPU state both entry points are the ``_fn`` bodies and touch
  nothing of ``torch.cuda``;
- (d) a replay adds to the launch counters what its capture counted.

Over the flagless DTQN, DTQN-bag (random and stored bags), DRQN, 2 stacked
seeds, dropout 0.1, bf16, ImageMaze and Gridverse.  On the card
``chip_smoke.py`` phase 22 holds graphed chunks against eager ones.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dtqn_tpu_torch.agents import Agent, AgentConfig
from dtqn_tpu_torch.envs import make_env
from dtqn_tpu_torch.ops import cuda_attention as ca
from dtqn_tpu_torch.train import loop
from dtqn_tpu_torch.utils import graphs
from dtqn_tpu_torch.utils.checkpoint import _leaves
from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule

UPDATES = 2
PREPOP_ITERS = 30
EPS = EpsilonSchedule(1.0, 0.1, 1_000)

# (env, AgentConfig fields, seeds); every env capped at 10 steps, so that
# episodes end during the prepopulation and the updates apply.
CONFIGS = {
    "flagless": ("DiscreteCarFlag-v0", {}, None),
    "bag": ("gv_memory.7x7.yaml", dict(model="DTQN-bag", bag_size=3), None),
    "bag_store": ("gv_memory.7x7.yaml",
                  dict(model="DTQN-bag", bag_size=3, bag_store=True), None),
    "drqn": ("Memory-5-v0", dict(model="DRQN"), None),
    "two_seeds": ("DiscreteCarFlag-v0", {}, [3, 4]),
    "dropout": ("DiscreteCarFlag-v0", dict(dropout=0.1), None),
    "bf16": ("DiscreteCarFlag-v0", dict(bf16=True), None),
    "image": ("ImageMaze-9-v0", {}, None),
    "gridverse": ("gv_memory.7x7.yaml", {}, None),
}

# Operations that read a device value on the host, make a tensor from
# Python data, or size their output by the data: none may run inside a
# captured iteration.
FORBIDDEN = ("aten._local_scalar_dense", "aten.lift_fresh",
             "aten.nonzero", "aten.masked_select", "aten.unique",
             "aten._unique", "aten.repeat_interleave.Tensor")


@pytest.fixture(autouse=True)
def one_thread():
    """These sizes gain nothing from intra-op threads; one keeps the tests
    from competing for the cores with the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def build(name):
    env_name, fields, seeds = CONFIGS[name]
    env = make_env(env_name)
    env.max_episode_steps = 10
    cfg = AgentConfig(**{**dict(
        num_envs=4, batch_size=4, context_len=8, history=8, inner_embed=16,
        num_heads=2, num_layers=1, buffer_size=400,
        target_update_frequency=5), **fields})
    agent = Agent(cfg, env, device="cpu")

    def fresh():
        return (agent.init_sweep_state(seeds) if seeds
                else agent.init_state(0))

    return agent, fresh


def tensor_leaves(state):
    return {k: v for k, v in _leaves(state) if isinstance(v, torch.Tensor)}


def generator_states(state):
    return {k: v.get_state() for k, v in _leaves(state)
            if isinstance(v, torch.Generator)}


def assert_states_equal(a, b):
    ta, tb = tensor_leaves(a), tensor_leaves(b)
    assert ta.keys() == tb.keys()
    differ = [k for k in ta if not torch.equal(ta[k], tb[k])]
    assert not differ, f"leaves differ: {differ}"
    ga, gb = generator_states(a), generator_states(b)
    assert ga.keys() == gb.keys() and ga
    assert all(torch.equal(ga[k], gb[k]) for k in ga)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_written_back_iterations_equal_eager_ones_in_place(name):
    agent, fresh = build(name)
    eager, wrapped = fresh(), fresh()
    loop.make_prepopulate_fn(agent, PREPOP_ITERS)(eager)
    prepop_step = graphs.write_back(loop.make_prepopulate_fn(agent, 1))
    storages = {k: v.untyped_storage().data_ptr()
                for k, v in tensor_leaves(wrapped).items()}
    leaves_before = tensor_leaves(wrapped)
    for _ in range(PREPOP_ITERS):
        prepop_step(wrapped)
    assert_states_equal(eager, wrapped)
    assert int(eager.buffer.flushed_total.min()) > agent.config.batch_size

    iteration = loop.make_train_chunk_fn(agent, EPS, UPDATES, 1)
    wrapped_iteration = graphs.write_back(iteration)
    for _ in range(3):
        iteration(eager)
        wrapped_iteration(wrapped)
        assert_states_equal(eager, wrapped)
        after = tensor_leaves(wrapped)
        assert all(after[k] is leaves_before[k] for k in after)
        assert {k: v.untyped_storage().data_ptr()
                for k, v in after.items()} == storages
    # Every update applied: the comparison covered real optimizer steps.
    applied = wrapped.train_steps.reshape(-1).tolist()
    assert applied == [3 * UPDATES] * len(applied)


class OpNames(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(str(func))
        self.calls += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_a_captured_iteration_reads_nothing_back_and_copies_nothing_in(name):
    agent, fresh = build(name)
    state = fresh()
    prepop_step = graphs.write_back(loop.make_prepopulate_fn(agent, 1))
    iteration = graphs.write_back(
        loop.make_train_chunk_fn(agent, EPS, UPDATES, 1))
    for _ in range(PREPOP_ITERS):
        prepop_step(state)
    iteration(state)  # the warm-up: constants are made here, once
    with OpNames() as ops:
        prepop_step(state)
        iteration(state)
    assert ops.calls > 100  # the mode saw the iteration's operations
    found = sorted(n for n in ops.names if n.startswith(FORBIDDEN))
    assert not found, f"{name}: {found} inside an iteration"


class NoCuda:
    """Every ``torch.cuda`` entry a graph would use, raising."""

    NAMES = ("CUDAGraph", "graph", "graph_pool_handle", "Stream", "stream",
             "current_stream", "synchronize")

    def __init__(self, monkeypatch):
        def refuse(*args, **kwargs):
            raise AssertionError("a CPU state reached torch.cuda")

        for name in self.NAMES:
            monkeypatch.setattr(torch.cuda, name, refuse)


@pytest.mark.parametrize("name", ["flagless", "two_seeds"])
def test_cpu_entry_points_are_the_plain_bodies(name, monkeypatch):
    agent, fresh = build(name)
    compiled, plain = fresh(), fresh()
    NoCuda(monkeypatch)
    prepopulate = loop.make_prepopulate(agent, PREPOP_ITERS)
    chunk = loop.make_train_chunk(agent, EPS, UPDATES, 2)
    assert not isinstance(prepopulate, graphs.GraphedStep)
    assert not isinstance(chunk, graphs.GraphedStep)
    prepopulate(compiled)
    chunk(compiled)
    chunk(compiled)
    loop.make_prepopulate_fn(agent, PREPOP_ITERS)(plain)
    loop.make_train_chunk_fn(agent, EPS, UPDATES, 4)(plain)
    assert_states_equal(compiled, plain)
    assert agent.graph_pool is None


class StandInGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replays_add_what_the_capture_counted(monkeypatch):
    monkeypatch.setitem(graphs.TRACKED_COUNTERS, "ledger", {})
    start = dict(ca.launch_counts)
    with graphs.counting_capture() as gains:
        # What the wrappers count while a capture records (no launch).
        ca.launch_counts["attention_fwd"] += 7
        ca.launch_counts["attention_bwd_bf16"] += 2
        graphs.TRACKED_COUNTERS["ledger"][("attention_fwd", 32)] = 7
    assert ca.launch_counts == start
    assert graphs.TRACKED_COUNTERS["ledger"] == {}
    graph = graphs.CountedGraph(StandInGraph(), gains)
    for _ in range(3):
        graph.replay()
    assert graph.graph.replays == 3
    assert graphs.TRACKED_COUNTERS["ledger"] == {("attention_fwd", 32): 21}
    # A fresh dict under the name gains from the next replay on.
    fresh = {}
    monkeypatch.setitem(graphs.TRACKED_COUNTERS, "ledger", fresh)
    graph.replay()
    assert fresh == {("attention_fwd", 32): 7}
    assert ca.launch_counts == {
        **start, "attention_fwd": start["attention_fwd"] + 28,
        "attention_bwd_bf16": start["attention_bwd_bf16"] + 8}
    ca.launch_counts.update(start)


def test_a_graph_is_replayed_while_the_leaves_stay_and_recaptured_after():
    agent, fresh = build("flagless")
    state = fresh()
    stepped = graphs.GraphedStep("step", lambda s: s, agent, times=4)
    captures = []

    def capture(st):  # a stand-in: the CPU cannot capture
        captures.append(st)
        stepped.graph = graphs.CountedGraph(StandInGraph(), {})
        stepped.bound = graphs.addresses(st)

    stepped.capture = capture
    stepped(state)
    stepped(state)
    assert len(captures) == 1 and stepped.graph.graph.replays == 3 + 4
    state.obs = state.obs.clone()  # a leaf moved: a graph of it is stale
    stepped(state)
    assert len(captures) == 2 and stepped.graph.graph.replays == 3
