"""The port's tracing (``utils/profiling.py``) on the CPU, at narrow widths.

- With tracing on, an eager iteration opens the phases' host spans in the
  order the step runs them: ``act``, ``env``, ``replay_write`` (with a bag
  split around ``evict``), the resets' ``replay_write``, then ``sample``
  and ``update`` once per update.
- With tracing off, ``phase`` is one shared null context and no ``dtqn.*``
  span opens.
- Tracing leaves the state after an iteration bit for bit as it is without.
- Boundaries are flat, each is an event of its own, and they read back by
  name (``phase_ms``); a graphed step reads its last replay's and opens no
  span of its own around a replay.

On the card ``chip_smoke.py`` phase 23 holds graphed iterations with the
marks recorded against ones without.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dtqn_tpu_torch.agents import Agent, AgentConfig
from dtqn_tpu_torch.envs import make_env
from dtqn_tpu_torch.train import loop
from dtqn_tpu_torch.utils import graphs, profiling
from dtqn_tpu_torch.utils.checkpoint import _leaves
from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule

UPDATES = 2
CONFIGS = {
    "flagless": ("DiscreteCarFlag-v0", {}),
    "bag": ("gv_memory.7x7.yaml", dict(model="DTQN-bag", bag_size=3)),
}
ORDER = {
    "flagless": ["act", "env", "replay_write", "replay_write",
                 "replay_write"] + ["sample", "update"] * UPDATES,
    "bag": ["act", "env", "replay_write", "evict", "replay_write",
            "replay_write"] + ["sample", "update"] * UPDATES,
}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def iteration(name):
    """A tiny agent's fresh state, prepopulated until episodes end, and its
    one-iteration train chunk (the plain body)."""
    env_name, fields = CONFIGS[name]
    env = make_env(env_name)
    env.max_episode_steps = 10
    agent = Agent(AgentConfig(**{**dict(
        num_envs=4, batch_size=4, context_len=8, history=8, inner_embed=16,
        num_heads=2, num_layers=1, buffer_size=200,
        target_update_frequency=5), **fields}), env, device="cpu")
    state = agent.init_state(0)
    loop.make_prepopulate_fn(agent, 24)(state)
    chunk = loop.make_train_chunk_fn(agent, EpsilonSchedule(1.0, 0.1, 100),
                                     UPDATES, 1)
    return state, chunk


def spans(run):
    """The ``dtqn.*`` host spans that ``run()`` opens, in order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    events = sorted((e for e in prof.events()
                     if e.name.startswith(profiling.PREFIX)),
                    key=lambda e: e.time_range.start)
    return [e.name[len(profiling.PREFIX):] for e in events]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_an_iteration_opens_the_phases_in_order(name):
    state, chunk = iteration(name)
    with profiling.tracing_on():
        seen = spans(lambda: chunk(state))
    assert seen == ORDER[name]


def test_tracing_off_opens_nothing():
    assert not profiling.tracing()
    assert profiling.phase("act") is profiling.phase("update")
    state, chunk = iteration("bag")
    assert spans(lambda: chunk(state)) == []


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tracing_leaves_the_state_as_it_is(name):
    (off, chunk), (on, _) = iteration(name), iteration(name)
    chunk(off)
    with profiling.tracing_on():
        chunk(on)
    a, b = dict(_leaves(off)), dict(_leaves(on))
    assert a.keys() == b.keys()
    differ = [k for k, v in a.items() if not (
        torch.equal(v.get_state(), b[k].get_state())
        if isinstance(v, torch.Generator) else torch.equal(v, b[k]))]
    assert not differ and int(off.train_steps) == UPDATES


class StandInEvent:
    """An event whose time is the count of events and of ``work`` calls
    before it (ms)."""

    made = 0

    def __init__(self):
        self.t = StandInEvent.made
        StandInEvent.made += 1
        self.synced = False

    def elapsed_time(self, end):
        return float(end.t - self.t)

    def synchronize(self):
        self.synced = True


def work():
    StandInEvent.made += 1


@pytest.fixture
def stand_in_events(monkeypatch):
    StandInEvent.made = 0
    monkeypatch.setattr(profiling, "_new_event", StandInEvent)


def test_boundaries_are_flat_shared_and_read_by_name(stand_in_events):
    with profiling.recording_phases() as marks:
        with profiling.phase("act"):
            work()
    assert marks == []  # tracing off: no boundary
    StandInEvent.made = 0
    with profiling.tracing_on(), profiling.recording_phases() as marks:
        with profiling.phase("act"):
            work()
        with profiling.phase("replay_write"):
            work()
            with profiling.phase("evict"):
                work()
        work()  # outside every phase
        with profiling.phase("update"):
            work()
    # An event a boundary; the work, one ms each, falls in the interval of
    # the phase around it, and an exit followed at once by an entry leaves
    # an ``other`` interval of the event's own ms.
    assert [(n, e.t) for n, e in marks] == [
        ("other", 0), ("act", 1), ("other", 3), ("replay_write", 4),
        ("evict", 6), ("replay_write", 8), ("other", 9), ("update", 11),
        ("other", 13), (None, 14)]
    assert profiling.phase_ms(marks) == {
        "phases": {"other": 5.0, "act": 2.0, "replay_write": 3.0,
                   "evict": 2.0, "update": 2.0},
        "replay": 14.0}


class StandInGraph:
    def replay(self):
        pass


def test_a_graphed_step_spans_its_replays_and_reads_the_last(
        stand_in_events):
    stepped = graphs.GraphedStep("step", lambda s: s, None, times=3)

    def capture(st):  # a stand-in: the CPU cannot capture
        with profiling.recording_phases() as marks:
            work()
            with profiling.phase("update"):
                work()
        stepped.graph = graphs.CountedGraph(StandInGraph(), {}, marks)
        stepped.bound = graphs.addresses(st)
        stepped.replayed = False

    stepped.capture = capture
    state, _ = iteration("flagless")
    with profiling.tracing_on():
        # The capture runs the step (its phase); the two replays run no
        # Python and open no span.
        assert spans(lambda: stepped(state)) == ["update"]
    assert stepped.phase_ms() == {
        "phases": {"other": 3.0, "update": 2.0}, "replay": 5.0}
    assert stepped.graph.marks[-1][1].synced
    stepped.times = 1
    stepped.bound = None  # captured anew, not replayed: nothing to read
    stepped(state)
    assert stepped.phase_ms() is None
    assert spans(lambda: stepped(state)) == []  # tracing off
