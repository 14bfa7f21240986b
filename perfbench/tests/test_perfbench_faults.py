"""The comparison fails what it must: each fault a training cell can have,
planted in the program under a whole harness run at a tiny size on the
CPU (the look for a card skipped), and the control (the reference in the
program's place, its products in TF32) against the cells' limits."""

import dataclasses

import pytest
import torch

from perfbench import control, harness
from perfbench.registry import Benchmark

ALL = ["carflag_dtqn.s1", "carflag_dtqn.s5", "gv7x7_dtqn_bag25.s1",
       "gv7x7_dtqn_bag25.s5"]


def unchanged(prog):
    """A step that returns its state unchanged."""
    prog.chunk = prog.step = lambda state: state


def half_batch(prog):
    """Half of each batch left out, the mean taken over the rest (the
    first half, twice)."""
    agent = prog.agent
    sample = agent.sample_batch
    seeds = len(prog.seeds)

    def first_half(buffer, generator):
        batch = sample(buffer, generator)

        def halve(x):
            if x is None:
                return None
            x = x.reshape(seeds, -1, *x.shape[1:])
            x = x[:, :x.shape[1] // 2]
            return torch.cat([x, x], 1).reshape(-1, *x.shape[2:])

        return type(batch)(**{k: halve(v) for k, v in vars(batch).items()})

    agent.sample_batch = first_half


def reward_altered(prog):
    """An answer altered where it is produced: one env's reward."""
    env = prog.agent.env
    step = env.step_env

    def altered(generator, state, action):
        obs, new, reward, terminated, info = step(generator, state, action)
        return obs, new, reward + (torch.arange(reward.shape[0]) == 0) * 0.5, \
            terminated, info

    env.step_env = altered


def evict_skipped(prog):
    """The bag's evict choice altered: a full bag never takes the
    newcomer."""
    prog.agent._bag_evict = lambda network, context, bag, *rest: bag


def greedy_altered(prog):
    """An answer altered where it is produced: the greedy action, one
    past the argmax."""
    agent = prog.agent
    greedy = agent.greedy_actions
    actions = agent.env.num_actions

    def altered(*args, **kwargs):
        a, carry = greedy(*args, **kwargs)
        return (a + 1) % actions, carry

    agent.greedy_actions = altered


def target_never_swapped(prog):
    """The target network never takes the weights."""
    agent = prog.agent
    agent.config = dataclasses.replace(agent.config,
                                       target_update_frequency=2**30)


FAULTS = [(n, f) for n in ALL for f in (unchanged, half_batch,
                                        reward_altered, greedy_altered,
                                        target_never_swapped)]
FAULTS += [(n, evict_skipped) for n in ALL if n.startswith("gv")]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_planted_fault_is_not_correct(tiny, name, fault):
    cell = tiny(name, 2 if name.endswith("s5") else 1)
    res = harness.run_cell(Benchmark(), cell, 4_000_000_007, 0.0, False,
                           "cpu", 0.0, plant=fault)
    assert not res.correct, res.checks


@pytest.mark.parametrize("name", ALL)
def test_control_is_not_correct(tiny, name):
    cell = tiny(name, 2 if name.endswith("s5") else 1)
    out = control.readings(cell, 123456789012, ["tf32"], "cpu")
    assert out["correct"], out["checks"]
    assert not out["controls"]["tf32"]["correct"], out["controls"]
