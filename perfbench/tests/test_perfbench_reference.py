"""The plain reference against the program at tiny sizes on the CPU: the
harness's own comparison reads no difference but rounding."""

import pytest
import torch

from perfbench import compare, harness
from perfbench.program import Program
from perfbench.reference.envs import make_env
from perfbench.reference.precision import Precision
from perfbench.registry import Benchmark

CELLS = [("carflag_dtqn.s1", 1), ("carflag_dtqn.s5", 2),
         ("gv7x7_dtqn_bag25.s1", 1), ("gv7x7_dtqn_bag25.s5", 2)]


@pytest.mark.parametrize("name,seeds", CELLS)
def test_run_agrees_with_reference(tiny, name, seeds):
    cell = tiny(name, seeds)
    res = harness.run_cell(Benchmark(), cell, 2**31 + 11, 0.0, False, "cpu",
                           0.0)
    values = {k: c["value"] for k, c in res.checks.items()}
    assert res.failed == 0
    assert values["replay_mismatch"] == 0, res.notes
    assert values["late_mismatch"] == 0, res.notes
    for k in ("loss_gap", "gnorm_gap", "moment_gap", "param_change_gap",
              "late_loss_gap", "late_gnorm_gap", "target_gap"):
        assert values[k] < 1e-5, (k, values[k])
    # The late stage acted greedily somewhere, and swapped the target.
    assert not any(n.startswith("late: 0 greedy") for n in res.notes)
    if cell.config["bag_size"]:
        assert values["evict_regret"] < 1e-6
    assert res.correct


@pytest.mark.parametrize("name", ["carflag_dtqn.s1", "gv7x7_dtqn_bag25.s1"])
def test_forward_agrees_with_program(tiny, name):
    """Q of the same windows and weights: the program's network against
    the plain forward of the configuration's reference module."""
    cell = tiny(name)
    cfg, model = cell.config, cell.family.reference
    env = make_env(cfg["env"])
    prog = Program(cfg, cell.traffic, [5], "cpu")
    weights = harness.make_weights(cfg, env, 1, 5, "cpu", model)
    prog.set_weights(weights)
    ctx = prog.state.context
    g = torch.Generator().manual_seed(3)
    bag = None
    if cfg["bag_size"]:
        bag = torch.randint(0, int(env.obs_mask) + 1,
                            (ctx.obs.shape[0], cfg["bag_size"], 6),
                            generator=g, dtype=torch.int32)
    with torch.no_grad():
        ours = prog.state.network(ctx.obs, ctx.action,
                                  *(() if bag is None else
                                    (bag, torch.zeros_like(bag[..., 0]))))
        with Precision() as prec:
            plain = model.Net(cfg, env, prec)(
                weights, ctx.obs[None], None if bag is None else bag[None])[0]
    torch.testing.assert_close(ours, plain, rtol=1e-5, atol=1e-6)


def test_target_gap_over_the_leaves_the_reference_moved():
    """A seed whose network trains only its output bias moves one leaf of
    its target at a swap: the gap is read over that leaf, a target left
    unmoved reads 1, and a seed without a swap has to stay exact."""
    before = {"target.a": torch.zeros(2, 3), "target.b": torch.zeros(2, 4),
              "target.c": torch.zeros(2, 5)}
    ref = {"target.a": torch.tensor([[1.0, 0, 0], [0, 0, 0]]),
           "target.b": torch.tensor([[0.0] * 4, [2.0, 0, 0, 0]]),
           "target.c": torch.tensor([[0.0] * 5, [0, 3.0, 0, 0, 0]])}
    assert compare.target_gap(ref, ref, before, []) == 0.0
    near = {k: v * (1 + 1e-6) for k, v in ref.items()}
    assert 0 < compare.target_gap(near, ref, before, []) < 1e-5
    assert compare.target_gap(before, ref, before, []) == 1.0
    unmoved = {k: torch.zeros_like(v) for k, v in before.items()}
    assert compare.target_gap(before, unmoved, before, []) == 0.0
    assert compare.target_gap(ref, unmoved, before, []) == float("inf")


def test_one_update_off_moves_the_median_of_the_first_updates_not():
    """A near-tie argmax that goes the other way moves one update's loss:
    the stage's reading is the median of its first updates, and a gap in
    two of them, as a fault or a lower precision makes, reads in full."""
    ref = {"losses": torch.tensor([[1.0, 2.0, 3.0, 4.0]] * 2)}
    one = {"losses": ref["losses"].clone()}
    one["losses"][1, 1] *= 1.01
    notes = []
    assert compare.first_updates_gap(one, ref, "losses", 4, notes,
                                     "replay: loss gap") == 0.0
    head, worst = notes[0].rsplit(" ", 1)
    assert head == "replay: loss gap: worst of the first 3 updates"
    assert float(worst) == pytest.approx(0.01)
    two = {"losses": one["losses"].clone()}
    two["losses"][1, 2] *= 1.02
    assert compare.first_updates_gap(two, ref, "losses", 4, [], "x") == \
        pytest.approx(0.01)


def test_a_null_limit_reads_the_number_and_compares_it_not():
    """A number whose limit is null is read and noted, not compared; a
    number without a limit entry, or a limit without its number, fails."""
    limits = {"loss_gap": 1e-5, "moment_gap": None}
    assert compare.judge({"loss_gap": 1e-6, "moment_gap": 0.9}, limits)
    assert not compare.judge({"loss_gap": 1e-4, "moment_gap": 0.0}, limits)
    assert not compare.judge({"loss_gap": 1e-6}, limits)
    assert not compare.judge({"loss_gap": 1e-6, "moment_gap": 0.0,
                              "gnorm_gap": 0.0}, limits)
    checks, notes = compare.checks({"loss_gap": 1e-6, "moment_gap": 0.9},
                                   limits)
    assert checks == {"loss_gap": {"value": 1e-6, "limit": 1e-5}}
    assert notes == ["not compared: moment_gap 0.9"]
