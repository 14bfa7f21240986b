"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
``card`` that run only where a CUDA device is (they skip elsewhere, from a
fixture).  Run from the repository's root:

    python3 -m pytest perfbench/tests -q
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100 the benchmark runs on)")
    return torch.device("cuda")


# Epsilon anneals and the target swaps within a few iterations, so that
# the late stage has greedy actions and a swap to compare.
TINY = dict(inner_embed=16, num_heads=2, num_layers=1, context_len=8,
            history=8, batch_size=4, buffer_size=4000, num_envs=4,
            prepop_steps=1700, eps_duration=40, target_update=12)


# At the tiny size on the CPU the program runs the plain versions of its
# kernels, and agrees with the reference to about 3e-7 (its sums in
# another order); the cells' limits are set for the card at full size.
TINY_LIMITS = dict(start_mismatch=0, replay_mismatch=0, start_loss_gap=1e-5,
                   start_gnorm_gap=1e-5, loss_gap=1e-5, gnorm_gap=1e-5,
                   moment_gap=1e-5, param_change_gap=1e-5, late_mismatch=0,
                   late_loss_gap=1e-5, late_gnorm_gap=1e-5, target_gap=1e-4)


def tiny_cell(name: str, seeds: int = 1):
    """``name``'s cell at a size a CPU test holds: every width cut, the
    same code paths (a bag of 3 where the cell has one), the CPU's
    limits."""
    from perfbench.registry import Benchmark

    cell = Benchmark().cell(name)
    cell.config.update(TINY, bag_size=min(cell.config["bag_size"], 3))
    cell.limits = dict(TINY_LIMITS)
    if cell.config["bag_size"]:
        cell.limits["evict_regret"] = 1e-7
    cell.traffic.update(seeds=seeds, iters_per_chunk=2)
    return cell


@pytest.fixture
def tiny():
    return tiny_cell


def pytest_sessionstart(session):
    # Several workers share the machine: a few threads each.
    import torch

    torch.set_num_threads(2)
