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


# At the tiny size on the CPU the program runs the plain versions of its
# kernels, and agrees with the reference to about 3e-7 (its sums in
# another order); the cells' limits are set for the card at full size.
# Here every number a cell reads is compared, also one its card limits
# leave uncompared (null): a few updates at the tiny size hold no chaos.
TINY_LIMITS = dict(start_mismatch=0, replay_mismatch=0, start_loss_gap=1e-5,
                   start_gnorm_gap=1e-5, loss_gap=1e-5, gnorm_gap=1e-5,
                   moment_gap=1e-5, param_change_gap=1e-5, late_mismatch=0,
                   late_loss_gap=1e-5, late_gnorm_gap=1e-5, target_gap=1e-4,
                   evict_regret=1e-7)


def tiny_cell(name: str, seeds: int = 1, bench=None):
    """``name``'s cell (of ``bench``, by default the repository's) at a
    size a CPU test holds: each key of its network family's ``TINY`` at
    most that size, the same code paths, the CPU's limits for the numbers
    the cell compares."""
    from perfbench.registry import Benchmark

    cell = (bench or Benchmark()).cell(name)
    cfg = cell.config
    cfg.update({k: min(cfg[k], v)
                for k, v in cell.family.reference.TINY.items()})
    cell.limits = {k: TINY_LIMITS[k] for k in cell.limits}
    cell.traffic.update(seeds=seeds, iters_per_chunk=2)
    return cell


@pytest.fixture
def tiny():
    return tiny_cell


def pytest_sessionstart(session):
    # Several workers share the machine: a few threads each.
    import torch

    torch.set_num_threads(2)
