"""Seeding helpers (``dtqn_tpu/utils/rng.py``).

The port draws from explicit ``torch.Generator`` objects that
``Agent.init_state`` builds from one integer seed (and checkpoints inside
``AgentState``), so seeding an experiment comes down to that integer; the
host-side python, numpy and torch global generators are seeded too, for any
host-side tooling.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int) -> int:
    """Seed the host generators and return the seed ``init_state`` takes."""
    random.seed(seed)
    np.random.seed(seed % (2**32 - 1))
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return int(seed)


def seed_count(generator) -> int:
    """1 for one generator; the number of seeds for a stacked run's list of
    per-seed generators."""
    return 1 if isinstance(generator, torch.Generator) else len(generator)


def folded_draw(generator, total: int, draw):
    """``draw(generator, total)`` for one generator.  For a list of S
    per-seed generators, each seed's ``draw(g, total // S)`` concatenated
    along the leading axis (the seed-major folded layout), so that seed i
    draws what a run of its own draws."""
    if isinstance(generator, torch.Generator):
        return draw(generator, total)
    share = total // len(generator)
    return torch.cat([draw(g, share) for g in generator])


def stacked_draw(generator, draw):
    """``draw(generator)`` for one generator; for per-seed generators each
    seed's draw, stacked along a new leading seed axis."""
    if isinstance(generator, torch.Generator):
        return draw(generator)
    return torch.stack([draw(g) for g in generator])
