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
