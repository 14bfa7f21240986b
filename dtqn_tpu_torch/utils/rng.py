"""Seeding helpers (``dtqn_tpu/utils/rng.py``).

The port draws from explicit ``torch.Generator`` objects that
``Agent.init_state`` builds from one integer seed (and checkpoints inside
``AgentState``), so seeding an experiment comes down to that integer; the
host-side python, numpy and torch global generators are seeded too, for any
host-side tooling.

A run sharded over the ranks of a mesh (``parallel/mesh.py``) holds one
generator, replicated in the same state on every rank.  Its draws over the
envs go through ``ShardedGenerator``: each draws the global shape, as the
one-device run does, and keeps the rank's block of the env axis, so the
generator advances exactly as it does in the one-device run.
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Any, Sequence

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


@dataclasses.dataclass(frozen=True)
class ShardedGenerator:
    """The replicated generator of a sharded run, passed where a draw has
    an env axis: ``mesh`` (its ``rank`` and ``size``) says which block of
    that axis this rank keeps."""

    generator: torch.Generator
    mesh: Any


def sharded_draw(generator, shape: Sequence[int], draw, env_axis: int = 0):
    """``draw(generator, shape)``, where ``shape[env_axis]`` counts this
    process's envs.  With a ``ShardedGenerator`` over a mesh of N ranks,
    the draw of the global shape (N times as many envs) and this rank's
    block of it along ``env_axis``."""
    if not isinstance(generator, ShardedGenerator):
        return draw(generator, tuple(shape))
    mesh = generator.mesh
    full = list(shape)
    full[env_axis] *= mesh.size
    return draw(generator.generator, tuple(full)).chunk(
        mesh.size, dim=env_axis)[mesh.rank]


def folded_draw(generator, total: int, draw):
    """``draw(generator, total)`` for one generator.  For a list of S
    per-seed generators, each seed's ``draw(g, total // S)`` concatenated
    along the leading axis (the seed-major folded layout), so that seed i
    draws what a run of its own draws.  For a ``ShardedGenerator``,
    ``total`` is this rank's share of the leading axis (``sharded_draw``)."""
    if isinstance(generator, torch.Generator):
        return draw(generator, total)
    if isinstance(generator, ShardedGenerator):
        return sharded_draw(generator, (total,), lambda g, s: draw(g, s[0]))
    share = total // len(generator)
    return torch.cat([draw(g, share) for g in generator])


def stacked_draw(generator, draw):
    """``draw(generator)`` for one generator; for per-seed generators each
    seed's draw, stacked along a new leading seed axis."""
    if isinstance(generator, torch.Generator):
        return draw(generator)
    return torch.stack([draw(g) for g in generator])
