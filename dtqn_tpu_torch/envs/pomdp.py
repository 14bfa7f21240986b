"""Tabular POMDP engine and the classic domains (``dtqn_tpu/envs/pomdp.py``).

  1. ``TabularPOMDP``: a batched engine over dense (T, O, R) tables with
     terminal states and a start distribution.  A step is two categorical
     draws and a few gathers; the state is [E]-shaped tensors.
  2. ``make_heavenhell(n)``: the classic T-maze (heaven at one arm end, hell
     at the other, a priest at the stem end reveals the side).
  3. ``make_hallway()``: the JAX package's reconstruction of the Hallway
     navigation POMDP (60 states, 5 actions, 21 observations).  The
     registry loads ``data/hallway.pomdp`` instead where it finds it
     (``envs/__init__.py``).

The table makers are plain numpy, copied from the JAX package as they
are.  Draws are Gumbel-max over ``log(p + 1e-30)`` as
``jax.random.categorical`` makes them, so a zero-probability outcome is
never drawn; ``reset_with`` / ``step_with`` take the outcomes instead, so
a test can replay a JAX run's draws.  The episodic convention matches
gym-pomdps: an episode ends in a terminal state, and the observation is one
discrete index (obs shape (1,), int32).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dtqn_tpu_torch.envs.core import Environment, ObsKind
from dtqn_tpu_torch.utils.rng import sharded_draw

LOG_FLOOR = 1e-30  # log(p + LOG_FLOOR): a zero probability never wins


@dataclasses.dataclass
class TabularState:
    s: torch.Tensor  # [E] int32 hidden state index
    t: torch.Tensor  # [E] int32 step counter


def categorical(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Gumbel-max: per row, the index of the largest ``logits + g`` where
    ``g = -log(-log(u))`` for uniforms ``u`` in [tiny, 1), as
    ``jax.random.gumbel`` draws them.  g lies in [-4.5, 16.7], so an entry
    at ``log(1e-30)`` (-69) never beats one of probability above 1e-20."""
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def draw(generator: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """One categorical draw per row of ``logits`` (int64)."""
    u = sharded_draw(generator, logits.shape, lambda g, s: torch.rand(
        s, generator=g, device=logits.device))
    return categorical(logits, u.clamp_min_(torch.finfo(torch.float32).tiny))


class TabularPOMDP(Environment):
    """Episodic POMDP over dense tables, batched.

    T: [S, A, S] transition probabilities
    O: [A, S, Obs] observation probabilities given (action, next state)
    R: [S, A, S] rewards
    start: [S] initial state distribution
    terminal: [S] bool absorbing flags
    init_obs: [S, Obs] distribution of the reset observation given s0
    """

    obs_kind = ObsKind.DISCRETE
    obs_dtype = torch.int32

    def __init__(
        self,
        name: str,
        T: np.ndarray,
        O: np.ndarray,
        R: np.ndarray,
        start: np.ndarray,
        terminal: np.ndarray,
        init_obs: Optional[np.ndarray],
        max_episode_steps: int,
        success_reward_threshold: float = 0.0,
    ):
        S, A, _ = T.shape
        n_obs = O.shape[-1]
        self.name = name
        self.num_states = S
        self.num_actions = A
        self.num_obs = n_obs
        self.max_episode_steps = max_episode_steps
        self.obs_shape = (1,)
        self.success_reward_threshold = success_reward_threshold
        if init_obs is None:
            init_obs = np.full((S, n_obs), 1.0 / n_obs, np.float32)
        self.tables = {
            "T": np.asarray(T, np.float32),
            "O": np.asarray(O, np.float32),
            "R": np.asarray(R, np.float32),
            "start": np.asarray(start, np.float32),
            "terminal": np.asarray(terminal, bool),
            "init_obs": np.asarray(init_obs, np.float32),
        }
        self._constants: Dict[str, Dict[str, torch.Tensor]] = {}

    @property
    def obs_mask(self) -> float:
        # Discrete -> mask == n (env_processing.py:106-107).
        return float(self.num_obs)

    def _on(self, device) -> Dict[str, torch.Tensor]:
        """The tables on ``device``, made once per device; the probability
        tables as ``log(p + 1e-30)``, as the JAX engine draws from them."""
        key = str(device)
        if key not in self._constants:
            t = {k: torch.tensor(v, device=device)
                 for k, v in self.tables.items()}
            self._constants[key] = {
                "R": t["R"],
                "terminal": t["terminal"],
                **{f"log_{k}": torch.log(t[k] + LOG_FLOOR)
                   for k in ("T", "O", "start", "init_obs")},
            }
        return self._constants[key]

    def _own(self, s: torch.Tensor) -> torch.Tensor:
        """States clamped into this POMDP's range.  A multi-domain env steps
        every member on every lane and keeps each lane's own member's
        result; a lane of a larger member must not index out of range, as a
        JAX gather clamps."""
        return torch.clamp(s, max=self.num_states - 1)

    def reset_with(self, s: torch.Tensor,
                   obs: torch.Tensor) -> Tuple[torch.Tensor, TabularState]:
        """Fresh episodes from given outcomes: start states ``s`` [E] and
        first observations ``obs`` [E]."""
        state = TabularState(
            s=s.to(torch.int32),
            t=torch.zeros(s.shape, dtype=torch.int32, device=s.device),
        )
        return obs.to(torch.int32)[:, None], state

    def reset_env(self, generator, num_envs: int, device):
        c = self._on(device)
        s = draw(generator, c["log_start"].expand(num_envs, -1))
        return self.reset_with(s, draw(generator, c["log_init_obs"][s]))

    def step_with(self, state: TabularState, action: torch.Tensor,
                  s2: torch.Tensor, obs: torch.Tensor):
        """One step with given outcomes: next states ``s2`` [E] and
        observations ``obs`` [E].  Returns (obs, state, reward, terminated,
        info), as ``step_env``."""
        c = self._on(s2.device)
        s, a, s2 = (x.to(torch.int64)
                    for x in (self._own(state.s), action, s2))
        reward = c["R"][s, a, s2]
        new_state = TabularState(s=s2.to(torch.int32), t=state.t + 1)
        info = {"is_success": reward > self.success_reward_threshold}
        return (obs.to(torch.int32)[:, None], new_state, reward,
                c["terminal"][s2], info)

    def step_env(self, generator, state: TabularState, action):
        c = self._on(state.s.device)
        a = action.to(torch.int64)
        s = self._own(state.s).to(torch.int64)
        s2 = draw(generator, c["log_T"][s, a])
        obs = draw(generator, c["log_O"][a, s2])
        return self.step_with(state, action, s2, obs)


def make_heavenhell(n: int = 3, max_episode_steps: int = 40) -> TabularPOMDP:
    """HeavenHell T-maze with arm/stem length ``n``.

    Layout (positions): junction J at index 0; right arm 1..n (exit at n);
    left arm n+1..2n (exit at 2n); stem 2n+1..3n with the priest at 3n.
    Hidden state = position x heaven-side (2 sides).  The agent starts at
    the junction; at the priest cell the observation reveals the side.
    Actions: 0=right, 1=left, 2=down (into stem), 3=up (toward junction).
    Reaching heaven gives +1, hell -1; both terminal.  Deterministic.

    Observations: position index (0..3n), except the priest cell emits
    P + side with P = 3n+1, so there are P+2 observations.  Matches the
    classic Geffner-Bonet domain the reference uses via gym-pomdps.
    """
    P = 3 * n + 1  # positions
    S = 2 * P + 1  # + one absorbing state
    A = 4
    n_obs = P + 2  # positions (priest pos obs unused) + 2 priest obs
    absorbing = S - 1

    def pos_right(i):  # arm cells
        return 1 + i  # i in 0..n-1 -> position 1..n

    def pos_left(i):
        return n + 1 + i  # 0..n-1 -> n+1..2n

    def pos_stem(i):
        return 2 * n + 1 + i  # 0..n-1 -> 2n+1..3n

    priest = pos_stem(n - 1)

    def sid(pos, side):
        return side * P + pos

    T = np.zeros((S, A, S), np.float32)
    O = np.zeros((A, S, n_obs), np.float32)
    R = np.zeros((S, A, S), np.float32)
    terminal = np.zeros((S,), bool)
    terminal[absorbing] = True
    start = np.zeros((S,), np.float32)
    start[sid(0, 0)] = 0.5
    start[sid(0, 1)] = 0.5

    # Adjacency: next position for (pos, action); None = blocked (stay).
    def neighbor(pos, a):
        if pos == 0:  # junction
            return {0: pos_right(0), 1: pos_left(0), 2: pos_stem(0)}.get(a, pos)
        if 1 <= pos <= n:  # right arm; 0 further right, 1 back
            if a == 0:
                return pos + 1 if pos < n else pos  # exit handled separately
            if a == 1:
                return pos - 1 if pos > 1 else 0
            return pos
        if n + 1 <= pos <= 2 * n:  # left arm; 1 further left, 0 back
            i = pos - (n + 1)
            if a == 1:
                return pos + 1 if i < n - 1 else pos
            if a == 0:
                return pos - 1 if i > 0 else 0
            return pos
        # stem; 2 deeper, 3 back up
        i = pos - (2 * n + 1)
        if a == 2:
            return pos + 1 if i < n - 1 else pos
        if a == 3:
            return pos - 1 if i > 0 else 0
        return pos

    exit_right, exit_left = pos_right(n - 1), pos_left(n - 1)
    for side in (0, 1):  # side 0: heaven right; side 1: heaven left
        heaven_exit = exit_right if side == 0 else exit_left
        hell_exit = exit_left if side == 0 else exit_right
        for pos in range(P):
            s = sid(pos, side)
            for a in range(A):
                # Exits: stepping outward from the last arm cell terminates.
                if pos == exit_right and a == 0:
                    T[s, a, absorbing] = 1.0
                    R[s, a, absorbing] = 1.0 if side == 0 else -1.0
                    continue
                if pos == exit_left and a == 1:
                    T[s, a, absorbing] = 1.0
                    R[s, a, absorbing] = 1.0 if side == 1 else -1.0
                    continue
                T[s, a, sid(neighbor(pos, a), side)] = 1.0
        del heaven_exit, hell_exit

    T[absorbing, :, absorbing] = 1.0  # absorbing self-loop

    # Observations: deterministic position id; priest reveals the side.
    for side in (0, 1):
        for pos in range(P):
            s = sid(pos, side)
            o = (P + side) if pos == priest else pos
            O[:, s, o] = 1.0
    O[:, absorbing, 0] = 1.0  # never seen (terminal)

    init_obs = np.zeros((S, n_obs), np.float32)
    init_obs[:, 0] = 1.0  # start at junction -> obs 0

    return TabularPOMDP(
        name=f"POMDP-heavenhell_{n}-episodic-v0",
        T=T,
        O=O,
        R=R,
        start=start,
        terminal=terminal,
        init_obs=init_obs,
        max_episode_steps=max_episode_steps,
    )


def make_hallway(max_episode_steps: int = 100) -> TabularPOMDP:
    """Hallway navigation POMDP at the classic problem's dimensions.

    Littman, Cassandra & Kaelbling '95's Hallway is the benchmark the
    reference trains via gym-pomdps (the reference's README.md:102-103).
    The JAX package could not obtain the exact Cassandra tables, so this
    reconstruction matches every dimension the benchmark literature
    documents for the problem — **60 states** (15 cells x 4 orientations),
    **5 actions**, **21 observations**, +1 reward only on reaching the
    goal, uniform non-goal start, noisy actions AND noisy observations —
    and marks the structural details it had to choose as such below.

    Map (reconstructed from the published figure): an 11-cell corridor
    with 4 alcove cells hanging below corridor cells 2, 4, 6, 8; the goal
    is the star in the third alcove (below corridor cell 6).

    State = (cell, orientation N/E/S/W); the 4 goal-cell states are
    terminal (entering any of them pays +1) => 60 states total, no extra
    absorbing index.

    Actions 0=stay, 1=forward, 2=turn-right, 3=turn-left, 4=turn-around.
    Action noise (the paper describes actions as very noisy; exact values
    are a reconstruction choice): forward = 0.8 success / 0.1 stay /
    0.05 slip into each adjacent turn; turns = 0.9 success / 0.1 stay;
    stay is exact.

    Observations: 16 front/right/back/left wall configurations with
    0.95-correct per-bit noise; obs 16..19 identify each alcove when the
    agent stands in the corridor cell above it facing it (landmarks); obs
    20 is the goal star, seen in the goal alcove.  Landmark/star cells
    emit their special observation w.p. 0.9, else fall back to the noisy
    wall-config model.  => 21 observations.
    """
    CORRIDOR = 11
    ALCOVE_XS = [2, 4, 6, 8]
    cells = [(c, 0) for c in range(CORRIDOR)] + [(x, 1) for x in ALCOVE_XS]
    goal_cell = cells.index((6, 1))
    C = len(cells)  # 15
    DIRS = [(0, -1), (1, 0), (0, 1), (-1, 0)]  # N, E, S, W (y down)
    S = C * 4  # 60
    A = 5
    n_obs = 21
    OBS_STAR = 20
    alcove_of = {cells.index((x, 1)): k for k, x in enumerate(ALCOVE_XS)}

    cell_at = {xy: i for i, xy in enumerate(cells)}

    def sidx(cell, d):
        return cell * 4 + d

    T = np.zeros((S, A, S), np.float32)
    O = np.zeros((A, S, n_obs), np.float32)
    R = np.zeros((S, A, S), np.float32)
    terminal = np.zeros((S,), bool)
    for d in range(4):
        terminal[sidx(goal_cell, d)] = True

    def forward_cell(cell, d):
        x, y = cells[cell]
        dx, dy = DIRS[d]
        return cell_at.get((x + dx, y + dy))

    def add_move(s, a, cell, d, p):
        """Accumulate outcome (cell, d) w.p. p, paying +1 into the goal."""
        s2 = sidx(cell, d)
        T[s, a, s2] += p
        if cell == goal_cell:
            R[s, a, s2] = 1.0

    for cell in range(C):
        for d in range(4):
            s = sidx(cell, d)
            if terminal[s]:
                T[s, :, s] = 1.0  # never sampled from; keep rows stochastic
                continue
            # stay: exact
            T[s, 0, s] = 1.0
            # forward: 0.8 success / 0.1 stay / 0.05 slip into each turn
            tgt = forward_cell(cell, d)
            if tgt is None:
                add_move(s, 1, cell, d, 0.8 + 0.1)  # bump: stays
            else:
                add_move(s, 1, tgt, d, 0.8)
                add_move(s, 1, cell, d, 0.1)
            add_move(s, 1, cell, (d + 1) % 4, 0.05)
            add_move(s, 1, cell, (d + 3) % 4, 0.05)
            # turns: 0.9 success / 0.1 stay
            for a, nd in ((2, (d + 1) % 4), (3, (d + 3) % 4),
                          (4, (d + 2) % 4)):
                add_move(s, a, cell, nd, 0.9)
                add_move(s, a, cell, d, 0.1)

    # Observations.
    P_BIT = 0.95
    P_SPECIAL = 0.9
    for cell in range(C):
        for d in range(4):
            s = sidx(cell, d)
            walls = [
                forward_cell(cell, (d + k) % 4) is None for k in range(4)
            ]  # front, right, back, left relative bits
            wall_probs = np.zeros((n_obs,), np.float32)
            for o in range(16):
                p = 1.0
                for b in range(4):
                    bit = (o >> b) & 1
                    p *= P_BIT if bit == int(walls[b]) else 1.0 - P_BIT
                wall_probs[o] = p
            special = None
            if cell == goal_cell:
                special = OBS_STAR
            elif cell in alcove_of and cell != goal_cell:
                pass  # non-goal alcoves look like dead ends (walls only)
            else:
                # Corridor cell above an alcove, facing it (south):
                # landmark identifying WHICH alcove.
                below = forward_cell(cell, 2)
                if below is not None and below in alcove_of and d == 2:
                    special = 16 + alcove_of[below]
            if special is None:
                O[:, s] = wall_probs
            else:
                O[:, s] = (1.0 - P_SPECIAL) * wall_probs
                O[:, s, special] += P_SPECIAL

    start = np.zeros((S,), np.float32)
    for cell in range(C):
        if cell == goal_cell:
            continue
        for d in range(4):
            start[sidx(cell, d)] = 1.0
    start /= start.sum()

    init_obs = np.asarray(O[0], np.float32)

    return TabularPOMDP(
        name="POMDP-hallway-episodic-v0",
        T=T,
        O=O,
        R=R,
        start=start,
        terminal=terminal,
        init_obs=init_obs,
        max_episode_steps=max_episode_steps,
    )
