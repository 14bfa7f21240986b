"""Gridverse memory tasks, batched (``dtqn_tpu/envs/gridverse.py``).

The task semantics of the reference's ``gv_memory.*.yaml`` configs
(`gv_memory.5x5.yaml:17-38`):

  - an NxN room bounded by walls; two EXITs of distinct colors in the top
    interior corners; one BEACON whose color marks the correct exit
  - actions: MOVE_FORWARD/BACKWARD/LEFT/RIGHT, TURN_LEFT/RIGHT (6)
  - rewards: reach_exit_memory +5 / -5 (correct/wrong exit) plus a -0.05
    living reward per step; terminating on any exit
  - observation: a 2x3 egocentric partially-occluded window
    (area [[-1,0],[-1,1]]): ahead-corner cells are hidden when both
    adjacent cells toward them are walls; out-of-grid cells are hidden
  - a 250-step time limit (env_processing.py:54)

The four-rooms variants (`gv_memory_four_rooms.{7x7,9x9}.yaml`) add
internal cross walls with four doorways and randomized exit/beacon corners.

Cell encoding: token = object_type * 5 + color, with types {hidden=0,
floor=1, wall=2, exit=3, beacon=4} and colors {none=0, red, green, blue,
yellow}; the observation is the flattened [2, 3] window, a
MultiDiscrete-like int32 vector of length 6 with vocabulary 25.

Grids can be padded to a larger static shape (``pad_to``) so different
sizes share one state structure.

Reconstruction-ablation variants, each a ``+``-suffix on the env name
(e.g. ``gv_memory.7x7.yaml+fspawn+walkbeacon``), so arms get distinct run
names and CSVs:

  - ``walkbeacon``: the beacon does not block movement
  - ``sumenc``: cell token = global_type_index + color_index, the reference
    wrapper's channel-sum encoding (gv_wrapper.py:25-30) with
    gym-gridverse's object registry indices {Hidden:1, Floor:2, Wall:3,
    Exit:4, Beacon:10} and vocabulary 21
  - ``fspawn``: the agent spawns on a floor cell adjacent to the beacon,
    facing it (the beacon's color is visible at t=0)
  - ``oracle``: appends the good color as a 7th observation token every
    step (diagnostic upper bound: no memory needed)

Every function works on a batch of envs: the state is a dataclass of
[E, ...] tensors on the device.  The random outcomes of a reset come from
one ``rand`` each (a sort order, an ``argmax`` or a comparison), and
``reset_with`` builds the episodes from given outcomes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from dtqn_tpu_torch.envs.core import Environment, ObsKind
from dtqn_tpu_torch.utils.rng import sharded_draw

# Object types
HIDDEN, FLOOR, WALL, EXIT, BEACON = 0, 1, 2, 3, 4
NUM_COLORS = 5  # none, red, green, blue, yellow
NUM_TYPES = 5
VOCAB = NUM_TYPES * NUM_COLORS  # 25 tokens

# ``sumenc`` variant: gym-gridverse global object-registry indices for the
# type channel (NoneGridObject=0, Hidden=1, Floor=2, Wall=3, Exit=4, ...,
# Beacon=10); the wrapper sums type + color channels and sizes the
# MultiDiscrete vocab as high.max()*2+1 with high = Beacon's index 10.
SUM_TYPE_IDX = (1, 2, 3, 4, 10)  # by object type
SUM_HIDDEN_TOKEN = 1  # Hidden + Color.NONE
SUM_VOCAB = 10 * 2 + 1  # 21

# (dy, dx) for orientations N, E, S, W
DIRS = ((-1, 0), (0, 1), (1, 0), (0, -1))

MOVE_FORWARD, MOVE_BACKWARD, MOVE_LEFT, MOVE_RIGHT, TURN_LEFT, TURN_RIGHT = (
    range(6)
)
# Per action: the move's share of the forward and of the right-hand unit
# vector, and the quarter turns clockwise.
MOVE_FWD = (1, -1, 0, 0, 0, 0)
MOVE_RIGHT_OF = (0, 0, -1, 1, 0, 0)
TURN = (0, 0, 0, 0, 3, 1)
# The 2x3 window's cells as (forward, lateral): row 0 ahead, row 1 the
# agent's own row.
WINDOW_FWD = (1, 1, 1, 0, 0, 0)
WINDOW_LAT = (-1, 0, 1, -1, 0, 1)
# ``fspawn``: the beacon's four neighbours, and the direction that faces
# the beacon from above / below / left / right (S / N / E / W).
SPAWN_OFFSETS = ((-1, 0), (1, 0), (0, -1), (0, 1))
SPAWN_FACING = (2, 0, 1, 3)


@dataclasses.dataclass
class GridverseState:
    grid_type: torch.Tensor  # [E, P, P] int32
    grid_color: torch.Tensor  # [E, P, P] int32
    good_color: torch.Tensor  # [E] int32: the beacon's color
    pos: torch.Tensor  # [E, 2] int32 (y, x)
    direction: torch.Tensor  # [E] int32 0..3
    t: torch.Tensor  # [E] int32


class GridverseMemory(Environment):
    """gv_memory.NxN (and the four-rooms variant)."""

    obs_kind = ObsKind.DISCRETE
    obs_dtype = torch.int32
    num_actions = 6

    def __init__(
        self,
        size: int,
        four_rooms: bool = False,
        max_episode_steps: int = 250,
        pad_to: Optional[int] = None,
        beacon_blocks: bool = True,
        sum_encoding: bool = False,
        front_spawn: bool = False,
        oracle: bool = False,
    ):
        if size < 5 or size % 2 == 0:
            raise ValueError("gridverse memory sizes are odd and >= 5")
        self.size = size
        self.pad = pad_to or size
        if self.pad < size:
            raise ValueError("pad_to must be >= size")
        self.four_rooms = four_rooms
        self.beacon_blocks = beacon_blocks
        self.sum_encoding = sum_encoding
        self.front_spawn = front_spawn
        self.oracle = oracle
        variant = "gv_memory_four_rooms" if four_rooms else "gv_memory"
        suffix = "".join(
            tag
            for tag, on in (
                ("+walkbeacon", not beacon_blocks),
                ("+sumenc", sum_encoding),
                ("+fspawn", front_spawn),
                ("+oracle", oracle),
            )
            if on
        )
        self.name = f"{variant}.{size}x{size}.yaml{suffix}"
        self.max_episode_steps = max_episode_steps
        # Flattened 2x3 window (+1 oracle token).
        self.obs_shape = (7,) if oracle else (6,)
        self._constants: Dict[str, Dict[str, torch.Tensor]] = {}

    @property
    def obs_mask(self) -> float:
        # MultiDiscrete rule: max token + 1 (env_processing.py:108-109).
        return float(SUM_VOCAB if self.sum_encoding else VOCAB)

    # ------------------------------------------------------------- building
    def _base_grid(self, device) -> torch.Tensor:
        """The empty room's object types, [P, P] int32."""
        n, p = self.size, self.pad
        yy, xx = torch.meshgrid(
            torch.arange(p, device=device), torch.arange(p, device=device),
            indexing="ij",
        )
        border = (yy == 0) | (xx == 0) | (yy == n - 1) | (xx == n - 1)
        outside = (yy >= n) | (xx >= n)
        gtype = torch.where(border | outside, WALL, FLOOR)
        if self.four_rooms:
            mid = n // 2
            cross = (yy == mid) | (xx == mid)
            # Doorways at the middle of each half-wall.
            q1, q3 = mid // 2, mid + (n - mid) // 2
            doors = (
                ((yy == mid) & ((xx == q1) | (xx == q3)))
                | ((xx == mid) & ((yy == q1) | (yy == q3)))
            )
            gtype = torch.where(cross & ~doors & ~border & ~outside, WALL,
                                gtype)
        return gtype.to(torch.int32)

    def _on(self, device) -> Dict[str, torch.Tensor]:
        """The env's constant tables on ``device``, made once per device."""
        key = str(device)
        if key not in self._constants:
            def table(values):
                return torch.tensor(values, dtype=torch.int32, device=device)

            n = self.size
            self._constants[key] = {
                "base_grid": self._base_grid(device),
                "dirs": table(DIRS),
                "move_fwd": table(MOVE_FWD),
                "move_right": table(MOVE_RIGHT_OF),
                "turn": table(TURN),
                "window_fwd": table(WINDOW_FWD),
                "window_lat": table(WINDOW_LAT),
                "spawn_offsets": table(SPAWN_OFFSETS),
                "spawn_facing": table(SPAWN_FACING),
                "sum_type_idx": table(SUM_TYPE_IDX),
                "corners": table(
                    [[1, 1], [1, n - 2], [n - 2, 1], [n - 2, n - 2]]
                ),
                # The one-room layout's exits and beacon, in that order.
                "fixed": table([[1, 1], [1, n - 2], [n - 2, n // 2]]),
                "exit": table(EXIT),
                "beacon": table(BEACON),
            }
        return self._constants[key]

    def _place(self, colors, swap, corner_order):
        """The grids with both exits and the beacon placed: (grid_type,
        grid_color, good_color, beacon_pos)."""
        device = colors.device
        c = self._on(device)
        p = self.pad
        e = colors.shape[0]
        e_idx = torch.arange(e, device=device)
        colors = 1 + colors.to(torch.int32)
        good, bad = colors[:, 0], colors[:, 1]

        if self.four_rooms:
            # Exits occupy two random distinct corners; beacon a third.
            placed = c["corners"][corner_order.to(torch.int64)]  # [E, 3, 2]
            exit_a, exit_b, beacon_pos = placed.unbind(dim=1)
        else:
            exit_a, exit_b, beacon_pos = c["fixed"][:, None].expand(3, e, 2)

        # Which exit is the good one.
        good_exit = torch.where(swap[:, None], exit_b, exit_a).to(torch.int64)
        bad_exit = torch.where(swap[:, None], exit_a, exit_b).to(torch.int64)
        beacon = beacon_pos.to(torch.int64)

        gtype = c["base_grid"].expand(e, p, p).clone()
        gcolor = torch.zeros((e, p, p), dtype=torch.int32, device=device)
        gtype[e_idx, good_exit[:, 0], good_exit[:, 1]] = c["exit"]
        gtype[e_idx, bad_exit[:, 0], bad_exit[:, 1]] = c["exit"]
        gtype[e_idx, beacon[:, 0], beacon[:, 1]] = c["beacon"]
        gcolor[e_idx, good_exit[:, 0], good_exit[:, 1]] = good
        gcolor[e_idx, bad_exit[:, 0], bad_exit[:, 1]] = bad
        gcolor[e_idx, beacon[:, 0], beacon[:, 1]] = good
        return gtype, gcolor, good, beacon_pos

    def _beacon_neighbours(self, beacon_pos) -> torch.Tensor:
        """[E, 4, 2] int64: the cells above, below, left and right of the
        beacon, clipped into the grid."""
        offsets = self._on(beacon_pos.device)["spawn_offsets"]
        return torch.clamp(
            beacon_pos[:, None, :] + offsets[None], 0, self.pad - 1
        ).to(torch.int64)

    def _spawn(self, gtype, gcolor, good, beacon_pos, spawn, direction):
        """Puts the agent into placed grids: (obs, state)."""
        c = self._on(gtype.device)
        e, p = gtype.shape[0], self.pad
        spawn = spawn.to(torch.int64)
        if self.front_spawn:
            e_idx = torch.arange(e, device=gtype.device)
            pos = self._beacon_neighbours(beacon_pos)[e_idx, spawn]
            direction = c["spawn_facing"][spawn]
        else:
            pos = torch.stack([spawn // p, spawn % p], dim=-1)
        state = GridverseState(
            grid_type=gtype,
            grid_color=gcolor,
            good_color=good,
            pos=pos.to(torch.int32),
            direction=direction.to(torch.int32),
            t=torch.zeros((e,), dtype=torch.int32, device=gtype.device),
        )
        return self._observe(state), state

    def reset_with(
        self,
        colors: torch.Tensor,
        swap: torch.Tensor,
        spawn: torch.Tensor,
        direction: Optional[torch.Tensor] = None,
        corner_order: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, GridverseState]:
        """Fresh episodes from given random outcomes, on their device.

        ``colors`` [E, 2]: two distinct draws from 0..3, the good and the
        bad exit's color less one.  ``swap`` [E] bool: the second exit is
        the good one.  ``corner_order`` [E, 3] (four rooms only): the
        corners, of 0..3, of the first exit, the second exit and the
        beacon.  ``spawn`` [E]: the agent's cell as y * pad + x, with
        ``direction`` [E] in 0..3; under ``fspawn`` the beacon's neighbour
        (up, down, left, right) it stands on, facing the beacon.
        """
        return self._spawn(*self._place(colors, swap, corner_order), spawn,
                           direction)

    def reset_env(self, generator, num_envs: int, device):
        e = num_envs

        def rand(*shape):
            return sharded_draw(generator, shape, lambda g, s: torch.rand(
                s, generator=g, device=device))

        # Two distinct exit colors from {red..yellow}: the first two of a
        # uniform shuffle (the sort order of one draw per color); the three
        # corners of the four-rooms variant likewise.
        colors = torch.argsort(rand(e, 4), dim=-1)[:, :2]
        swap = rand(e) < 0.5
        corner_order = (
            torch.argsort(rand(e, 4), dim=-1)[:, :3]
            if self.four_rooms
            else None
        )
        gtype, gcolor, good, beacon_pos = self._place(colors, swap,
                                                      corner_order)
        # The agent spawns on a uniformly chosen plain floor cell (under
        # ``fspawn``: floor neighbour of the beacon): the largest of one
        # draw per candidate, the others left out.
        if self.front_spawn:
            nbrs = self._beacon_neighbours(beacon_pos)
            e_idx = torch.arange(e, device=device)[:, None]
            allowed = gtype[e_idx, nbrs[..., 0], nbrs[..., 1]] == FLOOR
        else:
            allowed = (gtype == FLOOR).reshape(e, -1)
        u = rand(*allowed.shape)
        spawn = torch.argmax(torch.where(allowed, u, -1.0), dim=-1)
        direction = sharded_draw(generator, (e,), lambda g, s: torch.randint(
            0, 4, s, generator=g, device=device, dtype=torch.int32))
        return self._spawn(gtype, gcolor, good, beacon_pos, spawn, direction)

    # ------------------------------------------------------------ observing
    def _observe(self, state: GridverseState) -> torch.Tensor:
        """2x3 egocentric window, row 0 = ahead, row 1 = agent's row."""
        c = self._on(state.pos.device)
        p = self.pad
        d = state.direction.to(torch.int64)
        fwd = c["dirs"][d]  # [E, 2]
        right = c["dirs"][(d + 1) % 4]
        # World coordinates of the six cells, [E, 6, 2].
        cells = (
            state.pos[:, None, :]
            + c["window_fwd"][None, :, None] * fwd[:, None, :]
            + c["window_lat"][None, :, None] * right[:, None, :]
        )
        y, x = cells[..., 0], cells[..., 1]
        in_bounds = (y >= 0) & (y < p) & (x >= 0) & (x < p)
        yc = torch.clamp(y, 0, p - 1).to(torch.int64)
        xc = torch.clamp(x, 0, p - 1).to(torch.int64)
        e_idx = torch.arange(y.shape[0], device=y.device)[:, None]
        gtype = state.grid_type[e_idx, yc, xc]  # [E, 6]
        gcolor = state.grid_color[e_idx, yc, xc]
        # Out of the grid counts as a wall.
        wall = (gtype == WALL) | ~in_bounds
        # Ahead corners are occluded when both adjacent cells toward them
        # are walls (partially_occluded observation function, gv yaml
        # :36-37): the cell beside the agent (3 left, 5 right) and the cell
        # straight ahead (1).
        visible = torch.ones_like(in_bounds)
        visible[:, 0] = ~(wall[:, 3] & wall[:, 1])
        visible[:, 2] = ~(wall[:, 5] & wall[:, 1])
        shown = in_bounds & visible
        if self.sum_encoding:
            tok = c["sum_type_idx"][gtype.to(torch.int64)] + gcolor
            tok = torch.where(shown, tok, SUM_HIDDEN_TOKEN)
        else:
            tok = torch.where(shown, gtype * NUM_COLORS + gcolor, HIDDEN)
        if self.oracle:
            tok = torch.cat([tok, state.good_color[:, None]], dim=-1)
        return tok.to(torch.int32)

    # -------------------------------------------------------------- stepping
    def step_env(self, generator, state: GridverseState, action):
        del generator
        c = self._on(state.pos.device)
        p = self.pad
        a = action.to(torch.int64)
        d = state.direction.to(torch.int64)
        fwd = c["dirs"][d]
        right = c["dirs"][(d + 1) % 4]
        move = (c["move_fwd"][a][:, None] * fwd
                + c["move_right"][a][:, None] * right)
        new_dir = ((state.direction + c["turn"][a]) % 4).to(torch.int32)
        target = torch.clamp(state.pos + move, 0, p - 1)
        e_idx = torch.arange(a.shape[0], device=a.device)
        ty, tx = target[:, 0].to(torch.int64), target[:, 1].to(torch.int64)
        ttype = state.grid_type[e_idx, ty, tx]
        blocked = ttype == WALL
        if self.beacon_blocks:
            blocked = blocked | (ttype == BEACON)
        new_pos = torch.where(blocked[:, None], state.pos, target)

        ny, nx = new_pos[:, 0].to(torch.int64), new_pos[:, 1].to(torch.int64)
        on_exit = state.grid_type[e_idx, ny, nx] == EXIT
        exit_color = state.grid_color[e_idx, ny, nx]
        correct = exit_color == state.good_color
        # reach_exit_memory +-5 plus living reward -0.05 (gv yaml :24-31).
        reward = torch.where(
            on_exit, torch.where(correct, 5.0, -5.0), 0.0
        ).to(torch.float32) - 0.05

        new_state = dataclasses.replace(
            state, pos=new_pos, direction=new_dir, t=state.t + 1
        )
        info = {"is_success": on_exit & correct}
        return self._observe(new_state), new_state, reward, on_exit, info


_VARIANT_TAGS = ("walkbeacon", "sumenc", "fspawn", "oracle")


def make_gridverse_env(name: str,
                       pad_to: Optional[int] = None) -> GridverseMemory:
    """Resolve gv_memory*.yaml names (env_processing.make_env fallback).

    Accepts e.g. ``gv_memory.7x7.yaml`` or ``gv_memory_four_rooms.9x9.yaml``,
    optionally with reconstruction-ablation suffixes
    (``gv_memory.7x7.yaml+fspawn+walkbeacon``, see the module docstring).
    """
    core, *tags = name.split("+")
    unknown = sorted(set(tags) - set(_VARIANT_TAGS))
    if unknown:
        raise KeyError(
            f"Unknown gridverse variant tags {unknown} in {name!r}; "
            f"choices: {_VARIANT_TAGS}"
        )
    base = core[:-5] if core.endswith(".yaml") else core
    parts = base.split(".")
    if len(parts) != 2 or parts[0] not in (
        "gv_memory",
        "gv_memory_four_rooms",
    ):
        raise KeyError(f"Unknown gridverse env {name!r}")
    size = int(parts[1].split("x")[0])
    return GridverseMemory(
        size=size,
        four_rooms=parts[0] == "gv_memory_four_rooms",
        pad_to=pad_to,
        beacon_blocks="walkbeacon" not in tags,
        sum_encoding="sumenc" in tags,
        front_spawn="fspawn" in tags,
        oracle="oracle" in tags,
    )
