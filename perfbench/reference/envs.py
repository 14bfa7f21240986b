"""Plain Car Flag and Gridverse memory 7x7 steps, batched over the envs of
S seeds (seed-major blocks of E), each seed drawing from its own generator.

Semantics: Car Flag (kevslinger/DTQN ``envs/car_flag.py``) with discrete
forces {-1, 0, 1}, heaven at +1 or -1, the priest's hint within 0.2 of
x = 0.5 and a 200-step limit; ``gv_memory.7x7.yaml`` (gym-gridverse): a 7x7
room, two exits of distinct colours in the top corners, a beacon of the
good exit's colour at the bottom, six moves, a 2x3 partially occluded
egocentric window, +5 / -5 at an exit and -0.05 a step, 250 steps.

Every random outcome is one draw from the seed's CUDA generator, in the
order and of the shape that the program under test draws it (uniforms
sorted for the exit colours and the spawn cell, one comparison each for
the side of heaven or the good exit, an integer for the facing), so that
the same seed gives the same episodes on both sides.  Every env is
stepped, and every env draws a fresh episode on every step; the finished
ones take it.
"""

from __future__ import annotations

import torch


def per_seed_cat(gens, draw):
    """``draw(g)`` for each seed's generator, concatenated seed-major."""
    return torch.cat([draw(g) for g in gens])


def select(cond, new, old):
    """Per-env choice over a dict of [N, ...] tensors."""
    return {k: torch.where(cond.reshape(cond.shape + (1,) * (new[k].dim() - 1)),
                           new[k], old[k]) for k in old}


class CarFlag:
    num_actions = 3
    max_steps = 200
    obs_shape = (3,)
    obs_dtype = torch.float32
    obs_mask = -5.0

    def reset(self, gens, e, device):
        draws = [torch.rand((2, e), generator=g, device=device) for g in gens]
        left = torch.cat([d[0] < 0.5 for d in draws])
        position = torch.cat([d[1] * 0.4 - 0.2 for d in draws])
        state = {
            "position": position,
            "velocity": torch.zeros_like(position),
            "heaven": torch.where(left, torch.full_like(position, -1.0),
                                  torch.full_like(position, 1.0)),
            "t": torch.zeros(position.shape, dtype=torch.int32,
                             device=device),
        }
        return self.observe(state), state

    def observe(self, s):
        near = (s["position"] >= 0.5 - 0.2) & (s["position"] <= 0.5 + 0.2)
        hint = torch.where(near, s["heaven"], torch.zeros_like(s["heaven"]))
        return torch.stack([s["position"], s["velocity"], hint], dim=-1)

    def step(self, s, action):
        force = action.to(torch.float32) - 1.0
        velocity = torch.clamp(s["velocity"] + force * 0.0015, -0.07, 0.07)
        position = torch.clamp(s["position"] + velocity, -1.1, 1.1)
        velocity = torch.where((position == -1.1) & (velocity < 0),
                               torch.zeros_like(velocity), velocity)
        at_plus, at_minus = position >= 1.0, position <= -1.0
        right = s["heaven"] > 0
        one = torch.ones_like(position)
        reward = torch.where(
            at_plus, torch.where(right, one, -one),
            torch.where(at_minus, torch.where(right, -one, one),
                        torch.zeros_like(position)))
        new = {"position": position, "velocity": velocity,
               "heaven": s["heaven"], "t": s["t"] + 1}
        return self.observe(new), new, reward, at_plus | at_minus


HIDDEN, FLOOR, WALL, EXIT, BEACON = 0, 1, 2, 3, 4
DIRS = ((-1, 0), (0, 1), (1, 0), (0, -1))  # N, E, S, W as (dy, dx)


class GridverseMemory7:
    num_actions = 6
    max_steps = 250
    obs_shape = (6,)
    obs_dtype = torch.int32
    obs_mask = 25.0  # tokens are type * 5 + colour, 0..24
    n = 7

    def _base(self, device):
        yy, xx = torch.meshgrid(torch.arange(self.n, device=device),
                                torch.arange(self.n, device=device),
                                indexing="ij")
        border = (yy == 0) | (xx == 0) | (yy == self.n - 1) | (xx == self.n - 1)
        return torch.where(border, WALL, FLOOR).to(torch.int32)

    def reset(self, gens, e, device):
        n = self.n
        blocks = []
        for g in gens:
            colors = torch.argsort(torch.rand((e, 4), generator=g,
                                              device=device), dim=-1)[:, :2]
            swap = torch.rand((e,), generator=g, device=device) < 0.5
            gtype = self._base(device).expand(e, n, n).clone()
            gcolor = torch.zeros((e, n, n), dtype=torch.int32, device=device)
            good, bad = 1 + colors[:, 0].to(torch.int32), \
                1 + colors[:, 1].to(torch.int32)
            idx = torch.arange(e, device=device)
            # Exits at (1, 1) and (1, n-2); the second is the good one on
            # ``swap``; the beacon at (n-2, n//2).
            gx = torch.where(swap, n - 2, 1)
            bx = torch.where(swap, 1, n - 2)
            gtype[idx, 1, gx] = EXIT
            gtype[idx, 1, bx] = EXIT
            gtype[:, n - 2, n // 2] = BEACON
            gcolor[idx, 1, gx] = good
            gcolor[idx, 1, bx] = bad
            gcolor[:, n - 2, n // 2] = good
            allowed = (gtype == FLOOR).reshape(e, -1)
            u = torch.rand(allowed.shape, generator=g, device=device)
            spawn = torch.argmax(torch.where(allowed, u, -1.0), dim=-1)
            direction = torch.randint(0, 4, (e,), generator=g, device=device,
                                      dtype=torch.int32)
            blocks.append({
                "grid_type": gtype, "grid_color": gcolor, "good_color": good,
                "pos": torch.stack([spawn // n, spawn % n], -1).to(torch.int32),
                "direction": direction,
                "t": torch.zeros((e,), dtype=torch.int32, device=device),
            })
        state = {k: torch.cat([b[k] for b in blocks]) for k in blocks[0]}
        return self.observe(state), state

    def _cells(self, pos, direction, fwd_lat, device):
        dirs = torch.tensor(DIRS, dtype=torch.int32, device=device)
        d = direction.to(torch.int64)
        fwd, right = dirs[d], dirs[(d + 1) % 4]
        f = torch.tensor([c[0] for c in fwd_lat], dtype=torch.int32,
                         device=device)
        lat = torch.tensor([c[1] for c in fwd_lat], dtype=torch.int32,
                           device=device)
        return (pos[:, None, :] + f[None, :, None] * fwd[:, None, :]
                + lat[None, :, None] * right[:, None, :])

    def observe(self, s):
        device = s["pos"].device
        n = self.n
        # Row 0 ahead (left, centre, right), row 1 the agent's own row.
        cells = self._cells(s["pos"], s["direction"],
                            [(1, -1), (1, 0), (1, 1), (0, -1), (0, 0), (0, 1)],
                            device)
        y, x = cells[..., 0], cells[..., 1]
        inside = (y >= 0) & (y < n) & (x >= 0) & (x < n)
        yc = y.clamp(0, n - 1).to(torch.int64)
        xc = x.clamp(0, n - 1).to(torch.int64)
        rows = torch.arange(y.shape[0], device=device)[:, None]
        gtype, gcolor = s["grid_type"][rows, yc, xc], s["grid_color"][rows, yc, xc]
        wall = (gtype == WALL) | ~inside
        visible = torch.ones_like(inside)
        # An ahead corner is hidden behind a wall beside the agent and a
        # wall straight ahead.
        visible[:, 0] = ~(wall[:, 3] & wall[:, 1])
        visible[:, 2] = ~(wall[:, 5] & wall[:, 1])
        tok = torch.where(inside & visible, gtype * 5 + gcolor, HIDDEN)
        return tok.to(torch.int32)

    def step(self, s, action):
        device = s["pos"].device
        n = self.n
        a = action.to(torch.int64)
        # Forward, backward, left, right, turn left, turn right.
        fwd_part = torch.tensor([1, -1, 0, 0, 0, 0], dtype=torch.int32,
                                device=device)[a]
        lat_part = torch.tensor([0, 0, -1, 1, 0, 0], dtype=torch.int32,
                                device=device)[a]
        turn = torch.tensor([0, 0, 0, 0, 3, 1], dtype=torch.int32,
                            device=device)[a]
        dirs = torch.tensor(DIRS, dtype=torch.int32, device=device)
        d = s["direction"].to(torch.int64)
        move = fwd_part[:, None] * dirs[d] + lat_part[:, None] * dirs[(d + 1) % 4]
        target = torch.clamp(s["pos"] + move, 0, n - 1)
        idx = torch.arange(a.shape[0], device=device)
        ttype = s["grid_type"][idx, target[:, 0].long(), target[:, 1].long()]
        blocked = (ttype == WALL) | (ttype == BEACON)
        pos = torch.where(blocked[:, None], s["pos"], target)
        at = (idx, pos[:, 0].long(), pos[:, 1].long())
        on_exit = s["grid_type"][at] == EXIT
        correct = s["grid_color"][at] == s["good_color"]
        reward = torch.where(on_exit, torch.where(correct, 5.0, -5.0),
                             0.0).to(torch.float32) - 0.05
        new = dict(s, pos=pos.to(torch.int32),
                   direction=((s["direction"] + turn) % 4).to(torch.int32),
                   t=s["t"] + 1)
        return self.observe(new), new, reward, on_exit


ENVS = {"DiscreteCarFlag-v0": CarFlag, "gv_memory.7x7.yaml": GridverseMemory7}


def make_env(name):
    if name not in ENVS:
        raise KeyError(f"the plain reference has no env {name!r}: "
                       f"{sorted(ENVS)}")
    return ENVS[name]()


def step_autoreset(env, gens, e, state, action, device):
    """Step every env with the time limit, then reset the finished ones
    from a fresh episode drawn for every env: (obs, state, next_obs,
    reward, terminated, done)."""
    next_obs, new, reward, terminated = env.step(state, action)
    truncated = (new["t"] >= env.max_steps) & ~terminated
    done = terminated | truncated
    fresh_obs, fresh = env.reset(gens, e, device)
    obs = torch.where(done.reshape(-1, *(1,) * (next_obs.dim() - 1)),
                      fresh_obs, next_obs)
    return obs, select(done, fresh, new), next_obs, reward, terminated, done
