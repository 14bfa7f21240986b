"""Plain rolling context, persistent-memory bag and episode replay, over the
envs of S seeds (seed-major blocks of E).

Semantics of kevslinger/DTQN ``utils/context.py``, ``utils/bag.py`` and
``utils/replay_buffer.py``: the context holds the last L transitions, its
obs padded with the env's mask and its actions filled with random actions
at each episode's start; the oldest entry leaves when it is full and goes
to the bag; the replay keeps whole episodes, one row each, in a ring of
``buffer_size // max_steps`` rows split evenly over the envs, and a sample
is a uniformly chosen finished episode and a uniformly chosen window start
in it, with (for DTQN-bag) a uniformly chosen subset of the observations
before the window as its bag.

All state is dicts of tensors; every function returns new tensors or
writes the replay's own tensors in place, as noted.
"""

from __future__ import annotations

import torch

from perfbench.reference.envs import per_seed_cat


# ------------------------------------------------------------------ context
def new_context(gens, e, length, env, first_obs):
    n = first_obs.shape[0]
    device = first_obs.device
    obs = torch.full((n, length, *env.obs_shape), env.obs_mask,
                     dtype=env.obs_dtype, device=device)
    obs[:, 0] = first_obs.to(env.obs_dtype)
    return {
        "obs": obs,
        "action": per_seed_cat(gens, lambda g: torch.randint(
            0, env.num_actions, (e, length), generator=g, device=device,
            dtype=torch.int32)),
        "reward": torch.zeros((n, length), device=device),
        "done": torch.ones((n, length), dtype=torch.bool, device=device),
        "timestep": torch.zeros((n,), dtype=torch.int32, device=device),
    }


def context_add(ctx, obs, action, reward, done):
    """Append one transition; returns (ctx, evicted obs, evicted action,
    full): when full, the oldest entry leaves."""
    length = ctx["obs"].shape[1]
    timestep = ctx["timestep"] + 1
    full = timestep >= length
    rolled = {k: torch.where(
        full.reshape(-1, *(1,) * (ctx[k].dim() - 1)),
        torch.roll(ctx[k], -1, dims=1), ctx[k])
        for k in ("obs", "action", "reward", "done")}
    t = torch.clamp_max(timestep, length - 1).long()
    e = torch.arange(t.shape[0], device=t.device)
    ev_obs, ev_act = rolled["obs"][e, t], rolled["action"][e, t]
    rolled["obs"][e, t] = obs.to(rolled["obs"].dtype)
    rolled["action"][e, t] = action.to(torch.int32)
    rolled["reward"][e, t] = reward.to(torch.float32)
    rolled["done"][e, t] = done.to(torch.bool)
    rolled["timestep"] = timestep
    return rolled, ev_obs, ev_act, full


def last_row(ctx):
    return torch.clamp_max(ctx["timestep"], ctx["obs"].shape[1] - 1).long()


# ---------------------------------------------------------------------- bag
def new_bag(n, size, env, device):
    return {
        "obs": torch.full((n, size, *env.obs_shape), env.obs_mask,
                          dtype=env.obs_dtype, device=device),
        "action": torch.zeros((n, size), dtype=torch.int32, device=device),
        "obs_idx": torch.full((n, size), -1, dtype=torch.int32,
                              device=device),
        "pos": torch.zeros((n,), dtype=torch.int32, device=device),
    }


def bag_add(bag, obs, action, obs_idx, want):
    """Puts (obs, action) into the next free slot where ``want`` and the
    bag has room: (bag, accepted)."""
    size = bag["obs"].shape[1]
    accept = want & (bag["pos"] < size)
    hit = (torch.arange(size, device=obs.device)[None, :]
           == bag["pos"][:, None]) & accept[:, None]

    def put(arr, val):
        val = val.to(arr.dtype)[:, None]
        return torch.where(hit.reshape(hit.shape + (1,) * (arr.dim() - 2)),
                           val, arr)

    return {"obs": put(bag["obs"], obs), "action": put(bag["action"], action),
            "obs_idx": put(bag["obs_idx"], obs_idx),
            "pos": bag["pos"] + accept.to(torch.int32)}, accept


def bag_candidates(bag, obs, action, obs_idx):
    """The bag_size + 1 bags a full bag may become: candidate i holds the
    newcomer in slot i, the last one is the bag unchanged.  [N, C, size,
    ...] each."""
    size = bag["obs"].shape[1]
    device = obs.device
    replace = (torch.arange(size + 1, device=device)[:, None]
               == torch.arange(size, device=device)[None, :])[None]
    extra = (1,) * (bag["obs"].dim() - 2)
    return {
        "obs": torch.where(replace.reshape(1, size + 1, size, *extra),
                           obs.to(bag["obs"].dtype)[:, None, None],
                           bag["obs"][:, None]),
        "action": torch.where(replace, action.to(torch.int32)[:, None, None],
                              bag["action"][:, None]),
        "obs_idx": torch.where(replace, obs_idx.to(torch.int32)[:, None, None],
                               bag["obs_idx"][:, None]),
    }


# ------------------------------------------------------------------- replay
def new_replay(num_envs, buffer_size, max_steps, env, device):
    """One seed's ring; ``num_envs`` is that seed's E."""
    total = max(buffer_size // max_steps, 2 * num_envs)
    rows = max(total // num_envs, 2) * num_envs
    return {
        "obs": torch.full((rows, max_steps + 1, *env.obs_shape),
                          env.obs_mask, dtype=env.obs_dtype, device=device),
        "action": torch.zeros((rows, max_steps + 1), dtype=torch.int32,
                              device=device),
        "reward": torch.zeros((rows, max_steps), device=device),
        "done": torch.ones((rows, max_steps), dtype=torch.bool,
                           device=device),
        "ep_len": torch.zeros((rows,), dtype=torch.int32, device=device),
        "ep_valid": torch.zeros((rows,), dtype=torch.bool, device=device),
        "write_pos": torch.zeros((num_envs,), dtype=torch.int32,
                                 device=device),
        "ep_count": torch.zeros((num_envs,), dtype=torch.int32,
                                device=device),
        "flushed": torch.zeros((), dtype=torch.int32, device=device),
    }


def stack_replays(parts):
    """S seeds' rings as one: rows and envs concatenated seed-major,
    ``flushed`` [S]."""
    return {k: (torch.stack if k == "flushed" else torch.cat)(
        [p[k] for p in parts]) for k in parts[0]}


def current_rows(rb):
    envs = rb["write_pos"].shape[0]
    per_env = rb["obs"].shape[0] // envs
    return (torch.arange(envs, device=rb["obs"].device) * per_env
            + (rb["ep_count"] % per_env).long())


def replay_start_episode(rb, obs, mask, obs_mask):
    """Clears the current row of each env in ``mask`` and writes the
    episode's first observation (in place)."""
    rows = current_rows(rb)
    m = mask
    t = rb["reward"].shape[1]
    n = obs.shape[0]

    def masked(key, new):
        old = rb[key][rows]
        rb[key][rows] = torch.where(m.reshape(-1, *(1,) * (old.dim() - 1)),
                                    new, old)

    first = torch.full((n, t + 1, *rb["obs"].shape[2:]), obs_mask,
                       dtype=rb["obs"].dtype, device=obs.device)
    first[:, 0] = obs.to(rb["obs"].dtype)
    masked("obs", first)
    masked("action", torch.zeros_like(rb["action"][rows]))
    masked("reward", torch.zeros_like(rb["reward"][rows]))
    masked("done", torch.ones_like(rb["done"][rows]))
    masked("ep_len", torch.zeros_like(rb["ep_len"][rows]))
    masked("ep_valid", torch.zeros_like(rb["ep_valid"][rows]))
    rb["write_pos"] = torch.where(m, torch.zeros_like(rb["write_pos"]),
                                  rb["write_pos"])


def replay_store(rb, next_obs, action, reward, done):
    rows = current_rows(rb)
    pos = rb["write_pos"].long()
    rb["obs"][rows, pos + 1] = next_obs.to(rb["obs"].dtype)
    rb["action"][rows, pos] = action.to(torch.int32)
    rb["reward"][rows, pos] = reward.to(torch.float32)
    rb["done"][rows, pos] = done.to(torch.bool)
    rb["write_pos"] = rb["write_pos"] + 1
    rb["ep_len"][rows] = rb["write_pos"]


def replay_finish(rb, mask):
    """Marks the finished episodes samplable and moves their envs on to the
    next row."""
    rows = current_rows(rb)
    rb["ep_valid"][rows] = rb["ep_valid"][rows] | mask
    rb["ep_count"] = rb["ep_count"] + mask.to(torch.int32)
    rb["write_pos"] = torch.where(mask, torch.zeros_like(rb["write_pos"]),
                                  rb["write_pos"])
    seeds = rb["flushed"].shape
    rb["flushed"] = rb["flushed"] + mask.reshape(seeds + (-1,)).sum(-1).to(
        torch.int32)


def sample(rb, gens, batch, length, bag_size, obs_mask):
    """One batch per seed, seed-major: a finished episode drawn uniformly
    (the largest of log-uniform race times), a window start drawn uniformly,
    and for ``bag_size`` > 0 the bag: the observations before the window,
    or a uniform subset of ``bag_size`` of them (the smallest of one
    uniform score each)."""
    device = rb["obs"].device
    seeds = len(gens)
    per_seed = rb["ep_valid"].shape[0] // seeds
    valid = rb["ep_valid"].reshape(seeds, per_seed)
    logits = torch.where(valid, torch.zeros((), device=device),
                         torch.full((), -float("inf"), device=device))
    u = torch.stack([torch.rand((batch, per_seed), generator=g,
                                device=device) for g in gens])
    rows = torch.argmax(logits[:, None, :] - torch.log(-torch.log(u)), dim=-1)
    rows = (rows + torch.arange(seeds, device=device)[:, None]
            * per_seed).reshape(-1)
    max_start = torch.clamp_min(rb["ep_len"][rows] - length, 0)
    u_start = per_seed_cat(gens, lambda g: torch.rand((batch,), generator=g,
                                                      device=device))
    starts = torch.floor(u_start * (max_start + 1).to(torch.float32))
    starts = torch.minimum(starts.to(torch.int32), max_start)
    steps = rb["reward"].shape[1]
    out = {}
    if bag_size:
        scores = per_seed_cat(gens, lambda g: torch.rand(
            (batch, steps), generator=g, device=device))
    t_idx = starts.long()[:, None] + torch.arange(length + 1,
                                                  device=device)[None, :]
    r = rows[:, None]
    obs, act = rb["obs"][r, t_idx], rb["action"][r, t_idx]
    out.update(obs=obs[:, :length], action=act[:, :length],
               next_obs=obs[:, 1:], next_action=act[:, 1:],
               reward=rb["reward"][r, t_idx[:, :length]],
               done=rb["done"][r, t_idx[:, :length]])
    if bag_size:
        before = torch.arange(steps, device=device)[None, :] < starts[:, None]
        scores = torch.where(before, scores, torch.full_like(scores, 2.0))
        order = torch.argsort(scores, dim=1, stable=True)[:, :bag_size]
        keep = torch.gather(before, 1, order)
        b_obs, b_act = rb["obs"][r, order], rb["action"][r, order]
        out["bag_obs"] = torch.where(
            keep.reshape(keep.shape + (1,) * (b_obs.dim() - 2)), b_obs,
            torch.full_like(b_obs, obs_mask))
        out["bag_action"] = torch.where(keep, b_act, torch.zeros_like(b_act))
    return out

