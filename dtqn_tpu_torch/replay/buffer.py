"""Episode-major replay ring buffer on the device (``dtqn_tpu/replay/buffer.py``).

  - storage is episode-major: ``obs[R, T+1, ...]`` keeps s and s' in one
    tensor; actions get the same +1 slot; rewards / dones are [R, T]; dones
    start all True so padded tails never bootstrap
  - the FIFO of ``buffer_size // max_episode_steps`` episodes becomes a
    ring of rows partitioned per env, so E lockstep envs write without
    contention
  - the in-progress episode is excluded from sampling by a per-row validity
    bit: set on flush, cleared when a row is cleansed for reuse
  - ``sample`` draws a uniform valid episode and a uniform window start in
    [0, max(0, ep_len - L)] per sample
  - ``sample_with_bag`` also builds fixed-shape per-sample bags from
    pre-window observations: all of them if fewer than ``bag_size``,
    otherwise a uniform random subset, taken as the bottom-``bag_size`` of
    random scores over the valid slots
  - ``store_act_bag`` / ``sample_with_stored_bag`` (``--bag-store``): record
    the act-time bag per timestep as (episode obs index, action) pairs, and
    train on the stored bag of the sampled window's last acting step
  - episode lengths are int32
  - a stacked run of S seeds (``stack_buffers``) keeps S rings in one: seed
    s owns rows [s * R, (s + 1) * R) and envs [s * E, (s + 1) * E) (the
    seed-major folded layout), ``flushed_total`` is [S], and each seed
    samples its own rows from its own generator
  - a ring sharded over the ranks of a mesh (``parallel/mesh.py``; the
    ``mesh`` arguments) holds rank r's block of rows [r * R, (r + 1) * R)
    of the global ring, and ``flushed_total`` counts every rank's episodes.
    Sampling is global: every rank draws the same windows over all rows,
    their owners fill them in, and each rank gets its share of the batch

Unlike the JAX package, the write functions update the buffer's tensors in
place (and also return the buffer).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from dtqn_tpu_torch.envs.core import where_batch
from dtqn_tpu_torch.utils.rng import folded_draw, stacked_draw


@dataclasses.dataclass
class BufferState:
    obs: torch.Tensor  # [R, T+1, *obs_shape]
    action: torch.Tensor  # [R, T+1] int32
    reward: torch.Tensor  # [R, T] float32
    done: torch.Tensor  # [R, T] bool
    ep_len: torch.Tensor  # [R] int32
    ep_valid: torch.Tensor  # [R] bool: completed episode, samplable
    write_pos: torch.Tensor  # [E] int32: step cursor in current episode
    ep_count: torch.Tensor  # [E] int32: episodes started per env
    flushed_total: torch.Tensor  # int32 scalar ([S] stacked): completed
    # Act-time bag storage (--bag-store): slot p holds the bag state after
    # transition p+1 = the bag used when acting at episode obs index p+1.
    bag_idx: Optional[torch.Tensor] = None  # [R, T, bag] int32, -1 = empty
    bag_act: Optional[torch.Tensor] = None  # [R, T, bag] int32

    @property
    def num_envs(self) -> int:
        return self.write_pos.shape[0]

    @property
    def rows_per_env(self) -> int:
        return self.obs.shape[0] // self.num_envs

    @property
    def max_episode_steps(self) -> int:
        return self.reward.shape[1]

    @property
    def current_rows(self) -> torch.Tensor:
        """Row owned by each env for its in-progress episode (int64)."""
        rpe = self.rows_per_env
        env = torch.arange(self.num_envs, device=self.ep_count.device)
        return env * rpe + (self.ep_count % rpe).to(torch.int64)


@dataclasses.dataclass
class Batch:
    """One training batch of context windows (replay_buffer.py:160-168)."""

    obs: torch.Tensor  # [B, L, *obs_shape]
    action: torch.Tensor  # [B, L]
    reward: torch.Tensor  # [B, L]
    next_obs: torch.Tensor  # [B, L, *obs_shape]
    next_action: torch.Tensor  # [B, L]
    done: torch.Tensor  # [B, L]
    ep_len: torch.Tensor  # [B] clipped to L
    bag_obs: Optional[torch.Tensor] = None  # [B, bag, *obs_shape]
    bag_action: Optional[torch.Tensor] = None  # [B, bag]


def init_buffer(
    *,
    num_envs: int,
    buffer_size: int,
    max_episode_steps: int,
    context_len: int,
    obs_shape: Tuple[int, ...],
    obs_dtype: torch.dtype,
    obs_mask: float,
    device,
    act_bag_size: int = 0,
) -> BufferState:
    if context_len > max_episode_steps:
        raise ValueError(
            f"context_len {context_len} > max_episode_steps "
            f"{max_episode_steps}: sampled windows would overrun episodes"
        )
    total_rows = max(buffer_size // max_episode_steps, 2 * num_envs)
    rows_per_env = max(total_rows // num_envs, 2)
    rows = rows_per_env * num_envs
    t = max_episode_steps

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return BufferState(
        obs=torch.full((rows, t + 1, *obs_shape), obs_mask, dtype=obs_dtype,
                       device=device),
        action=zeros((rows, t + 1), torch.int32),
        reward=zeros((rows, t), torch.float32),
        done=torch.ones((rows, t), dtype=torch.bool, device=device),
        ep_len=zeros((rows,), torch.int32),
        ep_valid=zeros((rows,), torch.bool),
        write_pos=zeros((num_envs,), torch.int32),
        ep_count=zeros((num_envs,), torch.int32),
        flushed_total=zeros((), torch.int32),
        bag_idx=(
            torch.full((rows, t, act_bag_size), -1, dtype=torch.int32,
                       device=device)
            if act_bag_size > 0
            else None
        ),
        bag_act=(
            zeros((rows, t, act_bag_size), torch.int32)
            if act_bag_size > 0
            else None
        ),
    )


def _masked_row_update(arr, rows, mask, new_rows) -> None:
    """arr[rows] = new_rows where mask (per-env bool), in place."""
    arr[rows] = where_batch(mask, new_rows, arr[rows])


def store_first_obs(
    buf: BufferState, obs: torch.Tensor, mask: torch.Tensor, obs_mask: float
) -> BufferState:
    """Cleanse each masked env's current row and store the episode's first
    observation (replay_buffer.py:88-92 + cleanse_episode:100-135)."""
    rows = buf.current_rows
    e, t = buf.num_envs, buf.max_episode_steps
    device = obs.device
    clean_obs = torch.full((e, t + 1, *buf.obs.shape[2:]), obs_mask,
                           dtype=buf.obs.dtype, device=device)
    clean_obs[:, 0] = obs.to(buf.obs.dtype)
    _masked_row_update(buf.obs, rows, mask, clean_obs)
    _masked_row_update(
        buf.action, rows, mask,
        torch.zeros((e, t + 1), dtype=torch.int32, device=device),
    )
    _masked_row_update(
        buf.reward, rows, mask,
        torch.zeros((e, t), dtype=torch.float32, device=device),
    )
    _masked_row_update(
        buf.done, rows, mask,
        torch.ones((e, t), dtype=torch.bool, device=device),
    )
    _masked_row_update(buf.ep_len, rows, mask, torch.zeros_like(buf.ep_len[rows]))
    _masked_row_update(buf.ep_valid, rows, mask,
                       torch.zeros_like(buf.ep_valid[rows]))
    if buf.bag_idx is not None:
        bag = buf.bag_idx.shape[2]
        _masked_row_update(
            buf.bag_idx, rows, mask,
            torch.full((e, t, bag), -1, dtype=torch.int32, device=device),
        )
        _masked_row_update(
            buf.bag_act, rows, mask,
            torch.zeros((e, t, bag), dtype=torch.int32, device=device),
        )
    buf.write_pos = torch.where(mask, torch.zeros_like(buf.write_pos),
                                buf.write_pos)
    return buf


def store_step(
    buf: BufferState,
    obs: torch.Tensor,
    action: torch.Tensor,
    reward: torch.Tensor,
    done: torch.Tensor,
) -> BufferState:
    """Store one transition for every env (replay_buffer.py:71-86).

    ``obs`` is the post-step observation, written at slot pos+1 so s and s'
    share one tensor; the episode length tracks the running step count.
    """
    rows = buf.current_rows
    pos = buf.write_pos.to(torch.int64)
    buf.obs[rows, pos + 1] = obs.to(buf.obs.dtype)
    buf.action[rows, pos] = action.to(torch.int32)
    buf.reward[rows, pos] = reward.to(torch.float32)
    buf.done[rows, pos] = done.to(torch.bool)
    buf.write_pos = buf.write_pos + 1
    buf.ep_len[rows] = buf.write_pos
    return buf


def store_act_bag(buf: BufferState, bag_idx, bag_act) -> BufferState:
    """Record the act-time bag for the transition just written by
    ``store_step`` (--bag-store).

    Must be called after ``store_step`` with the bag state as updated by
    the agent's add/evict policy for that transition: slot p (the
    transition's write position) then holds the bag the agent acts with at
    episode obs index p+1, which ``sample_with_stored_bag`` gathers for
    windows ending there.
    """
    rows = buf.current_rows
    pos = (buf.write_pos - 1).to(torch.int64)  # store_step moved the cursor
    buf.bag_idx[rows, pos] = bag_idx.to(torch.int32)
    buf.bag_act[rows, pos] = bag_act.to(torch.int32)
    return buf


def flush(buf: BufferState, mask: torch.Tensor, mesh=None) -> BufferState:
    """Finish the masked envs' episodes: mark samplable, advance the ring
    (replay_buffer.py:97-98).  Over a mesh every rank adds all ranks'
    episodes to ``flushed_total``, which ``can_sample`` reads."""
    rows = buf.current_rows
    buf.ep_valid[rows] = buf.ep_valid[rows] | mask
    buf.ep_count = buf.ep_count + mask.to(torch.int32)
    buf.write_pos = torch.where(mask, torch.zeros_like(buf.write_pos),
                                buf.write_pos)
    flushed = mask.reshape(buf.flushed_total.shape + (-1,)).sum(-1).to(
        torch.int32)
    if mesh is not None:
        mesh.all_reduce(flushed)
    buf.flushed_total = buf.flushed_total + flushed
    return buf


def stack_buffers(buffers) -> BufferState:
    """S single-seed rings (of one configuration) as one stacked ring."""
    first = buffers[0]
    return dataclasses.replace(first, **{
        f.name: (None if getattr(first, f.name) is None else
                 (torch.stack if f.name == "flushed_total" else torch.cat)(
                     [getattr(b, f.name) for b in buffers]))
        for f in dataclasses.fields(first)
    })


def can_sample(buf: BufferState, batch_size: int) -> torch.Tensor:
    """batch_size < completed episodes (replay_buffer.py:94-95): a device
    bool ([S] stacked), never read on the host by the learner."""
    return buf.flushed_total > batch_size


def _draw_windows(buf: BufferState, generator, batch_size, context_len,
                  mesh=None):
    """Uniform valid rows (Gumbel-max over the validity logits, as
    ``jax.random.categorical``) and uniform window starts.  Stacked (a list
    of per-seed generators), each seed draws ``batch_size`` windows from
    its own rows: [S * batch_size], seed-major.  Over a mesh, every rank
    draws the same ``batch_size`` windows over the global ring's rows."""
    device = buf.ep_valid.device
    seeds = buf.flushed_total.shape  # () or (S,)
    ep_len, ep_valid = buf.ep_len, buf.ep_valid
    if mesh is not None:
        ep_len, ep_valid = mesh.gather_blocks([ep_len, ep_valid])
    valid = ep_valid.reshape(seeds + (-1,))
    logits = torch.where(
        valid,
        torch.zeros((), device=device),
        torch.full((), -float("inf"), device=device),
    )
    u = stacked_draw(generator, lambda g: torch.rand(
        (batch_size, valid.shape[-1]), generator=g, device=device))
    rows = torch.argmax(logits[..., None, :] - torch.log(-torch.log(u)),
                        dim=-1)
    if seeds:
        first = torch.arange(0, buf.ep_valid.shape[0], valid.shape[-1],
                             device=device)
        rows = (rows + first[:, None]).reshape(-1)
    max_start = torch.clamp_min(ep_len[rows] - context_len, 0)
    u_start = folded_draw(generator, rows.shape[0], lambda g, n: torch.rand(
        (n,), generator=g, device=device))
    starts = torch.floor(u_start * (max_start + 1).to(torch.float32))
    starts = torch.minimum(starts.to(torch.int32), max_start)
    return rows, starts


def _from_owners(buf: BufferState, mesh, rows, make_batch) -> Batch:
    """``make_batch(rows)``.  Over a mesh, where ``rows`` index the global
    ring: each rank makes the samples of the rows it holds, every rank
    receives them all, and keeps its share of the batch."""
    if mesh is None:
        return make_batch(rows)
    held = buf.ep_len.shape[0]
    local = rows - mesh.rank * held
    owned = (local >= 0) & (local < held)
    batch = make_batch(torch.where(owned, local, torch.zeros_like(local)))
    names = [f.name for f in dataclasses.fields(batch)
             if getattr(batch, f.name) is not None]
    full = mesh.gather_owned([getattr(batch, n) for n in names], owned)
    return dataclasses.replace(batch, **{
        n: mesh.share(x) for n, x in zip(names, full)})


def _gather_windows(buf: BufferState, rows, starts, context_len):
    """Batched context-window gather: one indexing op per storage tensor."""
    t_idx = starts.to(torch.int64)[:, None] + torch.arange(
        context_len + 1, device=starts.device
    )[None, :]
    rows_b = rows.to(torch.int64)[:, None]
    obs_slice = buf.obs[rows_b, t_idx]
    act_slice = buf.action[rows_b, t_idx]
    rew = buf.reward[rows_b, t_idx[:, :context_len]]
    don = buf.done[rows_b, t_idx[:, :context_len]]
    return obs_slice, act_slice, rew, don


def _window_batch(buf: BufferState, rows, starts, context_len,
                  bag_obs=None, bag_action=None) -> Batch:
    obs_s, act_s, rew, don = _gather_windows(buf, rows, starts, context_len)
    return Batch(
        obs=obs_s[:, :context_len],
        action=act_s[:, :context_len],
        reward=rew,
        next_obs=obs_s[:, 1:],
        next_action=act_s[:, 1:],
        done=don,
        ep_len=torch.clamp(buf.ep_len[rows], 0, context_len),
        bag_obs=bag_obs,
        bag_action=bag_action,
    )


def sample(
    buf: BufferState, generator, batch_size: int, context_len: int,
    mesh=None,
) -> Batch:
    """Uniform (valid episode, window start) batch (replay_buffer.py:137-168)."""
    rows, starts = _draw_windows(buf, generator, batch_size, context_len,
                                 mesh)
    return _from_owners(buf, mesh, rows, lambda r: _window_batch(
        buf, r, starts, context_len))


def _pad_bag(bag_obs, bag_act, valid, obs_mask: float):
    """Invalid bag slots hold the obs mask and action 0."""
    pad = valid.reshape(valid.shape + (1,) * (bag_obs.dim() - 2))
    return (
        torch.where(pad, bag_obs, torch.full_like(bag_obs, obs_mask)),
        torch.where(valid, bag_act, torch.zeros_like(bag_act)),
    )


def random_bags(buf: BufferState, rows, starts, scores, bag_size: int,
                obs_mask: float):
    """Per-sample bags from pre-window observations, given one uniform
    ``scores`` [B, T] draw per slot: (bag_obs, bag_action).

    The bottom-``bag_size`` of the scores over the valid slots (those before
    the window start); invalid slots score 2.0 and so sort last.  Scores tie
    only at 2.0, among invalid slots, and every chosen invalid slot is
    padded alike, so a tie never decides a valid entry; the stable sort
    makes the order of the padding repeatable all the same.
    """
    t_slots = buf.max_episode_steps
    slot_idx = torch.arange(t_slots, device=scores.device)[None, :]
    valid = slot_idx < starts[:, None]
    scores = torch.where(valid, scores, torch.full_like(scores, 2.0))
    order = torch.argsort(scores, dim=1, stable=True)[:, :bag_size]
    chosen_valid = torch.gather(valid, 1, order)
    rows_b = rows.to(torch.int64)[:, None]
    return _pad_bag(buf.obs[rows_b, order], buf.action[rows_b, order],
                    chosen_valid, obs_mask)


def sample_with_bag(
    buf: BufferState,
    generator,
    batch_size: int,
    context_len: int,
    bag_size: int,
    obs_mask: float,
    mesh=None,
) -> Batch:
    """Batch plus per-sample bags drawn from pre-window observations
    (replay_buffer.py:171-264).

    For each sample with window start s: if s <= bag_size take all s
    pre-window entries (mask-padding the rest), else a uniform random
    subset of ``bag_size``, which is distribution-equivalent to the
    reference's ``random.sample`` (order inside a bag is irrelevant to the
    unmasked bag cross-attention).
    """
    rows, starts = _draw_windows(buf, generator, batch_size, context_len,
                                 mesh)
    scores = folded_draw(generator, rows.shape[0], lambda g, n: torch.rand(
        (n, buf.max_episode_steps), generator=g, device=starts.device))

    def make_batch(held_rows):
        bag_obs, bag_act = random_bags(buf, held_rows, starts, scores,
                                       bag_size, obs_mask)
        return _window_batch(buf, held_rows, starts, context_len, bag_obs,
                             bag_act)

    return _from_owners(buf, mesh, rows, make_batch)


def stored_bags(buf: BufferState, rows, starts, context_len: int,
                obs_mask: float):
    """The act-time bag recorded for each window: (bag_obs, bag_action).

    For a window starting at s, the relevant acting step is its last
    position t = s + L - 1; the bag the agent used there is stored at slot
    t - 1 (the bag state after transition t).  Entries are episode obs
    indices < s by construction (evictions at step t come from obs index
    t - L), so the gathered bag is always pre-window.
    """
    rows = rows.to(torch.int64)
    slot = torch.minimum(
        torch.clamp_min(starts + context_len - 2, 0), buf.ep_len[rows] - 1
    ).to(torch.int64)
    idx = buf.bag_idx[rows, slot]  # [B, bag]
    valid = idx >= 0
    bag_obs = buf.obs[rows[:, None], torch.clamp_min(idx, 0).to(torch.int64)]
    return _pad_bag(bag_obs, buf.bag_act[rows, slot], valid, obs_mask)


def sample_with_stored_bag(
    buf: BufferState,
    generator,
    batch_size: int,
    context_len: int,
    obs_mask: float,
    mesh=None,
) -> Batch:
    """Batch plus the act-time bag recorded for each sampled window
    (--bag-store; see ``store_act_bag``): the same support as
    ``sample_with_bag``, but with the eviction policy's actual contents
    instead of a uniform random subset."""
    rows, starts = _draw_windows(buf, generator, batch_size, context_len,
                                 mesh)

    def make_batch(held_rows):
        bag_obs, bag_act = stored_bags(buf, held_rows, starts, context_len,
                                       obs_mask)
        return _window_batch(buf, held_rows, starts, context_len, bag_obs,
                             bag_act)

    return _from_owners(buf, mesh, rows, make_batch)
