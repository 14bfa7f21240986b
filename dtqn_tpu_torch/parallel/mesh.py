"""Data parallelism over the ranks of a 1-D mesh
(``dtqn_tpu/parallel/mesh.py``).

As in the JAX package, env-indexed state is split over the ranks along its
leading axis (envs, their replay rows, contexts, bags, carries and the
current observations), and the learner state is replicated (parameters,
target, optimizer, generator, counters, epsilon, diagnostics and
``flushed_total``).  Replay rows are env-major (env e owns rows
[e * rpe, (e + 1) * rpe)), so rank r owns envs [r * E / N, (r + 1) * E / N)
and exactly their rows: every write stays on its rank.

PyTorch has no GSPMD, so what XLA derives from the sharding annotations is
written out (``agents/base.py``, ``replay/buffer.py``, ``utils/metrics.py``):

  - every rank holds the generator in the same state; each draw over envs
    or over the batch draws the global shape and keeps the rank's slice
    (``utils/rng.py``), so the generator advances as in the one-device run;
  - sampling is global: the rows' lengths and validity are gathered, every
    rank draws the same windows, their owners fill them in, and each rank
    trains on its share of the batch (``torch.tensor_split``: a batch that
    N does not divide works too);
  - each rank's loss is its share of the global mean, and the gradient is
    all-reduced before the global-norm clip, so the clip, Adam and the
    target swap run identically on every rank;
  - ``flushed_total`` and the diagnostics are reduced over the ranks.

The collectives are ``all_reduce`` and ``broadcast`` only, the two that
both NCCL and gloo take on CUDA tensors.  A gather from owners is a
zero-filled byte image of the global tensors, in which each rank writes
what it owns, summed over the ranks: every dtype arrives bit for bit.
With no mesh, or a mesh of one rank, no collective is issued and every
result is bit-equal to the one-device path.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from dtqn_tpu_torch.agents.base import Agent, AgentState
from dtqn_tpu_torch.envs.core import batch_map
from dtqn_tpu_torch.train.loop import make_train_chunk_fn
from dtqn_tpu_torch.utils.device import resolve_device
from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule

# A field's placement, as ``state_shardings`` gives it: split along the
# leading axis over the ranks, or the same on every rank.
SHARDED = "sharded"
REPLICATED = "replicated"

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def rank_device(rank: int, device=None) -> torch.device:
    """The device of ``rank``: ``cuda:(rank % device_count)`` unless the
    caller names the CPU (``resolve_device`` raises without a card)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


@dataclasses.dataclass
class Mesh:
    """One rank's view of a 1-D data-parallel mesh of ``size`` ranks, one
    process each.  ``group`` is the process group of the collectives
    (``None``: the default group).  ``counts`` and ``seconds`` add up the
    collectives issued and their host time, per kind."""

    rank: int
    size: int
    device: torch.device
    backend: Optional[str] = None
    group: Any = None
    counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"all_reduce": 0, "broadcast": 0})
    seconds: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"all_reduce": 0.0, "broadcast": 0.0})

    def _issue(self, kind: str, call) -> None:
        t0 = time.perf_counter()
        call()
        self.counts[kind] += 1
        self.seconds[kind] += time.perf_counter() - t0

    def all_reduce(self, tensor: torch.Tensor, op: str = "sum"):
        """``tensor`` reduced over the ranks (``op`` "sum" or "max"), in
        place; returned."""
        self._issue("all_reduce", lambda: dist.all_reduce(
            _wire(tensor), op=_OPS[op], group=self.group))
        return tensor

    def broadcast(self, tensor: torch.Tensor, src: int = 0):
        """``tensor`` as rank ``src`` holds it, in place; returned."""
        self._issue("broadcast", lambda: dist.broadcast(
            _wire(tensor), src=src, group=self.group))
        return tensor

    def share(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's share of a global batch along its leading axis."""
        return torch.tensor_split(x, self.size)[self.rank]

    def gather_blocks(self, tensors: Sequence[torch.Tensor]):
        """Each of ``tensors`` (this rank's block of n rows of a tensor
        split over the ranks) as the global tensor of N * n rows, rank
        r's block at rows [r * n, (r + 1) * n): one collective."""
        n = tensors[0].shape[0]
        image = _pack(tensors, n)
        full = image.new_zeros((self.size * n, image.shape[1]))
        full[self.rank * n:(self.rank + 1) * n] = image
        self.all_reduce(full)
        return _unpack(full, tensors, self.size * n)

    def gather_owned(self, tensors: Sequence[torch.Tensor],
                     owned: torch.Tensor):
        """Each of ``tensors`` ([B, ...]) as the ranks that own its rows
        computed them: row b from the one rank where ``owned[b]`` holds.
        One collective."""
        image = _pack(tensors, owned.shape[0])
        image = torch.where(owned[:, None], image, torch.zeros_like(image))
        self.all_reduce(image)
        return _unpack(image, tensors, owned.shape[0])


def _wire(tensor: torch.Tensor) -> torch.Tensor:
    """The tensor the backends take: a bool one as its bytes."""
    return tensor.view(torch.uint8) if tensor.dtype == torch.bool else tensor


def _pack(tensors, rows: int) -> torch.Tensor:
    """The bytes of each tensor's rows side by side: [rows, total bytes]."""
    return torch.cat([t.contiguous().view(torch.uint8).reshape(rows, -1)
                      for t in tensors], dim=1)


def _unpack(image, like, rows: int) -> List[torch.Tensor]:
    """``_pack``'s inverse over ``rows`` rows, each tensor in its dtype."""
    out, col = [], 0
    for t in like:
        width = t.numel() * t.element_size() // max(t.shape[0], 1)
        part = image[:, col:col + width].contiguous()
        out.append(part.view(t.dtype).reshape(rows, *t.shape[1:]))
        col += width
    return out


def make_mesh(num_devices: Optional[int] = None, *,
              rank: Optional[int] = None, device=None) -> Mesh:
    """The 1-D mesh of ``num_devices`` ranks, one process each.

    In a process group (``init_distributed``), this process's rank in it;
    the group must hold exactly ``num_devices`` processes.  Without one, a
    mesh of ``num_devices`` (default 1) at ``rank`` (default 0) with no
    collectives: enough to shard a state and check shapes in one process.
    The device is ``rank_device(rank, device)``.
    """
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        size = num_devices or world
        if size != world:
            raise ValueError(
                f"a mesh of {size} ranks needs a process group of {size} "
                f"processes, one per rank; this one has {world}"
            )
        rank, backend = dist.get_rank(), dist.get_backend()
    else:
        size, rank, backend = num_devices or 1, rank or 0, None
    return Mesh(rank=rank, size=size, device=rank_device(rank, device),
                backend=backend)


def _every(tree, spec):
    """``spec`` for every tensor of a tree (None for an absent part)."""
    return None if tree is None else batch_map(lambda _: spec, [tree])


def state_shardings(agent: Agent, state: AgentState, mesh=None):
    """The placement of every field of ``state``: the state's structure
    with ``SHARDED`` or ``REPLICATED`` for each tensor, network and
    generator.

    Built by field, as the JAX package's, never by shape: a width can
    coincide with the env count.
    """
    del agent, mesh
    buf = state.buffer
    rows = {name: SHARDED if getattr(buf, name) is not None else None
            for name in ("obs", "action", "reward", "done", "ep_len",
                         "ep_valid", "write_pos", "ep_count", "bag_idx",
                         "bag_act")}
    return dataclasses.replace(
        state,
        network=REPLICATED,
        target_network=REPLICATED,
        params=REPLICATED,
        target_params=REPLICATED,
        opt_state=_every(state.opt_state, REPLICATED),
        buffer=dataclasses.replace(buf, flushed_total=REPLICATED, **rows),
        context=_every(state.context, SHARDED),
        bag=_every(state.bag, SHARDED),
        carry=_every(state.carry, SHARDED),
        env_state=_every(state.env_state, SHARDED),
        obs=SHARDED,
        generator=REPLICATED,
        env_steps=REPLICATED,
        train_steps=REPLICATED,
        epsilon=REPLICATED,
        diagnostics=_every(state.diagnostics, REPLICATED),
        nonfinite_grads=REPLICATED,
    )


def _check_divides(num_envs: int, mesh: Mesh) -> None:
    if num_envs % mesh.size:
        raise ValueError(
            f"num_envs {num_envs} must divide the mesh size {mesh.size}"
        )


def shard_state(agent: Agent, state: AgentState, mesh: Mesh) -> AgentState:
    """This rank's part of a global (one-device) state: its block of every
    sharded tensor, copied; the replicated ones are shared with ``state``
    (the networks' parameters are views of ``params``)."""
    _check_divides(state.obs.shape[0], mesh)
    specs = state_shardings(agent, state, mesh)

    def place(pair):
        x, spec = pair
        if spec != SHARDED:
            return x
        return x.chunk(mesh.size)[mesh.rank].clone()

    return batch_map(place, [state, specs])


def join_shards(shards: Sequence[AgentState]) -> AgentState:
    """The global state of the ranks' parts, in rank order: ``shard_state``'s
    inverse.  Replicated fields come from rank 0's part."""
    specs = state_shardings(None, shards[0])
    return batch_map(
        lambda xs: torch.cat(xs[:-1]) if xs[-1] == SHARDED else xs[0],
        [*shards, specs])


def unshard_state(state: AgentState, mesh: Mesh) -> AgentState:
    """The global state, on every rank, of the ranks' parts: each sharded
    tensor broadcast from every rank in turn, then ``join_shards``.  Every
    rank calls it."""
    specs = state_shardings(None, state, mesh)

    def from_rank(r):
        # Rank r sends its blocks; the others receive them into new ones.
        def part(pair):
            x, spec = pair
            if spec != SHARDED:
                return x
            return mesh.broadcast(
                x if r == mesh.rank else torch.empty_like(x), src=r)

        return batch_map(part, [state, specs])

    return join_shards([from_rank(r) for r in range(mesh.size)])


def _replicated_tensors(state: AgentState, specs) -> List[torch.Tensor]:
    found = []

    def visit(pair):
        if pair[1] == REPLICATED:
            found.append(pair[0])
        return pair[0]

    batch_map(visit, [state, specs])
    return found


def check_replicated(state: AgentState, mesh: Mesh) -> None:
    """Raises unless every replicated tensor and the generator's state
    equal rank 0's bit for bit (one broadcast): ranks that drift apart
    would each look healthy."""
    specs = state_shardings(None, state, mesh)
    tensors = _replicated_tensors(state, specs)
    tensors.append(state.generator.get_state().to(mesh.device))
    mine = _pack([t.reshape(1, -1) for t in tensors], 1)
    ref = mesh.broadcast(mine.clone(), src=0)
    if not torch.equal(ref, mine):
        raise RuntimeError(
            f"rank {mesh.rank}'s replicated state differs from rank 0's"
        )


def make_distributed_train_chunk(
    agent: Agent,
    eps_schedule: EpsilonSchedule,
    updates_per_iter: int,
    iters_per_chunk: int,
    mesh: Mesh,
    template_state: AgentState,
):
    """The train chunk of one rank of ``mesh``, for that rank's part of
    the state (``shard_state``): the ordinary chunk of an agent that
    draws, samples and updates over the mesh.  Raises before any
    collective when the envs do not split evenly over the ranks."""
    _check_divides(agent.config.num_envs, mesh)
    if template_state.obs.shape[0] * mesh.size != agent.config.num_envs:
        raise ValueError(
            f"the state holds {template_state.obs.shape[0]} envs, not this "
            f"rank's {agent.config.num_envs // mesh.size}: shard_state it"
        )
    ranked = Agent(agent.config, agent.env, device=agent.device, mesh=mesh)
    return make_train_chunk_fn(ranked, eps_schedule, updates_per_iter,
                               iters_per_chunk)
