"""Process groups for runs over several devices
(``dtqn_tpu/parallel/distributed.py``).

The JAX package drives every local device from one process and joins hosts
with ``jax.distributed``.  PyTorch's idiom is one process per rank:
``init_distributed`` joins this process to a ``torch.distributed`` group
(from a launcher's environment, as ``torchrun`` sets it, or from explicit
arguments), and ``spawn`` starts the ranks of a run on this host.

The backend follows one rule: NCCL when each rank has a card of its own,
gloo otherwise (NCCL refuses two ranks on one device) or on the CPU.  Every
rank computes on its own device either way; with gloo the collectives only
travel through the host.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dtqn_tpu_torch.parallel.mesh import make_mesh, rank_device


def pick_backend(local_ranks: int, device) -> str:
    """"nccl" when each of the ``local_ranks`` ranks of this host has a
    card of its own, else "gloo"."""
    if (torch.device(device).type == "cuda"
            and torch.cuda.device_count() >= local_ranks):
        return "nccl"
    return "gloo"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
) -> None:
    """Join this process to a ``torch.distributed`` group (no-op for one
    process, or when it has joined one already).

    With no arguments the launcher's environment says it (``torchrun``:
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``); without ``WORLD_SIZE`` there is one
    process.  ``coordinator_address`` is "host:port" or a
    ``torch.distributed`` URL ("tcp://...", "file://...").  The rank's
    device is ``rank_device(local rank, device)`` (the card unless
    ``device`` names the CPU), made current, and the backend follows
    ``pick_backend``.
    """
    if dist.is_initialized() or (num_processes is not None
                                 and num_processes <= 1):
        return
    if coordinator_address is None and num_processes is None:
        if "WORLD_SIZE" not in os.environ:
            return
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
        local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
        init_method = "env://"
    else:
        local_rank, local_ranks = process_id, num_processes
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    dev = rank_device(local_rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        pick_backend(local_ranks, dev), init_method=init_method,
        world_size=num_processes, rank=process_id,
    )


def process_info() -> dict:
    """This process's place in the run: its index and the process count,
    the devices it drives (one: one process per rank) and the run's, and
    the backend (None for one process)."""
    if not dist.is_initialized():
        return {"process_index": 0, "process_count": 1, "local_devices": 1,
                "global_devices": 1, "backend": None}
    world = dist.get_world_size()
    return {"process_index": dist.get_rank(), "process_count": world,
            "local_devices": 1, "global_devices": world,
            "backend": dist.get_backend()}


def _rank_main(rank, nprocs, tmp, threads, device, fn, args):
    torch.set_num_threads(threads)
    init_distributed(f"file://{tmp}/store", nprocs, rank, device=device)
    out = fn(make_mesh(nprocs, device=device), *args)
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn, nprocs: int, args=(), device=None) -> list:
    """``fn(mesh, *args)`` on ``nprocs`` ranks of this host, one process
    each (started with spawn: ``fn`` and ``args`` travel by pickle, ``fn``
    by import path), in a group that meets through a file store in a
    private temporary directory.  Rank r runs on ``rank_device(r,
    device)``; each takes its share of this process's intra-op threads.
    Returns every rank's result in rank order.  A rank that fails ends the
    others and raises here."""
    threads = max(1, torch.get_num_threads() // nprocs)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(
            _rank_main, args=(nprocs, tmp, threads, device, fn, tuple(args)),
            nprocs=nprocs, join=True, start_method="spawn")
        results = []
        for rank in range(nprocs):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
