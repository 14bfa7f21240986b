"""Two-tier checkpoint / resume protocol (``dtqn_tpu/utils/checkpoint.py``).

As the reference (dqn.py:212-327, run.py:471-490):
  1. *Mini checkpoint*: ``{step, wandb_id}`` sentinel written on completion
     (dqn.py:212-220), JSON, same file name and keys as the JAX package.
  2. *Full checkpoint*: the complete training state: parameters, target,
     optimizer state, the entire replay ring (with the stored act-time
     bags of ``--bag-store``), contexts, the bag, the recurrent models'
     act-time carry, env state, counters, epsilon, loss running averages
     and the generator's state.
  3. Plain policy weights every 50k steps under ``--save-policy``
     (run.py:337-338).

``torch.save`` / ``torch.load`` over tensors copied to the host.  Restoring
needs a template state of the same configuration and copies into its
tensors in place: the networks' parameters are views into the flat
``params`` / ``target_params`` vectors, and a rebound vector would leave the
optimizer updating memory the network no longer reads.  A generator's state
loads only into a generator of the same device kind, so a checkpoint
resumes on the device kind it was written on.  A stacked state
(``Agent.init_sweep_state``) is saved and restored the same way, its
per-seed generators one leaf each.

A run sharded over the ranks of a mesh keeps the one-device layout, as the
JAX package's does: every rank calls ``save_checkpoint`` with its part, the
parts are gathered and rank 0 writes the global state.  On resume every
rank loads the file into a global template and keeps its slice
(``parallel.mesh.shard_state``), so a sharded run and a one-device run
resume each other's checkpoints.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from dtqn_tpu_torch.parallel.mesh import unshard_state
from dtqn_tpu_torch.utils.tree import leaves as _leaves

_GENERATOR_DEVICE = "generator_device"


def save_mini_checkpoint(path: str, step: int, wandb_id: Optional[str]) -> None:
    with open(path + "_mini_checkpoint.json", "w") as f:
        json.dump({"step": step, "wandb_id": wandb_id}, f)


def load_mini_checkpoint(path: str) -> Optional[Dict[str, Any]]:
    mini = path + "_mini_checkpoint.json"
    if not os.path.exists(mini):
        return None
    with open(mini) as f:
        return json.load(f)


def save_checkpoint(
    path: str,
    state: Any,
    *,
    extra: Optional[Dict[str, Any]] = None,
    mesh=None,
) -> None:
    """Full checkpoint: every tensor of the AgentState and its generator's
    state, plus host-side extras (the eval running averages).  With a
    ``mesh`` of several ranks, every rank calls it with its part of the
    state, and rank 0 writes the gathered one."""
    if mesh is not None and mesh.size > 1:
        state = unshard_state(state, mesh)
        if mesh.rank:
            return
    payload: Dict[str, Any] = {}
    for name, leaf in _leaves(state):
        if isinstance(leaf, torch.Generator):
            payload[name] = leaf.get_state()
            payload[_GENERATOR_DEVICE] = leaf.device.type
        else:
            payload[name] = leaf.detach().cpu()
    torch.save(payload, path + "_checkpoint.pt")
    with open(path + "_checkpoint_extra.json", "w") as f:
        json.dump(extra or {}, f)


def has_checkpoint(path: str) -> bool:
    return os.path.exists(path + "_checkpoint.pt")


def load_checkpoint(path: str, template_state: Any) -> Tuple[Any, Dict[str, Any]]:
    """Restore a full checkpoint into ``template_state``'s own tensors (in
    place) and return it with the extras."""
    payload = torch.load(path + "_checkpoint.pt", map_location="cpu",
                         weights_only=True)
    leaves = dict(_leaves(template_state))
    missing = set(leaves) ^ (set(payload) - {_GENERATOR_DEVICE})
    if missing:
        raise ValueError(
            f"checkpoint {path!r} does not fit this configuration: "
            f"{sorted(missing)} differ"
        )
    with torch.no_grad():
        for name, leaf in leaves.items():
            saved = payload[name]
            if isinstance(leaf, torch.Generator):
                written_on = payload[_GENERATOR_DEVICE]
                if written_on != leaf.device.type:
                    raise RuntimeError(
                        f"checkpoint {path!r} was written on {written_on!r} "
                        f"and resumes only there, not on "
                        f"{leaf.device.type!r}: a generator's state does not "
                        "carry over between device kinds"
                    )
                leaf.set_state(saved)
            elif saved.shape != leaf.shape or saved.dtype != leaf.dtype:
                raise ValueError(
                    f"checkpoint {path!r} does not fit this configuration: "
                    f"{name} is {tuple(saved.shape)} {saved.dtype}, expected "
                    f"{tuple(leaf.shape)} {leaf.dtype}"
                )
            else:
                leaf.copy_(saved)
    extra_path = path + "_checkpoint_extra.json"
    extra: Dict[str, Any] = {}
    if os.path.exists(extra_path):
        with open(extra_path) as f:
            extra = json.load(f)
    return template_state, extra


def save_policy(path: str,
                network: Union[nn.Module, Mapping[str, torch.Tensor]]) -> None:
    """Policy-weights-only snapshot (run.py:337-338) of a network or of its
    ``state_dict`` (a stacked run's seed: ``StackedNetwork.seed_state_dict``)."""
    if isinstance(network, nn.Module):
        network = network.state_dict()
    weights = {k: v.detach().cpu().clone() for k, v in network.items()}
    torch.save(weights, path + "_policy.pt")


def load_policy(path: str, network: nn.Module) -> nn.Module:
    """Loads a snapshot into ``network``'s own parameters, in place."""
    weights = torch.load(path + "_policy.pt", map_location="cpu",
                         weights_only=True)
    network.load_state_dict(weights, strict=True)
    return network
