"""The leaves of an ``AgentState``: what a checkpoint saves and what a CUDA
graph of a step is bound to (``utils/checkpoint.py``, ``utils/graphs.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Tuple

import torch
from torch import nn

from dtqn_tpu_torch.models.stacked import StackedNetwork


def fields(node: Any) -> Iterator[Tuple[str, Any]]:
    if isinstance(node, tuple):  # a named tuple: the LSTM carry
        return iter(node._asdict().items())
    return ((f.name, getattr(node, f.name)) for f in dataclasses.fields(node))


def leaves(node: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted name, tensor or generator) for every leaf of a tree of
    dataclasses, named tuples and lists of generators (a stacked state's,
    one per seed).  Networks are left out: their parameters are views of a
    leaf; so are the parts a configuration does not have (``None``: no bag,
    no carry)."""
    for field, value in fields(node):
        name = prefix + field
        if isinstance(value, (torch.Tensor, torch.Generator)):
            yield name, value
        elif isinstance(value, list):
            for i, generator in enumerate(value):
                yield f"{name}.{i}", generator
        elif dataclasses.is_dataclass(value) or isinstance(value, tuple):
            yield from leaves(value, name + ".")
        elif value is not None and not isinstance(
                value, (nn.Module, StackedNetwork)):
            raise TypeError(f"cannot checkpoint {name}: {type(value)}")
