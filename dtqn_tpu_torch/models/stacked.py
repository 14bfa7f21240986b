"""S networks of one architecture, one per seed, run as one.

The JAX package trains several seeds at once by ``jax.vmap`` over a
stacked ``AgentState`` (``dtqn_tpu/train/sweep.py``).  Here the seeds'
flat parameter vectors are stacked into one [S, P] tensor, each parameter
is seen through an [S, *shape] view of it, and a forward runs the network
once for every seed under ``torch.func.vmap`` with the per-seed views
swapped in for the module's parameters (``functional_call``'s way): each
dispatched operation serves all S seeds, and the attention kernels and the
embedding lookup launch once, at the seeds folded into their batch (their
``vmap`` rules).

Callers keep the layout of a single network's calls with the seeds folded
into the leading batch axis: every tensor argument is [S*B, ...], seed-major,
and so is every output.  A train-mode forward takes its dropout masks
injected (``DropoutDraws(masks=...)``, each [S*B, ...]): per-seed
generators do not run under ``vmap``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterator, List, Mapping, Tuple

import torch
from torch import nn

from dtqn_tpu_torch.models.dropout import DropoutDraws


class StackedNetwork:
    """``module``'s architecture with the parameters of S seeds.

    ``flat`` [S, P] holds each seed's parameters in ``module.parameters()``
    order, as ``flatten_parameters`` lays out one network's; the per-seed
    views (``parameters()``) are leaves that share its memory, so an update
    written into ``flat`` in place is what the next forward reads.
    ``module``'s own parameters are not used; its buffers and
    hyperparameters serve every seed.
    """

    def __init__(self, module: nn.Module, flat: torch.Tensor):
        self.module = module
        self.num_seeds = flat.shape[0]
        self._params: Dict[str, torch.Tensor] = OrderedDict()
        # (owning module, attribute) of each parameter, in order: a forward
        # swaps the per-seed tensors in and back out (as functional_call
        # does, without its per-call lookups).
        self._slots = []
        offset = 0
        for name, p in module.named_parameters():
            owner, _, attr = name.rpartition(".")
            self._slots.append((module.get_submodule(owner), attr))
            n = p.numel()
            view = flat[:, offset:offset + n].view(self.num_seeds, *p.shape)
            self._params[name] = view.detach().requires_grad_(
                p.requires_grad)
            offset += n
        if offset != flat.shape[1]:
            raise ValueError(
                f"{flat.shape[1]} parameters per seed given, the network "
                f"has {offset}"
            )

    def parameters(self) -> List[torch.Tensor]:
        return list(self._params.values())

    def named_parameters(self) -> Iterator[Tuple[str, torch.Tensor]]:
        return iter(self._params.items())

    def seed_state_dict(self, seed_index: int) -> "OrderedDict[str, torch.Tensor]":
        """Seed ``seed_index``'s weights as a single network's
        ``state_dict`` (views of ``flat``)."""
        return OrderedDict(
            (k, self._params[k][seed_index] if k in self._params else v)
            for k, v in self.module.state_dict().items()
        )

    @torch.no_grad()
    def load_stacked_state_dict(self, weights: Mapping[str, torch.Tensor]):
        """Copies [S, *shape] weights, by a single network's parameter
        names, into ``flat``."""
        if set(weights) != set(self._params):
            raise ValueError(
                f"stacked weights differ in {sorted(set(weights) ^ set(self._params))}"
            )
        for name, value in weights.items():
            self._params[name].copy_(value)

    def __call__(self, *args, draws: DropoutDraws = None, **kwargs):
        if draws is not None and draws.masks is None:
            raise ValueError(
                "a stacked train-mode forward takes its dropout masks "
                "injected (DropoutDraws(masks=...), each [S*B, ...])"
            )
        names = tuple(kwargs)
        values = (*args, *kwargs.values(),
                  None if draws is None else draws.masks)
        folded = [_map_tensors(self._unfold, v) for v in values]

        def one_seed(params, *seed_values):
            seed_args = seed_values[:len(args)]
            seed_kwargs = dict(zip(names, seed_values[len(args):-1]))
            if seed_values[-1] is not None:
                seed_kwargs["draws"] = DropoutDraws(masks=seed_values[-1])
            saved = [owner._parameters[attr] for owner, attr in self._slots]
            try:
                for (owner, attr), p in zip(self._slots, params):
                    owner._parameters[attr] = p
                return self.module(*seed_args, **seed_kwargs)
            finally:
                for (owner, attr), p in zip(self._slots, saved):
                    owner._parameters[attr] = p

        in_dims = (0, *(None if v is None else 0 for v in values))
        out = torch.func.vmap(one_seed, in_dims=in_dims)(
            tuple(self._params.values()), *folded)
        return _map_tensors(lambda y: y.flatten(0, 1), out)

    def _unfold(self, x: torch.Tensor) -> torch.Tensor:
        """[S*B, ...] seed-major -> [S, B, ...]."""
        if x.shape[0] % self.num_seeds:
            raise ValueError(
                f"a batch of {x.shape[0]} does not fold {self.num_seeds} "
                "seeds"
            )
        return x.unflatten(0, (self.num_seeds, -1))


def _map_tensors(fn, value):
    """``fn`` on a tensor, or on each tensor of a (named) tuple or list of
    them; anything else as it is."""
    if isinstance(value, torch.Tensor):
        return fn(value)
    if isinstance(value, (tuple, list)):
        items = [_map_tensors(fn, v) for v in value]
        if hasattr(value, "_fields"):
            return type(value)(*items)
        return type(value)(items)
    return value
