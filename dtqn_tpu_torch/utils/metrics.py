"""On-device windowed running averages (``dtqn_tpu/utils/metrics.py``).

The reference's ``RunningAverage`` over the last N values, kept as tensors on
the device so the training loop never syncs to the host for diagnostics.
Unlike the JAX package, updates happen in place.  A stacked run of S seeds
stacks them (``envs.core.stack_batch``): every field takes a leading seed
axis, one ring per seed, and the means are [S] (the JAX sweep's
``jax.vmap(lambda d: d.means())``).  Over the ranks of a mesh each rank
holds the same rings: every update's values are reduced over the ranks
before they are written.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

DIAGNOSTIC_NAMES = (
    "losses/TD_Error",
    "losses/Grad_Norm",
    "losses/Max_Q_Value",
    "losses/Mean_Q_Value",
    "losses/Min_Q_Value",
    "losses/Max_Target_Value",
    "losses/Mean_Target_Value",
    "losses/Min_Target_Value",
)


@dataclasses.dataclass
class RunningAverage:
    """Ring of the last ``window`` values; each value may be a vector.
    Stacked, one ring per seed: ``buf`` [S, window, ...], ``idx`` and
    ``count`` [S]."""

    buf: torch.Tensor  # [window, *value_shape] float32
    idx: torch.Tensor  # int64 scalar, next write slot
    count: torch.Tensor  # int64 scalar, total values seen

    @classmethod
    def create(
        cls, window: int = 100, value_shape: Tuple[int, ...] = (), device="cpu"
    ) -> "RunningAverage":
        return cls(
            buf=torch.zeros((window, *value_shape), dtype=torch.float32,
                            device=device),
            idx=torch.zeros((), dtype=torch.int64, device=device),
            count=torch.zeros((), dtype=torch.int64, device=device),
        )

    def add_if(self, pred: torch.Tensor, value: torch.Tensor) -> None:
        """Write ``value`` at the next slot when ``pred`` (a device bool;
        stacked, per seed: ``pred`` [S], ``value`` [S, ...])."""
        seeds = self.idx.shape
        window = self.buf.shape[len(seeds)]
        rows = self.buf.view(-1, *self.buf.shape[len(seeds) + 1:])
        slot = self.idx.reshape(-1)
        if seeds:
            slot = slot + torch.arange(0, rows.shape[0], window,
                                       device=slot.device)
        old = rows.index_select(0, slot)
        new = value.to(torch.float32).reshape(old.shape)
        keep = pred.reshape(pred.shape + (1,) * (old.dim() - pred.dim()))
        rows.index_copy_(0, slot, torch.where(keep, new, old))
        self.idx = torch.where(pred, (self.idx + 1) % window, self.idx)
        self.count = self.count + pred.to(torch.int64)

    def mean(self) -> torch.Tensor:
        seeds = self.count.shape
        n = torch.clamp_max(self.count, self.buf.shape[len(seeds)])
        n = n.reshape(seeds + (1,) * (self.buf.dim() - len(seeds) - 1))
        total = self.buf.sum(dim=len(seeds)) / torch.clamp_min(n, 1)
        return torch.where(n > 0, total, torch.zeros_like(total))


@dataclasses.dataclass
class TrainDiagnostics:
    """The 8 loss/Q diagnostics the reference logs (run.py:303-312).

    One ``RunningAverage`` over 8-vectors, in ``DIAGNOSTIC_NAMES`` order,
    so an update costs one write instead of eight.
    """

    averages: RunningAverage

    @classmethod
    def create(cls, window: int = 100, device="cpu") -> "TrainDiagnostics":
        return cls(RunningAverage.create(window, (8,), device))

    def update(self, pred, *, td, gnorm, q, targets, mesh=None) -> None:
        """Stacked, ``pred``, ``td`` and ``gnorm`` are [S] and ``q`` and
        ``targets`` [S*B, ...], seed-major.  Over a mesh, ``td`` is this
        rank's share of the loss and ``q`` and ``targets`` its share of the
        batch: the sums and extremes are reduced over the ranks (two
        collectives)."""
        seeds = self.averages.idx.shape
        if mesh is not None:
            sums = mesh.all_reduce(torch.stack([
                td, q.sum(), targets.sum(),
                torch.tensor(float(q.numel()), device=q.device)]))
            # max(x) and -min(x) in one MAX reduction.
            top = mesh.all_reduce(torch.stack([
                q.max(), targets.max(), -q.min(), -targets.min()]), "max")
            self.averages.add_if(pred, torch.stack([
                sums[0], gnorm, top[0], sums[1] / sums[3], -top[2], top[1],
                sums[2] / sums[3], -top[3]]))
            return

        def stats(x):
            if not seeds:
                return x.max(), x.mean(), x.min()
            x = x.reshape(seeds + (-1,))
            return x.amax(-1), x.mean(-1), x.amin(-1)

        self.averages.add_if(
            pred, torch.stack([td, gnorm, *stats(q), *stats(targets)], -1))

    def means(self) -> Dict[str, torch.Tensor]:
        values = self.averages.mean()
        return {name: values[..., i]
                for i, name in enumerate(DIAGNOSTIC_NAMES)}
