"""Memory card (concentration) game, batched (``dtqn_tpu/envs/memory_cards.py``).

N pairs of cards are dealt face-down; each round one un-removed card is
revealed at random and the agent picks the card it believes is its
pair-mate.  A correct pick removes the pair (reward 0); a wrong pick
(including the revealed card itself or a removed card) gives reward -1; the
episode ends with success when all cards are removed.

Token layout of the MultiDiscrete([num_pairs+2]*num_cards) observation
(memory_cards.py:50-53): 0 = hidden, 1..num_pairs = card value,
num_pairs+1 = removed.  Observations are int32.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from dtqn_tpu_torch.envs.core import Environment, ObsKind
from dtqn_tpu_torch.utils.rng import sharded_draw


@dataclasses.dataclass
class MemoryState:
    values: torch.Tensor  # [E, num_cards] int32, dealt values (1..num_pairs)
    removed: torch.Tensor  # [E, num_cards] bool
    current_card: torch.Tensor  # [E] int32, index of the revealed card
    t: torch.Tensor  # [E] int32


class MemoryCards(Environment):
    """Memory-5-v0 style concentration game (num_pairs configurable)."""

    obs_kind = ObsKind.DISCRETE
    obs_dtype = torch.int32

    def __init__(self, num_pairs: int = 5, max_episode_steps: int = 50):
        self.num_pairs = num_pairs
        self.num_cards = num_pairs * 2
        self.name = f"Memory-{num_pairs}-v0"
        self.num_actions = self.num_cards
        self.max_episode_steps = max_episode_steps
        self.obs_shape = (self.num_cards,)
        self.card_hidden = 0
        self.card_removed = num_pairs + 1

    @property
    def obs_mask(self) -> float:
        # MultiDiscrete mask = max(nvec) + 1 (env_processing.py:108-109);
        # nvec is uniformly num_pairs+2 so the mask token is num_pairs+2.
        return float(self.num_pairs + 2)

    def _observe(self, state: MemoryState, revealed_card) -> torch.Tensor:
        """obs[i] = removed if removed, value if revealed, else hidden."""
        idx = torch.arange(self.num_cards, device=state.values.device)
        revealed = idx[None, :] == revealed_card[:, None]
        return torch.where(
            state.removed,
            self.card_removed,
            torch.where(revealed, state.values, self.card_hidden),
        ).to(torch.int32)

    def _reveal(self, generator, removed: torch.Tensor) -> torch.Tensor:
        """Uniformly chosen un-removed card per env: the largest of one
        uniform draw per card, removed cards left out (card 0 when all are
        removed)."""
        u = sharded_draw(generator, removed.shape, lambda g, s: torch.rand(
            s, generator=g, device=removed.device))
        return torch.argmax(torch.where(removed, -1.0, u), dim=-1).to(
            torch.int32
        )

    def reset_with(
        self, values: torch.Tensor, current_card: torch.Tensor
    ) -> Tuple[torch.Tensor, MemoryState]:
        """Fresh episodes from given draws: ``values`` [E, num_cards] the
        dealt cards, ``current_card`` [E] the first card revealed."""
        state = MemoryState(
            values=values.to(torch.int32),
            removed=torch.zeros(values.shape, dtype=torch.bool,
                                device=values.device),
            current_card=current_card.to(torch.int32),
            t=torch.zeros(values.shape[:1], dtype=torch.int32,
                          device=values.device),
        )
        return self._observe(state, state.current_card), state

    def reset_env(self, generator, num_envs: int, device):
        deck = torch.arange(
            1, self.num_pairs + 1, dtype=torch.int32, device=device
        ).repeat_interleave(2)
        # A uniform shuffle per env: the sort order of one draw per card.
        order = torch.argsort(
            sharded_draw(generator, (num_envs, self.num_cards),
                         lambda g, s: torch.rand(s, generator=g,
                                                 device=device)),
            dim=-1,
        )
        values = deck[order]
        current = self._reveal(
            generator, torch.zeros_like(values, dtype=torch.bool)
        )
        return self.reset_with(values, current)

    def step_env(self, generator, state: MemoryState, action):
        action = action.to(torch.int64)
        current = state.current_card.to(torch.int64)
        # A removed card keeps its dealt value, but pairs are removed
        # together, so it can never match the revealed (un-removed) card's
        # value: it falls into the wrong branch (memory_cards.py:93-106).
        picked_value = torch.gather(state.values, 1, action[:, None])[:, 0]
        current_value = torch.gather(state.values, 1, current[:, None])[:, 0]
        correct = (action != current) & (picked_value == current_value)
        reward = torch.where(correct, 0.0, -1.0).to(torch.float32)

        idx = torch.arange(self.num_cards, device=action.device)[None, :]
        pair = (idx == action[:, None]) | (idx == current[:, None])
        removed = state.removed | (correct[:, None] & pair)
        terminated = removed.all(dim=-1)
        # Reveal the next card only if the episode continues.
        next_current = torch.where(
            terminated, 0, self._reveal(generator, removed)
        ).to(torch.int32)
        new_state = MemoryState(
            values=state.values,
            removed=removed,
            current_card=next_current,
            t=state.t + 1,
        )
        obs = self._observe(
            new_state, torch.where(terminated, -1, next_current)
        )
        info = {"is_success": terminated}
        return obs, new_state, reward, terminated, info
