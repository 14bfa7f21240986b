"""DQN / DRQN / ADRQN / DARQN Q-networks (``dtqn_tpu/models/recurrent.py``).

  - DQN: obs embed -> ReLU MLP head (the reference's dqn.py:8-55); no
    sequence semantics (the agent forces context 1).
  - DRQN: obs embed -> one LSTM layer (hidden = inner_embed) -> MLP head
    (drqn.py:9-66).  The scan runs over the whole padded window; outputs past
    ``episode_lengths`` are zeroed before the Q head, which is what the
    reference's pack / pad_packed gives at the head (drqn.py:52-63).
  - ADRQN: DRQN with the previous action's embedding, right-shifted when
    L > 1, concatenated in front of the obs embedding (adrqn.py:12-95).
  - DARQN: DRQN with a soft attention over the obs features, conditioned on
    the LSTM's hidden state, stepped one timestep at a time (darqn.py:9-85);
    it ignores ``actions``.

The recurrent nets return (q_values, carry).  The carry is flax's (c, h)
order, as the named tuple ``LSTMCarry``.  The LSTM holds exactly flax's
``OptimizedLSTMCell`` parameters, fused: the input kernels ``ii|if|ig|io``
(no bias) as one ``input_proj`` [4E, in], which projects the whole window
in one product, and the hidden kernels ``hi|hf|hg|ho`` with their biases as
one ``hidden_proj`` [4E, E], one product per step.  Every step is stock
torch ops (no cuDNN RNN, whose backward need not repeat bit for bit).

Under a bfloat16 ``compute_dtype`` the embeddings, the Q head and DARQN's
soft attention compute in bf16, as flax's ``make_dense`` layers do; the
LSTM, which flax builds without a dtype, promotes its bf16 input with its
float32 parameters and computes in float32, its carry included.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from dtqn_tpu_torch.envs.core import ObsKind
from dtqn_tpu_torch.models.embeddings import (
    ActionEmbedding,
    make_obs_embedding,
)
from dtqn_tpu_torch.models.init import lecun_normal_, make_dense, orthogonal_

GATES = 4  # i, f, g, o


class LSTMCarry(NamedTuple):
    c: torch.Tensor  # [B, E] cell
    h: torch.Tensor  # [B, E] hidden


def zero_carry(batch_size: int, features: int, device=None) -> LSTMCarry:
    """The initial carry: zeros (the reference's agents/drqn.py:54-62)."""
    return LSTMCarry(
        torch.zeros((batch_size, features), device=device),
        torch.zeros((batch_size, features), device=device),
    )


class QHead(nn.Module):
    """Dense -> ReLU -> Dense (dqn.py:47-52).  flax names the output layer
    ``Dense_0`` and the hidden one ``Dense_1``; here they are ``out`` and
    ``hidden``."""

    def __init__(self, inner_embed: int, num_actions: int,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.hidden = make_dense(inner_embed, inner_embed, generator,
                                 compute_dtype=compute_dtype)
        self.out = make_dense(inner_embed, num_actions, generator,
                              compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(torch.relu(self.hidden(x)))


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``: i, f, o = sigmoid, g = tanh of
    ``W_h h + b_h + W_i x``; c' = f c + i g; h' = o tanh(c')."""

    def __init__(self, in_features: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = features
        self.input_proj = nn.Linear(in_features, GATES * features, bias=False)
        self.hidden_proj = nn.Linear(features, GATES * features)
        for k in range(GATES):
            rows = slice(k * features, (k + 1) * features)
            lecun_normal_(self.input_proj.weight[rows], in_features,
                          generator)
            orthogonal_(self.hidden_proj.weight[rows], generator)
        nn.init.zeros_(self.hidden_proj.bias)

    def step(self, x_proj: torch.Tensor, carry: LSTMCarry) -> LSTMCarry:
        """One step from the input's projection ``input_proj(x)`` [B, 4E]."""
        n = self.features
        gates = self.hidden_proj(carry.h) + x_proj
        s = torch.sigmoid(gates)
        i, f, o = s[:, :n], s[:, n:2 * n], s[:, 3 * n:]
        g = torch.tanh(gates[:, 2 * n:3 * n])
        c = f * carry.c + i * g
        return LSTMCarry(c, o * torch.tanh(c))


class LSTM(nn.Module):
    """One LSTM layer scanned over the time axis of [B, L, in]."""

    def __init__(self, in_features: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cell = LSTMCell(in_features, features, generator)

    def forward(self, x: torch.Tensor,
                carry: LSTMCarry) -> Tuple[torch.Tensor, LSTMCarry]:
        # The whole window in one product, in float32 (flax promotes).
        x_proj = self.cell.input_proj(x.to(torch.float32))
        ys = []
        for t in range(x.shape[1]):
            carry = self.cell.step(x_proj[:, t], carry)
            ys.append(carry.h)
        return torch.stack(ys, dim=1), carry


class DQN(nn.Module):
    def __init__(
        self,
        *,
        obs_kind: ObsKind,
        obs_shape: Tuple[int, ...],
        num_actions: int,
        vocab_size: int = 0,
        embed_per_obs_dim: int = 8,
        inner_embed: int = 128,
        generator: Optional[torch.Generator] = None,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.obs_embedding = make_obs_embedding(
            features=inner_embed, obs_kind=obs_kind, obs_shape=obs_shape,
            vocab_size=vocab_size, embed_per_obs_dim=embed_per_obs_dim,
            generator=generator, compute_dtype=compute_dtype,
        )
        self.q_head = QHead(inner_embed, num_actions, generator,
                            compute_dtype)

    def forward(self, obss: torch.Tensor, actions=None) -> torch.Tensor:
        """obss: [B, L, *obs_shape] -> Q [B, L, A]; ``actions`` unused."""
        del actions
        return self.q_head(self.obs_embedding(obss))


class _RecurrentBase(nn.Module):
    """The obs (and action) tokens, the padding mask and the Q head shared
    by the LSTM family; a subclass adds its core between them."""

    def __init__(
        self,
        *,
        obs_kind: ObsKind,
        obs_shape: Tuple[int, ...],
        num_actions: int,
        vocab_size: int = 0,
        embed_per_obs_dim: int = 8,
        inner_embed: int = 128,
        action_dim: int = 0,
        generator: Optional[torch.Generator] = None,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.inner_embed = inner_embed
        self.compute_dtype = compute_dtype
        self.obs_embedding = make_obs_embedding(
            features=inner_embed - action_dim, obs_kind=obs_kind,
            obs_shape=obs_shape, vocab_size=vocab_size,
            embed_per_obs_dim=embed_per_obs_dim, generator=generator,
            compute_dtype=compute_dtype,
        )
        self.action_embed = (
            ActionEmbedding(num_actions, action_dim, generator, compute_dtype)
            if action_dim > 0
            else None
        )
        self.q_head = QHead(inner_embed, num_actions, generator,
                            compute_dtype)

    def _tokens(self, obss, actions) -> torch.Tensor:
        tokens = self.obs_embedding(obss)
        if self.action_embed is None:
            return tokens
        act_tok = self.action_embed(actions)
        if obss.shape[1] > 1:
            # Right-shift previous actions (adrqn.py:73-76).
            act_tok = torch.cat(
                [torch.zeros_like(act_tok[:, :1]), act_tok[:, :-1]], dim=1
            )
        return torch.cat([act_tok, tokens], dim=-1)

    @staticmethod
    def _mask_padded(ys, episode_lengths):
        """Zero the outputs past each episode's length, as pad_packed_sequence
        pads them (drqn.py:58-63)."""
        if episode_lengths is None:
            return ys
        t = torch.arange(ys.shape[1], device=ys.device)[None, :, None]
        valid = t < episode_lengths.reshape(-1, 1, 1)
        return torch.where(valid, ys, torch.zeros_like(ys))


class DRQN(_RecurrentBase):
    def __init__(self, *, generator: Optional[torch.Generator] = None,
                 **kw):
        super().__init__(generator=generator, **kw)
        self.lstm = LSTM(self.inner_embed, self.inner_embed, generator)

    def forward(
        self,
        obss: torch.Tensor,
        actions: Optional[torch.Tensor] = None,
        carry: Optional[LSTMCarry] = None,
        episode_lengths: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, LSTMCarry]:
        """obss: [B, L, *obs_shape]; actions: [B, L] int -> (Q [B, L, A],
        the carry after the last step)."""
        tokens = self._tokens(obss, actions)
        if carry is None:
            carry = zero_carry(obss.shape[0], self.inner_embed, obss.device)
        ys, carry = self.lstm(tokens, carry)
        return self.q_head(self._mask_padded(ys, episode_lengths)), carry


class ADRQN(DRQN):
    """DRQN with previous-action conditioning; set action_dim > 0."""


class SoftAttention(nn.Module):
    """g(v, h) = softmax(linear2(tanh(linear(v) + W h))) (darqn.py:9-24)."""

    def __init__(self, features: int,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        cd = compute_dtype
        self.W = make_dense(features, features, generator, bias=False,
                            compute_dtype=cd)
        self.linear = make_dense(features, features, generator,
                                 compute_dtype=cd)
        self.linear2 = make_dense(features, features, generator,
                                  compute_dtype=cd)

    def forward(self, linear_x: torch.Tensor,
                h: torch.Tensor) -> torch.Tensor:
        """``linear_x`` is ``linear(x)``, made for the whole window at once."""
        z = torch.tanh(linear_x + self.W(h))
        return torch.softmax(self.linear2(z), dim=-1)


class DARQNCore(nn.Module):
    """The attend-then-LSTM step (darqn.py:72-83)."""

    def __init__(self, features: int,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.attention = SoftAttention(features, generator, compute_dtype)
        self.cell = LSTMCell(features, features, generator)

    def forward(self, tokens: torch.Tensor,
                carry: LSTMCarry) -> Tuple[torch.Tensor, LSTMCarry]:
        # The attention weights depend on the previous hidden state: a true
        # sequential scan.
        linear_x = self.attention.linear(tokens)
        ys = []
        for t in range(tokens.shape[1]):
            attn = self.attention(linear_x[:, t], carry.h)
            carry = self.cell.step(
                self.cell.input_proj(attn.to(torch.float32)), carry)
            ys.append(carry.h)
        return torch.stack(ys, dim=1), carry


class DARQN(_RecurrentBase):
    def __init__(self, *, generator: Optional[torch.Generator] = None,
                 **kw):
        super().__init__(generator=generator, **kw)
        self.core = DARQNCore(self.inner_embed, generator,
                              self.compute_dtype)

    def forward(
        self,
        obss: torch.Tensor,
        actions: Optional[torch.Tensor] = None,
        carry: Optional[LSTMCarry] = None,
        episode_lengths: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, LSTMCarry]:
        del actions  # DARQN does not condition on actions (darqn.py:59-85)
        tokens = self._tokens(obss, None)
        if carry is None:
            carry = zero_carry(obss.shape[0], self.inner_embed, obss.device)
        ys, carry = self.core(tokens, carry)
        return self.q_head(self._mask_padded(ys, episode_lengths)), carry
