"""DTQN's and DTQN-bag's work, counted from shapes: the model FLOPs of a
training iteration and the attention launches it makes.  A configuration
names this file as its ``"work"``; the harness calls
``iteration_flops`` and ``attention_applications``.

Model FLOPs are the matrix products' multiply-adds times two, as the
published network computes them, with no recomputation: per token the
observation embedding, each layer's fused QKV, attention (Q K^T and P V
over the causally unmasked pairs), output projection and 4x MLP, the bag's
projections and cross-attention, and the head.  A backward pass is twice
its forward, less the input gradient of a continuous observation's
embedding, which nothing needs.  A token lookup is no FLOP.

An iteration, per seed: one act forward over the E contexts; with a bag,
one evict forward over the E x (bag + 1) candidates; and per update two
no-grad forwards on the next windows (policy and target), one forward and
one backward on the windows.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from perfbench.flops import Application, causal_pairs


class Shapes(NamedTuple):
    features: int
    heads: int
    layers: int
    context: int
    bag: int
    obs_dim: int
    embed_per_obs_dim: int  # 0: a continuous observation
    actions: int


def shapes(cfg: dict, env) -> Shapes:
    """``cfg``'s shapes on the reference ``env``'s observations."""
    discrete = env.obs_dtype == torch.int32
    return Shapes(cfg["inner_embed"], cfg["num_heads"], cfg["num_layers"],
                  cfg["context_len"], cfg["bag_size"], env.obs_shape[0],
                  cfg["embed_per_obs_dim"] if discrete else 0,
                  env.num_actions)


def embed_flops(s: Shapes) -> int:
    """Per embedded observation."""
    inputs = s.obs_dim * (s.embed_per_obs_dim or 1)
    return 2 * inputs * s.features


def forward_flops(s: Shapes, batch: int, length: int) -> int:
    """One forward over ``batch`` windows of ``length`` steps."""
    f = s.features
    tokens = batch * length
    per_layer = tokens * (2 * f * 3 * f + 2 * f * f + 2 * 2 * f * 4 * f)
    per_layer += batch * 4 * causal_pairs(length, length, True) * f
    total = tokens * embed_flops(s) + s.layers * per_layer
    if s.bag:
        bag_tokens = batch * s.bag
        total += bag_tokens * embed_flops(s)
        total += tokens * 2 * f * f * 2  # query, out
        total += bag_tokens * 2 * f * f * 2  # key, value
        total += batch * 4 * length * s.bag * f
    head_in = 2 * f if s.bag else f
    total += tokens * (2 * head_in * f + 2 * f * s.actions)
    return total


def backward_flops(s: Shapes, batch: int, length: int) -> int:
    total = 2 * forward_flops(s, batch, length)
    if not s.embed_per_obs_dim:
        # A continuous observation's embedding needs no input gradient.
        total -= batch * (length + s.bag) * embed_flops(s)
    return total


def iteration_flops(cfg: dict, env, seeds: int, envs: int, batch: int,
                    updates: int) -> int:
    """Model FLOPs of one iteration of every seed."""
    s = shapes(cfg, env)
    act = forward_flops(s, envs, s.context)
    evict = forward_flops(s, envs * (s.bag + 1), s.context) if s.bag else 0
    update = (3 * forward_flops(s, batch, s.context)
              + backward_flops(s, batch, s.context))
    return seeds * (act + evict + updates * update)


def attention_applications(cfg: dict, env, seeds: int, envs: int,
                           batch: int, updates: int) -> List[Application]:
    """The attention launches one iteration makes, by the model's shapes
    (the seeds folded into the batch); every head of the width
    ``features / heads``, for queries, keys and values alike."""
    s = shapes(cfg, env)
    length, out = s.context, []
    d = s.features // s.heads

    def app(kind, b, lk, causal, count):
        out.append(Application(kind, b, length, lk, causal, count, s.heads,
                               d, d))

    def forward(b, count):
        app("attention_fwd", b, length, True, s.layers * count)
        if s.bag:
            app("attention_fwd", b, s.bag, False, count)

    forward(seeds * envs, 1)  # act
    if s.bag:
        forward(seeds * envs * (s.bag + 1), 1)  # evict
    forward(seeds * batch, 3 * updates)  # next-Q (policy, target), loss
    app("attention_bwd", seeds * batch, length, True, s.layers * updates)
    if s.bag:
        app("attention_bwd", seeds * batch, s.bag, False, updates)
    return out
