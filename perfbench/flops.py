"""Work counted from shapes: the model FLOPs of a training iteration, and
the attention pair's bytes, FLOPs and least time per application.

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

``bound_ms`` is the least time of one attention launch on an H100 SXM:
its inputs read and its outputs written once over HBM, or its products
over the float32 rate, whichever is larger (the forward reads Q, K, V and
writes O; the backward reads Q, K, V and dO and writes dQ, dK, dV, with
five products over the unmasked pairs, as the recompute backward does).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, NamedTuple

HERE = Path(__file__).resolve().parent


def peaks(kind: str) -> dict:
    """The published peaks of the card named ``kind`` (``peaks.json``),
    matched by the longest name that ``kind`` contains."""
    table = json.loads((HERE / "peaks.json").read_text())["cards"]
    hits = [k for k in table if k in kind]
    if not hits:
        raise KeyError(f"no peaks for {kind!r}: {sorted(table)}")
    return table[max(hits, key=len)]


def causal_pairs(lq: int, lk: int, causal: bool) -> int:
    return lq * (lq + 1) // 2 if causal else lq * lk


class Shapes(NamedTuple):
    features: int
    heads: int
    layers: int
    context: int
    bag: int
    obs_dim: int
    embed_per_obs_dim: int  # 0: a continuous observation
    actions: int


def shapes(cfg: dict, obs_dim: int, discrete: bool, actions: int) -> Shapes:
    return Shapes(cfg["inner_embed"], cfg["num_heads"], cfg["num_layers"],
                  cfg["context_len"], cfg["bag_size"], obs_dim,
                  cfg["embed_per_obs_dim"] if discrete else 0, actions)


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


def iteration_flops(s: Shapes, seeds: int, envs: int, batch: int,
                    updates: int) -> int:
    """Model FLOPs of one iteration of every seed."""
    act = forward_flops(s, envs, s.context)
    evict = forward_flops(s, envs * (s.bag + 1), s.context) if s.bag else 0
    update = (3 * forward_flops(s, batch, s.context)
              + backward_flops(s, batch, s.context))
    return seeds * (act + evict + updates * update)


class Application(NamedTuple):
    kind: str  # "attention_fwd" or "attention_bwd"
    batch: int
    lq: int
    lk: int
    causal: bool
    count: int  # per iteration


def attention_applications(s: Shapes, seeds: int, envs: int, batch: int,
                           updates: int) -> List[Application]:
    """The attention launches one iteration makes, by the model's shapes
    (the seeds folded into the batch)."""
    length, out = s.context, []

    def forward(b, count):
        out.append(Application("attention_fwd", b, length, length, True,
                               s.layers * count))
        if s.bag:
            out.append(Application("attention_fwd", b, length, s.bag, False,
                                   count))

    forward(seeds * envs, 1)  # act
    if s.bag:
        forward(seeds * envs * (s.bag + 1), 1)  # evict
    forward(seeds * batch, 3 * updates)  # next-Q (policy, target), loss
    out.append(Application("attention_bwd", seeds * batch, length, length,
                           True, s.layers * updates))
    if s.bag:
        out.append(Application("attention_bwd", seeds * batch, length, s.bag,
                               False, updates))
    return out


def bound_ms(kind: str, b: int, lq: int, lk: int, heads: int, d: int,
             causal: bool, bytes_per_s: float, flops_per_s: float,
             size: int = 4) -> float:
    """Least time of one launch: max(bytes / HBM rate, FLOPs / rate)."""
    e = heads * d
    pairs = causal_pairs(lq, lk, causal)
    if kind == "attention_fwd":  # reads q, k, v; writes out
        nbytes, products = size * b * e * (2 * lq + 2 * lk), 2
    else:  # reads q, k, v, dout; writes dq, dk, dv
        nbytes, products = size * b * e * (3 * lq + 4 * lk), 5
    flops = products * 2 * b * heads * d * pairs
    return 1e3 * max(nbytes / bytes_per_s, flops / flops_per_s)
